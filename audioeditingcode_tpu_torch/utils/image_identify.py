"""Which format PIL 12.1's ``Image.open`` takes a file for, without PIL.

``Image.open`` reads the first 16 bytes and tries its openers in the order
of ``Image.ID``. In a fresh interpreter that order is the six openers
``preinit()`` registers, then the rest in the order ``init()`` imports them
(``OPENERS`` below). An opener with an accept test is tried only where the
test passes; IM, IMT, IPTC, PCD, SPIDER and TGA have none and are tried on
every file that reaches them. An opener that raises ``SyntaxError``,
``IndexError``, ``TypeError``, ``KeyError``, ``EOFError`` or
``struct.error`` while it reads the header, or leaves the image without a
mode or with a size of 0, passes the file on to the next opener; any other
error ends ``Image.open``. A file no opener takes raises "cannot identify
image file".

``identify`` follows that order. Each entry of ``OPENERS`` is (name, accept
test, header open), the name being the ``format`` PIL gives the image. A
header open returns where PIL's opener takes the file, raises ``PassOn``
where it passes the file on, and raises a
``ValueError`` that names PIL failing where PIL's opener ends
``Image.open``. The formats ``read_image`` reads have their header opens in
their own modules, copies of PIL's; the others have copies of PIL's checks
up to where the opener takes the file, enough to tell where it passes the
file on. ICO's opener loads the entry it picks, so its header open,
``image_ico.open_entry``, makes that entry's PNG or DIB checks too.
"""

from __future__ import annotations

import struct
from typing import Callable, Optional, Tuple


class PassOn(Exception):
    """PIL's opener passes the file on to the next one."""


class Unidentified(ValueError):
    """No opener of PIL's takes the file ("cannot identify image file")."""


# PIL's ``Image.MAX_IMAGE_PIXELS`` twice: ``Image.open`` raises
# ``DecompressionBombError`` above it
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)


def check_size(width: int, height: int, path: str) -> None:
    """PIL's ``_decompression_bomb_check`` as it ends ``Image.open``."""
    if width * height > MAX_PIXELS:
        raise ValueError(f"{path}: image of {width} x {height} pixels (PIL fails on it: "
                         f"DecompressionBombError)")


def _be16(data: bytes, pos: int) -> int:
    return struct.unpack_from(">H", data, pos)[0]


def _le32(data: bytes, pos: int = 0) -> int:
    return struct.unpack_from("<I", data, pos)[0]


def _be32(data: bytes, pos: int = 0) -> int:
    return struct.unpack_from(">I", data, pos)[0]


def _starts(*magics: bytes) -> Callable[[bytes], bool]:
    return lambda prefix: prefix.startswith(magics)


def _takes(data: bytes, path: str) -> None:
    """An opener that takes every file its accept test passes."""


# ------------------------------------------- the checks of other openers
def _avif_accept(prefix: bytes) -> bool:
    return prefix[4:8] == b"ftyp" and prefix[8:12] in (b"avif", b"avis", b"mif1", b"msf1")


def _cur(data: bytes, path: str) -> None:
    """``CurImageFile._open``: the directory (``image_ico.choose_cursor``),
    the chosen bitmap header's size field, and half its height above 0."""
    from .image_ico import choose_cursor

    (offset,) = struct.unpack_from("<I", choose_cursor(data), 12)
    (size,) = struct.unpack_from("<I", data, offset)
    if size == 12 and len(data) >= offset + 12:
        (height,) = struct.unpack_from("<H", data, offset + 6)
    elif size in (40, 52, 56, 64, 108, 124) and len(data) >= offset + 16:
        height = abs(struct.unpack_from("<i", data, offset + 8)[0])
    else:
        return  # PIL fails on the header (OSError) or reads further
    if height // 2 <= 0:
        raise PassOn("no mode, or a size of 0")


def _mpeg(data: bytes, path: str) -> None:
    if len(data) < 7 or not (data[4] << 4 | data[5] >> 4) or not ((data[5] & 15) << 8 | data[6]):
        raise PassOn("MPEG sequence header of size 0")


def _webp_accept(prefix: bytes) -> bool:
    return prefix[:4] == b"RIFF" and prefix[8:12] == b"WEBP" and prefix[12:16] in (
        b"VP8 ", b"VP8X", b"VP8L")


def _tga(data: bytes, path: str) -> None:
    from .image_tga import is_tga

    if not is_tga(data[:18]):
        raise PassOn("not a TGA file")


def _ppm(data: bytes, path: str) -> None:
    from .image_pnm import read_magic

    if read_magic(data)[0] not in _PPM_MAGICS:
        raise PassOn("not a PPM file")


_PPM_MAGICS = (b"P1", b"P2", b"P3", b"P4", b"P5", b"P6", b"P0CMYK", b"Pf", b"PyP", b"PyRGBA",
               b"PyCMYK")


def _module_open(module: str, name: str = "header") -> Callable[[bytes, str], None]:
    """The header open of a format read beside ``image_io``."""
    def opens(data: bytes, path: str) -> None:
        import importlib

        getattr(importlib.import_module(f".{module}", __package__), name)(data, path)
    return opens


Accept = Optional[Callable[[bytes], bool]]
OPENERS: Tuple[Tuple[str, Accept, Callable[[bytes, str], None]], ...] = (
    ("BMP", _starts(b"BM"), _takes),
    ("DIB", lambda p: len(p) >= 4 and _le32(p) in (12, 40, 52, 56, 64, 108, 124), _takes),
    ("GIF", _starts(b"GIF87a", b"GIF89a"), _takes),
    ("JPEG", _starts(b"\xff\xd8\xff"), _takes),
    ("PPM", lambda p: len(p) >= 2 and p[:1] == b"P" and p[1] in b"0123456fy", _ppm),
    ("PNG", _starts(b"\x89PNG\r\n\x1a\n"), _module_open("image_io", "png_header")),
    ("AVIF", _avif_accept, _takes),
    ("BLP", _starts(b"BLP1", b"BLP2"), _module_open("image_blp")),
    ("BUFR", _starts(b"BUFR", b"ZCZC"), _takes),
    ("CUR", _starts(b"\0\0\2\0"), _cur),
    ("PCX", lambda p: len(p) >= 2 and p[0] == 10 and p[1] in (0, 2, 3, 5),
     _module_open("image_pcx")),
    ("DCX", lambda p: len(p) >= 4 and _le32(p) == 0x3ADE68B1, _module_open("image_pcx", "dcx")),
    ("DDS", _starts(b"DDS "), _module_open("image_dds")),
    ("EPS", lambda p: p.startswith(b"%!PS") or (len(p) >= 4 and _le32(p) == 0xC6D3D0C5), _takes),
    ("FITS", _starts(b"SIMPLE"), _module_open("image_fits")),
    ("FLI", lambda p: len(p) >= 16 and struct.unpack_from("<H", p, 4)[0] in (0xAF11, 0xAF12)
     and struct.unpack_from("<H", p, 14)[0] in (0, 3), _module_open("image_fli")),
    ("FTEX", _starts(b"FTEX"), _module_open("image_ftex")),
    ("GBR", lambda p: len(p) >= 8 and _be32(p) >= 20 and _be32(p, 4) in (1, 2),
     _module_open("image_gbr")),
    ("GRIB", lambda p: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1, _takes),
    ("HDF5", _starts(b"\x89HDF\r\n\x1a\n"), _takes),
    ("JPEG2000", _starts(b"\xff\x4f\xff\x51", b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"),
     _module_open("image_jpeg2000")),
    ("ICNS", _starts(b"icns"), _module_open("image_icns")),
    ("ICO", _starts(b"\0\0\1\0"), _module_open("image_ico", "open_entry")),
    ("IM", None, _module_open("image_im")),
    ("IMT", None, _module_open("image_imt")),
    ("IPTC", None, _module_open("image_iptc")),
    ("MCIDAS", _starts(b"\0\0\0\0\0\0\0\4"), _module_open("image_mcidas")),
    ("MPEG", _starts(b"\0\0\1\xb3"), _mpeg),
    ("TIFF", _starts(b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b",
                     b"II\x2b\x00"), _takes),
    ("MSP", _starts(b"DanM", b"LinS"), _module_open("image_msp")),
    ("PCD", None, _module_open("image_pcd")),
    ("PIXAR", _starts(b"\200\350\000\000"), _module_open("image_pixar")),
    ("PSD", _starts(b"8BPS"), _module_open("image_psd")),
    ("QOI", _starts(b"qoif"), _module_open("image_qoi")),
    ("SGI", lambda p: len(p) >= 2 and _be16(p, 0) == 474, _module_open("image_sgi")),
    ("SPIDER", None, _module_open("image_spider")),
    ("SUN", lambda p: len(p) >= 4 and _be32(p) == 0x59A66A95, _module_open("image_sun")),
    ("TGA", None, _tga),
    ("WEBP", _webp_accept, _takes),
    ("WMF", _starts(b"\xd7\xcd\xc6\x9a\x00\x00", b"\x01\x00\x00\x00"), _takes),
    ("XBM", lambda p: p.lstrip().startswith(b"#define"), _module_open("image_xbm")),
    ("XPM", _starts(b"/* XPM */"), _module_open("image_xpm")),
    ("XVThumb", _starts(b"P7 332"), _module_open("image_xvthumb")),  # registered as XVTHUMB
)


def identify(data: bytes, path: str) -> str:
    """The ``format`` of PIL's ``Image.open`` on a file of these bytes
    (see the module docstring)."""
    prefix = data[:16]
    for name, accept, opens in OPENERS:
        if accept is not None and not accept(prefix):
            continue
        try:
            opens(data, path)
        except (PassOn, IndexError, TypeError, KeyError, EOFError, struct.error):
            continue
        return name
    raise Unidentified(f"{path}: cannot identify image file (no opener of PIL's takes it, so PIL "
                       f"fails on it)")
