"""ICO and CUR decoding for ``image_io.read_image``, numpy and the standard
library only, bit-equal to PIL 12.1's ``np.array(Image.open(path).convert(
"RGB"))``.

- ICO (``\\0\\0\\1\\0``): the entry PIL's ``IcoImagePlugin`` loads: the
  directory sorted by colour depth (the bit count, else log2 of the
  colour count rounded up, else 256), then by area, largest first, both
  stable, so the largest image of the lowest depth. A PNG entry goes
  through ``image_io.decode_png``. A DIB entry (a BMP without its file
  header, its height doubled for the AND mask) goes through
  ``image_bmp.decode_dib`` at half the height; the AND mask (or a 32-bit entry's
  alpha bytes) only becomes alpha, which ``convert("RGB")`` drops, but
  PIL reads it, so a file that ends before it raises, as in PIL.
  PIL's ICO opener loads that entry, and a failure it takes for "not
  this format" passes the file on to the next opener (TGA, ...).
  ``open_entry`` makes those checks: for a PNG entry, PIL's PNG opener's
  (``image_io.png_header``) and its load's (image data that ends early,
  then a chunk header whose name is not a name); for a DIB entry, its
  header checks (a header word cut short, bitfield masks past the file's
  end, or a width or height of 0 pass the file on; a header cut short,
  an unknown header size, depth or compression, or a bad palette size
  end ``Image.open``).
- CUR (``\\0\\0\\2\\0``): PIL's ``CurImagePlugin`` takes the first entry
  unless a later one is larger in both width and height (the directory's
  bytes, 0 not read as 256), and reads its DIB at half the height without
  a mask; a PNG cursor raises, as PIL fails on it.
"""

from __future__ import annotations

import math
import re
import struct
import zlib

import numpy as np

from .image_bmp import decode_dib
from .image_identify import PassOn, check_size
from .image_io import _COLOR_TYPES, _SIGNATURE, decode_png, inflate_idat, png_header


def choose_cursor(data: bytes) -> bytes:
    """The directory entry PIL's ``CurImageFile`` picks; ``PassOn`` (or an
    ``IndexError`` or ``struct.error``) where PIL passes the file on."""
    (n,) = struct.unpack_from("<H", data, 4)
    best = b""
    for i in range(n):
        e = data[6 + 16 * i:22 + 16 * i]
        if not best:
            best = e
        elif e[0] > best[0] and e[1] > best[1]:
            best = e
    if not best:
        raise PassOn("no cursors were found")
    return best


def choose(data: bytes, path: str) -> tuple:
    """The entry PIL's ``IcoFile`` picks: (area, depth, bit count, size,
    offset). A directory that ends early raises ``IndexError`` or
    ``struct.error``, and an empty one ``IndexError``, as in PIL."""
    (n,) = struct.unpack_from("<H", data, 4)
    heads = []
    for i in range(n):
        e = data[6 + 16 * i:22 + 16 * i]
        width, height, ncolor = e[0] or 256, e[1] or 256, e[2]
        bpp, size, offset = struct.unpack("<HII", e[6:16])
        depth = bpp or (ncolor != 0 and math.ceil(math.log(ncolor, 2))) or 256
        heads.append((width * height, depth, bpp, size, offset))
    heads.sort(key=lambda h: h[1])
    heads.sort(key=lambda h: h[0], reverse=True)
    return heads[0]


def open_entry(data: bytes, path: str) -> None:
    """PIL's ICO opener on the chosen entry (see the module docstring):
    returns where it takes the file, raises ``PassOn`` (or ``IndexError``,
    ``struct.error``) where it passes the file on and ``ValueError`` where
    ``Image.open`` fails."""
    offset = choose(data, path)[4]
    entry = data[offset:]
    if entry[:8] == _SIGNATURE:
        _load_png(entry, png_header(entry, path))
    else:
        _open_dib(entry, path)


def _load_png(png: bytes, head: dict) -> None:
    """PIL's load of a PNG entry inside the ICO opener: where its
    consecutive IDAT chunks end before its decoder does
    (``image_io.inflate_idat``), PIL reads the next chunk header, and a
    name there that is not four word characters raises ``SyntaxError``,
    which passes the file on. Other failures of the load end
    ``Image.open``."""
    if head["idat"] is None:
        return
    width, height, bits, ctype, interlace = head["ihdr"]
    chunks, pos = [], head["idat"]
    while png[pos + 4:pos + 8] == b"IDAT":
        (length,) = struct.unpack(">I", png[pos:pos + 4])
        chunks.append(png[pos + 8:pos + 8 + length])
        if len(chunks[-1]) < length:
            return  # the file ends inside the chunk: PIL fails
        pos += 12 + length
    try:
        if inflate_idat(chunks, width, height, _COLOR_TYPES[ctype][1], bits, interlace):
            return
    except zlib.error:
        return  # PIL's decoder fails
    following = png[pos:pos + 8]
    if len(following) >= 4 and not re.match(rb"\w\w\w\w", following[4:]):
        raise PassOn("broken PNG file after its image data")


def _open_dib(dib: bytes, path: str) -> None:
    """``BmpImageFile._bitmap`` on a DIB entry, then ``ImageFile``'s size
    check."""
    (hsize,) = struct.unpack("<I", dib[:4])
    if len(dib) < hsize:
        raise ValueError(f"{path}: ICO entry's DIB header cut short (PIL fails on it: Truncated "
                         f"File Read)")
    if hsize == 12:
        width, height, _, bits = struct.unpack("<HHHH", dib[4:12])
        compression, colors = 0, 0
    elif hsize in (40, 52, 56, 64, 108, 124):
        width, height = struct.unpack("<II", dib[4:12])
        if dib[11] == 0xFF:  # top-down
            height = 2 ** 32 - height
        bits, compression = struct.unpack("<HI", dib[14:20])
        (colors,) = struct.unpack("<I", dib[36:40])
        if compression == 3 and hsize < 52:  # the masks after the header
            struct.unpack("<3I", dib[hsize:hsize + 12])
    else:
        raise ValueError(f"{path}: ICO entry's DIB header of {hsize} bytes (PIL fails on it: "
                         f"unsupported BMP header type)")
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"{path}: ICO entry's DIB of {bits} bits (PIL fails on it)")
    if compression not in (0, 1, 2, 3):
        raise ValueError(f"{path}: ICO entry's DIB compression {compression} (PIL fails on it)")
    if bits <= 8 and not 0 < (colors or 1 << bits) <= 65536:
        raise ValueError(f"{path}: ICO entry's DIB palette of {colors} colours (PIL fails on it)")
    if width <= 0 or height <= 0:
        raise PassOn("no mode, or a size of 0")
    check_size(width, height, path)


def decode_ico(data: bytes, path: str) -> np.ndarray:
    """An ICO or CUR file's bytes as (H, W, 3) uint8 RGB (see the module docstring)."""
    if data[:4] == b"\x00\x00\x02\x00":
        try:
            (offset,) = struct.unpack_from("<I", choose_cursor(data), 12)
        except (PassOn, IndexError, struct.error):
            raise ValueError(f"{path}: CUR directory without a cursor PIL reads") from None
        if data[offset:offset + 8] == _SIGNATURE:
            raise ValueError(f"{path}: PNG cursor (PIL's CUR reader fails on it)")
        return decode_dib(data[offset:], path, halve=True)
    if data[:4] != b"\x00\x00\x01\x00":
        raise ValueError(f"{path}: not an ICO or CUR file")
    try:
        _, _, bpp, size, offset = choose(data, path)
    except (IndexError, struct.error):
        raise ValueError(f"{path}: truncated ICO/CUR directory") from None
    if data[offset:offset + 8] == _SIGNATURE:
        return decode_png(data[offset:], path)
    rgb = decode_dib(data[offset:], path, halve=True)
    h, w = rgb.shape[:2]
    if bpp == 32:  # the alpha bytes PIL reads from the pixels
        (hsize,) = struct.unpack("<I", data[offset:offset + 4])
        need = offset + hsize + w * h * 4
    else:  # the AND mask PIL reads at the entry's end: rows padded to 32 bits
        need = offset + size
        if offset + size - ((w + 31) // 32 * 4) * h < 0:
            raise ValueError(f"{path}: ICO AND mask before the file's start")
    if need > len(data):
        raise ValueError(f"{path}: truncated ICO data: the mask ends past the file")
    return rgb
