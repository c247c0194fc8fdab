"""FITS decoding for ``image_io.read_image``, numpy and the standard library
only, bit-equal to PIL 12.1's ``np.array(Image.open(path).convert("RGB"))``.

PIL's ``FitsImagePlugin`` reads 80-byte cards: the first must be
``SIMPLE = T`` (else the file passes on); ``END`` closes a header unit,
which runs to the next multiple of 2880 bytes, and the first card of the
data after it ends the header; ``XTENSION`` opens another unit. The first
unit with ``NAXIS`` above 0 gives the size (``NAXIS1`` x ``NAXIS2``; one
axis: 1 x ``NAXIS1``) and ``BITPIX`` the mode: 8 ``L``, 16 ``I;16``, 32
``I``, -32 and -64 ``F``; another ``BITPIX`` passes the file on, and no
such unit makes PIL fail ("No image data"), as does a file that ends in
the header. PIL reads the data with the mode as its raw mode, rows bottom
to top: FITS stores big-endian samples, but ``I;16``, ``I`` and ``F`` are
little-endian raw modes, so PIL reads 16- and 32-bit samples byte-swapped
and a -64 file's doubles as pairs of float32 (its misread, reproduced
here); ``convert("RGB")`` then clamps or truncates to 0..255.

A tile-compressed image (a ``BINTABLE`` with ``ZIMAGE = T`` and
``ZCMPTYPE = 'GZIP_1'``) is read as PIL's ``FitsGzipDecoder`` reads it:
the size and mode from ``ZNAXIS*`` and ``ZBITPIX``; everything from
NAXIS1 x NAXIS2 x (BITPIX // 8) bytes past the table's first card to the
end of the file through ``gzip.decompress`` (gzip members back to back,
zero bytes after them skipped); of each 4-byte element of what that
gives, the last min(ZBITPIX // 8, 4) bytes, read in the mode's raw mode
as above; rows bottom to top. For a ZBITPIX of -32 or -64 that count is
negative, PIL keeps no byte of an element and fails ("not enough image
data"), and so does the port; it fails too where the data inflates to
fewer than four bytes a pixel or is not gzip data.
"""

from __future__ import annotations

import gzip
import math
import zlib

import numpy as np

from .image_identify import PassOn, check_size
from .image_io import band_to_rgb

_MODES = {8: "u1", 16: "<u2", 32: "<i4", -32: "<f4", -64: "<f4"}


def _int(headers: dict, key: bytes, path: str) -> int:
    try:
        return int(headers[key])
    except ValueError:
        raise ValueError(f"{path}: FITS {key.decode()} {headers[key]!r} is not an integer (PIL "
                         f"fails on it)") from None


def _size(headers: dict, prefix: bytes, path: str):
    """PIL's ``_get_size``: (width, height), None where there are no axes."""
    naxis = _int(headers, prefix + b"NAXIS", path)
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, _int(headers, prefix + b"NAXIS1", path)
    return _int(headers, prefix + b"NAXIS1", path), _int(headers, prefix + b"NAXIS2", path)


def _parse(headers: dict, path: str):
    """PIL's ``_parse_headers``: (decoder, size, dtype, offset, bitpix),
    decoder "" where the unit has no axes; ``offset`` from the first data
    card (the binary table's bytes for GZIP_1)."""
    prefix, decoder, offset = b"", "raw", 0
    if (headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T"
            and headers[b"ZCMPTYPE"] == b"'GZIP_1  '"):
        w, h = _size(headers, b"", path) or (0, 0)
        offset = w * h * (_int(headers, b"BITPIX", path) // 8)
        prefix, decoder = b"Z", "fits_gzip"
    size = _size(headers, prefix, path)
    if size is None:
        return "", None, None, 0, 0
    bitpix = _int(headers, prefix + b"BITPIX", path)
    return decoder, size, _MODES.get(bitpix), offset, bitpix


def header(data: bytes, path: str) -> dict:
    """PIL's ``FitsImageFile._open``."""
    headers, in_progress, decoder, pos = {}, False, "", 0
    size = dtype = None
    offset = bitpix = 0
    while True:
        card = data[pos:pos + 80]
        pos = min(pos + 80, len(data))
        if not card:
            raise ValueError(f"{path}: truncated FITS file (PIL fails on it)")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_progress = True
        elif headers and not in_progress:
            break
        elif keyword == b"END":
            pos = math.ceil(pos / 2880) * 2880
            if not decoder:
                decoder, size, dtype, offset, bitpix = _parse(headers, path)
            in_progress = False
            continue
        if decoder:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(b"SIMPLE") or value != b"T"):
            raise PassOn("not a FITS file")
        headers[keyword] = value
    if not decoder:
        raise ValueError(f"{path}: FITS without image data (PIL fails on it)")
    if dtype is None or size[0] <= 0 or size[1] <= 0:
        raise PassOn("no mode, or a size of 0")
    check_size(*size, path)
    return {"size": size, "dtype": dtype, "decoder": decoder, "bitpix": bitpix,
            "offset": offset + min(pos, len(data)) - 80}


def decode_fits(data: bytes, path: str) -> np.ndarray:
    """A FITS file's bytes as (H, W, 3) uint8 RGB (see the module docstring)."""
    try:
        head = header(data, path)
    except (PassOn, KeyError) as e:
        raise ValueError(f"{path}: not a FITS file PIL opens ({e})") from None
    (w, h), dt, pos = head["size"], np.dtype(head["dtype"]), head["offset"]
    if head["decoder"] == "fits_gzip":
        return _gzip_1(data, pos, w, h, dt, head["bitpix"], path)
    if len(data) - pos < dt.itemsize * w * h:
        raise ValueError(f"{path}: truncated FITS data (PIL: image file is truncated)")
    v = np.frombuffer(data, dt, w * h, pos).reshape(h, w)[::-1]
    return band_to_rgb(v if dt.kind == "f" else v.astype(np.int64))


def _gzip_1(data: bytes, pos: int, w: int, h: int, dt: np.dtype, bitpix: int,
            path: str) -> np.ndarray:
    """PIL's ``FitsGzipDecoder`` (see the module docstring)."""
    if pos < 0:
        raise ValueError(f"{path}: GZIP_1 FITS whose binary table has a negative size (PIL "
                         f"fails to seek to its data)")
    try:
        value = gzip.decompress(data[pos:])
    except (OSError, EOFError, zlib.error) as e:
        raise ValueError(f"{path}: corrupt GZIP_1 FITS data (PIL's fits_gzip decoder fails: "
                         f"{e})") from None
    keep = min(bitpix // 8, 4)
    if keep <= 0 or len(value) < 4 * w * h:
        raise ValueError(f"{path}: GZIP_1 FITS data gives too few bytes for its {w} x {h} "
                         f"pixels of ZBITPIX {bitpix} (PIL: not enough image data)")
    rows = np.frombuffer(value, np.uint8, 4 * w * h).reshape(h, w, 4)[::-1, :, 4 - keep:]
    v = np.ascontiguousarray(rows).view(dt).reshape(h, w)
    return band_to_rgb(v if dt.kind == "f" else v.astype(np.int64))
