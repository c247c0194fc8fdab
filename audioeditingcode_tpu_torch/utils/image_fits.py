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
here); ``convert("RGB")`` then clamps or truncates to 0..255. A
tile-compressed image (a ``BINTABLE`` with ``ZIMAGE = T`` and
``GZIP_1``) is refused: PIL reads it through a decoder not ported yet.
"""

from __future__ import annotations

import math

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


def _parse(headers: dict, path: str):
    """PIL's ``_parse_headers``: (decoder, size, dtype), decoder "" where the
    unit has no axes."""
    prefix, decoder = b"", "raw"
    if (headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T"
            and headers[b"ZCMPTYPE"] == b"'GZIP_1  '"):
        prefix, decoder = b"Z", "fits_gzip"
    naxis = _int(headers, prefix + b"NAXIS", path)
    if naxis == 0:
        return "", None, None
    if naxis == 1:
        size = 1, _int(headers, prefix + b"NAXIS1", path)
    else:
        size = _int(headers, prefix + b"NAXIS1", path), _int(headers, prefix + b"NAXIS2", path)
    return decoder, size, _MODES.get(_int(headers, prefix + b"BITPIX", path))


def header(data: bytes, path: str) -> dict:
    """PIL's ``FitsImageFile._open``."""
    headers, in_progress, decoder, pos = {}, False, "", 0
    size = dtype = None
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
                decoder, size, dtype = _parse(headers, path)
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
    return {"size": size, "dtype": dtype, "decoder": decoder, "offset": min(pos, len(data)) - 80}


def decode_fits(data: bytes, path: str) -> np.ndarray:
    """A FITS file's bytes as (H, W, 3) uint8 RGB (see the module docstring)."""
    try:
        head = header(data, path)
    except (PassOn, KeyError) as e:
        raise ValueError(f"{path}: not a FITS file PIL opens ({e})") from None
    if head["decoder"] != "raw":
        raise ValueError(f"{path}: tile-compressed (GZIP_1) FITS, read by PIL's fits_gzip "
                         f"decoder, which is not ported yet")
    (w, h), dt, pos = head["size"], np.dtype(head["dtype"]), head["offset"]
    if len(data) - pos < dt.itemsize * w * h:
        raise ValueError(f"{path}: truncated FITS data (PIL: image file is truncated)")
    v = np.frombuffer(data, dt, w * h, pos).reshape(h, w)[::-1]
    return band_to_rgb(v if dt.kind == "f" else v.astype(np.int64))
