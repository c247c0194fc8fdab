"""Netpbm decoding for ``image_io.read_image``, numpy and the standard library
only, bit-equal to PIL 12.1's ``np.array(Image.open(path).convert("RGB"))``.

Every magic PIL's ``PpmImagePlugin`` opens, read with its rules:

- the magic: up to six bytes before the first whitespace: ``P1`` and ``P4``
  (mode ``1``: a 1 bit or a ``1`` is black), ``P2`` and ``P5`` (``L``, or
  ``I`` where maxval is over 255), ``P3`` and ``P6`` (``RGB``), ``Pf``
  (greyscale float), ``P0CMYK`` and ``PyCMYK`` (``CMYK``), ``PyRGBA``
  (alpha dropped) and ``PyP`` (mode ``P`` with PIL's black palette). PAM
  (``P7``) and colour PFM (``PF``) raise, as PIL does not open them;
- header tokens as PIL's ``_read_token`` reads them: whitespace skipped, at
  most ten bytes, a ``#`` dropping the rest of its line (within a token,
  which then goes on); the raster starts right after the whitespace byte
  that ends the last token;
- binary rasters: maxval 255 as stored; maxval 65535 in ``P5`` as
  big-endian 16-bit ``I``; any other maxval scaled as PIL's ``PpmDecoder``
  does, each sample ``min(out_max, round(v / maxval * out_max))`` with
  Python's ``round`` (out_max 65535 for ``I``, else 255; two bytes a
  sample from maxval 256 on), so samples above maxval clamp; ``I`` then
  converts to RGB clamped at 255;
- plain rasters (``P1``-``P3``) as PIL's ``PpmPlainDecoder``: comments to
  the end of their line, ``P1`` digits with or without whitespace
  between them, ``P2``/``P3`` tokens of at most ten bytes, negative
  values or values above maxval raising;
- ``Pf``: float32 samples, little-endian for a negative scale, rows bottom
  to top, converted through ``L`` as PIL's ``F`` (0 at or below 0 and for
  NaN, 255 at or above 255, else truncated); the scale must be finite and
  non-zero.

A file that ends before its raster is full raises, as PIL raises.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from .image_io import cmyk_to_rgb

_WHITESPACE = b" \t\n\x0b\x0c\r"
_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
          b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_BANDS = {"1": 1, "L": 1, "I": 1, "P": 1, "F": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}


def _token(data: bytes, pos: int, path: str) -> Tuple[bytes, int]:
    """PIL's ``_read_token`` from ``pos``: (token, position after it)."""
    token = b""
    n = len(data)
    while len(token) <= 10:
        if pos >= n:
            break
        c = data[pos:pos + 1]
        pos += 1
        if c in _WHITESPACE:
            if not token:
                continue
            break
        if c == b"#":
            while pos < n and data[pos:pos + 1] not in b"\r\n":
                pos += 1
            pos += 1
            continue
        token += c
    if not token:
        raise ValueError(f"{path}: Netpbm header ends early (PIL: reached EOF while reading "
                         f"header)")
    if len(token) > 10:
        raise ValueError(f"{path}: Netpbm header token too long")
    return token, pos


def _int(token: bytes, path: str) -> int:
    try:
        return int(token)
    except ValueError:
        raise ValueError(f"{path}: Netpbm header value {token!r} is not an integer") from None


def _plain(data: bytes, pos: int, count: int, mode: str, maxval: int, path: str) -> np.ndarray:
    """PIL's ``PpmPlainDecoder`` on ``data[pos:]``: ``count`` values."""
    body = data[pos:]
    parts, i = [], 0
    while True:  # comments run from '#' to the next CR or LF
        j = body.find(b"#", i)
        if j < 0:
            parts.append(body[i:])
            break
        parts.append(body[i:j])
        ends = [k for k in (body.find(b"\n", j), body.find(b"\r", j)) if k >= 0]
        if not ends:
            break
        i = min(ends) + 1
    body = b"".join(parts)
    if mode == "1":
        digits = b"".join(body.split())
        if digits.strip(b"01"):
            raise ValueError(f"{path}: plain PBM data other than 0 and 1")
        digits = digits[:count]
        if len(digits) < count:
            raise ValueError(f"{path}: truncated Netpbm data (PIL: not enough image data)")
        return np.where(np.frombuffer(digits, np.uint8) == ord("1"), 0, 255).astype(np.int64)
    tokens = body.split()[:count]
    if len(tokens) < count:
        raise ValueError(f"{path}: truncated Netpbm data (PIL: not enough image data)")
    out_max = 65535 if mode == "I" else 255
    vals = []
    for t in tokens:
        if len(t) > 10:
            raise ValueError(f"{path}: Netpbm token too long")
        v = _int(t, path)
        if v < 0 or v > maxval:
            raise ValueError(f"{path}: Netpbm value {v} outside 0..{maxval}")
        vals.append(round(v / maxval * out_max))
    return np.asarray(vals, np.int64)


def read_magic(data: bytes) -> Tuple[bytes, int]:
    """PIL's ``_read_magic``: up to six bytes before the first whitespace,
    and the position after them."""
    magic, pos = b"", 0
    while pos < min(6, len(data)):
        c = data[pos:pos + 1]
        pos += 1
        if c in _WHITESPACE:
            break
        magic += c
    return magic, pos


def decode_pnm(data: bytes, path: str) -> np.ndarray:
    """A Netpbm file's bytes as (H, W, 3) uint8 RGB (see the module docstring)."""
    magic, pos = read_magic(data)
    if magic not in _MODES:
        raise ValueError(f"{path}: Netpbm magic {magic!r} is not one PIL opens (P1-P6, Pf, "
                         f"P0CMYK, PyP, PyRGBA, PyCMYK)")
    mode = _MODES[magic]
    width, pos = _token(data, pos, path)
    height, pos = _token(data, pos, path)
    width, height = _int(width, path), _int(height, path)
    if width <= 0 or height <= 0:
        raise ValueError(f"{path}: Netpbm image of {width} x {height}")
    plain = magic in (b"P1", b"P2", b"P3")
    bands = _BANDS[mode]
    count = width * height * bands
    if mode == "F":
        scale, pos = _token(data, pos, path)
        try:
            scale = float(scale)
        except ValueError:
            raise ValueError(f"{path}: PFM scale {scale!r} is not a number") from None
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError(f"{path}: PFM scale must be finite and non-zero")
        if len(data) - pos < 4 * count:
            raise ValueError(f"{path}: truncated PFM data")
        v = np.frombuffer(data, "<f4" if scale < 0 else ">f4", count, pos).reshape(
            height, width)[::-1].astype(np.float64)
        v = np.where(v >= 255, 255, np.where(v > 0, np.trunc(np.nan_to_num(v)), 0))
        return np.repeat(v.astype(np.uint8)[:, :, None], 3, axis=2)
    maxval = 1
    if mode != "1":
        token, pos = _token(data, pos, path)
        maxval = _int(token, path)
        if not 0 < maxval < 65536:
            raise ValueError(f"{path}: Netpbm maxval {maxval} outside 1..65535")
        if maxval > 255 and mode == "L":
            mode = "I"
    if plain:
        v = _plain(data, pos, count, mode, maxval, path)
    elif mode == "1":  # P4: rows of packed bits, a 1 bit black
        stride = (width + 7) // 8
        if len(data) - pos < stride * height:
            raise ValueError(f"{path}: truncated PBM data")
        rows = np.frombuffer(data, np.uint8, stride * height, pos).reshape(height, stride)
        v = np.where(np.unpackbits(rows, axis=1)[:, :width] == 1, 0, 255)
    else:
        wide = maxval > 255
        need = count * (2 if wide else 1)
        if len(data) - pos < need:
            raise ValueError(f"{path}: truncated Netpbm data")
        v = np.frombuffer(data, ">u2" if wide else np.uint8, count, pos).astype(np.int64)
        if maxval != 255 and not (maxval == 65535 and mode == "I"):
            out_max = 65535 if mode == "I" else 255
            v = np.minimum(out_max, np.round(v / maxval * out_max)).astype(np.int64)
    v = np.asarray(v).reshape(height, width, bands)
    if mode == "I":
        v = np.minimum(v, 255)
    if mode == "P":  # PyP: PIL gives the image a palette of zeros
        v = np.zeros_like(v)
    if mode == "CMYK":
        return cmyk_to_rgb(*np.moveaxis(v.astype(np.int64), -1, 0))
    if bands == 1:
        return np.repeat(v.astype(np.uint8), 3, axis=2)
    return np.ascontiguousarray(v[:, :, :3].astype(np.uint8))
