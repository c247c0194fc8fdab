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
- CUR (``\\0\\0\\2\\0``): PIL's ``CurImagePlugin`` takes the first entry
  unless a later one is larger in both width and height (the directory's
  bytes, 0 not read as 256), and reads its DIB at half the height without
  a mask; a PNG cursor raises, as PIL fails on it.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from .image_bmp import decode_dib
from .image_io import _SIGNATURE, decode_png


def _entries(data: bytes, path: str):
    if len(data) < 6:
        raise ValueError(f"{path}: truncated ICO/CUR header")
    (n,) = struct.unpack("<H", data[4:6])
    if len(data) < 6 + 16 * n:
        raise ValueError(f"{path}: truncated ICO/CUR directory")
    return [data[6 + 16 * i:22 + 16 * i] for i in range(n)]


def read_ico_rgb(path: str) -> np.ndarray:
    """An ICO or CUR file as (H, W, 3) uint8 RGB (see the module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] == b"\x00\x00\x02\x00":
        entries = _entries(data, path)
        if not entries:
            raise ValueError(f"{path}: CUR file without a cursor")
        best = entries[0]
        for e in entries[1:]:
            if e[0] > best[0] and e[1] > best[1]:
                best = e
        (offset,) = struct.unpack("<I", best[12:16])
        if data[offset:offset + 8] == _SIGNATURE:
            raise ValueError(f"{path}: PNG cursor (PIL's CUR reader fails on it)")
        return decode_dib(data[offset:], path, halve=True)
    if data[:4] != b"\x00\x00\x01\x00":
        raise ValueError(f"{path}: not an ICO or CUR file")
    heads = []
    for e in _entries(data, path):
        width, height, ncolor = e[0] or 256, e[1] or 256, e[2]
        bpp, size, offset = struct.unpack("<HII", e[6:16])
        depth = bpp or (ncolor != 0 and math.ceil(math.log(ncolor, 2))) or 256
        heads.append((width * height, depth, bpp, size, offset))
    if not heads:
        raise ValueError(f"{path}: ICO file without an image")
    heads.sort(key=lambda h: h[1])
    heads.sort(key=lambda h: h[0], reverse=True)
    _, _, bpp, size, offset = heads[0]
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
