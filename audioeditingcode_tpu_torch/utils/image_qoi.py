"""QOI decoding for ``image_io.read_image``, the standard library and numpy
only, bit-equal to PIL 12.1's ``np.array(Image.open(path).convert("RGB"))``.

PIL's ``QoiImagePlugin`` reads the 14-byte header (``qoif``, big-endian
width and height, channels: 3 is RGB and any other value RGBA, and a
colour space it skips) and decodes the ops as its ``QoiDecoder`` does:

- the previous pixel starts as (0, 0, 0, 255), the 64-slot index empty;
- ``0xfe`` RGB (the previous alpha kept), ``0xff`` RGBA, then by the top
  two bits INDEX (an empty slot gives (0, 0, 0, 0)), DIFF (each of R, G
  and B plus its two bits minus 2, modulo 256), LUMA (green plus its six
  bits minus 32, red and blue plus that and their four bits minus 8) and
  RUN (the previous pixel 1 to 62 times, not put in the index);
- every other op puts its pixel in the index at (3r + 5g + 7b + 11a) % 64
  and makes it the previous pixel, an INDEX op too;
- the ops stop when the image is full (a run may overshoot; the end
  marker is not read). Alpha is dropped by ``convert("RGB")``.

A file whose ops end before the image is full raises, as PIL fails on it.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_identify import PassOn, check_size


def header(data: bytes, path: str) -> dict:
    """PIL's ``QoiImageFile._open``."""
    if data[:4] != b"qoif":
        raise PassOn("not a QOI file")
    width, height = struct.unpack(">II", data[4:12])
    data[12]  # channels: PIL opens RGB for 3 and RGBA for any other value
    if width <= 0 or height <= 0:
        raise PassOn("no mode, or a size of 0")
    check_size(width, height, path)
    return {"size": (width, height)}


def read_qoi_rgb(path: str) -> np.ndarray:
    """A QOI file as (H, W, 3) uint8 RGB (see the module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        head = header(data, path)
    except (PassOn, IndexError, struct.error) as e:
        raise ValueError(f"{path}: not a QOI file PIL opens ({e})") from None
    width, height = head["size"]
    need = width * height
    out = bytearray()
    index = [None] * 64
    r, g, b, a = 0, 0, 0, 255
    pos, n, count = 14, len(data), 0
    try:
        while count < need:
            byte = data[pos]
            pos += 1
            if byte == 0xFE:
                if pos + 3 > n:
                    raise IndexError
                r, g, b = data[pos], data[pos + 1], data[pos + 2]
                pos += 3
            elif byte == 0xFF:
                if pos + 4 > n:
                    raise IndexError
                r, g, b, a = data[pos:pos + 4]
                pos += 4
            elif byte < 0x40:
                r, g, b, a = index[byte] or (0, 0, 0, 0)
            elif byte < 0x80:
                r = (r + ((byte >> 4) & 3) - 2) % 256
                g = (g + ((byte >> 2) & 3) - 2) % 256
                b = (b + (byte & 3) - 2) % 256
            elif byte < 0xC0:
                second = data[pos]
                pos += 1
                dg = (byte & 0x3F) - 32
                r = (r + dg + (second >> 4) - 8) % 256
                g = (g + dg) % 256
                b = (b + dg + (second & 15) - 8) % 256
            else:
                run = (byte & 0x3F) + 1
                out += bytes((r, g, b)) * run
                count += run
                continue
            index[(r * 3 + g * 5 + b * 7 + a * 11) % 64] = (r, g, b, a)
            out += bytes((r, g, b))
            count += 1
    except IndexError:
        raise ValueError(f"{path}: truncated QOI data: the ops end before the image is full "
                         f"(PIL fails on it)") from None
    return np.frombuffer(bytes(out[:3 * need]), np.uint8).reshape(height, width, 3).copy()
