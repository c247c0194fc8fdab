"""PIXAR decoding for ``image_io.read_image``, numpy and the standard library
only, bit-equal to PIL 12.1's ``np.array(Image.open(path).convert("RGB"))``.

PIL's ``PixarImagePlugin`` reads the 512-byte header after the magic
0x80E80000: the height and width at bytes 416 and 418 (little-endian 16
bits), and the channel and depth codes at 424 and 426. It opens only
(14, 2) as RGB ("dumped": 3 bytes a pixel from byte 1024); any other code
leaves no mode, and the file passes on. A file that ends before its
pixels raises, as PIL raises "image file is truncated".
"""

from __future__ import annotations

import struct

import numpy as np

from .image_identify import PassOn, check_size


def header(data: bytes, path: str) -> dict:
    """PIL's ``PixarImageFile._open``."""
    if not data.startswith(b"\200\350\000\000"):
        raise PassOn("not a PIXAR file")
    height, width, _, _, channels, depth = struct.unpack_from("<6H", data, 416)
    if (channels, depth) != (14, 2) or width <= 0 or height <= 0:
        raise PassOn("no mode, or a size of 0")
    check_size(width, height, path)
    return {"size": (width, height)}


def read_pixar_rgb(path: str) -> np.ndarray:
    """A PIXAR file as (H, W, 3) uint8 RGB (see the module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        w, h = header(data, path)["size"]
    except (PassOn, struct.error) as e:
        raise ValueError(f"{path}: not a PIXAR file PIL opens ({e})") from None
    if len(data) - 1024 < 3 * w * h:
        raise ValueError(f"{path}: truncated PIXAR data (PIL: image file is truncated)")
    return np.frombuffer(data, np.uint8, 3 * w * h, 1024).reshape(h, w, 3).copy()
