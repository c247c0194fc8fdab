"""SPIDER decoding for ``image_io.read_image``, numpy and the standard
library only, bit-equal to PIL 12.1's
``np.array(Image.open(path).convert("RGB"))``.

SPIDER has no magic: PIL's ``SpiderImagePlugin`` (no accept test) reads
27 float32 header values, big-endian first, then little-endian, and takes
the file where ``isSpiderHeader`` holds: values 1, 2, 5, 12, 13, 22 and 23
(1-based) whole numbers, iform (5) one of 1, 3, -11, -12, -21, -22, and
labbyt (22) = labrec (13) x lenbyt (23), the header's length. Only a 2-D
image (iform 1) opens; the rest pass the file on. A plain image (istack
and imgnumber 0) starts after the header; a stack (istack > 0) at its first
image, after a second header; an image inside a stack (imgnumber > 0 with
istack 0) makes PIL fail. The width is value 12 and the height value 2;
the samples are float32 in the header's byte order (mode ``F``), and
``convert("RGB")`` truncates them to 0..255 (``image_io.band_to_rgb``).
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from .image_identify import PassOn, check_size
from .image_io import band_to_rgb


def _is_int(f: float) -> bool:
    try:
        return f - int(f) == 0
    except (ValueError, OverflowError):
        return False


def _header_length(t: Tuple[float, ...]) -> int:
    """PIL's ``isSpiderHeader``: the header's length in bytes, or 0."""
    h = (99,) + t
    if not all(_is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def header(data: bytes, path: str) -> dict:
    """PIL's ``SpiderImageFile._open``."""
    if len(data) < 108:
        raise PassOn("not a valid Spider file")
    for order in ">", "<":
        t = struct.unpack(order + "27f", data[:108])
        hdrlen = _header_length(t)
        if hdrlen:
            break
    else:
        raise PassOn("not a valid Spider file")
    h = (99,) + t
    if int(h[5]) != 1:
        raise PassOn("not a Spider 2D image")
    try:
        istack, imgnumber = int(h[24]), int(h[27])
    except (ValueError, OverflowError):
        raise ValueError(f"{path}: SPIDER stack fields are not finite (PIL fails on it)") from None
    if istack == 0 and imgnumber > 0:  # PIL reads an attribute it has not set yet
        raise ValueError(f"{path}: SPIDER image within a stack (PIL fails on it: "
                         f"AttributeError)")
    if imgnumber != 0 or istack < 0:
        raise PassOn("inconsistent stack header values")
    width, height = int(h[12]), int(h[2])
    if width <= 0 or height <= 0:
        raise PassOn("no mode, or a size of 0")
    check_size(width, height, path)
    return {"size": (width, height), "order": order,
            "offset": hdrlen if istack == 0 else 2 * hdrlen}


def decode_spider(data: bytes, path: str) -> np.ndarray:
    """A SPIDER file's bytes as (H, W, 3) uint8 RGB (see the module docstring)."""
    try:
        head = header(data, path)
    except PassOn as e:
        raise ValueError(f"{path}: not a SPIDER file PIL opens ({e})") from None
    (w, h), pos = head["size"], head["offset"]
    if len(data) - pos < 4 * w * h:
        raise ValueError(f"{path}: truncated SPIDER data (PIL: image file is truncated)")
    return band_to_rgb(np.frombuffer(data, head["order"] + "f4", w * h, pos).reshape(h, w))
