"""GIMP brush (GBR) decoding for ``image_io.read_image``, numpy and the
standard library only, bit-equal to PIL 12.1's
``np.array(Image.open(path).convert("RGB"))``.

PIL's ``GbrImagePlugin`` reads the big-endian header: its size (at least
20), version 1 or 2, width, height (neither 0) and depth 1 (``L``) or 4
(RGBA, alpha dropped); version 2 has ``GIMP`` and a spacing after them.
Anything else passes the file on. The pixels follow the header (its size),
width x height x depth bytes; fewer make PIL fail.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_identify import PassOn, check_size


def header(data: bytes, path: str) -> dict:
    """PIL's ``GbrImageFile._open``."""
    if len(data) < 20:
        raise PassOn("GIMP brush header ends early")
    size, version, width, height, depth = struct.unpack(">5I", data[:20])
    if size < 20 or version not in (1, 2) or width == 0 or height == 0 or depth not in (1, 4):
        raise PassOn("not a GIMP brush PIL reads")
    if version == 2 and data[20:24] != b"GIMP":
        raise PassOn("not a GIMP brush, bad magic number")
    if version == 2:
        struct.unpack_from(">I", data, 24)  # the spacing
    check_size(width, height, path)
    return {"size": (width, height), "depth": depth, "offset": size}


def read_gbr_rgb(path: str) -> np.ndarray:
    """A GIMP brush as (H, W, 3) uint8 RGB (see the module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        head = header(data, path)
    except (PassOn, struct.error) as e:
        raise ValueError(f"{path}: not a GIMP brush PIL opens ({e})") from None
    (w, h), depth, pos = head["size"], head["depth"], head["offset"]
    if len(data) - pos < w * h * depth:
        raise ValueError(f"{path}: GIMP brush of {w * h * depth} bytes of pixels ends early "
                         f"(PIL fails on it: not enough image data)")
    px = np.frombuffer(data, np.uint8, w * h * depth, pos).reshape(h, w, depth)
    return np.ascontiguousarray(np.repeat(px, 3, axis=2) if depth == 1 else px[:, :, :3])
