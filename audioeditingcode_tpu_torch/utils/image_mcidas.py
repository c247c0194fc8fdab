"""McIdas area file decoding for ``image_io.read_image``, numpy and the
standard library only, bit-equal to PIL 12.1's
``np.array(Image.open(path).convert("RGB"))``.

PIL's ``McIdasImagePlugin`` reads the 256-byte area directory (64
big-endian words after the magic, word n at index n - 1 below): the
height (9), the width (10), bytes a sample (11: 1 is ``L``, 2 big-endian
``I;16B``, 4 big-endian ``I``; anything else passes the file on), bands
(14), the line prefix (15) and the data offset (34). Row y starts at
offset + prefix + y x stride, stride = prefix + width x bytes x bands
(the row's bytes where that is 0), top to bottom. PIL maps ``L`` and
``I;16B`` rows straight from the file where offset + height x stride fits
in it (rows may then overlap, and bytes past the file's end read as 0);
else, and for ``I``, its raw decoder reads them, which fails on a stride
below the row's bytes. ``convert("RGB")`` clamps the samples to 0..255.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_identify import PassOn, check_size
from .image_io import band_to_rgb

_TYPES = {1: "u1", 2: ">u2", 4: ">i4"}


def header(data: bytes, path: str) -> dict:
    """PIL's ``McIdasImageFile._open``."""
    if len(data) < 256 or not data.startswith(b"\0\0\0\0\0\0\0\4"):
        raise PassOn("not an McIdas area file")
    w = (0,) + struct.unpack(">64i", data[:256])
    if w[11] not in _TYPES:
        raise PassOn("unsupported McIdas format")
    width, height = w[10], w[9]
    if width <= 0 or height <= 0:
        raise PassOn("no mode, or a size of 0")
    check_size(width, height, path)
    return {"size": (width, height), "bytes": w[11], "offset": w[34] + w[15],
            "stride": w[15] + w[10] * w[11] * w[14]}


def decode_mcidas(data: bytes, path: str) -> np.ndarray:
    """A McIdas area file's bytes as (H, W, 3) uint8 RGB (see the module docstring)."""
    try:
        head = header(data, path)
    except PassOn as e:
        raise ValueError(f"{path}: not a McIdas file PIL opens ({e})") from None
    (w, h), nbytes, pos = head["size"], head["bytes"], head["offset"]
    line, stride = w * nbytes, head["stride"]
    if pos < 0:
        raise ValueError(f"{path}: McIdas data offset {pos} before the file (PIL fails on it)")
    if nbytes != 4 and not (stride and pos + h * stride > len(data)):
        # PIL maps L and I;16B rows straight from the file: rows may overlap,
        # and bytes past its end read as 0
        stride = stride or line
        if pos + h * stride > len(data):
            raise ValueError(f"{path}: truncated McIdas data (PIL fails on it: buffer is not "
                             f"large enough)")
        data = data + bytes(max(0, pos + (h - 1) * stride + line - len(data)))
    else:  # PIL's raw decoder
        stride = stride or line
        if stride < line:
            raise ValueError(f"{path}: McIdas rows of {stride} bytes for {line} bytes of samples "
                             f"(PIL fails on it: codec configuration error)")
        if len(data) < pos + (h - 1) * stride + line:
            raise ValueError(f"{path}: truncated McIdas data (PIL: image file is truncated)")
    rows = np.stack([np.frombuffer(data, _TYPES[nbytes], w, pos + y * stride) for y in range(h)])
    return band_to_rgb(rows.astype(np.int64))
