"""FTEX (Independence War 2 texture) decoding for ``image_io.read_image``,
numpy and the standard library only, bit-equal to PIL 12.1's
``np.array(Image.open(path).convert("RGB"))``.

PIL's ``FtexImagePlugin`` reads ``FTEX``, a version, the width and height
and the mipmap and format counts (signed 32-bit words; a format count other
than 1 ends ``Image.open`` on an assertion), then the first format's
(format, offset) pair and, at that offset, the first mipmap's size and
bytes. Format 0 is DXT1 through PIL's C ``bcn`` decoder
(``image_bcn.decode``), format 1 raw RGB; another format ends
``Image.open``. A header cut short, or a width or height of 0 or less,
passes the file on; a mipmap shorter than its pixels raises, as PIL fails
("image file is truncated").
"""

from __future__ import annotations

import struct

import numpy as np

from .image_identify import PassOn, check_size


def header(data: bytes, path: str) -> dict:
    """PIL's ``FtexImageFile._open``: {"size", "format", "mipmap"}."""
    if data[:4] != b"FTEX":
        raise PassOn("not an FTEX file")
    width, height, _, formats = struct.unpack("<4i", data[8:24])
    if formats != 1:
        raise ValueError(f"{path}: FTEX with {formats} formats (PIL fails on it: it asserts a "
                         f"single format)")
    fmt, where = struct.unpack("<2i", data[24:32])
    if where < 0:
        raise ValueError(f"{path}: FTEX mipmap at offset {where} (PIL fails on it: negative "
                         f"seek)")
    (size,) = struct.unpack("<i", data[where:where + 4])
    mipmap = data[where + 4:] if size < 0 else data[where + 4:where + 4 + size]
    if fmt not in (0, 1):
        raise ValueError(f"{path}: FTEX texture compression format {fmt} (PIL fails on it: "
                         f"invalid texture compression format)")
    if width <= 0 or height <= 0:
        raise PassOn("no mode, or a size of 0")
    check_size(width, height, path)
    return {"size": (width, height), "format": fmt, "mipmap": mipmap}


def decode_ftex(data: bytes, path: str) -> np.ndarray:
    """An FTEX file's bytes as (H, W, 3) uint8 RGB (see the module
    docstring)."""
    from . import image_bcn

    try:
        head = header(data, path)
    except (PassOn, struct.error) as e:
        raise ValueError(f"{path}: not an FTEX file PIL opens ({e})") from None
    (width, height), mipmap = head["size"], head["mipmap"]
    if head["format"] == 0:
        return np.ascontiguousarray(image_bcn.decode(mipmap, width, height, 1, "", path)[:, :, :3])
    if len(mipmap) < width * height * 3:
        raise ValueError(f"{path}: truncated FTEX data: a mipmap of {len(mipmap)} bytes for "
                         f"{width} x {height} RGB pixels (PIL fails on it: image file is "
                         f"truncated)")
    return np.frombuffer(mipmap, np.uint8, width * height * 3).reshape(height, width, 3).copy()
