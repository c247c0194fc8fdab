"""MSP (Microsoft Paint) decoding for ``image_io.read_image``, numpy and
the standard library only, bit-equal to PIL 12.1's
``np.array(Image.open(path).convert("RGB"))``.

PIL's ``MspImagePlugin`` reads the 32-byte header of 16 little-endian
words: ``DanM`` (version 1) or ``LinS`` (version 2), the width and the
height, and a checksum: the XOR of the 16 words must be 0, or PIL passes
the file on to its next opener. The image is mode ``1``, a 1 bit white.

- Version 1: rows of (width + 7) // 8 bytes after the header.
- Version 2: a map of one 16-bit length per row, then each row's runs as
  PIL's ``MspDecoder`` reads them: a 0 byte, a count and a byte repeated
  count times, or a count and that many literal bytes; a length of 0 is a
  white row. The decoded bytes of all rows are joined and cut into rows
  of (width + 7) // 8 bytes, so a row that decodes to another length
  shifts the ones after it, as in PIL. A map, a row or a run that ends
  early, or too few bytes in all, raise, as PIL fails on them.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_identify import PassOn, check_size


def header(data: bytes, path: str) -> dict:
    """PIL's ``MspImageFile._open``."""
    s = data[:32]
    if not s.startswith((b"DanM", b"LinS")):
        raise PassOn("not an MSP file")
    words = struct.unpack("<16H", s)
    checksum = 0
    for v in words:
        checksum ^= v
    if checksum:
        raise PassOn("bad MSP checksum")
    width, height = words[2], words[3]
    if width <= 0 or height <= 0:
        raise PassOn("no mode, or a size of 0")
    check_size(width, height, path)
    return {"size": (width, height), "version": 1 if s.startswith(b"DanM") else 2}


def _rows(data: bytes, width: int, height: int, path: str) -> bytes:
    """PIL's ``MspDecoder``: the bytes of all rows, joined."""
    stride = (width + 7) // 8
    if len(data) < 32 + 2 * height:
        raise ValueError(f"{path}: truncated MSP file in row map (PIL fails on it)")
    rowmap = struct.unpack_from(f"<{height}H", data, 32)
    pos = 32 + 2 * height
    out = bytearray()
    for y, rowlen in enumerate(rowmap):
        if rowlen == 0:
            out += b"\xff" * stride
            continue
        row = data[pos:pos + rowlen]
        pos += rowlen
        if len(row) != rowlen:
            raise ValueError(f"{path}: truncated MSP file, {rowlen} bytes expected on row {y} "
                             f"(PIL fails on it)")
        i = 0
        while i < rowlen:
            runtype = row[i]
            i += 1
            if runtype == 0:
                if i + 2 > rowlen:
                    raise ValueError(f"{path}: corrupted MSP file in row {y} (PIL fails on it)")
                out += row[i + 1:i + 2] * row[i]
                i += 2
            else:
                out += row[i:i + runtype]
                i += runtype
    return bytes(out)


def read_msp_rgb(path: str) -> np.ndarray:
    """An MSP file as (H, W, 3) uint8 RGB (see the module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        head = header(data, path)
    except (PassOn, struct.error) as e:
        raise ValueError(f"{path}: not an MSP file PIL opens ({e})") from None
    (w, h), stride = head["size"], (head["size"][0] + 7) // 8
    if head["version"] == 1:
        raw = data[32:32 + stride * h]
    else:
        raw = _rows(data, w, h, path)
    if len(raw) < stride * h:
        raise ValueError(f"{path}: truncated MSP data: {h} rows of {stride} bytes (PIL fails on "
                         f"it)")
    rows = np.frombuffer(raw, np.uint8, stride * h).reshape(h, stride)
    v = np.unpackbits(rows, axis=1)[:, :w].astype(np.uint8) * 255
    return np.repeat(v[:, :, None], 3, axis=2)
