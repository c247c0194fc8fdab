"""IM Tools (IMT) decoding for ``image_io.read_image``, numpy and the
standard library only, bit-equal to PIL 12.1's
``np.array(Image.open(path).convert("RGB"))``.

IMT has no accept test; PIL's ``ImtImagePlugin`` (no accept test) needs a
line feed among the first 100 bytes, then reads ``key value`` lines
(lower-case keys; ``*`` lines are comments) until a line it cannot read,
one of 1 or more than 100 bytes, or a form feed, after which the pixels
start. ``width`` and ``height`` set the size (a value that is not an
integer makes PIL fail) and ``pixel n8`` the mode ``L``; without both
the file passes on. A header that ends without a form feed leaves PIL with
no pixels to load: it fails. One byte a pixel, rows top to bottom.
"""

from __future__ import annotations

import re

import numpy as np

from .image_identify import PassOn, check_size

_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def header(data: bytes, path: str) -> dict:
    """PIL's ``ImtImageFile._open``."""
    buffer = data[:100]
    if b"\n" not in buffer:
        raise PassOn("not an IM Tools file")
    pos = 100
    width = height = 0
    mode, offset = "", None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = data[pos:pos + 1]
            pos += 1
        if not s:
            break
        if s == b"\x0c":
            offset = min(pos, len(data)) - len(buffer)
            break
        if b"\n" not in buffer:
            buffer += data[pos:pos + 100]
            pos += 100
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        try:
            if k == b"width":
                width = int(v)
            elif k == b"height":
                height = int(v)
        except ValueError:
            raise ValueError(f"{path}: IM Tools header value {v!r} is not an integer (PIL "
                             f"fails on it)") from None
        if k == b"pixel" and v == b"n8":
            mode = "L"
    if not mode or width <= 0 or height <= 0:
        raise PassOn("no mode, or a size of 0")
    check_size(width, height, path)
    return {"size": (width, height), "offset": offset}


def decode_imt(data: bytes, path: str) -> np.ndarray:
    """An IM Tools file's bytes as (H, W, 3) uint8 RGB (see the module docstring)."""
    try:
        head = header(data, path)
    except PassOn as e:
        raise ValueError(f"{path}: not an IM Tools file PIL opens ({e})") from None
    (w, h), pos = head["size"], head["offset"]
    if pos is None:
        raise ValueError(f"{path}: IM Tools header without a form feed (PIL opens it and fails "
                         f"to load it)")
    if len(data) - pos < w * h:
        raise ValueError(f"{path}: truncated IM Tools data (PIL: image file is truncated)")
    return np.repeat(np.frombuffer(data, np.uint8, w * h, pos).reshape(h, w, 1), 3, axis=2)
