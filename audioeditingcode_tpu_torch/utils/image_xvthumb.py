"""XV thumbnail decoding for ``image_io.read_image``, numpy and the standard
library only, bit-equal to PIL 12.1's
``np.array(Image.open(path).convert("RGB"))``.

PIL's ``XVThumbImagePlugin``: ``P7 332``, the rest of that line skipped,
then comment lines (``#``) skipped up to a line whose first two words are
the width and the height (fewer words, or words that are not integers,
make PIL fail; the file ending first passes it on). One byte a pixel
follows, an index into the 3-3-2 palette: red (i >> 5) * 255 // 7, green
((i >> 2) & 7) * 255 // 7, blue (i & 3) * 255 // 3.
"""

from __future__ import annotations

import numpy as np

from .image_identify import PassOn, check_size

_I = np.arange(256)
PALETTE = np.stack([(_I >> 5) * 255 // 7, ((_I >> 2) & 7) * 255 // 7, (_I & 3) * 255 // 3],
                   -1).astype(np.uint8)


def header(data: bytes, path: str) -> dict:
    """PIL's ``XVThumbImageFile._open``."""
    if not data.startswith(b"P7 332"):
        raise PassOn("not an XV thumbnail file")
    pos = data.find(b"\n", 6)
    pos = len(data) if pos < 0 else pos + 1
    while True:
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        line, pos = data[pos:end], end
        if not line:
            raise PassOn("unexpected end of file reading an XV thumbnail header")
        if line[0] != 35:
            break
    words = line.strip().split(maxsplit=2)[:2]
    try:
        width, height = (int(w) for w in words)
    except ValueError:
        raise ValueError(f"{path}: XV thumbnail size line {line!r} (PIL fails on it)") from None
    if width <= 0 or height <= 0:
        raise PassOn("no mode, or a size of 0")
    check_size(width, height, path)
    return {"size": (width, height), "offset": pos}


def read_xvthumb_rgb(path: str) -> np.ndarray:
    """An XV thumbnail as (H, W, 3) uint8 RGB (see the module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        head = header(data, path)
    except PassOn as e:
        raise ValueError(f"{path}: not an XV thumbnail PIL opens ({e})") from None
    (w, h), pos = head["size"], head["offset"]
    if len(data) - pos < w * h:
        raise ValueError(f"{path}: truncated XV thumbnail (PIL: image file is truncated)")
    return PALETTE[np.frombuffer(data, np.uint8, w * h, pos).reshape(h, w)]
