"""XBM decoding for ``image_io.read_image``, numpy and the standard library
only, bit-equal to PIL 12.1's ``np.array(Image.open(path).convert("RGB"))``.

PIL's ``XbmImagePlugin`` matches its regular expression against the first
512 bytes: ``#define <name>_width <n>`` and ``#define <name>_height <n>``
lines, optional ``_x_hot``/``_y_hot`` lines, then anything up to
``_bits[]``; a file it does not match passes on to the next opener. Its
``XbmDecode`` then skips to each ``x`` and takes the two characters after
it as a hex byte (a character that is not a hex digit counts as 0), until
every row of (width + 7) // 8 bytes is full. The bits of each byte run
from the least significant, a 1 bit white (mode ``1`` as PIL reads it). A file that ends before the
rows are full raises, as PIL raises "image file is truncated".
"""

from __future__ import annotations

import re

import numpy as np

from .image_identify import PassOn, check_size

_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    rb"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    rb"(?P<hotspot>"
    rb"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    rb"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    rb")?"
    rb"[\000-\377]*_bits\[]"
)
_HEX = np.zeros(256, np.uint8)
for _c in b"0123456789":
    _HEX[_c] = _c - 48
for _c in b"abcdef":
    _HEX[_c] = _HEX[_c - 32] = _c - 87


def header(data: bytes, path: str) -> dict:
    """PIL's ``XbmImageFile._open``."""
    m = _HEAD.match(data[:512])
    if not m:
        raise PassOn("not an XBM file")
    width, height = int(m.group("width")), int(m.group("height"))
    if width <= 0 or height <= 0:
        raise PassOn("no mode, or a size of 0")
    check_size(width, height, path)
    return {"size": (width, height), "offset": m.end()}


def decode_xbm(data: bytes, path: str) -> np.ndarray:
    """An XBM file's bytes as (H, W, 3) uint8 RGB (see the module docstring)."""
    try:
        head = header(data, path)
    except PassOn as e:
        raise ValueError(f"{path}: not an XBM file PIL opens ({e})") from None
    (w, h), pos = head["size"], head["offset"]
    need = (w + 7) // 8 * h
    body = np.frombuffer(data, np.uint8, offset=pos)
    xs = []
    i = 0
    n = len(body)
    while len(xs) < need:  # each 'x' with two characters after it is a byte
        j = data.find(b"x", pos + i)
        if j < 0 or j - pos + 3 > n:
            raise ValueError(f"{path}: truncated XBM data: {need} bytes do not fit in the file "
                             f"(PIL: image file is truncated)")
        xs.append(j - pos)
        i = j - pos + 3
    at = np.asarray(xs, np.int64)
    vals = (_HEX[body[at + 1]] << 4) + _HEX[body[at + 2]]
    rows = vals.astype(np.uint8).reshape(h, (w + 7) // 8)
    bits = np.unpackbits(rows, axis=1, bitorder="little")[:, :w]
    v = bits.astype(np.uint8) * 255
    return np.repeat(v[:, :, None], 3, axis=2)
