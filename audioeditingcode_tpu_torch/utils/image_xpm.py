"""XPM decoding for ``image_io.read_image``, numpy and the standard library
only, bit-equal to PIL 12.1's ``np.array(Image.open(path).convert("RGB"))``.

PIL's ``XpmImagePlugin`` (after ``/* XPM */``) reads lines up to the first
one that starts with ``"<width> <height> <colours> <chars per pixel>``
(none: the file passes on to the next opener), then one line per colour:
the key is the ``cpp`` bytes after the line's first byte, and the words
from there to the line's last two bytes are read in pairs up to the first
``c`` key, whose value is ``None`` (transparent, no palette entry) or
``#`` and hex digits (the last six bits of each 8-bit field of their
value: red, green, blue); any other value, or no ``c`` key, makes PIL
fail. Up to 256 colours open as ``P``, the palette in the order of the
keys (a repeated key keeps its first place and its last colour); more open
as RGB.

The pixels are PIL's ``XpmDecoder``: every later line (but a first
``/* pixels */``) gives the text between its first and last ``"`` (inner
quotes kept), cut into keys of ``cpp`` bytes, until width x height pixels
are read; rows do not follow lines. A key that is not in the palette
(``None``'s among them) or too few pixels make PIL fail.
"""

from __future__ import annotations

import re

import numpy as np

from .image_identify import PassOn, check_size

_HEAD = re.compile(rb'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def _lines(data: bytes, pos: int):
    """Python's ``readline`` from ``pos``: (line, position after it)."""
    n = len(data)
    while pos < n:
        end = data.find(b"\n", pos)
        end = n if end < 0 else end + 1
        yield data[pos:end], end
        pos = end


def header(data: bytes, path: str) -> dict:
    """PIL's ``XpmImageFile._open``."""
    if not data.startswith(b"/* XPM */"):
        raise PassOn("not an XPM file")
    lines = _lines(data, 9)
    for line, _ in lines:
        m = _HEAD.match(line)
        if m:
            break
    else:
        raise PassOn("broken XPM file")
    try:
        width, height, ncolours, cpp = (int(g) for g in m.groups())
    except ValueError:
        raise ValueError(f"{path}: XPM header {line!r} has an empty number (PIL fails on "
                         f"it)") from None
    palette = {}
    for _ in range(ncolours):
        line = next(lines, (b"", 0))[0].rstrip()
        key = line[1:cpp + 1]
        words = line[cpp + 1:-2].split()
        for i in range(0, len(words), 2):
            if words[i] == b"c":
                rgb = words[i + 1]  # IndexError: PIL passes the file on
                if rgb == b"None":
                    break
                if rgb.startswith(b"#"):
                    try:
                        v = int(rgb[1:], 16)
                    except ValueError:
                        raise ValueError(f"{path}: XPM colour {rgb!r} (PIL fails on it)") from None
                    palette[key] = ((v >> 16) & 255, (v >> 8) & 255, v & 255)
                    break
                raise ValueError(f"{path}: XPM colour {rgb!r} is not #rgb hex or None (PIL "
                                 f"fails on it: cannot read this XPM file)")
        else:
            raise ValueError(f"{path}: XPM colour line without a c key (PIL fails on it: "
                             f"cannot read this XPM file)")
    if width <= 0 or height <= 0:
        raise PassOn("no mode, or a size of 0")
    check_size(width, height, path)
    pos = next(lines, (b"", len(data)))
    return {"size": (width, height), "cpp": cpp, "palette": palette, "lines": lines,
            "first": pos}


def read_xpm_rgb(path: str) -> np.ndarray:
    """An XPM file as (H, W, 3) uint8 RGB (see the module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        head = header(data, path)
    except (PassOn, IndexError) as e:
        raise ValueError(f"{path}: not an XPM file PIL opens ({e})") from None
    (w, h), cpp, palette = head["size"], head["cpp"], head["palette"]
    keys = list(palette)
    index = {k: i for i, k in enumerate(keys)}
    colours = np.asarray(list(palette.values()) or [(0, 0, 0)], np.uint8)
    if cpp == 0:
        raise ValueError(f"{path}: XPM of 0 characters per pixel (PIL fails on it)")
    need = w * h
    px = []
    header_seen = False
    line = head["first"][0]
    lines = head["lines"]
    while len(px) < need:
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not header_seen:
            header_seen = True
        else:
            text = b'"'.join(line.split(b'"')[1:-1])
            for i in range(0, len(text), cpp):
                key = text[i:i + cpp]
                if key not in index:
                    raise ValueError(f"{path}: XPM pixel key {key!r} is not in the palette "
                                     f"(PIL fails on it)")
                px.append(index[key])
        line = next(lines, (b"", 0))[0]
    if len(px) < need:
        raise ValueError(f"{path}: XPM with {len(px)} of {need} pixels (PIL fails on it: not "
                         f"enough image data)")
    return np.ascontiguousarray(colours[np.asarray(px[:need], np.int64)].reshape(h, w, 3))
