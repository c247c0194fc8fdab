"""Sun raster decoding for ``image_io.read_image``, numpy and the standard
library only, bit-equal to PIL 12.1's
``np.array(Image.open(path).convert("RGB"))``.

PIL's ``SunImagePlugin`` reads the 32-byte big-endian header (magic
0x59A66A95, width, height, depth, a length it ignores, type, colour map
type and length) and takes the mode from the depth:

- 1 bit: ``1``, a 1 bit black (``1;I``); 4 bits: ``L`` scaled by 17
  (``L;4``); 8 bits: ``L``; 24 bits: BGR, or RGB for type 3; 32 bits:
  BGRX, or RGBX for type 3; any other depth passes the file on;
- a colour map (length up to 1024 bytes, map type 1; another length or
  type passes the file on) of three planes of length // 3 entries, red,
  green then blue, turns ``L`` into ``P``: 8-bit indices, or 4-bit ones
  unscaled; an index past the map is black. A map at 1, 24 or 32 bits
  makes PIL fail (it gives the palette to an image of another mode).

Types 0, 1, 3, 4 and 5 are raw rows padded to 16 bits; type 2 is PIL's
``SunRleDecode``: 0x80 0x00 is one 0x80 byte, 0x80 n v is n + 1 bytes v
(a run may go on into the next rows), any other byte is itself. Its rows
are not padded: (width * depth + 7) // 8 bytes each. Other types pass
the file on. A file that ends before its pixels raises, as PIL raises
"image file is truncated".
"""

from __future__ import annotations

import struct

import numpy as np

from .image_identify import PassOn, check_size

_BITS = {1: 1, 4: 4, 8: 8, 24: 24, 32: 32}


def header(data: bytes, path: str) -> dict:
    """PIL's ``SunImageFile._open``."""
    s = data[:32]
    if len(s) < 4 or struct.unpack_from(">I", s)[0] != 0x59A66A95:
        raise PassOn("not a SUN raster file")
    width, height, depth, _, ftype, ptype, plen = struct.unpack_from(">7I", s, 4)
    if depth not in _BITS:
        raise PassOn("unsupported SUN mode or bit depth")
    offset, palette = 32, None
    if plen:
        if plen > 1024:
            raise PassOn("unsupported SUN colour palette length")
        if ptype != 1:
            raise PassOn("unsupported SUN palette type")
        raw = data[32:32 + plen]
        offset += plen
        if depth not in (4, 8):
            raise ValueError(f"{path}: SUN colour map at {depth} bits (PIL fails on it: "
                             f"unrecognized image mode)")
        n = len(raw) // 3
        palette = np.zeros((256, 3), np.uint8)
        palette[:min(n, 256)] = np.frombuffer(raw[:3 * n], np.uint8).reshape(3, n).T[:256]
    if ftype not in (0, 1, 2, 3, 4, 5):
        raise PassOn("unsupported SUN raster file type")
    if width <= 0 or height <= 0:
        raise PassOn("no mode, or a size of 0")
    check_size(width, height, path)
    return {"size": (width, height), "depth": depth, "type": ftype, "palette": palette,
            "offset": offset}


def _rle(data: bytes, pos: int, line: int, height: int, path: str) -> bytes:
    """PIL's ``SunRleDecode``: ``height`` rows of ``line`` bytes."""
    out = bytearray()
    size = line * height
    n = len(data)
    while len(out) < size:
        if pos >= n:
            raise ValueError(f"{path}: truncated SUN RLE data (PIL: image file is truncated)")
        c = data[pos]
        if c == 0x80:
            if pos + 1 >= n:
                raise ValueError(f"{path}: truncated SUN RLE data (PIL: image file is "
                                 f"truncated)")
            count = data[pos + 1]
            if count == 0:
                out.append(0x80)
                pos += 2
            else:
                if pos + 2 >= n:
                    raise ValueError(f"{path}: truncated SUN RLE data (PIL: image file is "
                                     f"truncated)")
                out += bytes([data[pos + 2]]) * (count + 1)
                pos += 3
        else:
            out.append(c)
            pos += 1
    return bytes(out[:size])


def decode_sun(data: bytes, path: str) -> np.ndarray:
    """A Sun raster file's bytes as (H, W, 3) uint8 RGB (see the module docstring)."""
    try:
        head = header(data, path)
    except (PassOn, IndexError, struct.error) as e:
        raise ValueError(f"{path}: not a SUN raster file PIL opens ({e})") from None
    (w, h), depth, pal = head["size"], head["depth"], head["palette"]
    if head["type"] == 2:
        line = (w * depth + 7) // 8
        raw = _rle(data, head["offset"], line, h, path)
    else:
        line = (w * depth + 15) // 16 * 2
        raw = data[head["offset"]:head["offset"] + line * h]
        if len(raw) < line * (h - 1) + (w * depth + 7) // 8:  # the last row's padding may be cut
            raise ValueError(f"{path}: truncated SUN data: {h} rows of {line} bytes do not fit "
                             f"in the file (PIL: image file is truncated)")
        raw = raw.ljust(line * h, b"\0")
    rows = np.frombuffer(raw, np.uint8).reshape(h, line)
    if depth == 1:
        v = (1 - np.unpackbits(rows, axis=1)[:, :w]).astype(np.uint8) * 255
        return np.repeat(v[:, :, None], 3, axis=2)
    if depth in (4, 8):
        if depth == 4:
            v = np.stack([rows >> 4, rows & 15], -1).reshape(h, -1)[:, :w]
        else:
            v = rows[:, :w]
        if pal is not None:
            return np.ascontiguousarray(pal[v])
        v = v * 17 if depth == 4 else v
        return np.repeat(v[:, :, None].astype(np.uint8), 3, axis=2)
    b = depth // 8
    px = rows[:, :b * w].reshape(h, w, b)[:, :, :3]
    return np.ascontiguousarray(px if head["type"] == 3 else px[:, :, ::-1])
