"""PCX and DCX decoding for ``image_io.read_image``, numpy and the standard
library only, bit-equal to PIL 12.1's
``np.array(Image.open(path).convert("RGB"))``.

PIL's ``PcxImagePlugin`` reads the 128-byte header (magic 10, a version of
0, 2, 3 or 5, a window whose size must be positive) and takes the mode
from the bits per pixel and the planes, with its rules:

- 1 bit, 1 plane: mode ``1`` (a 1 bit is white);
- 1 bit, 2 or 4 planes: mode ``P`` with the header's 16-colour palette,
  each index built from one bit of each plane (PIL's ``P;2L``/``P;4L``,
  the planes taken (width + 7) // 8 bytes apart);
- version 5, 8 bits, 1 plane: mode ``L``, unless the file's last 769
  bytes are 0x0C and a palette that is not the grey ramp, which makes it
  ``P`` with that palette (for DCX, the last bytes of the whole file);
- version 5, 8 bits, 3 planes: RGB, the three planes of each line in turn;
- anything else (2 or 4 bits, 8 bits in 4 planes, an 8-bit file of
  another version) raises, as PIL fails on it ("unknown PCX mode").

Each line holds ``planes * stride`` bytes, stride the line's bytes
((width * bits + 7) // 8) made even where the header says another value.
PIL's ``PcxDecode`` run-length decoding: a byte with its top two bits set
repeats the next byte (its low six bits) times, any other byte is itself;
a run that goes past the line's end makes PIL fail (buffer overrun). At
each line's end ``PcxDecode.c`` moves bands together before it unpacks:
for the 1-bit planes of ``P``, each plane from a multiple of line // planes
to a multiple of (width + 7) // 8; else each of line // width bands from a
multiple of line // bands to a multiple of the width; either only where
the first step is the larger.

DCX (magic 0x3ADE68B1) holds up to 1024 page offsets; its first page is
a PCX read as above.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_identify import PassOn, check_size


def header(data: bytes, path: str, start: int = 0) -> dict:
    """PIL's ``PcxImageFile._open`` on the page at ``start``."""
    s = data[start:start + 68]
    if not (len(s) >= 2 and s[0] == 10 and s[1] in (0, 2, 3, 5)):
        raise PassOn("not a PCX file")
    x0, y0, x1, y1 = struct.unpack_from("<4H", s, 4)
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        raise PassOn("bad PCX image size")
    version, bits = s[1], s[3]
    planes = s[65]
    (provided,) = struct.unpack_from("<H", s, 66)
    palette = None
    if bits == 1 and planes == 1:
        mode = "1"
    elif bits == 1 and planes in (2, 4):
        mode = "P"
        palette = np.frombuffer(s[16:64], np.uint8).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = "L"
        if len(data) < 769:
            raise ValueError(f"{path}: 8-bit PCX shorter than its palette's 769 bytes (PIL "
                             f"fails on it: it seeks before the file's start)")
        tail = data[-769:]
        if tail[0] == 12 and tail[1:] != bytes(np.repeat(np.arange(256, dtype=np.uint8), 3)):
            mode = "P"
            palette = np.frombuffer(tail[1:], np.uint8).reshape(256, 3)
    elif version == 5 and bits == 8 and planes == 3:
        mode = "RGB"
    else:
        raise ValueError(f"{path}: PCX of {bits} bits in {planes} planes, version {version} "
                         f"(PIL fails on it: unknown PCX mode)")
    width, height = x1 + 1 - x0, y1 + 1 - y0
    stride = (width * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    check_size(width, height, path)
    return {"mode": mode, "size": (width, height), "bits": bits, "planes": planes,
            "line": planes * stride, "palette": palette, "offset": start + 128}


def dcx(data: bytes, path: str) -> dict:
    """PIL's ``DcxImageFile._open``: the first page's PCX header."""
    if len(data) < 4 or struct.unpack_from("<I", data)[0] != 0x3ADE68B1:
        raise PassOn("not a DCX file")
    offsets = []
    for i in range(1, 1025):  # PIL reads the directory up to a 0 (struct.error at the end)
        (offset,) = struct.unpack_from("<I", data, 4 * i)
        if not offset:
            break
        offsets.append(offset)
    if not offsets:
        raise PassOn("DCX without a page (attempt to seek outside sequence)")
    return header(data, path, offsets[0])


def _lines(data: bytes, pos: int, line: int, width: int, height: int, planar: int,
           path: str) -> np.ndarray:
    """PIL's ``PcxDecode``: ``height`` lines of ``line`` bytes, each with
    its bands moved as the decoder moves them (``planar``: the planes of a
    1-bit ``P`` image, else 0)."""
    out = np.zeros((height, line), np.uint8)
    buf = bytearray(line)
    x = y = 0
    n = len(data)
    while y < height:
        if pos >= n:
            raise ValueError(f"{path}: truncated PCX data: {height} lines do not fit in the file "
                             f"(PIL: image file is truncated)")
        c = data[pos]
        if c & 0xC0 == 0xC0:
            if pos + 1 >= n:
                raise ValueError(f"{path}: truncated PCX data in a run (PIL: image file is "
                                 f"truncated)")
            count = c & 0x3F
            if x + count > line:
                raise ValueError(f"{path}: PCX run past a line's end (PIL fails on it: buffer "
                                 f"overrun)")
            buf[x:x + count] = bytes([data[pos + 1]]) * count
            x += count
            pos += 2
        else:
            buf[x] = c
            x += 1
            pos += 1
        if x >= line:
            if planar:  # P;2L / P;4L: a band per plane, (width + 7) // 8 bytes each
                size, bands = (width + 7) // 8, planar
                step = line // bands
            else:
                size, bands = width, line // width
                step = line // bands if bands else 0
            if step > size:
                for i in range(1, bands):
                    buf[i * size:(i + 1) * size] = bytes(buf[i * step:i * step + size])
            out[y] = np.frombuffer(bytes(buf), np.uint8)
            x = 0
            y += 1
    return out


def read_pcx_rgb(path: str) -> np.ndarray:
    """A PCX or DCX file (its first page) as (H, W, 3) uint8 RGB (see the
    module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        head = dcx(data, path) if data[:4] == b"\xb1\x68\xde\x3a" else header(data, path)
    except (PassOn, IndexError, struct.error) as e:
        raise ValueError(f"{path}: not a PCX file PIL opens ({e})") from None
    mode, (w, h), planes = head["mode"], head["size"], head["planes"]
    planar = planes if mode == "P" and head["bits"] == 1 else 0
    rows = _lines(data, head["offset"], head["line"], w, h, planar, path)
    if mode == "1":
        v = np.unpackbits(rows, axis=1)[:, :w].astype(np.uint8) * 255
        return np.repeat(v[:, :, None], 3, axis=2)
    if mode == "RGB":
        return np.ascontiguousarray(np.stack([rows[:, k * w:(k + 1) * w] for k in range(3)], -1))
    if head["bits"] == 1:  # P;2L / P;4L: one bit of each plane, planes (w + 7) // 8 apart
        s = (w + 7) // 8
        bits = np.unpackbits(rows[:, :planes * s].reshape(h, planes, s), axis=2)[:, :, :w]
        idx = np.tensordot(1 << np.arange(planes), bits.astype(np.int64), axes=(0, 1))
    else:
        idx = rows[:, :w]
    if mode == "L":
        return np.repeat(idx[:, :, None].astype(np.uint8), 3, axis=2)
    pal = np.zeros((256, 3), np.uint8)
    pal[:len(head["palette"])] = head["palette"]
    return np.ascontiguousarray(pal[idx])
