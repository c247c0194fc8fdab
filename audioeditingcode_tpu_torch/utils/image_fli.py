"""FLI/FLC (Autodesk animation) decoding for ``image_io.read_image``, numpy
and the standard library only, bit-equal to PIL 12.1's
``np.array(Image.open(path).convert("RGB"))`` of the first frame.

PIL's ``FliImagePlugin`` checks the 128-byte header (magic 0xAF11 or
0xAF12, flags 0 or 3, bytes 20-21, 42-79 and 88-127 zero; otherwise the
file passes on), takes the size at bytes 8-11, and looks for a palette in
the first frame chunk after the header (skipping a 0xF100 prefix chunk):
only the first of its sub-chunks of type 4 (8-bit colours) or 11 (6-bit,
shifted left by 2) counts, each packet skipping ``s[0]`` entries and
setting ``s[1]`` (0 meaning 256); without one the palette is a grey ramp.
A palette that runs past 256 entries or ends inside a colour passes the
file on. The frame decoded is the chunk at byte 128 itself, so a file
with a prefix chunk fails, as in PIL ("unrecognized data stream
contents"). PIL's C ``fli`` decoder runs the frame's sub-chunks on a
zero (black) image:

- 4, 11 (colours) and 18 (postage stamp): skipped;
- 7 (SS2, word delta): per line a packet count, with flag words before
  it (0xC000 set: skip lines; 0x8000 alone: the line's last byte), each
  packet a column skip and a count (positive: that many words copied,
  negative: one word repeated); a packet past the line's end ends the
  lines;
- 12 (LC, byte delta): a first line and a line count, per line a packet
  count, each packet a column skip and a count (positive: bytes copied,
  negative: one byte repeated);
- 13 (black): the image cleared;
- 15 (BRUN): per line a skipped byte, then runs (positive: one byte
  repeated, negative: bytes copied) to the line's end;
- 16 (copy): width x height bytes.

Another sub-chunk type, a sub-chunk size of 0 or past the frame's data,
data that runs out inside a chunk, or lines left undone raise, as PIL
fails on them (the decoder's overrun and unknown errors). The frame's
indices go through the palette.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_identify import PassOn, check_size


def header(data: bytes, path: str) -> dict:
    """PIL's ``FliImageFile._open``: {"size", "palette"}; ``PassOn`` (or
    ``IndexError``, ``struct.error``) where PIL passes the file on."""
    s = data[:128]
    magic, flags = struct.unpack_from("<H", s, 4)[0], struct.unpack_from("<H", s, 14)[0]
    if (magic not in (0xAF11, 0xAF12) or flags not in (0, 3) or s[20:22] != b"\0\0"
            or s[42:80] != bytes(38) or s[88:] != bytes(40)):
        raise PassOn("not an FLI/FLC file")
    width, height = struct.unpack_from("<HH", s, 8)
    palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    pos = 128
    chunk = data[pos:pos + 16]
    if struct.unpack_from("<H", chunk, 4)[0] == 0xF100:  # a prefix chunk
        pos += struct.unpack_from("<I", chunk)[0]
        chunk = data[pos:pos + 16]
    if struct.unpack_from("<H", chunk, 4)[0] == 0xF1FA:
        pos += 16
        size = None
        for _ in range(struct.unpack_from("<H", chunk, 6)[0]):
            if size is not None:
                pos += size
            if pos < 0:
                raise ValueError(f"{path}: FLI sub-chunk before the file's start (PIL fails on "
                                 f"it: invalid seek)")
            sub = data[pos:pos + 6]
            kind = struct.unpack_from("<H", sub, 4)[0]
            if kind in (4, 11):
                _palette(data, pos + 6, palette, 2 if kind == 11 else 0)
                break
            size = struct.unpack_from("<I", sub)[0]
            if not size:
                break
    if len(data) < 132:
        raise PassOn("missing frame size")
    if width <= 0 or height <= 0:
        raise PassOn("no mode, or a size of 0")
    check_size(width, height, path)
    return {"size": (width, height), "palette": palette}


def _palette(data: bytes, pos: int, palette: np.ndarray, shift: int) -> None:
    """PIL's ``FliImageFile._palette`` into ``palette`` (IndexError where an
    entry past 255 or a colour cut short is read)."""
    i = 0
    (packets,) = struct.unpack_from("<H", data, pos)
    pos += 2
    for _ in range(packets):
        if pos + 2 > len(data):
            raise IndexError("FLI palette packet cut short")
        skip, n = data[pos], data[pos + 1]
        pos += 2
        i += skip
        rgb = data[pos:pos + 3 * (n or 256)]
        pos += 3 * (n or 256)
        for k in range(0, len(rgb), 3):
            if i > 255 or k + 2 >= len(rgb):
                raise IndexError("FLI palette entry past 255 or cut short")
            palette[i] = [(rgb[k] << shift) & 255, (rgb[k + 1] << shift) & 255,
                          (rgb[k + 2] << shift) & 255]
            i += 1


class _Overrun(Exception):
    pass


def _frame(buf: bytes, width: int, height: int) -> np.ndarray:
    """PIL's C ``fli`` decoder over one frame chunk: (H, W) uint8 indices."""
    img = np.zeros((height, width), np.uint8)
    end = len(buf)
    if end < 8:
        raise _Overrun("frame header cut short")
    if struct.unpack_from("<H", buf, 4)[0] != 0xF1FA:
        raise _Overrun("not a frame chunk (unrecognized data stream contents)")
    chunks = struct.unpack_from("<H", buf, 6)[0]
    ptr = 16
    for _ in range(chunks):
        if end - ptr < 10:
            raise _Overrun("sub-chunk header past the data")
        kind = struct.unpack_from("<H", buf, ptr + 4)[0]
        d = ptr + 6

        def need(n):
            if d + n > end:
                raise _Overrun("chunk data past the end")

        if kind in (4, 11, 18):
            pass
        elif kind == 7:  # SS2
            lines = struct.unpack_from("<H", buf, d)[0]
            d += 2
            y = line = 0
            while line < lines and y < height:
                need(2)
                packets = struct.unpack_from("<H", buf, d)[0]
                d += 2
                row = y
                while packets & 0x8000:
                    if packets & 0x4000:
                        y += 65536 - packets
                        if y >= height:
                            raise _Overrun("SS2 line skip past the image")
                        row = y
                    else:
                        img[row, width - 1] = packets & 255
                    need(2)
                    packets = struct.unpack_from("<H", buf, d)[0]
                    d += 2
                x = p = 0
                while p < packets:
                    need(2)
                    x += buf[d]
                    if buf[d + 1] >= 128:
                        need(4)
                        n = 256 - buf[d + 1]
                        if x + 2 * n > width:
                            break
                        img[row, x:x + 2 * n] = np.tile(np.frombuffer(buf, np.uint8, 2, d + 2),
                                                        n)
                        x += 2 * n
                        d += 4
                    else:
                        n = 2 * buf[d + 1]
                        if x + n > width:
                            break
                        need(2 + n)
                        img[row, x:x + n] = np.frombuffer(buf, np.uint8, n, d + 2)
                        d += 2 + n
                        x += n
                    p += 1
                if p < packets:
                    break
                line += 1
                y += 1
            if line < lines:
                raise _Overrun("SS2 lines left undone")
        elif kind == 12:  # LC
            y, count = struct.unpack_from("<HH", buf, d)
            ymax = y + count
            d += 4
            while y < ymax and y < height:
                need(1)
                packets = buf[d]
                d += 1
                x = p = 0
                while p < packets:
                    need(2)
                    x += buf[d]
                    if buf[d + 1] & 0x80:
                        n = 256 - buf[d + 1]
                        if x + n > width:
                            break
                        need(3)
                        img[y, x:x + n] = buf[d + 2]
                        d += 3
                    else:
                        n = buf[d + 1]
                        if x + n > width:
                            break
                        need(2 + n)
                        img[y, x:x + n] = np.frombuffer(buf, np.uint8, n, d + 2)
                        d += 2 + n
                    x += n
                    p += 1
                if p < packets:
                    break
                y += 1
            if y < ymax:
                raise _Overrun("LC lines left undone")
        elif kind == 13:  # black
            img[:] = 0
        elif kind == 15:  # BRUN
            for y in range(height):
                d += 1
                x = 0
                while x < width:
                    need(2)
                    if buf[d] & 0x80:
                        n = 256 - buf[d]
                        if x + n > width:
                            break
                        need(n + 1)
                        img[y, x:x + n] = np.frombuffer(buf, np.uint8, n, d + 1)
                        d += n + 1
                    else:
                        n = buf[d]
                        if x + n > width:
                            break
                        img[y, x:x + n] = buf[d + 1]
                        d += 2
                    x += n
                if x != width:
                    raise _Overrun("BRUN line left undone")
        elif kind == 16:  # copy
            if d + width * height > end:
                raise _Overrun("copy chunk past the data")
            img[:] = np.frombuffer(buf, np.uint8, width * height, d).reshape(height, width)
        else:
            raise _Overrun(f"unknown sub-chunk type {kind}")
        (advance,) = struct.unpack_from("<i", buf, ptr)
        if advance == 0:
            raise _Overrun("sub-chunk of size 0")
        if advance < 0 or advance > end - ptr:
            raise _Overrun("sub-chunk size past the data")
        ptr += advance
    return img


def decode_fli(data: bytes, path: str) -> np.ndarray:
    """An FLI/FLC file's bytes as (H, W, 3) uint8 RGB of its first frame
    (see the module docstring)."""
    try:
        head = header(data, path)
    except (PassOn, IndexError, struct.error) as e:
        raise ValueError(f"{path}: not an FLI/FLC file PIL opens ({e})") from None
    width, height = head["size"]
    (framesize,) = struct.unpack_from("<I", data, 128)
    buf = data[128:128 + framesize]  # PIL's decoder sees one read of the frame's size
    if len(buf) + len(buf) % 2 < framesize:
        raise ValueError(f"{path}: truncated FLI data: a frame of {framesize} bytes, the file "
                         f"holds {len(buf)} (PIL fails on it: image file is truncated)")
    try:
        idx = _frame(buf, width, height)
    except (_Overrun, IndexError, struct.error) as e:
        raise ValueError(f"{path}: broken FLI frame: {e} (PIL's decoder fails on it)") from None
    return head["palette"][idx]
