"""GIF decoding for ``image_io.read_image``, numpy and the standard library
only, bit-equal to PIL 12.1's ``np.array(Image.open(path).convert("RGB"))``.

PIL opens the first frame of GIF87a and GIF89a files, and so does this:

- the logical screen, grown where the first image's rectangle reaches past
  it; the pixels outside that rectangle hold the frame's transparency
  index where its graphic control extension sets one, else index 0 (the
  background index is not used for the first frame);
- the local colour table, else the global one; a table whose every entry
  is (i, i, i) at its own index i, or no table at all, makes PIL open the
  image in mode ``L``, where an index is its own grey level; with another
  table, an index past its end is black;
- variable-code-size LZW, least significant bit first, minimum code sizes
  1-11, clear and end codes, and a table left full at 4096 codes until the
  next clear ("deferred clear"); a code past the next free one is corrupt;
- the four-pass interlace;
- extension blocks (graphic control, comment, application) skipped but for
  the first graphic control's transparency index.

A file that ends before its image data is complete raises, as PIL raises
"image file is truncated"; so does an LZW stream that ends, or reaches its
end code, before the last pixel (PIL raises the same), and a corrupt one.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

_MAX_CODES = 4096
# the interlace's passes: (first row, row step)
_PASSES = ((0, 8), (4, 8), (2, 4), (1, 2))


def _sub_blocks(data: bytes, pos: int, path: str) -> Tuple[bytes, int]:
    """The data sub-blocks from ``pos`` joined, and the position after their
    terminating empty block."""
    parts = []
    while True:
        if pos >= len(data):
            raise ValueError(f"{path}: truncated GIF data: the file ends inside a data block")
        n = data[pos]
        if pos + 1 + n > len(data):
            raise ValueError(f"{path}: truncated GIF data: the file ends inside a data block")
        if n == 0:
            return b"".join(parts), pos + 1
        parts.append(data[pos + 1:pos + 1 + n])
        pos += 1 + n


def _lzw(stream: bytes, min_size: int, count: int, path: str) -> bytes:
    """Up to ``count`` indices of a GIF LZW stream (least significant bit
    first): fewer where the data or an end code comes first."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    base = [bytes([i]) for i in range(clear)] + [b"", b""]
    table = list(base)
    size, prev = min_size + 1, None
    out = bytearray()
    acc = nbits = pos = 0
    n = len(stream)
    while len(out) < count:
        while nbits < size:
            if pos >= n:
                return bytes(out)
            acc |= stream[pos] << nbits
            pos += 1
            nbits += 8
        code = acc & ((1 << size) - 1)
        acc >>= size
        nbits -= size
        if code == clear:
            table = list(base)
            size, prev = min_size + 1, None
            continue
        if code == end:
            return bytes(out)
        if prev is None:
            if code >= clear:
                raise ValueError(f"{path}: corrupt GIF data: LZW code {code} after a clear")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            if len(table) < _MAX_CODES:
                table.append(prev + entry[:1])
        elif code == len(table) and len(table) < _MAX_CODES:
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError(f"{path}: corrupt GIF data: LZW code {code} past the table's "
                             f"{len(table)} entries")
        if len(table) == 1 << size and size < 12:
            size += 1
        out += entry
        prev = entry
    return bytes(out[:count])


def _greyscale_table(table: Optional[np.ndarray]) -> bool:
    """PIL's ``_is_palette_needed`` negated: no table, or entry i = (i, i, i)."""
    if table is None:
        return True
    return bool(np.all(table == np.arange(len(table))[:, None]))


def decode_gif(data: bytes, path: str) -> np.ndarray:
    """The first frame of a GIF file's bytes as (H, W, 3) uint8 RGB (see the module
    docstring)."""
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError(f"{path}: not a GIF87a or GIF89a file")
    width, height, flags = struct.unpack("<HHB", data[6:11])
    pos = 13
    global_table = None
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        if pos + n > len(data):
            raise ValueError(f"{path}: truncated GIF data: the colour table ends past the file")
        global_table = np.frombuffer(data, np.uint8, n, pos).reshape(-1, 3)
        pos += n
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError(f"{path}: GIF file without an image")
        kind = data[pos]
        if kind == 0x21:  # extension: a label, then data sub-blocks
            if pos + 1 >= len(data):
                raise ValueError(f"{path}: truncated GIF data: the file ends in an extension")
            label = data[pos + 1]
            body, pos = _sub_blocks(data, pos + 2, path)
            if label == 0xF9 and len(body) >= 4 and body[0] & 1:
                transparency = body[3]
            continue
        if kind != 0x2C:
            raise ValueError(f"{path}: corrupt GIF data: block type {kind:#04x}")
        if pos + 10 > len(data):
            raise ValueError(f"{path}: truncated GIF data: the file ends in an image descriptor")
        x0, y0, w, h, iflags = struct.unpack("<HHHHB", data[pos + 1:pos + 10])
        pos += 10
        table = global_table
        if iflags & 0x80:
            n = 3 << ((iflags & 7) + 1)
            if pos + n > len(data):
                raise ValueError(f"{path}: truncated GIF data: the colour table ends past the "
                                 f"file")
            table = np.frombuffer(data, np.uint8, n, pos).reshape(-1, 3)
            pos += n
        break
    if pos >= len(data):
        raise ValueError(f"{path}: truncated GIF data: the file ends before its image data")
    min_size = data[pos]
    if not 1 <= min_size <= 11:
        raise ValueError(f"{path}: corrupt GIF data: LZW minimum code size {min_size}")
    stream, _ = _sub_blocks(data, pos + 1, path)
    indices = _lzw(stream, min_size, w * h, path)
    if len(indices) < w * h:
        raise ValueError(f"{path}: truncated GIF data: the LZW stream ends after "
                         f"{len(indices)} of {w * h} pixels")
    px = np.frombuffer(indices, np.uint8).reshape(h, w)
    if iflags & 0x40:  # interlaced: the rows of the four passes in turn
        order = np.concatenate([np.arange(r0, h, step) for r0, step in _PASSES])
        rows = np.empty_like(px)
        rows[order] = px
        px = rows
    screen = np.full((max(height, y0 + h), max(width, x0 + w)),
                     transparency if transparency is not None else 0, np.uint8)
    screen[y0:y0 + h, x0:x0 + w] = px
    if _greyscale_table(table):
        return np.repeat(screen[:, :, None], 3, axis=2)
    pal = np.zeros((256, 3), np.uint8)
    pal[:len(table)] = table[:256]
    return pal[screen]
