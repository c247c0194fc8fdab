"""TGA decoding for ``image_io.read_image``, numpy and the standard library
only, bit-equal to PIL 12.1's ``np.array(Image.open(path).convert("RGB"))``.

TGA has no magic: PIL tries its ``TgaImagePlugin`` on every file that
reaches it, and ``is_tga`` makes that opener's header checks: colour map
type 0 or 1, a positive width and height, depth 1, 8, 16, 24 or 32, image
type 1, 2, 3, 9, 10 or 11, and a colour map (if any) of 16-, 24- or
32-bit entries; a file that fails them passes on to PIL's next opener.
This module reads, with PIL's rules:

- image types 1 and 9 (colour-mapped, mode ``P``; without a colour map
  PIL fails), 2 and 10 (true colour: 16 bits as BGR 5-5-5, each field
  ``v * 255 // 31``, the top bit ignored; 24 bits BGR; 32 bits BGRA, alpha
  dropped), 3 and 11 (greyscale: 8 bits, 16 bits grey + alpha, 1 bit);
  the depths PIL has no raw mode for raise, as PIL fails on them;
- the colour map after the image-ID field: 16-bit (BGR 5-5-5) or 24-bit
  entries, the entries before its first index black, an index past the map
  black; 32-bit entries and maps past 256 entries raise, as PIL fails on
  them;
- rows bottom to top unless the origin's 0x20 bit is set, and mirrored
  where its 0x10 bit is;
- run-length encoding (types 9-11) as PIL's ``TgaRleDecode`` runs it: a
  packet header's top bit for a run of one pixel repeated (low 7 bits + 1
  times) or else that many literal pixels, each pixel (depth + 7) // 8
  bytes; a literal packet may run on into the next row, but a run packet
  that crosses a row's end raises, as PIL fails on it ("buffer overrun").

A file that ends before its pixels do raises, as PIL raises "image file is
truncated".
"""

from __future__ import annotations

import struct

import numpy as np

from .image_io import _samples as _unpack

_RAWMODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGR15",
             (2, 24): "BGR", (2, 32): "BGRA"}


def is_tga(head: bytes) -> bool:
    """Whether PIL's ``TgaImagePlugin`` opens a file with these first 18
    bytes (its header checks; ``decode_tga`` raises where PIL then fails
    to decode)."""
    if len(head) < 18:
        return False
    width, height = struct.unpack("<HH", head[12:16])
    return (head[1] in (0, 1) and width > 0 and height > 0 and head[16] in (1, 8, 16, 24, 32)
            and head[2] in (1, 2, 3, 9, 10, 11) and (head[1] == 0 or head[7] in (16, 24, 32)))


def _rle(data: bytes, pos: int, size: int, stride: int, depth: int, path: str) -> bytes:
    """``size`` bytes of RLE pixels of ``depth`` bytes from ``data[pos:]``,
    in rows of ``stride`` bytes."""
    out = bytearray()
    n = len(data)
    while len(out) < size:
        if pos >= n:
            raise ValueError(f"{path}: truncated TGA data: the RLE packets end early")
        head = data[pos]
        count = (head & 0x7F) + 1
        if head & 0x80:
            if pos + 1 + depth > n:
                raise ValueError(f"{path}: truncated TGA data in a run packet")
            if len(out) % stride + depth * count > stride:
                raise ValueError(f"{path}: TGA run packet across a row's end (PIL fails on it: "
                                 f"buffer overrun)")
            out += data[pos + 1:pos + 1 + depth] * count
            pos += 1 + depth
        else:
            if pos + 1 + depth * count > n:
                raise ValueError(f"{path}: truncated TGA data in a literal packet")
            out += data[pos + 1:pos + 1 + depth * count]
            pos += 1 + depth * count
    return bytes(out[:size])


def decode_tga(data: bytes, path: str) -> np.ndarray:
    """A TGA file's bytes as (H, W, 3) uint8 RGB (see the module docstring)."""
    if not is_tga(data[:18]):
        raise ValueError(f"{path}: not a TGA file PIL opens")
    id_len, cmap_type, itype = data[0], data[1], data[2]
    cmap_start, cmap_len, cmap_depth = struct.unpack("<HHB", data[3:8])
    width, height, depth, flags = struct.unpack("<HHBB", data[12:18])
    rawmode = _RAWMODES.get((itype & 7, depth))
    if itype & 7 == 1 and not cmap_type:
        raise ValueError(f"{path}: colour-mapped TGA without a colour map (PIL fails on it)")
    if rawmode is None:
        raise ValueError(f"{path}: TGA image type {itype} at {depth} bits: PIL has no raw mode "
                         f"for it and fails on it")
    pos = 18 + id_len
    pal = None
    if cmap_type:
        size = {16: 2, 24: 3}.get(cmap_depth)
        if size is None:  # PIL 12.1 has no palette raw mode for 32-bit entries
            raise ValueError(f"{path}: TGA colour map of {cmap_depth}-bit entries (PIL fails "
                             f"on it)")
        if cmap_start + cmap_len > 256:
            raise ValueError(f"{path}: TGA colour map of {cmap_start} + {cmap_len} entries (PIL "
                             f"fails on it: invalid palette size)")
        raw = data[pos:pos + size * cmap_len]
        pos += size * cmap_len
        entries = np.zeros((cmap_start + cmap_len, 3), np.int64)
        got = len(raw) // size
        entries[cmap_start:cmap_start + got] = _pixels(
            np.frombuffer(raw[:got * size], np.uint8).reshape(1, got * size), got, size * 8)[0]
        pal = np.zeros((256, 3), np.uint8)
        m = min(256, len(entries))
        pal[:m] = entries[:m]
    bpp = (depth + 7) // 8
    stride = (width * depth + 7) // 8
    if itype & 8:
        if depth == 1:  # PIL's run-length decoder takes a byte a pixel there, and fails
            raise ValueError(f"{path}: run-length 1-bit TGA (PIL fails on it)")
        raw = _rle(data, pos, stride * height, stride, bpp, path)
    else:
        raw = data[pos:pos + stride * height]
        if len(raw) < stride * height:
            raise ValueError(f"{path}: truncated TGA data: {height} rows of {stride} bytes do "
                             f"not fit in the file")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride)
    if rawmode == "P":
        px = pal[rows[:, :width]]
    elif rawmode == "1":
        px = np.repeat(_unpack(rows, width, 1, 1)[:, :, :1].astype(np.uint8) * 255, 3, axis=2)
    elif rawmode in ("L", "LA"):
        px = np.repeat(rows[:, 0:width * bpp:bpp, None], 3, axis=2)
    else:
        px = _pixels(rows, width, depth).astype(np.uint8)
    if not flags & 0x20:
        px = px[::-1]
    if flags & 0x10:
        px = px[:, ::-1]
    return np.ascontiguousarray(px)


def _pixels(rows: np.ndarray, width: int, depth: int) -> np.ndarray:
    """BGR 5-5-5, BGR or BGRA rows -> (rows, width, 3) int64 RGB."""
    h = rows.shape[0]
    if depth == 16:
        v = rows[:, :2 * width].reshape(h, width, 2).astype(np.int64) @ [1, 256]
        return np.stack([((v >> s) & 31) * 255 // 31 for s in (10, 5, 0)], axis=-1)
    b = depth // 8
    return rows[:, :b * width].reshape(h, width, b)[:, :, 2::-1].astype(np.int64)
