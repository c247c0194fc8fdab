"""PSD (Photoshop) decoding for ``image_io.read_image``, numpy and the
standard library only, bit-equal to PIL 12.1's
``np.array(Image.open(path).convert("RGB"))``.

``Image.open`` reads the merged (composite) image, and so does this
module, with the rules of PIL's ``PsdImagePlugin``:

- the 26-byte header: ``8BPS``, version 1, the channel count, height,
  width, depth and colour mode. PIL takes (mode, depth) = (bitmap, 1) as
  ``1``, (greyscale, 8), (multichannel, 8) and (duotone, 8) as ``L``,
  (indexed, 8) as ``P``, (RGB, 8) as RGB (RGBA where the file has exactly
  four channels), (CMYK, 8) as CMYK and (Lab, 8) as LAB; any other pair
  (16- and 32-bit files, for one) passes the file on to PIL's next opener,
  and a file with fewer channels than its mode needs makes PIL fail;
- the colour mode data (an indexed file's palette where it is 768 bytes:
  256 reds, greens, then blues; else PIL's palette of zeros, all black), the
  image resources (walked as PIL walks them, so a block that ends early
  passes the file on) and the layer and mask section are skipped;
- the composite image: a 16-bit compression, then the mode's channels
  only (the others are never read), each a plane of rows; raw planes
  follow each other at width x height bytes; PackBits (compression 1)
  reads one 16-bit byte count per row of the mode's channels only (so a
  file with extra channels has the rest of its count table read as
  image data, as PIL reads it), and each channel's data starts after the
  counts of the channels before it. PIL's ``PackBitsDecode`` runs across
  rows, drops the part of a run or a literal past a row's end, and skips
  a 0x80 byte. Another compression leaves PIL without tiles: it fails.

Bitmap pixels are 0 or 255 (a 1 bit white, as PIL reads it); CMYK is
stored inverted (PIL's ``C;I`` raw modes) and converted by
``image_io.cmyk_to_rgb``; Lab's a* and b* are stored offset by 128, which
PIL's ``A`` and ``B`` raw modes XOR with 128 into its signed LAB bytes, and
those go through ``image_lab.lab_to_rgb``, the LittleCMS transform PIL's
``convert("RGB")`` applies (as for TIFF's CIELab); alpha is dropped. A
file that ends before its pixels raises, as PIL raises "image file is
truncated".
"""

from __future__ import annotations

import struct

import numpy as np

from .image_identify import PassOn, check_size
from .image_io import cmyk_to_rgb

_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1),
          (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1),
          (9, 8): ("LAB", 3)}


def header(data: bytes, path: str) -> dict:
    """PIL's ``PsdImageFile._open``: mode, size, palette and where each
    channel's data starts."""
    s = data[:26]
    be16 = lambda pos: struct.unpack_from(">H", data, pos)[0]  # noqa: E731
    be32 = lambda pos: struct.unpack_from(">I", data, pos)[0]  # noqa: E731
    if not s.startswith(b"8BPS") or be16(4) != 1:
        raise PassOn("not a PSD file")
    bits, psd_channels, psd_mode = be16(22), be16(12), be16(24)
    if (psd_mode, bits) not in _MODES:
        raise PassOn(f"PSD colour mode {psd_mode} at {bits} bits (PIL: KeyError)")
    mode, channels = _MODES[(psd_mode, bits)]
    if channels > psd_channels:
        raise ValueError(f"{path}: PSD of {psd_channels} channels in a mode of {channels} (PIL "
                         f"fails on it: not enough channels)")
    if mode == "RGB" and psd_channels == 4:
        mode, channels = "RGBA", 4
    width, height = be32(18), be32(14)
    pos = 26

    def read(n: int) -> bytes:  # a file's read: short at the end, never past it
        nonlocal pos
        got = data[pos:pos + n]
        pos = min(pos + n, len(data))
        return got

    def read32() -> int:
        return struct.unpack(">I", read(4))[0]

    size = read32()
    palette = None
    if size:
        mode_data = read(size)
        if mode == "P" and size == 768 and len(mode_data) == 768:
            palette = np.frombuffer(mode_data, np.uint8).reshape(3, 256).T
    size = read32()
    if size:  # the image resources, walked block by block
        end = pos + size
        while pos < end:
            read(4)
            struct.unpack(">H", read(2))
            name = read(read(1)[0])
            if not len(name) & 1:
                read(1)
            if len(read(read32())) & 1:
                read(1)
    size = read32()
    if size:
        end = pos + size
        read32()
        pos = end
    (compression,) = struct.unpack(">H", read(2))
    starts = []
    if compression == 0:
        starts = [pos + k * width * height for k in range(channels)]
    elif compression == 1:
        counts = read(2 * channels * height)
        for k in range(channels):
            starts.append(pos)
            pos += sum(struct.unpack_from(f">{height}H", counts, 2 * k * height))
    if width <= 0 or height <= 0:
        raise PassOn("no mode, or a size of 0")
    check_size(width, height, path)
    return {"mode": mode, "size": (width, height), "palette": palette,
            "compression": compression, "starts": starts}


def _packbits(data: bytes, pos: int, line: int, rows: int, path: str) -> bytes:
    """PIL's ``PackbitsDecode``: ``rows`` rows of ``line`` bytes from ``pos``."""
    out = bytearray()
    row = bytearray()
    n = len(data)
    while len(out) < line * rows:
        if pos >= n:
            raise ValueError(f"{path}: truncated PSD PackBits data (PIL: image file is "
                             f"truncated)")
        c = data[pos]
        if c == 0x80:
            pos += 1
            continue
        if c & 0x80:
            if pos + 1 >= n:
                raise ValueError(f"{path}: truncated PSD PackBits data (PIL: image file is "
                                 f"truncated)")
            row += data[pos + 1:pos + 2] * (257 - c)
            pos += 2
        else:
            if pos + c + 2 > n:
                raise ValueError(f"{path}: truncated PSD PackBits data (PIL: image file is "
                                 f"truncated)")
            row += data[pos + 1:pos + c + 2]
            pos += c + 2
        if len(row) >= line:
            out += row[:line]
            row = bytearray()
    return bytes(out)


def decode_psd(data: bytes, path: str) -> np.ndarray:
    """A PSD file's bytes's composite image as (H, W, 3) uint8 RGB (see the module
    docstring)."""
    try:
        head = header(data, path)
    except (PassOn, IndexError, struct.error) as e:
        raise ValueError(f"{path}: not a PSD file PIL opens ({e})") from None
    mode, (w, h) = head["mode"], head["size"]
    if head["compression"] not in (0, 1):
        raise ValueError(f"{path}: PSD compression {head['compression']} (PIL fails on it: "
                         f"cannot load this image)")
    line = (w + 7) // 8 if mode == "1" else w
    planes = []
    for start in head["starts"]:
        if head["compression"] == 0:
            raw = data[start:start + line * h]
            if len(raw) < line * h:
                raise ValueError(f"{path}: truncated PSD data: a plane of {h} rows of {line} "
                                 f"bytes does not fit in the file (PIL: image file is "
                                 f"truncated)")
        else:
            raw = _packbits(data, start, line, h, path)
        planes.append(np.frombuffer(raw, np.uint8).reshape(h, line))
    if mode == "1":
        v = np.unpackbits(planes[0], axis=1)[:, :w].astype(np.uint8) * 255
        return np.repeat(v[:, :, None], 3, axis=2)
    if mode == "L":
        return np.repeat(planes[0][:, :, None], 3, axis=2)
    if mode == "P":
        pal = head["palette"]
        if pal is None:  # PIL's palette of zeros
            pal = np.zeros((256, 3), np.uint8)
        return np.ascontiguousarray(pal[planes[0]])
    px = np.stack(planes, -1)
    if mode == "CMYK":
        return cmyk_to_rgb(*np.moveaxis(255 - px.astype(np.int64), -1, 0))
    if mode == "LAB":
        from .image_lab import lab_to_rgb

        return lab_to_rgb(px ^ np.array([0, 128, 128], np.uint8))
    return np.ascontiguousarray(px[:, :, :3])
