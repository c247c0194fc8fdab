"""SGI image decoding for ``image_io.read_image``, numpy and the standard
library only, bit-equal to PIL 12.1's
``np.array(Image.open(path).convert("RGB"))``.

PIL's ``SgiImagePlugin`` reads the 512-byte header (big-endian magic 474,
the storage byte, bytes per channel, dimension, width, height and
channels) and opens (bytes per channel, dimension, channels) = (1 or 2,
1 or 2, 1) as ``L``, (1 or 2, 3, 3) as RGB and (1 or 2, 3, 4) as RGBA;
any other combination (two channels, for one) makes PIL fail. 16-bit
channels keep their high byte (``L;16B``). The rows run bottom to top.

- Verbatim (storage 0): one plane per channel after the header, rows of
  width samples.
- RLE (storage 1): PIL's ``SgiRleDecode`` reads the offset and length
  tables (4 bytes per row and channel each, big-endian; the file must
  hold both) and expands each row and channel from its offset: a packet
  byte (for 16 bits, the low byte of a 16-bit word) whose low seven bits
  count pixels, copied from the stream when its top bit is set, else the
  next value repeated; a count of 0 ends the row, leaving the pixels it
  did not reach as the previous row left them in PIL's buffer. The
  packets of a row are counted against its length table entry as a limit
  on packets, and where the last one allowed is not a 0, PIL stops the
  whole image there, the rows not yet decoded black. An offset before
  the data, packets past the file's end or a row longer than the width
  make PIL fail (buffer overrun); a length entry past the file's end does
  not, and one of 0 or of 2**31 and above (negative as PIL's int) decodes
  nothing.

Another storage byte leaves PIL's image without tiles: PIL fails on it.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_identify import PassOn, check_size

_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L", (2, 2, 1): "L", (1, 3, 3): "RGB",
          (2, 3, 3): "RGB", (1, 3, 4): "RGBA", (2, 3, 4): "RGBA"}


def header(data: bytes, path: str) -> dict:
    """PIL's ``SgiImageFile._open``."""
    s = data[:512]
    if len(s) < 2 or struct.unpack_from(">H", s)[0] != 474:
        raise ValueError(f"{path}: not an SGI image file (PIL fails on it)")
    compression, bpc = s[2], s[3]
    dimension, xsize, ysize, zsize = struct.unpack_from(">4H", s, 4)
    mode = _MODES.get((bpc, dimension, zsize))
    if mode is None:
        raise ValueError(f"{path}: SGI image of {zsize} channels of {bpc} bytes in {dimension} "
                         f"dimensions (PIL fails on it: unsupported SGI image mode)")
    if xsize <= 0 or ysize <= 0:
        raise PassOn("no mode, or a size of 0")
    check_size(xsize, ysize, path)
    return {"mode": mode, "size": (xsize, ysize), "bpc": bpc, "compression": compression}


def _rle(data: bytes, w: int, h: int, z: int, bpc: int, path: str) -> np.ndarray:
    """PIL's ``SgiRleDecode``: (h, w, z) samples, rows bottom to top."""
    body = data[512:]
    size = len(body)
    n = z * h
    if size < 8 * n:
        raise ValueError(f"{path}: SGI RLE tables do not fit in the file (PIL fails on it: "
                         f"buffer overrun)")
    starts = struct.unpack_from(f">{n}I", body, 0)
    lengths = struct.unpack_from(f">{n}i", body, 4 * n)  # PIL counts down an int
    out = np.zeros((h, w, z), np.uint8)
    line = [[0] * w for _ in range(z)]  # PIL's row buffer, kept from row to row
    last = size - 1
    overrun = ValueError(f"{path}: SGI RLE row outside the file or longer than the width (PIL "
                         f"fails on it: buffer overrun)")
    for row in range(h):
        for c in range(z):
            start, count = starts[row + c * h], lengths[row + c * h]
            if start < 512:
                raise overrun
            src = start - 512
            dest = line[c]
            x = 0
            while count > 0:
                if src + bpc - 1 > last:
                    raise overrun
                pixel = body[src + bpc - 1]
                src += bpc
                if count == 1 and pixel != 0:  # PIL stops the whole image here
                    return out
                run = pixel & 0x7F
                if not run:
                    break
                if x + run > w:
                    raise overrun
                if pixel & 0x80:
                    if src + bpc * run > last:
                        raise overrun
                    dest[x:x + run] = body[src:src + bpc * run:bpc]
                    src += bpc * run
                else:
                    if src + (bpc == 2) * 2 > last:
                        raise overrun
                    dest[x:x + run] = [body[src]] * run
                    src += bpc
                x += run
                count -= 1
        out[row] = np.asarray(line).T
    return out


def read_sgi_rgb(path: str) -> np.ndarray:
    """An SGI image file as (H, W, 3) uint8 RGB (see the module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        head = header(data, path)
    except (PassOn, IndexError, struct.error) as e:
        raise ValueError(f"{path}: not an SGI file PIL opens ({e})") from None
    mode, (w, h), bpc = head["mode"], head["size"], head["bpc"]
    z = len(mode)
    if head["compression"] == 0:
        page = w * h * bpc
        if len(data) < 512 + z * page:
            raise ValueError(f"{path}: truncated SGI data: {z} planes of {page} bytes do not fit "
                             f"in the file (PIL: image file is truncated)")
        px = np.frombuffer(data, np.uint8, z * page, 512).reshape(z, h, w, bpc)[..., 0]
        px = px.transpose(1, 2, 0)
    elif head["compression"] == 1:
        px = _rle(data, w, h, z, bpc, path)
    else:
        raise ValueError(f"{path}: SGI storage {head['compression']} (PIL fails on it: cannot "
                         f"load this image)")
    px = px[::-1].astype(np.uint8)
    if z == 1:
        return np.repeat(px, 3, axis=2)
    return np.ascontiguousarray(px[:, :, :3])
