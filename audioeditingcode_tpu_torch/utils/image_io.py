"""Image IO for the image-editing CLIs, without an image library.

Counterpart of ``audioeditingcode_tpu/utils/image_io.py``, which reads,
resizes and writes with PIL. This module does the same with numpy, ``zlib``
and ``struct``:

- ``read_png_rgb``: a PNG decoder for 8-bit greyscale, greyscale + alpha,
  RGB and RGBA images and for palette images (1, 2, 4 or 8 bits),
  non-interlaced, with the five scanline filters, converted to RGB as
  PIL's ``convert("RGB")`` does (alpha dropped, palette looked up, grey
  repeated). Any other file (JPEG, GIF, 16-bit or sub-byte greyscale
  samples, Adam7 interlacing) raises a ``ValueError`` that names what it
  is.
- ``write_png``: 8-bit greyscale, RGB or RGBA, filter 0, zlib level 6.
- ``resize_rgb``: PIL's default ``Image.resize`` filter for RGB (bicubic,
  a = -0.5, the support widened by the downscaling factor, coefficients
  normalised and turned into 22-bit fixed point, a horizontal then a
  vertical pass, each rounded and clipped to uint8).
- ``load_image`` / ``save_image``: the reference's crop -> centre square ->
  resize -> [-1, 1] NCHW float32, and its inverse to a PNG.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# the leading bytes of formats this reader does not take, for the error
_OTHER_FORMATS = ((b"\xff\xd8\xff", "JPEG"), (b"GIF8", "GIF"), (b"BM", "BMP"),
                  (b"RIFF", "RIFF (WebP?)"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"))
# PNG colour types: (name, samples per pixel)
_COLOR_TYPES = {0: ("greyscale", 1), 2: ("RGB", 3), 3: ("palette", 1),
                4: ("greyscale + alpha", 2), 6: ("RGBA", 4)}


# -------------------------------------------------------------------- PNG
def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        yield tag, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IEND":
            return


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The scanlines with their filters undone, (height, stride) uint8."""
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.int64)
    for y in range(height):
        start = y * (stride + 1)
        ftype = raw[start]
        line = np.frombuffer(raw, np.uint8, stride, start + 1).astype(np.int64)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum per byte of the pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) % 256
        elif ftype == 2:  # Up
            cur = (line + prior) % 256
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            lb, pr = line.tolist(), prior.tolist()
            cb = [0] * stride
            for i in range(stride):
                left = cb[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    cb[i] = (lb[i] + ((left + pr[i]) >> 1)) & 255
                else:
                    up_left = pr[i - bpp] if i >= bpp else 0
                    cb[i] = (lb[i] + _paeth(left, pr[i], up_left)) & 255
            cur = np.asarray(cb, np.int64)
        else:
            raise ValueError(f"PNG scanline filter {ftype} is not one of 0-4")
        out[y] = cur
        prior = cur
    return out


def _unpack(rows: np.ndarray, width: int, bits: int) -> np.ndarray:
    """Palette indices of 1, 2 or 4 bits packed high bit first -> (H,
    width) uint8."""
    if bits == 8:
        return rows[:, :width]
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)  # high bits first
    vals = (rows[:, :, None] >> shifts) & ((1 << bits) - 1)
    return vals.reshape(rows.shape[0], -1)[:, :width].astype(np.uint8)


def read_png_rgb(path: str) -> np.ndarray:
    """A PNG file as (H, W, 3) uint8 RGB (see the module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        name = next((n for sig, n in _OTHER_FORMATS if data.startswith(sig)), None)
        raise ValueError(f"{path}: {name or 'not a PNG'} file; this reader takes PNG "
                         f"only (the port has no image library)")
    idat, palette, header = [], None, None
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    width, height, bits, ctype, _, _, interlace = header
    if ctype not in _COLOR_TYPES:
        raise ValueError(f"{path}: PNG colour type {ctype} is not a valid one")
    kind, samples = _COLOR_TYPES[ctype]
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not supported")
    if bits == 16:
        raise ValueError(f"{path}: 16-bit {kind} PNG is not supported (8-bit only)")
    if bits != 8 and ctype != 3:
        raise ValueError(f"{path}: {bits}-bit {kind} PNG is not supported (8-bit only)")
    stride = (width * samples * bits + 7) // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, stride,
                     max(1, samples * bits // 8))
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without a PLTE chunk")
        idx = _unpack(rows, width, bits)
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(palette)] = palette
        return pal[idx]
    px = rows.reshape(height, width, samples)
    if ctype in (0, 4):  # greyscale (+ alpha, dropped)
        return np.repeat(px[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(px[:, :, :3])


def write_png(path: str, img: np.ndarray) -> None:
    """(H, W) greyscale or (H, W, 3|4) RGB(A) uint8 as an 8-bit PNG."""
    img = np.ascontiguousarray(img, np.uint8)
    ctype = {2: 0, 3: {3: 2, 4: 6}.get(img.shape[-1])}.get(img.ndim)
    if ctype is None:
        raise ValueError(f"write_png takes (H, W) or (H, W, 3|4) uint8, got {img.shape}")
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


# ----------------------------------------------------------------- resize
_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed point for 8-bit images


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    bicubic filter over the whole axis: (first source index (out,), fixed
    point weights (out, ksize), zero past each output's window)."""
    scale = float(np.float32(in_size)) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    x = np.arange(ksize)[None, :]
    w = _bicubic((x + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(x < xmax[:, None], w, 0.0)
    ww = np.zeros((out_size, 1))
    for j in range(ksize):  # summed in Pillow's order
        ww[:, 0] += w[:, j]
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    one = float(1 << _PRECISION_BITS)
    fixed = np.where(w < 0, np.trunc(-0.5 + w * one), np.trunc(0.5 + w * one))
    return xmin, fixed.astype(np.int64)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One of Pillow's two passes along ``axis`` of an (H, W, C) uint8 image."""
    in_size = img.shape[axis]
    xmin, k = _coeffs(in_size, out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    bshape = (out_size,) + (1,) * (src.ndim - 1)
    for j in range(k.shape[1]):
        idx = np.minimum(xmin + j, in_size - 1)  # weight 0 where past the window
        acc += src[idx] * k[:, j].reshape(bshape)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_rgb(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W, 3) uint8 -> (size[1], size[0], 3), as PIL's
    ``Image.fromarray(img).resize(size)`` (size is (width, height))."""
    width, height = int(size[0]), int(size[1])
    if img.shape[1] != width:
        img = _resample_axis(img, width, axis=1)
    if img.shape[0] != height:
        img = _resample_axis(img, height, axis=0)
    return img


# ---------------------------------------------------------- the CLIs' IO
def load_image(image_path, left: int = 0, right: int = 0, top: int = 0, bottom: int = 0,
               resize: Tuple[int, int] = (512, 512)) -> np.ndarray:
    """An RGB image (a PNG path, or an (H, W, 3+) uint8 array) -> (1, 3, H,
    W) float32 in [-1, 1]: crop, centre square, resize to ``resize`` =
    (width, height)."""
    if isinstance(image_path, str):
        image = read_png_rgb(image_path)
    else:
        image = np.asarray(image_path)[:, :, :3]

    h, w, _ = image.shape
    # the reference's clamps, as they are (top is clamped with left)
    left = min(left, w - 1)
    right = min(right, w - left - 1)
    top = min(top, h - left - 1)
    bottom = min(bottom, h - top - 1)
    image = image[top: h - bottom, left: w - right]
    h, w, _ = image.shape

    if h < w:
        offset = (w - h) // 2
        image = image[:, offset: offset + h]
    elif w < h:
        offset = (h - w) // 2
        image = image[offset: offset + w]

    image = resize_rgb(np.ascontiguousarray(image, np.uint8), resize)
    image = image.astype(np.float32) / 255.0
    image = np.transpose(image, (2, 0, 1))[None]  # (1, 3, H, W)
    return image * 2.0 - 1.0


def save_image(path: str, x: np.ndarray) -> None:
    """Save a (1, 3, H, W) or (3, H, W) [-1, 1] array as an RGB PNG."""
    x = np.asarray(x)
    if x.ndim == 4:
        x = x[0]
    x = np.clip((x + 1.0) / 2.0, 0.0, 1.0)
    x = (np.transpose(x, (1, 2, 0)) * 255.0).round().astype(np.uint8)
    write_png(path, x)
