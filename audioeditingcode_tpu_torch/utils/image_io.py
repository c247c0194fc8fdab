"""Image IO for the image-editing CLIs, without an image library.

Counterpart of ``audioeditingcode_tpu/utils/image_io.py``, which reads,
resizes and writes with PIL. This module does the same with numpy, ``zlib``
and ``struct``. Every decoder gives the pixels of PIL 12.1's
``np.array(Image.open(path).convert("RGB"))`` bit for bit:

- ``read_image``: the format PIL's ``Image.open`` would take the file for
  (``format_name``: ``image_identify`` tries PIL's openers in their
  fresh-interpreter order, with their accept tests and header checks),
  then its reader: PNG and JPEG here, the others in the decoders beside
  this module (``image_gif``, ``image_bmp`` (BMP, DIB), ``image_tiff``
  with ``image_lab``, ``image_webp`` with ``image_vp8``, ``image_pnm``,
  ``image_ico`` (ICO, CUR), ``image_tga``, ``image_qoi``, ``image_pcx``
  (PCX, DCX), ``image_sgi``, ``image_psd``, ``image_sun``, ``image_msp``,
  ``image_xbm``, ``image_xpm``, ``image_im``, ``image_spider``,
  ``image_pixar``, ``image_mcidas``, ``image_gbr``, ``image_xvthumb``,
  ``image_imt``, ``image_fits``), each bit-equal to PIL's
  ``convert("RGB")`` on what it reads; a format the port does not read, or
  a file PIL cannot identify, raises a ``ValueError`` that names it.
- ``read_png_rgb``: PNG in every colour type and bit depth, non-interlaced
  or Adam7 (each of the seven passes its own filtered image; a pass of an
  image smaller than 8 px may be empty), with the five scanline filters.
  ``tRNS`` is ignored, as ``convert("RGB")`` ignores it. The samples are
  brought to 8 bits as PIL opens and converts them:

  - 16-bit RGB, RGBA and greyscale + alpha keep the high byte of each
    sample (PIL's ``RGB;16B``, ``RGBA;16B`` and ``LA;16B`` unpackers:
    256 -> 1, 4095 -> 15, 65535 -> 255); alpha is dropped;
  - 16-bit greyscale opens as ``I;16``, whose conversion clamps:
    min(v, 255) (256, 300 and 4095 all -> 255);
  - 1-bit greyscale opens as mode ``1``: 0 or 255; 2- and 4-bit greyscale
    are scaled by 85 and 17 (PIL's ``L;2`` and ``L;4``);
  - palette indices of 1, 2, 4 or 8 bits are looked up (an index past the
    palette gives black); greyscale is repeated into R, G and B.
- ``read_jpeg_rgb``: baseline and extended-sequential Huffman JPEG with
  8-bit samples (SOF0, SOF1), greyscale or three components at any integral
  sampling (1x1, 2x1, 2x2, ...), restart intervals, tables anywhere before
  their scan, one or several scans. It follows libjpeg-turbo's defaults,
  which PIL's decoder keeps: the integer "islow" IDCT of ``jidctint.c``
  (its constants, its pass-1 and pass-2 rounding and descale, and the
  range-limit table), fancy (triangle) upsampling of 2x1, 1x2 and 2x2
  chroma with the edge samples repeated (box replication where a
  downsampled width is 2 or less, and for other ratios), and the
  fixed-point YCbCr -> RGB tables of ``jdcolor.c``. The colour space is
  libjpeg's guess: YCbCr under a JFIF marker; else the Adobe APP14
  transform flag (0: RGB, no conversion); else component ids 'R', 'G', 'B'
  mean RGB. The IDCT, upsampling and colour conversion run over all blocks
  at once in numpy; only the Huffman decoder is a Python loop (over a
  16-bit lookup table). Progressive Huffman JPEG (SOF2) fills the same
  coefficient arrays scan by scan, as libjpeg's ``jdphuff.c``: DC first
  and refinement scans (interleaved or not), AC first scans over a band
  with end-of-band runs carried from block to block, AC refinement scans
  (correction bits, new coefficients of +-1 past the zero run), each
  restart resetting the runs and the DC predictions; a non-interleaved
  scan covers only the component's own blocks. A complete file then goes
  through the same IDCT; where some of the first ten coefficients' bits
  never arrive, the blocks are first smoothed as libjpeg smooths them
  (``image_jpeg_smooth``). A file that ends before its EOI marker raises
  (PIL raises "image file is truncated"). Four components are CMYK or YCCK as libjpeg guesses
  (the Adobe APP14 transform 2, or another non-zero one, means YCCK,
  turned into CMYK by ``ycck_cmyk_convert``: 255 minus the YCbCr -> RGB
  value, K kept; transform 0 or no Adobe marker means CMYK); PIL opens
  every four-component JPEG inverted (``CMYK;I``), then its ``cmyk2rgb``
  gives each channel clip(nk - nk * c / 255) with nk = 255 - K in its
  rounded fixed point. Lossless frames (SOF3, ``image_jpeg_lossless``)
  and arithmetic-coded ones (SOF9, SOF10, ``image_jpeg_arith``, with the
  DAC segment's conditioning) fill the same planes or coefficients;
  ``decode_jpeg`` takes a stream's bytes with a colour space from the
  caller (JPEG-in-TIFF). Hierarchical frames, arithmetic-coded lossless
  (SOF11) and 12-bit samples raise a ``ValueError`` that names them, as
  PIL fails on them.
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
import re
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_SIGNATURE = b"\xff\xd8\xff"
# PNG colour types: (name, samples per pixel, allowed bit depths)
_COLOR_TYPES = {0: ("greyscale", 1, (1, 2, 4, 8, 16)), 2: ("RGB", 3, (8, 16)),
                3: ("palette", 1, (1, 2, 4, 8)), 4: ("greyscale + alpha", 2, (8, 16)),
                6: ("RGBA", 4, (8, 16))}
# Adam7 passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


# PIL's format name -> (module beside this one, reader); PNG and JPEG are here
_READERS = {"PNG": ("image_io", "read_png_rgb"), "JPEG": ("image_io", "read_jpeg_rgb"),
            "DIB": ("image_bmp", "read_dib_rgb"), "WEBP": ("image_webp", "read_webp_rgb"),
            "PPM": ("image_pnm", "read_pnm_rgb"), "CUR": ("image_ico", "read_ico_rgb"),
            "DCX": ("image_pcx", "read_pcx_rgb")}
_READERS.update({name: (f"image_{name.lower()}", f"read_{name.lower()}_rgb") for name in (
    "GIF", "BMP", "TIFF", "ICO", "TGA", "QOI", "PCX", "SGI", "PSD", "SUN", "MSP", "XBM", "XPM",
    "IM", "SPIDER", "PIXAR", "MCIDAS", "GBR", "XVThumb", "IMT", "FITS")})
READ_FORMATS = ("PNG, JPEG, GIF, BMP, DIB, TIFF, WebP, Netpbm, ICO, CUR, TGA, QOI, PCX, DCX, "
                "SGI, PSD, SUN, MSP, XBM, XPM, IM, SPIDER, PIXAR, McIdas, GBR, XV thumbnails, "
                "IMT and FITS")


def format_name(path: str) -> str:
    """The format PIL's ``Image.open`` takes the file for (its ``format``;
    ``image_identify``)."""
    from .image_identify import Unidentified, identify

    with open(path, "rb") as f:
        data = f.read()
    try:
        return identify(data, path)
    except Unidentified:
        if data[:1] == b"P" and data[1:2] in (b"7", b"F"):  # PAM and colour PFM
            from .image_pnm import read_magic

            raise ValueError(f"{path}: Netpbm magic {read_magic(data)[0]!r} is not one PIL opens "
                             f"(cannot identify image file)") from None
        raise


def _kind(data: bytes) -> str:
    from .image_identify import identify

    try:
        return identify(data, "")
    except ValueError:
        return "unknown"


def read_image(path: str) -> np.ndarray:
    """An image file as (H, W, 3) uint8 RGB, as PIL's
    ``Image.open(path).convert("RGB")`` (see the module docstring)."""
    import importlib

    kind = format_name(path)
    if kind not in _READERS:
        raise ValueError(f"{path}: {kind} image, a format the port does not read yet (it reads "
                         f"{READ_FORMATS})")
    module, name = _READERS[kind]
    reader = getattr(importlib.import_module(f".{module}", __package__), name)
    try:
        return reader(path)
    except (struct.error, zlib.error) as e:  # data that ends inside a field
        raise ValueError(f"{path}: truncated or corrupt {kind} data ({e})") from None


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


def _unfilter(raw: bytes, offset: int, height: int, stride: int, bpp: int) -> np.ndarray:
    """The scanlines at ``raw[offset:]`` with their filters undone,
    (height, stride) uint8."""
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.int64)
    if offset + height * (stride + 1) > len(raw):
        raise ValueError("PNG image data is shorter than its header says")
    for y in range(height):
        start = offset + y * (stride + 1)
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


def _samples(rows: np.ndarray, width: int, channels: int, bits: int) -> np.ndarray:
    """Unfiltered scanlines -> (H, width, channels) samples as uint16,
    16-bit ones big-endian, sub-byte ones packed high bit first."""
    h = rows.shape[0]
    if bits == 16:
        return (rows[:, :width * channels * 2].reshape(h, -1, 2).astype(np.uint16)
                @ np.array([256, 1], np.uint16)).reshape(h, width, channels)
    if bits == 8:
        return rows[:, :width * channels].reshape(h, width, channels).astype(np.uint16)
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << bits) - 1)
    return vals.reshape(h, -1)[:, :width * channels].reshape(h, width, channels).astype(
        np.uint16)


def _png_samples(raw: bytes, width: int, height: int, channels: int, bits: int,
                 interlace: int) -> np.ndarray:
    """Every pixel's samples, (H, W, channels) uint16, from the
    decompressed image data, Adam7 passes scattered into place."""
    bpp = max(1, channels * bits // 8)

    def image(offset, w, h):
        stride = (w * channels * bits + 7) // 8
        rows = _unfilter(raw, offset, h, stride, bpp)
        return _samples(rows, w, channels, bits), offset + h * (stride + 1)

    if not interlace:
        return image(0, width, height)[0]
    out = np.zeros((height, width, channels), np.uint16)
    offset = 0
    for x0, y0, dx, dy in _ADAM7:
        w, h = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if w <= 0 or h <= 0:  # an empty pass has no scanlines at all
            continue
        out[y0::dy, x0::dx], offset = image(offset, w, h)
    return out


def read_png_rgb(path: str) -> np.ndarray:
    """A PNG file as (H, W, 3) uint8 RGB (see the module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_png(data, path)


def decode_png(data: bytes, path: str) -> np.ndarray:
    """A PNG file's bytes as (H, W, 3) uint8 RGB."""
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: {_kind(data)} file, not a PNG")
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
    kind, channels, depths = _COLOR_TYPES[ctype]
    if bits not in depths:
        raise ValueError(f"{path}: {bits}-bit {kind} is not a valid PNG bit depth")
    if interlace not in (0, 1):
        raise ValueError(f"{path}: PNG interlace method {interlace} is not a valid one")
    px = _png_samples(zlib.decompress(b"".join(idat)), width, height, channels, bits,
                      interlace)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without a PLTE chunk")
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(palette)] = palette[:256]
        return pal[px[:, :, 0]]
    if bits == 16:
        if ctype == 0:  # I;16 -> RGB clamps
            px = np.minimum(px, 255)
        else:  # the high byte
            px = px >> 8
    elif ctype == 0 and bits < 8:  # "1" -> 0/255; L;2 x 85; L;4 x 17
        px = px * (255 // ((1 << bits) - 1))
    px = px.astype(np.uint8)
    if ctype in (0, 4):  # greyscale (+ alpha, dropped)
        return np.repeat(px[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(px[:, :, :3])


# ------------------------------------------------------------------- JPEG
def _natural_order() -> np.ndarray:
    """libjpeg's ``jpeg_natural_order``: the zigzag position k -> the
    row-major index of the coefficient."""
    order = []
    for s in range(15):
        rows = range(min(s, 7), max(0, s - 7) - 1, -1) if s % 2 == 0 else \
            range(max(0, s - 7), min(s, 7) + 1)
        order += [r * 8 + (s - r) for r in rows]
    return np.asarray(order)


_ZIGZAG = _natural_order()
# jidctint.c's fixed-point constants (CONST_BITS 13) and its descale shifts
_CONST_BITS, _PASS1_BITS = 13, 2
# the post-IDCT range-limit table of jdmaster.c, indexed by the descaled
# value & 1023: x + 128 clamped to [0, 255] for x in [-512, 511]
_IDCT_LIMIT = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384),
                              np.arange(0, 128)]).astype(np.uint8)
_SOF_NAMES = {0xC3: "lossless JPEG (SOF3)",
              0xC5: "hierarchical JPEG (SOF5)", 0xC6: "hierarchical progressive JPEG (SOF6)",
              0xC7: "hierarchical lossless JPEG (SOF7)",
              0xC9: "arithmetic-coded JPEG (SOF9)", 0xCA: "arithmetic-coded progressive JPEG "
              "(SOF10)", 0xCB: "arithmetic-coded lossless JPEG (SOF11)",
              0xCD: "arithmetic-coded hierarchical JPEG (SOF13)",
              0xCE: "arithmetic-coded hierarchical JPEG (SOF14)",
              0xCF: "arithmetic-coded hierarchical JPEG (SOF15)"}
# the frames read besides SOF0-SOF2: lossless Huffman, arithmetic-coded
_SOF_READ = (0xC3, 0xC9, 0xCA)
_SCAN_END = re.compile(rb"\xff[^\x00\xd0-\xd7\xff]")
_RESTART = re.compile(rb"\xff+[\xd0-\xd7]")


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _huffman_lut(counts: bytes, symbols: bytes) -> List[int]:
    """A 65536-entry table of a DHT table: the 16 bits that start with a
    code -> (code length << 8) | symbol; 0 where no code starts."""
    if sum(counts) > len(symbols):
        raise ValueError("truncated JPEG data: a Huffman table ends before its symbols")
    lut = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length:
                raise ValueError("JPEG Huffman table with more codes than fit")
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code, k = code + 1, k + 1
        code <<= 1
    return lut.tolist()


def _peek16(segment: bytes) -> List[int]:
    """The 16 bits that start at every bit of ``segment`` (stuffed zero
    bytes removed), zero bits past its end, as libjpeg reads them."""
    b = np.frombuffer(segment + b"\x00" * 4, np.uint8).astype(np.uint32)
    v24 = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]
    return ((v24[:, None] >> np.arange(8, 0, -1, dtype=np.uint32)) & 0xFFFF).reshape(
        -1).tolist()


def _decode_blocks(w16: List[int], slots, coefs: List[List[int]], preds: List[int]) -> None:
    """Huffman-decode the blocks ``slots`` ((component, first index in its
    zigzag coefficient list, DC table, AC table) each) from one
    entropy-coded segment, DC predictions in ``preds``."""
    p = 0
    for ci, base, dc, ac in slots:
        out = coefs[ci]
        e = dc[w16[p]]
        if not e:
            raise ValueError("corrupt JPEG data: no Huffman code for a DC value")
        p += e >> 8
        s = e & 15
        if s:
            v = w16[p] >> (16 - s)
            p += s
            if v < 1 << (s - 1):
                v += 1 - (1 << s)
            preds[ci] += v
        out[base] = preds[ci]
        k = 1
        while k < 64:
            e = ac[w16[p]]
            if not e:
                raise ValueError("corrupt JPEG data: no Huffman code for an AC value")
            p += e >> 8
            r, s = (e >> 4) & 15, e & 15
            if s:
                k += r
                if k > 63:
                    raise ValueError("corrupt JPEG data: AC run past the block")
                v = w16[p] >> (16 - s)
                p += s
                if v < 1 << (s - 1):
                    v += 1 - (1 << s)
                out[base + k] = v
                k += 1
            elif r == 15:
                k += 16
            else:
                break


def _dc_first(w16: List[int], slots, coefs: List[List[int]], preds: List[int], al: int) -> None:
    """A progressive DC first scan: each block's DC difference, the
    prediction shifted left by ``al`` (``decode_mcu_DC_first``)."""
    p = 0
    for ci, base, dc, _ in slots:
        e = dc[w16[p]]
        if not e:
            raise ValueError("corrupt JPEG data: no Huffman code for a DC value")
        p += e >> 8
        s = e & 15
        if s:
            v = w16[p] >> (16 - s)
            p += s
            if v < 1 << (s - 1):
                v += 1 - (1 << s)
            preds[ci] += v
        coefs[ci][base] = preds[ci] << al


def _dc_refine(w16: List[int], slots, coefs: List[List[int]], al: int) -> None:
    """A progressive DC refinement scan: one bit per block, OR-ed in at
    ``al`` (``decode_mcu_DC_refine``)."""
    bit = 1 << al
    for p, (ci, base, _, _) in enumerate(slots):
        if w16[p] >> 15:
            coefs[ci][base] |= bit


def _ac_first(w16: List[int], slots, coefs: List[List[int]], ss: int, se: int,
              al: int) -> None:
    """A progressive AC first scan of band ``ss``..``se`` (one component):
    run/size codes, values shifted left by ``al``, and end-of-band runs
    that skip whole blocks (``decode_mcu_AC_first``)."""
    p = eobrun = 0
    for ci, base, _, ac in slots:
        if eobrun:
            eobrun -= 1
            continue
        out = coefs[ci]
        k = ss
        while k <= se:
            e = ac[w16[p]]
            if not e:
                raise ValueError("corrupt JPEG data: no Huffman code for an AC value")
            p += e >> 8
            r, s = (e >> 4) & 15, e & 15
            if s:
                k += r
                if k > se:
                    raise ValueError("corrupt JPEG data: AC run past the band")
                v = w16[p] >> (16 - s)
                p += s
                if v < 1 << (s - 1):
                    v += 1 - (1 << s)
                out[base + k] = v << al
                k += 1
            elif r == 15:
                k += 16
            else:
                eobrun = 1 << r
                if r:
                    eobrun += w16[p] >> (16 - r)
                    p += r
                eobrun -= 1
                break


def _ac_refine(w16: List[int], slots, coefs: List[List[int]], ss: int, se: int,
               al: int) -> None:
    """A progressive AC refinement scan of band ``ss``..``se``: a
    correction bit for each coefficient that is already non-zero, and each
    new coefficient (+-1 at ``al``) placed past its run of zero ones
    (``decode_mcu_AC_refine``)."""
    p1, m1 = 1 << al, -1 << al
    p = eobrun = 0
    for ci, base, _, ac in slots:
        out = coefs[ci]
        k = ss
        if not eobrun:
            while k <= se:
                e = ac[w16[p]]
                if not e:
                    raise ValueError("corrupt JPEG data: no Huffman code for an AC value")
                p += e >> 8
                r, s = (e >> 4) & 15, e & 15
                if s:
                    s = p1 if w16[p] >> 15 else m1
                    p += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += w16[p] >> (16 - r)
                        p += r
                    break
                while k <= se:  # correction bits up to the r-th zero coefficient
                    c = out[base + k]
                    if c:
                        if w16[p] >> 15 and not c & p1:
                            out[base + k] = c + (p1 if c >= 0 else m1)
                        p += 1
                    elif r == 0:
                        break
                    else:
                        r -= 1
                    k += 1
                if s:
                    if k > se:
                        raise ValueError("corrupt JPEG data: AC run past the band")
                    out[base + k] = s
                k += 1
        if eobrun:
            while k <= se:  # the rest of an end-of-band block: corrections only
                c = out[base + k]
                if c:
                    if w16[p] >> 15 and not c & p1:
                        out[base + k] = c + (p1 if c >= 0 else m1)
                    p += 1
                k += 1
            eobrun -= 1


def _idct_1d(x: List[np.ndarray], shift: int) -> List[np.ndarray]:
    """jidctint.c's 1-D pass on the 8 inputs, each descaled by ``shift``."""
    z1 = (x[2] + x[6]) * 4433
    tmp2 = z1 - x[6] * 15137
    tmp3 = z1 + x[2] * 6270
    tmp0 = (x[0] + x[4]) << _CONST_BITS
    tmp1 = (x[0] - x[4]) << _CONST_BITS
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    a0, a1, a2, a3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = a0 + a3, a1 + a2, a0 + a2, a1 + a3
    z5 = (z3 + z4) * 9633
    a0, a1, a2, a3 = a0 * 2446, a1 * 16819, a2 * 25172, a3 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    a0, a1, a2, a3 = a0 + z1 + z3, a1 + z2 + z4, a2 + z2 + z3, a3 + z1 + z4
    half = 1 << (shift - 1)
    return [(v + half) >> shift for v in (t10 + a3, t11 + a2, t12 + a1, t13 + a0,
                                          t13 - a0, t12 - a1, t11 - a2, t10 - a3)]


def _idct_islow(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """libjpeg's ``jpeg_idct_islow`` of (N, 64) natural-order coefficients
    with their quantization table: (N, 8, 8) uint8 samples."""
    c = (coefs.astype(np.int64) * quant.astype(np.int64)).reshape(-1, 8, 8)
    ws = _idct_1d([c[:, r, :] for r in range(8)], _CONST_BITS - _PASS1_BITS)  # columns
    ws = np.stack(ws, axis=1)  # (N, row, col)
    out = _idct_1d([ws[:, :, k] for k in range(8)], _CONST_BITS + _PASS1_BITS + 3)
    return _IDCT_LIMIT[np.stack(out, axis=2) & 1023]


def _fancy_h2(p: np.ndarray, near: int, far: int, scale: int) -> np.ndarray:
    """Double the columns of ``p`` (int64 sums) by the triangle filter of
    jdsample.c: out[2j] = (3p[j] + p[j-1] + near) >> scale, out[2j+1] =
    (3p[j] + p[j+1] + far) >> scale, the edge columns repeated."""
    left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
    right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
    out = np.empty((p.shape[0], 2 * p.shape[1]), np.int64)
    out[:, 0::2] = (3 * p + left + near) >> scale
    out[:, 1::2] = (3 * p + right + far) >> scale
    return out


def _v2_sums(p: np.ndarray) -> np.ndarray:
    """The rows of ``p`` doubled as 3 x nearer + farther (the vertical
    half of h2v2 and h1v2 fancy upsampling), the edge rows repeated."""
    above = np.concatenate([p[:1], p[:-1]], axis=0)
    below = np.concatenate([p[1:], p[-1:]], axis=0)
    out = np.empty((2 * p.shape[0], p.shape[1]), np.int64)
    out[0::2] = 3 * p + above
    out[1::2] = 3 * p + below
    return out


def _upsample(plane: np.ndarray, h: int, v: int, hmax: int, vmax: int) -> np.ndarray:
    """A component's plane (its downsampled height and width) to full
    size, as libjpeg-turbo's jdsample.c with fancy upsampling on."""
    if (h, v) == (hmax, vmax):
        return plane
    p = plane.astype(np.int64)
    dw = p.shape[1]
    if hmax == 2 * h and vmax == v and dw > 2:
        return _fancy_h2(p, 1, 2, 2)
    if hmax == h and vmax == 2 * v:
        sums = _v2_sums(p)
        sums[0::2] += 1
        sums[1::2] += 2
        return sums >> 2
    if hmax == 2 * h and vmax == 2 * v and dw > 2:
        return _fancy_h2(_v2_sums(p), 8, 7, 4)
    if hmax % h or vmax % v:
        raise ValueError(f"JPEG sampling {h}x{v} of {hmax}x{vmax} is fractional")
    return np.repeat(np.repeat(p, vmax // v, axis=0), hmax // h, axis=1)


def _cmyk_pixels(planes: List[np.ndarray], adobe) -> np.ndarray:
    """Four decoded planes -> RGB as PIL gives it: libjpeg's CMYK (or YCCK
    -> CMYK), PIL's ``CMYK;I`` inversion, then PIL's ``cmyk2rgb``."""
    if adobe is not None and adobe != 0:  # YCCK: inverted CMYK is the YCbCr -> RGB value
        inv = _ycc_to_rgb(*planes[:3]).astype(np.int64)
    else:
        inv = 255 - np.stack(planes[:3], axis=-1).astype(np.int64)
    return cmyk_to_rgb(*np.moveaxis(inv, -1, 0), 255 - planes[3].astype(np.int64))


def cmyk_to_rgb(c: np.ndarray, m: np.ndarray, y: np.ndarray, k: np.ndarray) -> np.ndarray:
    """PIL's ``cmyk2rgb`` of (H, W) int64 samples: each channel
    clip(nk - nk * v / 255) with nk = 255 - K, in its rounded fixed point."""
    nk = 255 - k[:, :, None]
    t = np.stack([c, m, y], axis=-1) * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def band_to_rgb(v: np.ndarray) -> np.ndarray:
    """One band of PIL's ``L``, ``I``, ``I;16`` or ``F`` modes, (H, W), to
    (H, W, 3) uint8 as ``convert("RGB")`` gives it: integers clamped to
    0..255; floats truncated, 0 at or below 0 and for NaN, 255 at or above
    255."""
    if v.dtype.kind == "f":
        v = np.where(v >= 255, 255, np.where(v > 0, np.trunc(np.nan_to_num(v)), 0))
    return np.repeat(np.clip(v, 0, 255).astype(np.uint8)[:, :, None], 3, axis=2)


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert: its fixed-point tables (SCALEBITS 16),
    each channel clamped to [0, 255]."""
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15
    cr_r = (int(1.40200 * 65536 + 0.5) * x + one_half) >> 16
    cb_b = (int(1.77200 * 65536 + 0.5) * x + one_half) >> 16
    cr_g = -int(0.71414 * 65536 + 0.5) * x
    cb_g = -int(0.34414 * 65536 + 0.5) * x + one_half
    y = y.astype(np.int64)
    rgb = np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16), y + cb_b[cb]], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def read_jpeg_rgb(path: str) -> np.ndarray:
    """A baseline, extended sequential or progressive (Huffman, 8-bit)
    JPEG file as (H, W, 3) uint8 RGB (see the module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_JPEG_SIGNATURE):
        raise ValueError(f"{path}: {_kind(data)} file, not a JPEG")
    return decode_jpeg(data, path)


def decode_jpeg(data: bytes, path: str, space: Optional[str] = None, tables: bytes = b"",
                sampling=None) -> np.ndarray:
    """A JPEG stream as (H, W, 3) uint8 RGB. ``space`` None takes the colour
    space from libjpeg's guess, as for a JPEG file; a caller that knows it
    (libtiff passes the TIFF photometric to libjpeg) gives "ycc" (YCbCr,
    converted), "planes" ((H, W, components) samples, no conversion) or
    "replicated" (the same, the subsampled components repeated rather than
    filtered up). ``tables``, an abbreviated tables-only stream
    (TIFF's JPEGTables), is read first, as ``jpeg_read_header(FALSE)``.
    ``sampling`` (h, v), where given, is the first component's sampling the
    caller requires ("any": any), the others' being 1x1, as libtiff
    requires of a strip's stream."""
    qt: Dict[int, np.ndarray] = {}
    huff: Dict[Tuple[int, int], List[int]] = {}
    if tables:
        _jpeg_segments(tables, path, qt, huff, {})
    frame, coefs, jfif, adobe, eoi = _jpeg_segments(data, path, qt, huff, {})
    if frame is None:
        raise ValueError(f"{path}: JPEG without a frame header")
    if sampling is not None:
        factors = [(h, v) for _, h, v, _ in frame["comps"]]
        if (sampling != "any" and factors[0] != tuple(sampling)) or any(
                f != (1, 1) for f in factors[1:]):
            raise ValueError(f"{path}: JPEG sampling factors {factors} where libtiff requires "
                             f"{sampling} for the first component and 1x1 for the others")
    if frame["progressive"]:
        if not eoi:
            raise ValueError(f"{path}: truncated JPEG data: the file ends before its EOI "
                             f"marker")
        frame["smooth"] = _smoothing_ok(frame)
    return _jpeg_pixels(frame, coefs, jfif, adobe, space)


def _jpeg_segments(data: bytes, path: str, qt: Dict[int, np.ndarray],
                   huff: Dict[Tuple[int, int], List[int]], cond: dict):
    """Read a JPEG stream's markers and scans into ``qt``, ``huff``, ``cond``
    (the DAC conditioning: (0, table) -> (L, U), (1, table) -> Kx) and the
    coefficients (or, lossless, ``frame["samples"]``): (frame or None,
    coefficients, JFIF marker seen, Adobe transform or None, EOI reached)."""
    from . import image_jpeg_lossless

    frame = None
    restart, jfif, adobe, eoi = 0, False, None, False
    coefs: List[List[int]] = []
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"{path}: corrupt JPEG: no marker at byte {pos}")
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            eoi = True
            break
        if marker == 0x01 or 0xD0 <= marker <= 0xD8:  # TEM, RSTn, SOI: no length
            continue
        if pos + 2 > len(data) or pos + struct.unpack(">H", data[pos:pos + 2])[0] > len(data):
            raise ValueError(f"{path}: truncated JPEG data: a marker segment ends past the "
                             f"end of the file")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + length]
        pos += length
        if marker in _SOF_NAMES and marker not in _SOF_READ:
            raise ValueError(f"{path}: {_SOF_NAMES[marker]} is not read by the port "
                             f"(baseline, extended sequential, progressive and lossless "
                             f"Huffman and sequential and progressive arithmetic-coded JPEG "
                             f"only)")
        if marker == 0xCC:  # DAC: conditioning of arithmetic-coding tables
            for i in range(0, len(seg) - 1, 2):
                tc, tb, cs = seg[i] >> 4, seg[i] & 15, seg[i + 1]
                if tc == 0 and (cs & 15) > cs >> 4:
                    raise ValueError(f"{path}: corrupt JPEG DAC value {cs}")
                cond[(tc, tb)] = (cs & 15, cs >> 4) if tc == 0 else cs
        if marker in (0xC0, 0xC1, 0xC2) or marker in _SOF_READ:
            precision, height, width, n = struct.unpack(">BHHB", seg[:6])
            if precision != 8:
                raise ValueError(f"{path}: {precision}-bit JPEG is not read by the port "
                                 f"(8-bit samples only)")
            if n not in (1, 3, 4):
                raise ValueError(f"{path}: JPEG with {n} components is not read by the port")
            if height == 0 or width == 0:
                raise ValueError(f"{path}: JPEG with its height in a DNL marker is not read")
            comps = [(seg[6 + 3 * i], seg[7 + 3 * i] >> 4, seg[7 + 3 * i] & 15, seg[8 + 3 * i])
                     for i in range(n)]
            hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
            mcux, mcuy = _ceil_div(width, 8 * hmax), _ceil_div(height, 8 * vmax)
            frame = {"width": width, "height": height, "comps": comps, "hmax": hmax,
                     "vmax": vmax, "mcux": mcux, "mcuy": mcuy, "quant": [None] * n,
                     "progressive": marker in (0xC2, 0xCA), "arith": marker in (0xC9, 0xCA),
                     "lossless": marker == 0xC3, "precision": precision, "samples": {},
                     # the bits each zigzag coefficient has so far (-1: none)
                     "coef_bits": [[-1] * 64 for _ in range(n)]}
            coefs = [[0] * (mcuy * v * mcux * h * 64) for _, h, v, _ in comps]
        elif marker == 0xC4:  # DHT: one or more tables
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = seg[i + 1:i + 17]
                total = sum(counts)
                huff[(tc, th)] = _huffman_lut(counts, seg[i + 17:i + 17 + total])
                i += 17 + total
        elif marker == 0xDB:  # DQT: 8- or 16-bit tables, zigzag order
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                size = 128 if pq else 64
                vals = np.frombuffer(seg[i + 1:i + 1 + size], ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int64)
                table[_ZIGZAG] = vals
                qt[tq] = table
                i += 1 + size
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xE0 and seg.startswith(b"JFIF\x00") and length >= 16:
            jfif = True
        elif marker == 0xEE and seg.startswith(b"Adobe") and length >= 14:
            adobe = seg[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{path}: JPEG scan before its frame header")
            end = _SCAN_END.search(data, pos)
            if end is None and frame["arith"]:  # libjpeg reads on into the marker
                raise ValueError(f"{path}: truncated JPEG data: an arithmetic-coded scan runs "
                                 f"to the end of the file")
            end = len(data) if end is None else end.start()
            if frame["lossless"]:
                scan = data[pos:end]
                parts = _RESTART.split(scan) if restart else [scan]
                image_jpeg_lossless.decode_scan(
                    frame, seg, [p.replace(b"\xff\x00", b"\xff") for p in parts], huff,
                    restart, _peek16)
            else:
                _decode_scan(frame, seg, data[pos:end], qt, huff, restart, coefs, cond)
            pos = end
    return frame, coefs, jfif, adobe, eoi


# zigzag positions of the coefficients libjpeg's block smoothing estimates
# (jdcoefct.c SAVED_COEFS: DC and the first nine AC), and their natural
# positions, whose quantizers must be non-zero for it
_SMOOTHED = range(1, 10)
_SMOOTHED_NATURAL = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24]


def _smoothing_ok(frame: dict) -> bool:
    """libjpeg's ``smoothing_ok``: it smooths the blocks of a progressive
    image (``image_jpeg_smooth``) where every component has its DC and
    non-zero quantizers for the first ten coefficients, and some of the
    first nine AC coefficients still lack bits."""
    for quant, bits in zip(frame["quant"], frame["coef_bits"]):
        if quant is None or bits[0] < 0 or not all(quant[_SMOOTHED_NATURAL]):
            return False
    return any(bits[k] != 0 for bits in frame["coef_bits"] for k in _SMOOTHED)


def _decode_scan(frame: dict, header: bytes, scan: bytes, qt, huff, restart: int,
                 coefs: List[List[int]], cond: Optional[dict] = None) -> None:
    """Huffman- or arithmetic-decode one scan into ``coefs`` (each component's
    blocks, zigzag order, in the padded MCU grid)."""
    comps = frame["comps"]
    ids = [c[0] for c in comps]
    n = header[0]
    if len(header) < 4 + 2 * n:
        raise ValueError("corrupt JPEG data: a scan header shorter than its component count")
    ss, se, ah, al = header[1 + 2 * n], header[2 + 2 * n], header[3 + 2 * n] >> 4, \
        header[3 + 2 * n] & 15
    progressive = frame["progressive"]
    if progressive and (ss > se or se > 63 or al > 13 or (ah and al != ah - 1)
                        or (ss == 0 and se != 0) or (ss and n != 1)):
        raise ValueError(f"corrupt JPEG data: invalid progressive scan Ss={ss} Se={se} "
                         f"Ah={ah} Al={al} over {n} components")
    # the tables the scan needs: both in a sequential scan; DC in a DC first
    # scan, none in a DC refinement, AC in an AC scan
    need_dc = not progressive or (ss == 0 and ah == 0)
    need_ac = not progressive or ss > 0
    members = []
    for i in range(n):
        cid, tables = header[1 + 2 * i], header[2 + 2 * i]
        ci = ids.index(cid)
        if frame["arith"]:  # the tables' numbers: statistics bins and DAC conditioning
            dc, ac = tables >> 4, tables & 15
        else:
            dc, ac = huff.get((0, tables >> 4)), huff.get((1, tables & 15))
            if (need_dc and dc is None) or (need_ac and ac is None):
                raise ValueError("JPEG scan uses a Huffman table it does not define")
        members.append((ci, dc, ac))
        if frame["quant"][ci] is None:  # latched at the component's first scan
            frame["quant"][ci] = qt.get(comps[ci][3])
        if progressive:
            bits = frame["coef_bits"][ci]
            for k in range(ss, se + 1):
                bits[k] = al
    mcux, mcuy = frame["mcux"], frame["mcuy"]
    slots = []
    if n == 1:  # non-interleaved: the component's own blocks, row by row
        ci, dc, ac = members[0]
        _, h, v, _ = comps[ci]
        bw = _ceil_div(_ceil_div(frame["width"] * h, frame["hmax"]), 8)
        bh = _ceil_div(_ceil_div(frame["height"] * v, frame["vmax"]), 8)
        stride = mcux * h
        slots = [(ci, (by * stride + bx) * 64, dc, ac) for by in range(bh) for bx in range(bw)]
        per_mcu = 1
    else:
        per_mcu = sum(comps[ci][1] * comps[ci][2] for ci, _, _ in members)
        for my in range(mcuy):
            for mx in range(mcux):
                for ci, dc, ac in members:
                    _, h, v, _ = comps[ci]
                    stride = mcux * h
                    for yy in range(v):
                        for xx in range(h):
                            slots.append((ci, ((my * v + yy) * stride + mx * h + xx) * 64,
                                          dc, ac))
    segments = _RESTART.split(scan) if restart else [scan]
    if frame["arith"]:
        from . import image_jpeg_arith

        image_jpeg_arith.decode_scan(frame, members, segments, restart, per_mcu, slots, coefs,
                                     ss, se, ah, al, cond or {})
        return
    chunk = restart * per_mcu if restart else len(slots)
    for i in range(0, len(slots), chunk):
        seg = segments[i // chunk] if i // chunk < len(segments) else b""
        w16, part = _peek16(seg.replace(b"\xff\x00", b"\xff")), slots[i:i + chunk]
        try:  # DC predictions and end-of-band runs start from 0 after each restart
            if not progressive:
                _decode_blocks(w16, part, coefs, [0] * len(comps))
            elif ss == 0 and ah == 0:
                _dc_first(w16, part, coefs, [0] * len(comps), al)
            elif ss == 0:
                _dc_refine(w16, part, coefs, al)
            elif ah == 0:
                _ac_first(w16, part, coefs, ss, se, al)
            else:
                _ac_refine(w16, part, coefs, ss, se, al)
        except IndexError:
            raise ValueError("truncated JPEG data: the scan ends early") from None


def _jpeg_pixels(frame: dict, coefs: List[List[int]], jfif: bool, adobe,
                 space: Optional[str] = None) -> np.ndarray:
    """IDCT, upsampling and colour conversion of the decoded coefficients
    (``space``: see ``decode_jpeg``)."""
    from . import image_jpeg_lossless, image_jpeg_smooth

    width, height, comps = frame["width"], frame["height"], frame["comps"]
    hmax, vmax, mcux, mcuy = frame["hmax"], frame["vmax"], frame["mcux"], frame["mcuy"]
    planes = image_jpeg_lossless.planes(frame) if frame["lossless"] else []
    for ci, (_, h, v, tq) in enumerate([] if frame["lossless"] else comps):
        quant = frame["quant"][ci]
        if quant is None:
            raise ValueError("JPEG component with no scan or no quantization table")
        zz = np.asarray(coefs[ci], np.int64).reshape(-1, 64)
        nat = np.empty_like(zz)
        nat[:, _ZIGZAG] = zz
        dh, dw = _ceil_div(height * v, vmax), _ceil_div(width * h, hmax)
        if frame.get("smooth"):  # the component's own blocks, not the MCU padding
            grid = nat.reshape(mcuy * v, mcux * h, 64)
            bh, bw = _ceil_div(dh, 8), _ceil_div(dw, 8)
            grid[:bh, :bw] = image_jpeg_smooth.smooth(grid.copy(), bh, bw, v, quant,
                                                      frame["coef_bits"][ci][:10])
        blocks = _idct_islow(nat, quant).reshape(mcuy * v, mcux * h, 8, 8)
        plane = blocks.transpose(0, 2, 1, 3).reshape(mcuy * v * 8, mcux * h * 8)
        if space == "replicated":  # libtiff's data units: chroma repeated, not filtered
            if hmax % h or vmax % v:
                raise ValueError(f"JPEG sampling {h}x{v} of {hmax}x{vmax} is fractional")
            planes.append(np.repeat(np.repeat(plane[:dh, :dw], vmax // v, axis=0), hmax // h,
                                    axis=1)[:height, :width])
        else:
            planes.append(_upsample(plane[:dh, :dw], h, v, hmax, vmax)[:height, :width])
    if space in ("planes", "replicated"):
        return np.stack([p.astype(np.uint8) for p in planes], axis=-1)
    if space is not None:  # "ycc"
        if len(planes) != 3:
            raise ValueError(f"YCbCr JPEG data with {len(planes)} components")
        return _ycc_to_rgb(*planes)
    if len(planes) == 1:
        return np.repeat(planes[0].astype(np.uint8)[:, :, None], 3, axis=2)
    if len(planes) == 4:
        if frame["lossless"] and adobe not in (None, 0):
            raise ValueError("lossless YCCK JPEG: libjpeg-turbo does not convert its colour, and "
                             "PIL fails on it")
        return _cmyk_pixels(planes, adobe)
    ids = [c[0] for c in comps]
    if frame["lossless"]:  # libjpeg-turbo takes RGB but under JFIF or an Adobe transform
        if jfif or adobe not in (None, 0):
            raise ValueError("lossless JPEG in YCbCr (a JFIF marker or an Adobe transform): "
                             "libjpeg-turbo does not convert its colour, and PIL fails on it")
        rgb_space = True
    elif jfif:
        rgb_space = False
    elif adobe is not None:
        rgb_space = adobe == 0
    else:
        rgb_space = ids == [82, 71, 66]  # 'R', 'G', 'B'
    if rgb_space:
        return np.stack([p.astype(np.uint8) for p in planes], axis=-1)
    return _ycc_to_rgb(*planes)


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
    """An RGB image (a path ``read_image`` reads, or an (H, W, 3+) uint8 array) ->
    (1, 3, H, W) float32 in [-1, 1]: crop, centre square, resize to
    ``resize`` = (width, height)."""
    if isinstance(image_path, str):
        image = read_image(image_path)
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
