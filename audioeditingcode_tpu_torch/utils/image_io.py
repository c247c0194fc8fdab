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
  ``image_imt``, ``image_fits``, ``image_fli``, ``image_pcd``,
  ``image_iptc``, ``image_dds``, ``image_ftex`` and ``image_blp`` with
  ``image_bcn``, ``image_icns``, ``image_jpeg2000`` with ``image_j2k_t1``
  and ``image_j2k_dwt``), each bit-equal to PIL's
  ``convert("RGB")`` on what it reads; a format the port does not read, or
  a file PIL cannot identify, raises a ``ValueError`` that names it.
  ``decode_image`` does the same on a file's bytes (each module's
  ``decode_<format>`` takes the bytes).
- ``read_png_rgb``: PNG in every colour type and bit depth, non-interlaced
  or Adam7 (each of the seven passes its own filtered image; a pass of an
  image smaller than 8 px may be empty), with the five scanline filters.
  The data is inflated scanline by scanline as PIL's decoder does
  (``inflate_idat``): a stream cut or corrupt after the last scanline
  still reads, and one whose end comes with an earlier scanline leaves
  the scanlines after it at 0.
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
  (its constants, its pass-1 and pass-2 rounding and descale) as its x86
  SIMD version computes it, with 16-bit lanes that wrap and saturate where
  corrupt or zero-filled data leaves 16 bits, fancy (triangle) upsampling of 2x1, 1x2 and 2x2
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
  caller (JPEG-in-TIFF; there also 12-bit sequential frames, tables kept
  across a file's streams and data that ends early, as libtiff hands them
  to libjpeg). Damaged entropy-coded data reads as libjpeg-turbo reads it
  under PIL (``image_jpeg_stream``: markers, restart resynchronisation,
  data that runs out, PIL's 64 KiB reads; ``image_jpeg_exact``: its bit
  reader byte for byte where that shows; bad codes, runs past the block).
  Hierarchical frames, arithmetic-coded lossless (SOF11) and
  12-bit samples in a JPEG file raise a ``ValueError`` that names them, as
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

import functools
import math
import re
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from .image_jpeg_stream import CHUNK, STD_HUFFMAN, Source, Truncated, intervals

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_SIGNATURE = b"\xff\xd8\xff"
# PNG colour types: (name, samples per pixel, allowed bit depths)
_COLOR_TYPES = {0: ("greyscale", 1, (1, 2, 4, 8, 16)), 2: ("RGB", 3, (8, 16)),
                3: ("palette", 1, (1, 2, 4, 8)), 4: ("greyscale + alpha", 2, (8, 16)),
                6: ("RGBA", 4, (8, 16))}
# Adam7 passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


# PIL's format name -> (module beside this one, decoder of the file's bytes)
_READERS = {"PNG": ("image_io", "decode_png"), "JPEG": ("image_io", "decode_jpeg_file"),
            "DIB": ("image_bmp", "decode_dib"), "WEBP": ("image_webp", "decode_webp"),
            "PPM": ("image_pnm", "decode_pnm"), "CUR": ("image_ico", "decode_ico"),
            "DCX": ("image_pcx", "decode_pcx")}
_READERS.update({name: (f"image_{name.lower()}", f"decode_{name.lower()}") for name in (
    "GIF", "BMP", "TIFF", "ICO", "TGA", "QOI", "PCX", "SGI", "PSD", "SUN", "MSP", "XBM", "XPM",
    "IM", "SPIDER", "PIXAR", "MCIDAS", "GBR", "XVThumb", "IMT", "FITS", "FLI", "PCD", "IPTC",
    "DDS", "FTEX", "BLP", "ICNS", "JPEG2000")})
READ_FORMATS = ("PNG, JPEG, GIF, BMP, DIB, TIFF, WebP, Netpbm, ICO, CUR, TGA, QOI, PCX, DCX, "
                "SGI, PSD, SUN, MSP, XBM, XPM, IM, SPIDER, PIXAR, McIdas, GBR, XV thumbnails, "
                "IMT, FITS, FLI, PCD, IPTC, DDS, FTEX, BLP, ICNS and JPEG 2000")


def format_name(path: str) -> str:
    """The format PIL's ``Image.open`` takes the file for (its ``format``;
    ``image_identify``)."""
    with open(path, "rb") as f:
        return _format_name(f.read(), path)


def _format_name(data: bytes, path: str) -> str:
    from .image_identify import Unidentified, identify

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
    with open(path, "rb") as f:
        return decode_image(f.read(), path)


def decode_image(data: bytes, path: str) -> np.ndarray:
    """``read_image`` on a file's bytes, as PIL's ``Image.open`` of a file
    object (``path`` names it in errors)."""
    import importlib

    kind = _format_name(data, path)
    if kind not in _READERS:
        raise ValueError(f"{path}: {kind} image, a format the port does not read yet (it reads "
                         f"{READ_FORMATS})")
    module, name = _READERS[kind]
    decoder = getattr(importlib.import_module(f".{module}", __package__), name)
    try:
        return decoder(data, path)
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


def _png_rows(width: int, height: int, channels: int, bits: int, interlace: int) -> List[int]:
    """The bytes of each filtered scanline, pass after pass."""
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    rows = []
    for x0, y0, dx, dy in passes:
        w, h = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if w > 0 and h > 0:
            rows += [(w * channels * bits + 7) // 8 + 1] * h
    return rows


def inflate_idat(chunks: List[bytes], width: int, height: int, channels: int, bits: int,
                 interlace: int) -> Optional[bytes]:
    """PIL's zip decoder over the data of consecutive IDAT chunks, fed as
    its loader reads them (each chunk in pieces of up to 65536 bytes): it
    inflates one scanline at a time and stops after the last one, or after
    the one whose inflate call met the stream's end (the scanlines after it
    stay 0). Returns every scanline's bytes, or None where the chunks end
    first (PIL then reads the next chunk header, and fails unless that is
    no chunk name; ``zlib.error`` where the data is corrupt)."""
    rows = _png_rows(width, height, channels, bits, interlace)
    inflate, out, r, left, tail = zlib.decompressobj(), bytearray(), 0, rows[0], b""
    for chunk in chunks:
        for start in range(0, len(chunk), 65536):
            data = tail + chunk[start:start + 65536]
            while data:
                got = inflate.decompress(data, left)
                data = inflate.unconsumed_tail
                out += got
                left -= len(got)
                if left:
                    break  # needs more input
                r += 1
                if r == len(rows) or inflate.eof:
                    return bytes(out) + bytes(sum(rows) - len(out))
                left = rows[r]
            tail = data
    return None


# PIL's PNG modes: (bit depth, colour type)
_PNG_MODES = {(1, 0), (2, 0), (4, 0), (8, 0), (16, 0), (8, 2), (16, 2), (1, 3), (2, 3), (4, 3),
              (8, 3), (8, 4), (16, 4), (8, 6), (16, 6)}


def png_header(png: bytes, path: str) -> dict:
    """PIL's ``PngImageFile._open``: its chunk walk up to the first IDAT or
    IEND chunk. A chunk name that is not four word characters, a bad or
    missing CRC, an IHDR filter method other than 0, no mode or a size of
    0 pass the file on (``PassOn``, or ``struct.error`` where a chunk
    header is cut short); a chunk cut short or an IHDR under 13 bytes ends
    ``Image.open``. The other chunks' handlers are not modelled. Returns
    {"ihdr": (width, height, bits, colour type, interlace), "idat": the
    first IDAT chunk's position, None where IEND comes first}."""
    from .image_identify import PassOn, check_size

    pos, ihdr, mode = 8, (0, 0, 0, 0, 0), False
    while True:
        (length,) = struct.unpack(">I", png[pos:pos + 4])
        cid = png[pos + 4:pos + 8]
        if not re.match(rb"\w\w\w\w", cid):
            raise PassOn(f"broken PNG file (chunk {cid!r})")
        if cid in (b"IDAT", b"IEND"):
            break
        pos += 8
        if pos + length > len(png):
            raise ValueError(f"{path}: PNG chunk {cid!r} cut short (PIL fails on it: "
                             f"Truncated File Read)")
        body = png[pos:pos + length]
        if cid == b"IHDR":
            if length < 13:
                raise ValueError(f"{path}: PNG IHDR of {length} bytes (PIL fails on "
                                 f"it: truncated IHDR chunk)")
            ihdr = struct.unpack(">IIBBxxB", body[:13])
            mode = (body[8], body[9]) in _PNG_MODES
            if body[11]:
                raise PassOn("unknown filter category")
        crc = png[pos + length:pos + length + 4]
        if len(crc) < 4 or struct.unpack(">I", crc)[0] != zlib.crc32(cid + body):
            raise PassOn(f"broken PNG file (bad or incomplete checksum in {cid!r})")
        pos += length + 4
    if not mode or ihdr[0] <= 0 or ihdr[1] <= 0:
        raise PassOn("no mode, or a size of 0")
    check_size(ihdr[0], ihdr[1], path)
    return {"ihdr": ihdr, "idat": pos if cid == b"IDAT" else None}


def read_png_rgb(path: str) -> np.ndarray:
    """A PNG file as (H, W, 3) uint8 RGB (see the module docstring)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, path: str) -> np.ndarray:
    """A PNG file's bytes as (H, W, 3) uint8 RGB."""
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: {_kind(data)} file, not a PNG")
    idat, palette, header, last = [], None, None, None
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT" and (not idat or last == b"IDAT"):  # PIL reads the first run
            idat.append(body)
        last = tag
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
    raw = inflate_idat(idat, width, height, channels, bits, interlace)
    if raw is None:
        raise ValueError(f"{path}: PNG image data is shorter than its header says (PIL fails on "
                         f"it: image file is truncated)")
    px = _png_samples(raw, width, height, channels, bits, interlace)
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
# jidctint.c's fixed-point constants (CONST_BITS 13)
_CONST_BITS = 13
# the post-IDCT range-limit table of jdmaster.c at 12 bits, indexed by the
# descaled value & 16383: x + 2048 clamped to [0, 4095] for x in [-8192, 8191]
_IDCT_LIMIT_12 = np.concatenate([np.arange(2048, 4096), np.full(6144, 4095), np.zeros(6144),
                                 np.arange(0, 2048)]).astype(np.uint16)
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
# libjpeg's limit on the blocks of one MCU (D_MAX_BLOCKS_IN_MCU)
_MAX_BLOCKS_IN_MCU = 10
# the bits one block's Huffman codes can take at most, past the data too:
# 64 codes of up to 17 bits (a code no table entry starts) and 15 more
_BLOCK_BITS = 2048


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=64)
def _huffman_lut(counts: bytes, symbols: bytes) -> Tuple[int, ...]:
    """A 65536-entry table of a DHT table: the 16 bits that start with a
    code -> (code length << 8) | symbol; 0 where no code starts (libjpeg
    then takes 17 bits and the value 0: ``JWRN_HUFF_BAD_CODE``). As
    ``jpeg_make_d_derived_tbl``, a table whose codes of some length end on
    the all-ones code, or run past it, is refused."""
    lut = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code, k = code + 1, k + 1
        if k and code >= 1 << length:
            raise ValueError("corrupt JPEG data: a Huffman table with more codes than fit "
                             "(JERR_BAD_HUFF_TABLE)")
        code <<= 1
        if k == len(symbols):
            break
    return tuple(lut.tolist())


def _peek16(segment: bytes, pad: int = 4) -> List[int]:
    """The 16 bits that start at every bit of ``segment`` (stuffed zero
    bytes removed), then zero bits for ``pad`` bytes, as libjpeg reads on
    past a marker."""
    b = np.frombuffer(segment + bytes(max(pad, 3)), np.uint8).astype(np.uint32)
    v24 = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]
    return ((v24[:, None] >> np.arange(8, 0, -1, dtype=np.uint32)) & 0xFFFF).reshape(
        -1).tolist()


def _decode_blocks(w16: List[int], slots, coefs: List[List[int]], nbits: int,
                   per_mcu: int) -> Tuple[int, bool]:
    """Huffman-decode the blocks ``slots`` ((component, first index in its
    zigzag coefficient list, DC table, AC table) each) of one restart
    interval from its ``nbits`` bits of data, DC predictions from 0, as
    libjpeg's ``decode_mcu``: a code no entry starts is 17 bits and the
    value 0, a run past coefficient 63 writes coefficient 63, and an MCU
    that begins past the data is left as it is, and so is every one after
    it. Returns (the MCUs decoded, whether the last of them ran past the
    data)."""
    preds = [0] * len(coefs)
    p = 0
    for i, (ci, base, dc, ac) in enumerate(slots):
        if p > nbits and i % per_mcu == 0:
            return i // per_mcu, True
        out = coefs[ci]
        e = dc[w16[p]]
        if e:
            p += e >> 8
            s = e & 15
            if s:
                v = w16[p] >> (16 - s)
                p += s
                if v < 1 << (s - 1):
                    v += 1 - (1 << s)
                preds[ci] += v
        else:
            p += 17
        out[base] = preds[ci]
        k = 1
        while k < 64:
            e = ac[w16[p]]
            if not e:
                p += 17
                break
            p += e >> 8
            r, s = (e >> 4) & 15, e & 15
            if s:
                k += r
                v = w16[p] >> (16 - s)
                p += s
                if v < 1 << (s - 1):
                    v += 1 - (1 << s)
                out[base + (k if k < 64 else 63)] = v
                k += 1
            elif r == 15:
                k += 16
            else:
                break
    return len(slots) // per_mcu, p > nbits


def _dc_first(w16: List[int], slots, coefs: List[List[int]], nbits: int, per_mcu: int,
              al: int) -> Tuple[int, bool]:
    """A progressive DC first scan: each block's DC difference, the
    prediction shifted left by ``al`` and kept to 16 bits
    (``decode_mcu_DC_first``); past the data as ``_decode_blocks``."""
    preds = [0] * len(coefs)
    p = 0
    for i, (ci, base, dc, _) in enumerate(slots):
        if p > nbits and i % per_mcu == 0:
            return i // per_mcu, True
        e = dc[w16[p]]
        if e:
            p += e >> 8
            s = e & 15
            if s:
                v = w16[p] >> (16 - s)
                p += s
                if v < 1 << (s - 1):
                    v += 1 - (1 << s)
                preds[ci] += v
        else:
            p += 17
        coefs[ci][base] = (((preds[ci] << al) + 32768) & 65535) - 32768
    return len(slots) // per_mcu, p > nbits


def _dc_refine(w16: List[int], slots, coefs: List[List[int]], nbits: int, per_mcu: int,
               al: int) -> Tuple[int, bool]:
    """A progressive DC refinement scan: one bit per block, OR-ed in at
    ``al`` (``decode_mcu_DC_refine``; zero bits past the data change
    nothing)."""
    bit = 1 << al
    for p, (ci, base, _, _) in enumerate(slots[:nbits]):
        if w16[p] >> 15:
            coefs[ci][base] |= bit
    n = len(slots) // per_mcu
    return min(n, nbits // per_mcu + 1), len(slots) > nbits


def _ac_first(w16: List[int], slots, coefs: List[List[int]], nbits: int, ss: int, se: int,
              al: int) -> Tuple[int, bool]:
    """A progressive AC first scan of band ``ss``..``se`` (one component):
    run/size codes, values shifted left by ``al``, and end-of-band runs
    that skip whole blocks (``decode_mcu_AC_first``); a run past ``se``
    writes the coefficient it reaches (63 past the block)."""
    p = eobrun = 0
    for i, (ci, base, _, ac) in enumerate(slots):
        if p > nbits:
            return i, True
        if eobrun:
            eobrun -= 1
            continue
        out = coefs[ci]
        k = ss
        while k <= se:
            e = ac[w16[p]]
            if not e:  # a bad code: the value 0, an end of band here
                p += 17
                break
            p += e >> 8
            r, s = (e >> 4) & 15, e & 15
            if s:
                k += r
                v = w16[p] >> (16 - s)
                p += s
                if v < 1 << (s - 1):
                    v += 1 - (1 << s)
                v <<= al
                if s + al > 15:
                    v = ((v + 32768) & 65535) - 32768
                out[base + (k if k < 64 else 63)] = v
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
    return len(slots), p > nbits


def _ac_refine(w16: List[int], slots, coefs: List[List[int]], nbits: int, ss: int, se: int,
               al: int) -> Tuple[int, bool]:
    """A progressive AC refinement scan of band ``ss``..``se``: a
    correction bit for each coefficient that is already non-zero, and each
    new coefficient (+-1 at ``al``) placed past its run of zero ones, or on
    the coefficient after the band where the run goes past it
    (``decode_mcu_AC_refine``)."""
    p1, m1 = 1 << al, -1 << al
    p = eobrun = 0
    for i, (ci, base, _, ac) in enumerate(slots):
        if p > nbits:
            return i, True
        out = coefs[ci]
        k = ss
        if not eobrun:
            while k <= se:
                e = ac[w16[p]]
                p += e >> 8 if e else 17
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
                    out[base + (k if k < 64 else 63)] = s
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
    return len(slots), p > nbits


def _wrap16(v: np.ndarray) -> np.ndarray:
    return ((v + 32768) & 65535) - 32768


def _idct_1d(x: List[np.ndarray], shift: int, simd: bool = False) -> List[np.ndarray]:
    """jidctint.c's 1-D pass on the 8 inputs, each descaled by ``shift``;
    ``simd``: as libjpeg-turbo's x86 SIMD version, whose sums x0 +- x4,
    x7 + x3 and x5 + x1 are 16-bit and wrap."""
    w = _wrap16 if simd else (lambda v: v)
    z1 = (x[2] + x[6]) * 4433
    tmp2 = z1 - x[6] * 15137
    tmp3 = z1 + x[2] * 6270
    tmp0 = w(x[0] + x[4]) << _CONST_BITS
    tmp1 = w(x[0] - x[4]) << _CONST_BITS
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    a0, a1, a2, a3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = a0 + a3, a1 + a2, w(a0 + a2), w(a1 + a3)
    z5 = (z3 + z4) * 9633
    a0, a1, a2, a3 = a0 * 2446, a1 * 16819, a2 * 25172, a3 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    a0, a1, a2, a3 = a0 + z1 + z3, a1 + z2 + z4, a2 + z2 + z3, a3 + z1 + z4
    half = 1 << (shift - 1)
    return [(v + half) >> shift for v in (t10 + a3, t11 + a2, t12 + a1, t13 + a0,
                                          t13 - a0, t12 - a1, t11 - a2, t10 - a3)]


def _idct_islow(coefs: np.ndarray, quant: np.ndarray, bits: int = 8) -> np.ndarray:
    """libjpeg's ``jpeg_idct_islow`` of (N, 64) natural-order coefficients
    with their quantization table: (N, 8, 8) samples, uint8 at 8 bits (as
    libjpeg-turbo's x86 SIMD computes it), uint16 at 12 (``jidctint.c`` in
    libjpeg-turbo's 12-bit build: PASS1_BITS 1, its range-limit table)."""
    c = (coefs.astype(np.int64) * quant.astype(np.int64)).reshape(-1, 8, 8)
    if bits == 8:
        return _idct_islow_simd(c)
    ws = np.stack(_idct_1d([c[:, r, :] for r in range(8)], _CONST_BITS - 1), axis=1)
    out = _idct_1d([ws[:, :, k] for k in range(8)], _CONST_BITS + 1 + 3)
    return _IDCT_LIMIT_12[np.stack(out, axis=2) & 16383]


def _idct_islow_simd(c: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's x86 SIMD ``jsimd_idct_islow`` (the one its 8-bit
    build runs) of (N, 8, 8) dequantized coefficients: ``jidctint.c``'s
    arithmetic, which it equals wherever no value leaves 16 bits, with the
    SIMD's 16-bit lanes where one does (corrupt or zero-filled data): the
    dequantized coefficients and the sums of ``_idct_1d`` wrap, each pass
    saturates its output to 16 bits and the samples to [0, 255] (no
    range-limit table), and a block whose rows 1-7 are zero takes its
    columns as row 0 shifted by PASS1_BITS (2) in 16 bits."""
    c = _wrap16(c)
    ws = np.stack(_idct_1d([c[:, r, :] for r in range(8)], _CONST_BITS - 2, True), axis=1)
    ws = np.clip(ws, -32768, 32767)
    dc_only = ~c[:, 1:, :].any(axis=(1, 2))
    ws[dc_only] = _wrap16(c[dc_only, :1, :] << 2)
    out = _idct_1d([ws[:, :, k] for k in range(8)], _CONST_BITS + 2 + 3, True)
    return (np.clip(np.stack(out, axis=2), -128, 127) + 128).astype(np.uint8)


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
        return decode_jpeg_file(f.read(), path)


def decode_jpeg_file(data: bytes, path: str) -> np.ndarray:
    """``read_jpeg_rgb`` on the file's bytes (``path`` names it in errors)."""
    if not data.startswith(_JPEG_SIGNATURE):
        raise ValueError(f"{path}: {_kind(data)} file, not a JPEG")
    return decode_jpeg(data, path)


def decode_jpeg(data: bytes, path: str, space: Optional[str] = None, tables: bytes = b"",
                sampling=None, cmyk: bool = False, precision: int = 8,
                persist: Optional[tuple] = None, libtiff: str = "") -> np.ndarray:
    """A JPEG stream as (H, W, 3) uint8 RGB. ``space`` None takes the colour
    space from libjpeg's guess, as for a JPEG file; a caller that knows it
    (libtiff passes the TIFF photometric to libjpeg) gives "ycc" (YCbCr,
    converted), "planes" ((H, W, components) samples, no conversion) or
    "replicated" (the same, the subsampled components repeated rather than
    filtered up). ``tables``, an abbreviated tables-only stream
    (TIFF's JPEGTables), is read first, as ``jpeg_read_header(FALSE)``.
    ``sampling`` (h, v), where given, is the first component's sampling the
    caller requires ("any": any), the others' being 1x1, as libtiff
    requires of a strip's stream. ``cmyk`` takes four components as CMYK
    whatever the Adobe transform says (PIL's JPEG colour space ``CMYK``,
    which BLP's reader sets: no YCCK conversion). ``precision`` 12 takes
    12-bit Huffman-coded sequential frames instead of 8-bit ones (libtiff's
    12-bit JPEG-in-TIFF, ``space`` "planes": uint16 samples), decoded as
    libjpeg-turbo's 12-bit build does (its ``jidctint.c`` with PASS1_BITS
    1, samples limited to [0, 4095] around 2048). ``persist``, a
    (quantization, Huffman) pair of dicts, keeps the tables across calls,
    as one libjpeg decompressor keeps them across the streams it reads
    (libtiff's strips and tiles). ``libtiff`` "jpeg" reads the stream as
    libtiff's JPEG codec hands it to libjpeg: whole, an EOI marker wherever
    libjpeg reads past its end; "ojpeg" as its OJPEG codec does, which also
    fails where libjpeg would resynchronise on a restart marker ("": a
    file's stream, as PIL hands it over; see ``image_jpeg_stream``).
    Damaged entropy-coded data reads as libjpeg reads it past its warnings
    (``_jpeg_segments``)."""
    qt: Dict[int, np.ndarray]
    huff: Dict[Tuple[int, int], Tuple[bytes, bytes]]
    qt, huff = persist if persist is not None else ({}, {})
    if tables:
        _jpeg_segments(tables, path, qt, huff, precision, "jpeg")
    frame, coefs, jfif, adobe = _jpeg_segments(data, path, qt, huff, precision, libtiff)
    if frame is None:
        raise ValueError(f"{path}: JPEG without a frame header")
    if sampling is not None:
        factors = [(h, v) for _, h, v, _ in frame["comps"]]
        if (sampling != "any" and factors[0] != tuple(sampling)) or any(
                f != (1, 1) for f in factors[1:]):
            raise ValueError(f"{path}: JPEG sampling factors {factors} where libtiff requires "
                             f"{sampling} for the first component and 1x1 for the others")
    if frame["progressive"]:
        frame["smooth"] = _smoothing_ok(frame)
    return _jpeg_pixels(frame, coefs, jfif, adobe, space, cmyk)


def _jpeg_segments(data: bytes, path: str, qt: Dict[int, np.ndarray],
                   huff: Dict[Tuple[int, int], Tuple[bytes, bytes]], want: int = 8,
                   libtiff: str = ""):
    """Read a JPEG stream's markers and scans as libjpeg's ``read_markers``
    and input controller read them, into ``qt``, ``huff`` ((class, table)
    -> (code counts, symbols)) and the coefficients (or, lossless,
    ``frame["samples"]``): (frame or None, coefficients, JFIF marker seen,
    Adobe transform or None). ``want`` is the sample precision the caller
    takes, ``libtiff`` the data source (see ``decode_jpeg``). Each marker
    segment is checked as libjpeg checks it, and what libjpeg fails on
    raises. A stream of one scan ends with its last MCU (PIL has every
    scanline then): what follows may end early, and only a marker libjpeg
    fails on raises (libtiff reads nothing after it); a stream of several
    scans reads to its EOI marker (``image_jpeg_stream`` for the data between markers)."""
    from . import image_jpeg_lossless

    src = Source(data, 2, bool(libtiff), libtiff != "ojpeg")
    frame, coefs, cond = None, [], {}
    restart, jfif, adobe = 0, False, None
    scans, one_scan, done = 0, False, False
    try:
        while True:
            marker = src.unread or src.next_marker()
            src.unread = 0
            if marker == 0xD9:  # EOI
                if frame is not None and not scans:
                    raise ValueError("corrupt JPEG data: an EOI marker before any scan "
                                     "(JERR_SOF_NO_SOS)")
                break
            if 0xD0 <= marker <= 0xD7 or marker == 0x01:  # RSTn, TEM: no parameters
                continue
            if marker == 0xD8:
                raise ValueError("corrupt JPEG data: a second SOI marker (JERR_SOI_DUPLICATE)")
            if marker in _SOF_NAMES and marker not in _SOF_READ or marker == 0xC8:
                raise ValueError(f"{_SOF_NAMES.get(marker, 'a JPG marker')} is not read by the "
                                 f"port (baseline, extended sequential, progressive and "
                                 f"lossless Huffman and sequential and progressive "
                                 f"arithmetic-coded JPEG only)")
            if marker in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA):
                if frame is not None:
                    raise ValueError("corrupt JPEG data: a second frame header "
                                     "(JERR_SOF_DUPLICATE)")
                frame, coefs = _read_sof(src, marker, want)
            elif marker == 0xC4:
                _read_dht(src, huff)
            elif marker == 0xDB:
                _read_dqt(src, qt)
            elif marker == 0xCC:
                _read_dac(src, cond)
            elif marker == 0xDD:
                if src.u16() != 4:
                    raise ValueError("corrupt JPEG data: a DRI segment of the wrong length")
                restart = src.u16()
            elif 0xE0 <= marker <= 0xEF or marker in (0xFE, 0xDC):  # APPn, COM, DNL
                length = src.u16() - 2
                if marker in (0xE0, 0xEE) and length > 0:  # the first 14 bytes looked at
                    body = bytes(src.byte() for _ in range(min(length, 14)))
                    length -= len(body)
                    if not scans and marker == 0xE0:
                        jfif |= len(body) == 14 and body.startswith(b"JFIF\x00")
                    elif not scans and len(body) >= 12 and body.startswith(b"Adobe"):
                        adobe = body[11]
                src.skip(length)
            elif marker == 0xDA:
                if frame is None:
                    raise ValueError(f"{path}: JPEG scan before its frame header")
                if one_scan:
                    raise ValueError("corrupt JPEG data: a second scan in a one-scan image "
                                     "(JERR_EOI_EXPECTED)")
                scans += 1
                frame["scans"] = scans
                members, ss, se, ah, al = _read_sos(src, frame)
                if scans == 1:
                    one_scan = not frame["progressive"] and len(members) == len(frame["comps"])
                    if not frame["progressive"] and not frame["lossless"]:
                        for key, table in STD_HUFFMAN.items():  # std_huff_tables
                            huff.setdefault(key, table)
                if frame["lossless"]:
                    image_jpeg_lossless.decode_scan(frame, src, members, ss, se, ah, al, huff,
                                                    restart, _peek16, _huffman_table,
                                                    _exact_bits)
                else:
                    _decode_scan(frame, src, members, ss, se, ah, al, qt, huff, restart, coefs,
                                 cond)
                done = one_scan
                if done and libtiff:  # libtiff reads no further (nor fails) past the scanlines
                    break
            else:
                raise ValueError(f"corrupt JPEG data: marker 0x{marker:02X}, which libjpeg "
                                 f"does not know (JERR_UNKNOWN_MARKER)")
    except Truncated:
        if not done:
            raise ValueError(f"{path}: truncated JPEG data: the file ends where libjpeg reads "
                             f"on (PIL: image file is truncated)") from None
    return frame, coefs, jfif, adobe


def _read_sof(src: Source, marker: int, want: int):
    """``get_sof``: the frame, and each component's zero coefficients."""
    length = src.u16()
    precision, height, width, n = src.byte(), src.u16(), src.u16(), src.byte()
    if height == 0 or width == 0 or n == 0:
        raise ValueError("JPEG with its height in a DNL marker, or no width or components, "
                         "is not read (JERR_EMPTY_IMAGE)")
    if length != 8 + 3 * n:
        raise ValueError("corrupt JPEG data: a frame header of the wrong length")
    comps = []
    for _ in range(n):
        cid, hv, tq = src.byte(), src.byte(), src.byte()
        comps.append((cid, hv >> 4, hv & 15, tq))
    if precision != want and want != 8:  # libtiff: "Improper JPEG data precision"
        raise ValueError(f"{precision}-bit JPEG data in a {want}-bit JPEG-in-TIFF: libtiff "
                         f"fails on it")
    if precision != want or (want == 12 and marker not in (0xC0, 0xC1)):
        raise ValueError(f"{precision}-bit JPEG is not read by the port (8-bit samples only, "
                         f"and 12-bit Huffman-coded sequential frames in TIFF)")
    if n not in (1, 3, 4):
        raise ValueError(f"JPEG with {n} components is not read by the port")
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    mcux, mcuy = _ceil_div(width, 8 * hmax), _ceil_div(height, 8 * vmax)
    frame = {"width": width, "height": height, "comps": comps, "hmax": hmax,
             "vmax": vmax, "mcux": mcux, "mcuy": mcuy, "quant": [None] * n,
             "progressive": marker in (0xC2, 0xCA), "arith": marker in (0xC9, 0xCA),
             "lossless": marker == 0xC3, "precision": precision, "samples": {},
             # the bits each zigzag coefficient has so far (-1: none), and
             # what they were before the component's last scan
             "coef_bits": [[-1] * 64 for _ in range(n)], "prev_bits": [[0] * 64 for _ in range(n)]}
    return frame, [[0] * (mcuy * v * mcux * h * 64) for _, h, v, _ in comps]


def _read_dht(src: Source, huff) -> None:
    """``get_dht``: one or more tables, kept as their counts and symbols."""
    length = src.u16() - 2
    while length > 16:
        index = src.byte()
        counts = bytes(src.byte() for _ in range(16))
        length -= 17
        total = sum(counts)
        if total > 256 or total > length:
            raise ValueError("corrupt JPEG data: a Huffman table longer than its segment "
                             "(JERR_BAD_HUFF_TABLE)")
        symbols = bytes(src.byte() for _ in range(total))
        length -= total
        if index & ~0x13:
            raise ValueError(f"corrupt JPEG data: Huffman table index 0x{index:02X} "
                             f"(JERR_DHT_INDEX)")
        huff[(index >> 4, index & 15)] = (counts, symbols)
    if length:
        raise ValueError("corrupt JPEG data: a DHT segment of the wrong length")


def _read_dqt(src: Source, qt) -> None:
    """``get_dqt``: 8- or 16-bit tables of 64 values, zigzag order."""
    length = src.u16() - 2
    while length > 0:
        n = src.byte()
        prec, n = n >> 4, n & 15
        if n >= 4:
            raise ValueError(f"corrupt JPEG data: quantization table {n} (JERR_DQT_INDEX)")
        vals = [src.u16() if prec else src.byte() for _ in range(64)]
        table = np.zeros(64, np.int64)
        table[_ZIGZAG] = vals
        qt[n] = table
        length -= 65 + (64 if prec else 0)
    if length:
        raise ValueError("corrupt JPEG data: a DQT segment of the wrong length")


def _read_dac(src: Source, cond: dict) -> None:
    """``get_dac``: the arithmetic-coding conditioning, (0, table) -> (L, U)
    and (1, table) -> Kx."""
    length = src.u16() - 2
    while length > 0:
        index, val = src.byte(), src.byte()
        length -= 2
        if index >= 32:
            raise ValueError(f"corrupt JPEG data: DAC index {index} (JERR_DAC_INDEX)")
        if index >= 16:
            cond[(1, index - 16)] = val
        else:
            if (val & 15) > val >> 4:
                raise ValueError(f"corrupt JPEG DAC value {val}")
            cond[(0, index)] = (val & 15, val >> 4)
    if length:
        raise ValueError("corrupt JPEG data: a DAC segment of the wrong length")


def _read_sos(src: Source, frame: dict):
    """``get_sos``: the scan's components ((index, DC table, AC table) each,
    found as libjpeg finds them) and Ss, Se, Ah, Al."""
    length, n = src.u16(), src.byte()
    if length != 2 * n + 6 or not 1 <= n <= 4:
        raise ValueError("corrupt JPEG data: a scan header of the wrong length")
    ids = [c[0] for c in frame["comps"]][:4]
    slot: List[Optional[int]] = [None] * 4  # cur_comp_info, by scan position
    members = []
    for i in range(n):
        cid, tables = src.byte(), src.byte()
        # libjpeg looks for the id among the components whose index is a free
        # scan position, then refuses one the scan already has
        ci = next((c for c, x in enumerate(ids) if x == cid and slot[c] is None), None)
        if ci is None or ci in slot[:i]:
            raise ValueError(f"corrupt JPEG data: scan component id {cid} "
                             f"(JERR_BAD_COMPONENT_ID)")
        slot[i] = ci
        members.append((ci, tables >> 4, tables & 15))
    ss, se, a = src.byte(), src.byte(), src.byte()
    return members, ss, se, a >> 4, a & 15


def _exact_bits(src: Source, pad: int):
    """``image_jpeg_exact.Bits`` over the segment ``src`` last read, zero
    bits for ``pad`` bytes past it."""
    from . import image_jpeg_exact

    start, end, marker_end = src.span
    top = len(src.data) if src.eoi_pad else min(src.n, CHUNK * ((start - 1) // CHUNK + 1))
    return image_jpeg_exact.Bits(src.data[start:end], start, marker_end, top,
                                 len(src.data) if src.eoi_pad else src.n, pad, _peek16)


def _huffman_table(huff, cls: int, th: int, lossless: bool = False) -> Tuple[int, ...]:
    """``jpeg_make_d_derived_tbl``: table ``th`` of class ``cls``, checked."""
    table = huff.get((cls, th))
    if table is None:
        raise ValueError(f"corrupt JPEG data: a scan uses Huffman table {th}, which the "
                         f"stream does not define (JERR_NO_HUFF_TABLE)")
    counts, symbols = table
    if cls == 0 and max(symbols, default=0) > (16 if lossless else 15):
        raise ValueError("corrupt JPEG data: a DC Huffman table with a symbol past 15 "
                         "(JERR_BAD_HUFF_TABLE)")
    return _huffman_lut(counts, symbols)


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


def _decode_scan(frame: dict, src: Source, members, ss: int, se: int, ah: int, al: int, qt,
                 huff, restart: int, coefs: List[List[int]], cond: dict) -> None:
    """Huffman- or arithmetic-decode one scan into ``coefs`` (each component's
    blocks, zigzag order, in the padded MCU grid), set up as libjpeg's
    ``start_input_pass`` sets it up, and checked as it checks it."""
    from . import image_jpeg_arith, image_jpeg_exact

    comps = frame["comps"]
    n = len(members)
    progressive = frame["progressive"]
    if progressive and (ss > se or se > 63 or al > 13 or (ah and al != ah - 1)
                        or (ss == 0 and se != 0) or (ss and n != 1)):
        raise ValueError(f"corrupt JPEG data: invalid progressive scan Ss={ss} Se={se} "
                         f"Ah={ah} Al={al} over {n} components")
    mcux, mcuy = frame["mcux"], frame["mcuy"]
    if n == 1:  # non-interleaved: the component's own blocks, row by row
        ci, dct, act = members[0]
        _, h, v, _ = comps[ci]
        bw = _ceil_div(_ceil_div(frame["width"] * h, frame["hmax"]), 8)
        bh = _ceil_div(_ceil_div(frame["height"] * v, frame["vmax"]), 8)
        per_mcu, grid = 1, [(ci, by * mcux * h + bx, dct, act)
                            for by in range(bh) for bx in range(bw)]
        row_of = lambda mcu: mcu // bw // v  # noqa: E731  the MCU's iMCU row
    else:
        per_mcu = sum(comps[ci][1] * comps[ci][2] for ci, _, _ in members)
        if per_mcu > _MAX_BLOCKS_IN_MCU:
            raise ValueError(f"corrupt JPEG data: {per_mcu} blocks in an MCU "
                             f"(JERR_BAD_MCU_SIZE)")
        grid = [(ci, (my * v + yy) * mcux * h + mx * h + xx, dct, act)
                for my in range(mcuy) for mx in range(mcux)
                for ci, dct, act in members for h, v in [comps[ci][1:3]]
                for yy in range(v) for xx in range(h)]
        row_of = lambda mcu: mcu // mcux  # noqa: E731
    for ci, _, _ in members:
        if frame["quant"][ci] is None:  # latched at the component's first scan
            frame["quant"][ci] = qt.get(comps[ci][3])
            if frame["quant"][ci] is None:
                raise ValueError("JPEG component with no quantization table "
                                 "(JERR_NO_QUANT_TABLE)")
        if progressive:
            bits, prev = frame["coef_bits"][ci], frame["prev_bits"][ci]
            for k in range(min(ss, 1), max(se, 9) + 1):
                prev[k] = bits[k] if frame["scans"] > 1 else 0
            for k in range(ss, se + 1):
                bits[k] = al
    if frame["arith"]:  # the tables' numbers: statistics bins and DAC conditioning
        if any(t >= 16 for _, d, a in members for t in (d, a)):
            raise ValueError("corrupt JPEG data: arithmetic-coding table past 15 "
                             "(JERR_NO_ARITH_TABLE)")
        slots = [(ci, base * 64, dct, act) for ci, base, dct, act in grid]
        image_jpeg_arith.decode_scan(frame, src, members, restart, per_mcu, slots, coefs,
                                     ss, se, ah, al, cond)
        frame["good_row"] = mcuy  # the arithmetic decoder never runs out of data
        return
    # the tables the scan needs: both in a sequential scan; DC in a DC first
    # scan, none in a DC refinement, AC in an AC scan
    need_dc = not progressive or (ss == 0 and ah == 0)
    need_ac = not progressive or ss > 0
    luts = {}
    for _, dct, act in members:
        if need_dc:
            luts[(0, dct)] = _huffman_table(huff, 0, dct)
        if need_ac:
            luts[(1, act)] = _huffman_table(huff, 1, act)
    slots = [(ci, base * 64, luts.get((0, dct)), luts.get((1, act)))
             for ci, base, dct, act in grid]
    if not progressive:
        def run(w16, part, nbits):
            return _decode_blocks(w16, part, coefs, nbits, per_mcu)
    elif ss == 0 and ah == 0:
        def run(w16, part, nbits):
            return _dc_first(w16, part, coefs, nbits, per_mcu, al)
    elif ss == 0:
        def run(w16, part, nbits):
            return _dc_refine(w16, part, coefs, nbits, per_mcu, al)
    elif ah == 0:
        def run(w16, part, nbits):
            return _ac_first(w16, part, coefs, nbits, ss, se, al)
    else:
        def run(w16, part, nbits):
            return _ac_refine(w16, part, coefs, nbits, ss, se, al)
    refine = progressive and ss and ah

    def decode(first: int, count: int, data: bytes):
        part = slots[first * per_mcu:(first + count) * per_mcu]
        if not progressive and src.span and (src.at_end or (src.ff_run and not restart)):
            bits = _exact_bits(src, _BLOCK_BITS // 8 * per_mcu + 8)
            return image_jpeg_exact.sequential(bits, part, coefs, per_mcu, not restart)
        saved = [coefs[ci][b:b + 64] for ci, b, _, _ in part] if refine else None
        try:
            return run(_peek16(data), part, 8 * len(data))
        except IndexError:  # the last MCU ran on past the data: more zero bits for it
            for (ci, b, _, _), block in zip(part, saved or ()):
                coefs[ci][b:b + 64] = block
            return run(_peek16(data, _BLOCK_BITS // 8 * per_mcu + 4), part, 8 * len(data))

    frame["good_row"] = row_of(intervals(src, restart, len(slots) // per_mcu, decode))


def _jpeg_pixels(frame: dict, coefs: List[List[int]], jfif: bool, adobe,
                 space: Optional[str] = None, cmyk: bool = False) -> np.ndarray:
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
        zz = _wrap16(np.asarray(coefs[ci], np.int64).reshape(-1, 64))  # JCOEF
        nat = np.empty_like(zz)
        nat[:, _ZIGZAG] = zz
        dh, dw = _ceil_div(height * v, vmax), _ceil_div(width * h, hmax)
        if frame.get("smooth"):  # the component's own blocks, not the MCU padding
            grid = nat.reshape(mcuy * v, mcux * h, 64)
            bh, bw = _ceil_div(dh, 8), _ceil_div(dw, 8)
            bits = frame["coef_bits"][ci][:10]
            smoothed = image_jpeg_smooth.smooth(grid.copy(), bh, bw, v, quant, bits)
            # iMCU rows past the last scan's last good one take the bits as
            # they were before that scan (last_good_iMCU_row)
            cut = (frame["good_row"] + 1) * v
            if cut < bh:
                prev = bits[:1] + (frame["prev_bits"][ci][1:10] if frame["scans"] > 1
                                   else [-1] * 9)
                smoothed[cut:] = image_jpeg_smooth.smooth(grid.copy(), bh, bw, v, quant,
                                                          prev)[cut:]
            grid[:bh, :bw] = smoothed
        blocks = _idct_islow(nat, quant, frame["precision"]).reshape(mcuy * v, mcux * h, 8, 8)
        plane = blocks.transpose(0, 2, 1, 3).reshape(mcuy * v * 8, mcux * h * 8)
        if space == "replicated":  # libtiff's data units: chroma repeated, not filtered
            if hmax % h or vmax % v:
                raise ValueError(f"JPEG sampling {h}x{v} of {hmax}x{vmax} is fractional")
            planes.append(np.repeat(np.repeat(plane[:dh, :dw], vmax // v, axis=0), hmax // h,
                                    axis=1)[:height, :width])
        else:
            planes.append(_upsample(plane[:dh, :dw], h, v, hmax, vmax)[:height, :width])
    if space in ("planes", "replicated"):
        dtype = np.uint8 if frame["precision"] == 8 else np.uint16
        return np.stack([p.astype(dtype) for p in planes], axis=-1)
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
        return _cmyk_pixels(planes, 0 if cmyk else adobe)
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
