"""TIFF decoding for ``image_io.read_image``, numpy, ``zlib`` and the standard
library only, bit-equal to PIL 12.1's ``np.array(Image.open(path).convert(
"RGB"))``.

The first IFD of a classic TIFF, little-endian (``II*\\0``) or big-endian
(``MM\\0*``):

- compression none (1; PIL's own raw decoder), PackBits (32773), LZW (5:
  most significant bit first with libtiff's "early change", or the old
  least-significant-bit-first codes libtiff still reads, told apart by
  their first two bytes as libtiff does) and Deflate (8, 32946); LZW and
  Deflate with predictor 1 or 2 (horizontal differencing per sample,
  16-bit samples in the file's byte order), which libtiff does not apply
  to PackBits, nor PIL to uncompressed data;
- strips, or tiles cut at the image's edge; planar configuration 1
  (chunky) or 2 (one plane per sample) where PIL reads it right: 8-bit RGB
  and RGBA, and compressed 16-bit RGB and RGBA, greyscale + alpha and
  premultiplied RGBA. The other planar files raise: PIL fails on some
  (an extra sample not alpha; uncompressed premultiplied alpha or
  greyscale + alpha) and mis-reads others (uncompressed 16-bit samples; a
  compressed fourth sample without an ExtraSamples tag);
- the modes of PIL's ``OPEN_INFO`` that turn into RGB:

  - WhiteIsZero and BlackIsZero at 1, 2, 4 and 8 bits (mode ``1`` gives 0
    or 255; 2 and 4 bits are scaled by 85 and 17; WhiteIsZero is inverted),
    at 8 bits with an alpha sample (``LA``), and at 16 bits, where PIL opens
    ``I;16`` (``I;16B`` big-endian) and ``convert("RGB")`` clamps at 255; a
    16-bit WhiteIsZero little-endian file opens uninverted, as in PIL, and
    a big-endian one raises, as PIL does;
  - RGB at 8 and 16 bits (16-bit samples keep their high byte), with extra
    samples: unassociated alpha or unspecified ones are dropped; an
    associated (premultiplied) alpha is divided out first, as PIL's
    ``RGBa`` unpacker does;
  - palette at 1, 2, 4 and 8 bits, the 16-bit colormap narrowed to its
    high byte, an index past it black; a palette index with an extra
    sample.

The Orientation tag (274) is applied as PIL 12.1 applies it on load
(``ImageOps.exif_transpose``: 2 mirrors, 3 turns 180 degrees, 4 flips,
5 transposes, 6 turns 90 degrees clockwise, 7 transverses, 8 turns 90
degrees anticlockwise). Orientation 5-8 on an uncompressed file whose one
strip or tile covers the image, in a mode PIL maps straight into memory
(L, P, RGBA, I;16, I;16B read as stored), raises: PIL misreads it, taking
the pixels in file order as an image of the swapped size. JPEG-in-TIFF
(compression 6 and 7), BigTIFF, FillOrder 2, signed and floating-point
samples, 12- and 32-bit samples and the other photometric interpretations
(transparency mask, CMYK, YCbCr, CIELab and beyond) raise a ``ValueError``
that names them; so do a file that ends before a strip or tile, and
compressed data that decodes to less than its strip or tile.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

from .image_io import _samples as _unpack

_PHOTOMETRIC = {4: "transparency-mask", 5: "CMYK", 6: "YCbCr", 8: "CIELab", 9: "ICCLab",
                10: "ITULab", 32844: "LogL", 32845: "LogLuv"}
_COMPRESSION = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 32771: "RLE 16-bit",
                32809: "ThunderScan", 34676: "SGILog", 34677: "SGILog24", 34925: "LZMA",
                50000: "Zstandard", 50001: "WebP"}
# bytes of each TIFF field type, and its struct code (integer types only)
_TYPES = {1: (1, "B"), 2: (1, "B"), 3: (2, "H"), 4: (4, "I"), 6: (1, "b"), 7: (1, "B"),
          8: (2, "h"), 9: (4, "i"), 16: (8, "Q")}
_CLEAR, _EOI = 256, 257
# ImageOps.exif_transpose on (H, W, C) arrays
_ORIENT = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
           5: lambda a: a.transpose(1, 0, 2), 6: lambda a: np.rot90(a, -1),
           7: lambda a: np.rot90(a, 2).transpose(1, 0, 2), 8: lambda a: np.rot90(a, 1)}


def _ifd(data: bytes, order: str, path: str) -> Dict[int, Tuple[int, ...]]:
    """The integer tags of the first IFD: tag -> values."""
    (off,) = struct.unpack(order + "I", data[4:8])
    if off + 2 > len(data):
        raise ValueError(f"{path}: truncated TIFF data: the first IFD lies past the file")
    (n,) = struct.unpack(order + "H", data[off:off + 2])
    if off + 2 + 12 * n > len(data):
        raise ValueError(f"{path}: truncated TIFF data: the first IFD ends past the file")
    tags = {}
    for i in range(n):
        tag, kind, count = struct.unpack(order + "HHI", data[off + 2 + 12 * i:off + 10 + 12 * i])
        if kind not in _TYPES:
            continue
        size, code = _TYPES[kind]
        where = off + 10 + 12 * i
        if size * count > 4:
            (where,) = struct.unpack(order + "I", data[where:where + 4])
        if where + size * count > len(data):
            raise ValueError(f"{path}: truncated TIFF data: tag {tag} lies past the file")
        tags[tag] = struct.unpack(f"{order}{count}{code}", data[where:where + size * count])
    return tags


def _lzw(src: bytes, size: int) -> bytes:
    """TIFF LZW to at most ``size`` bytes: codes most significant bit first
    with the width raised one code early, or, where the data starts with a
    clear code written least significant bit first (libtiff's test), the
    old codes: least significant bit first, raised at the table's power of
    two as in GIF."""
    old = len(src) >= 2 and src[0] == 0 and src[1] & 1
    early = 0 if old else 1
    base = [bytes([i]) for i in range(256)] + [b"", b""]
    table = list(base)
    width, prev = 9, None
    out = bytearray()
    acc = nbits = pos = 0
    n = len(src)
    while len(out) < size:
        while nbits < width:
            if pos >= n:
                return bytes(out)
            if old:
                acc |= src[pos] << nbits
            else:
                acc = (acc << 8) | src[pos]
            pos += 1
            nbits += 8
        if old:
            code = acc & ((1 << width) - 1)
            acc >>= width
            nbits -= width
        else:
            nbits -= width
            code = (acc >> nbits) & ((1 << width) - 1)
            acc &= (1 << nbits) - 1
        if code == _CLEAR:
            table = list(base)
            width, prev = 9, None
            continue
        if code == _EOI:
            break
        if prev is None:
            if code > _CLEAR:
                raise ValueError(f"corrupt TIFF LZW data: code {code} after a clear")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError(f"corrupt TIFF LZW data: code {code} past the table's "
                             f"{len(table)} entries")
        if len(table) >= (1 << width) - early and width < 12:
            width += 1
        out += entry
        prev = entry
    return bytes(out)


def _packbits(src: bytes, size: int) -> bytes:
    out = bytearray()
    pos, n = 0, len(src)
    while pos < n and len(out) < size:
        h = src[pos]
        pos += 1
        if h < 128:  # h + 1 literal bytes
            out += src[pos:pos + h + 1]
            pos += h + 1
        elif h > 128:  # the next byte 257 - h times
            if pos < n:
                out += src[pos:pos + 1] * (257 - h)
            pos += 1
    return bytes(out)


def _inflate(src: bytes, size: int) -> bytes:
    d = zlib.decompressobj()
    try:
        return d.decompress(src, size)
    except zlib.error as e:
        raise ValueError(f"corrupt TIFF Deflate data: {e}") from None


def _samples(raw: bytes, rows: int, cols: int, spp: int, bits: int, order: str,
             predictor: int) -> np.ndarray:
    """A strip's or tile's bytes -> (rows, cols, spp) samples (uint16), each
    row starting on a byte, horizontal differencing undone."""
    stride = (cols * spp * bits + 7) // 8
    buf = np.frombuffer(raw, np.uint8, rows * stride).reshape(rows, stride)
    if bits == 16:
        px = buf.view(order + "u2").astype(np.int64).reshape(rows, cols, spp)
    else:
        px = _unpack(buf, cols, spp, bits).astype(np.int64)
    if predictor == 2:
        px = np.cumsum(px, axis=1) & ((1 << bits) - 1)
    return px.astype(np.uint16)


def _mode(tags, order: str, path: str) -> Tuple[str, int, Tuple[int, ...], int]:
    """PIL's ``_setup`` checks: (mode, photometric, bits per sample, samples
    per pixel), or a ValueError where PIL has no mode or the port lacks one."""
    photo = tags.get(262, (0,))[0]
    if photo in _PHOTOMETRIC:
        raise ValueError(f"{path}: {_PHOTOMETRIC[photo]} TIFF (photometric {photo}) is not read "
                         f"by the port")
    if photo not in (0, 1, 2, 3):
        raise ValueError(f"{path}: TIFF photometric interpretation {photo} is not read")
    if tags.get(266, (1,))[0] != 1:
        raise ValueError(f"{path}: TIFF with FillOrder 2 (bits reversed) is not read by the port")
    fmt = tags.get(339, (1,))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    extra = tags.get(338, ())
    spp = tags.get(277, (1,))[0]
    bps = tags.get(258, (1,))
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ValueError(f"{path}: TIFF with {spp} samples and {len(bps)} bit depths")
    grey = photo in (0, 1)
    if fmt == (2,) and grey and bps == (8,) and photo == 1:
        fmt = (1,)  # PIL reads signed 8-bit BlackIsZero as L
    if fmt != (1,):
        raise ValueError(f"{path}: TIFF sample format {fmt} (signed or floating point) is not "
                         f"read by the port")
    bits = bps[0]
    ok = False
    if grey and not extra:
        ok = bps in ((1,), (2,), (4,), (8,), (16,))
        if bps == (16,) and photo == 0 and order == ">":
            raise ValueError(f"{path}: 16-bit big-endian WhiteIsZero TIFF: PIL has no mode for "
                             f"it")
    elif photo == 1:
        ok = bps == (8, 8) and extra == (2,)
    elif photo == 2:
        if bps == (8,) * spp:
            ok = ((spp == 3 and not extra)
                  or (spp == 4 and extra in ((), (0,), (1,), (2,), (999,)))
                  or (spp in (5, 6) and len(extra) == spp - 3 and extra[0] in (0, 1, 2)
                      and not any(extra[1:])))
        elif bps == (16,) * spp:
            ok = (spp == 3 and not extra) or (spp == 4 and extra in ((), (0,), (1,), (2,)))
    elif photo == 3:
        ok = (bps in ((1,), (2,), (4,), (8,)) and not extra) or (bps == (8, 8)
                                                                   and extra in ((0,), (2,)))
    if not ok:
        raise ValueError(f"{path}: TIFF photometric {photo} with {bps} bits and extra samples "
                         f"{extra}: PIL has no mode for it")
    mode = {0: "grey", 1: "grey", 2: "RGB", 3: "P"}[photo]
    if photo == 2 and extra[:1] == (1,):
        mode = "RGBa"
    return mode, photo, bits, spp


def read_tiff_rgb(path: str) -> np.ndarray:
    """The first image of a TIFF file as (H, W, 3) uint8 RGB (see the module
    docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] in (b"II+\x00", b"MM\x00+"):
        raise ValueError(f"{path}: BigTIFF is not read by the port (classic TIFF only)")
    if data[:4] not in (b"II*\x00", b"MM\x00*") or len(data) < 8:
        raise ValueError(f"{path}: not a TIFF file, or one cut short in its header")
    order = "<" if data[:2] == b"II" else ">"
    tags = _ifd(data, order, path)
    if 256 not in tags or 257 not in tags:
        raise ValueError(f"{path}: TIFF without its image width or length")
    width, height = tags[256][0], tags[257][0]
    comp = tags.get(259, (1,))[0]
    if comp in (6, 7):
        raise ValueError(f"{path}: JPEG-in-TIFF (compression {comp}) is not read by the port")
    if comp in _COMPRESSION:
        raise ValueError(f"{path}: {_COMPRESSION[comp]} TIFF (compression {comp}) is not read "
                         f"by the port")
    if comp not in (1, 5, 8, 32773, 32946):
        raise ValueError(f"{path}: TIFF compression {comp} is not read by the port")
    mode, photo, bits, spp = _mode(tags, order, path)
    predictor = tags.get(317, (1,))[0] if comp in (5, 8, 32946) else 1
    if predictor not in (1, 2) or (predictor == 2 and bits not in (8, 16)):
        raise ValueError(f"{path}: TIFF predictor {predictor} at {bits} bits is not read")
    planar = tags.get(284, (1,))[0]
    if planar == 2 and spp > 1:
        extra = tags.get(338, ())
        if (comp == 1 and (bits != 8 or mode != "RGB" or extra not in ((), (2,)))) or (
                comp != 1 and (spp > 4 or extra == (0,) or (spp == 4 and not extra))):
            raise ValueError(f"{path}: planar TIFF with {spp} samples of {bits} bits, extra "
                             f"samples {extra} and compression {comp}: PIL fails on it or "
                             f"mis-reads it, and the port does not read it")
    if 324 in tags:
        offsets, counts = tags[324], tags.get(325)
        bw, bh = tags[322][0], tags[323][0]
    elif 273 in tags:
        offsets, counts = tags[273], tags.get(279)
        bw, bh = width, min(tags.get(278, (height,))[0], height)
    else:
        raise ValueError(f"{path}: TIFF without strip or tile offsets")
    per_plane = 1 if planar == 1 else spp
    cols, rows = -(-width // bw), -(-height // bh)
    orient = tags.get(274, (1,))[0]
    if orient in (5, 6, 7, 8) and comp == 1 and cols * rows == 1 and (
            planar == 1 or spp == 1) and _mapped(mode, photo, bits, spp, order, tags):
        raise ValueError(f"{path}: Orientation {orient} on an uncompressed single-strip or "
                         f"single-tile TIFF (PIL misreads it) is not read by the port")
    if len(offsets) < cols * rows * (spp if planar == 2 else 1):
        raise ValueError(f"{path}: TIFF with {len(offsets)} strips or tiles for "
                         f"{cols * rows} blocks")
    px = np.zeros((height, width, spp), np.uint16)
    k = 0
    for plane in range(spp if planar == 2 else 1):
        for by in range(rows):
            for bx in range(cols):
                off = offsets[k]
                n = counts[k] if counts else len(data) - off
                k += 1
                block_rows = bh if 324 in tags else min(bh, height - by * bh)
                need = block_rows * ((bw * (spp // per_plane) * bits + 7) // 8)
                src = data[off:off + n]
                if comp == 1:
                    raw = src
                elif comp == 5:
                    raw = _lzw(src, need)
                elif comp == 32773:
                    raw = _packbits(src, need)
                else:
                    raw = _inflate(src, need)
                if len(raw) < need:
                    raise ValueError(f"{path}: truncated TIFF data: a strip or tile gives "
                                     f"{len(raw)} of {need} bytes")
                block = _samples(raw, block_rows, bw, spp // per_plane, bits, order, predictor)
                y0, x0 = by * bh, bx * bw
                h, w = min(bh, height - y0), min(bw, width - x0)
                sl = slice(plane, plane + 1) if planar == 2 else slice(None)
                px[y0:y0 + h, x0:x0 + w, sl] = block[:h, :w]
    rgb = _to_rgb(px, mode, photo, bits, tags, path)
    return np.ascontiguousarray(_ORIENT[orient](rgb)) if orient in _ORIENT else rgb


def _mapped(mode: str, photo: int, bits: int, spp: int, order: str, tags) -> bool:
    """Whether PIL's mode equals its raw mode and is one it memory-maps:
    L, P, RGBA, I;16 and I;16B."""
    extra = tags.get(338, ())
    if mode == "grey":
        return spp == 1 and ((bits == 8 and photo == 1) or (bits == 16 and (order == "<"
                                                                              or photo == 1)))
    if mode == "P":
        return bits == 8 and spp == 1
    return mode == "RGB" and bits == 8 and spp == 4 and extra in ((), (2,), (999,))


def _to_rgb(px: np.ndarray, mode: str, photo: int, bits: int, tags, path: str) -> np.ndarray:
    """Samples -> RGB as PIL opens the mode and converts it."""
    if mode == "P":
        cmap = tags.get(320)
        if cmap is None or len(cmap) < 3:
            raise ValueError(f"{path}: palette TIFF without a colormap")
        n = len(cmap) // 3
        pal = np.zeros((256, 3), np.uint8)
        m = min(n, 256)
        pal[:m] = (np.asarray(cmap[:3 * n], np.int64).reshape(3, n).T[:m] >> 8)
        return pal[px[:, :, 0]]
    if mode == "grey":
        v = px[:, :, 0].astype(np.int64)
        if bits == 16:
            v = np.minimum(v, 255)
        else:
            if photo == 0:
                v = (1 << bits) - 1 - v
            v = v * (255 // ((1 << bits) - 1))
        return np.repeat(v.astype(np.uint8)[:, :, None], 3, axis=2)
    v = px[:, :, :4].astype(np.int64)
    if bits == 16:
        v = v >> 8
    if mode == "RGBa":
        a = v[:, :, 3:4]
        v = np.where(a == 0, 0, np.where(a == 255, v, np.minimum(v * 255 // np.maximum(a, 1),
                                                                  255)))
    return np.ascontiguousarray(v[:, :, :3].astype(np.uint8))
