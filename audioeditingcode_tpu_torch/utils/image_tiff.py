"""TIFF decoding for ``image_io.read_image``, numpy, ``zlib`` and the standard
library only, bit-equal to PIL 12.1's ``np.array(Image.open(path).convert(
"RGB"))``.

The first IFD of a classic TIFF, little-endian (``II*\\0``) or big-endian
(``MM\\0*``), or of a little-endian BigTIFF (``II+\\0``: 8-byte offsets,
20-byte IFD entries with 8-byte counts, the types LONG8, SLONG8 and IFD8;
PIL fails on a big-endian one, ``MM\\0+``, and so the port raises):

- compression none (1; PIL's own raw decoder), PackBits (32773), LZW (5:
  most significant bit first with libtiff's "early change", or the old
  least-significant-bit-first codes libtiff still reads, told apart by
  their first two bytes as libtiff does), Deflate (8, 32946), LZMA (34925:
  an xz stream a strip, by the standard ``lzma`` module), Zstandard
  (50000: a frame a strip, by ``image_zstd``), JPEG (7, below), the CCITT
  fax codings at 1 bit a sample (2 RLE, 32771 RLEW, 3 Group 3 1-D and 2-D,
  4 Group 4, by ``image_ccitt`` as libtiff decodes them; other bit depths
  raise, as libtiff refuses them) and ThunderScan (32809, 4-bit strips, as
  libtiff's Thunder decoder); LZW, Deflate, LZMA and Zstandard with
  predictor 1, 2 (horizontal differencing per sample, 16- and 32-bit
  samples in the file's byte order) or 3 (libtiff's floating-point byte
  planes), which libtiff does not apply to PackBits, nor PIL to
  uncompressed data;
- strips, or tiles cut at the image's edge; planar configuration 1
  (chunky) or 2 (one plane per sample) where PIL reads it right: 8-bit
  RGB, RGBA, CMYK and CIELab, compressed 16-bit RGB, RGBA and CMYK,
  greyscale + alpha, palette + alpha and premultiplied RGBA, and, in
  compressed tiles (not strips, where PIL fails), unspecified extra
  samples. The other planar files raise: PIL fails on some (an extra
  sample not alpha in strips or uncompressed; uncompressed premultiplied
  alpha or greyscale + alpha) and misreads others (uncompressed 16-bit
  samples; a fourth sample without an ExtraSamples tag, compressed, or
  uncompressed in a tile cut at the edge; palette + unspecified sample in
  tiles; one uncompressed sample in a mode whose raw mode PIL cuts to its
  first letter; any uncompressed plane with FillOrder 2);
- FillOrder 2 (bits reversed in each byte) in the modes PIL has a
  FillOrder 2 entry for (1, 2, 4 and 8-bit greyscale, 16-bit
  little-endian BlackIsZero, 8-bit RGB, palette); PIL fails on the rest;
- the modes of PIL's ``OPEN_INFO`` and their conversion to RGB:

  - WhiteIsZero and BlackIsZero at 1, 2, 4 and 8 bits (mode ``1`` gives 0
    or 255; 2 and 4 bits are scaled by 85 and 17; WhiteIsZero is inverted),
    at 8 bits with an alpha sample (``LA``), and at 12 and 16 bits, where
    PIL opens ``I;16`` (``I;16B`` big-endian; 12-bit little-endian
    BlackIsZero unscaled) and ``convert("RGB")`` clamps at 255; a 16-bit
    WhiteIsZero little-endian file opens uninverted, as in PIL, and a
    big-endian one raises, as PIL does;
  - signed 16- and 32-bit and unsigned 32-bit (little-endian only)
    BlackIsZero as mode ``I``, clamped to [0, 255]; 32-bit floating point
    (WhiteIsZero or BlackIsZero, not inverted) as mode ``F``, whose
    conversion goes through ``L``: 0 at or below 0 and for NaN, 255 at or
    above 255, else truncated. Compressed big-endian files of these raise:
    libtiff hands PIL native-order samples, which PIL reads as big-endian;
  - RGB at 8 and 16 bits (16-bit samples keep their high byte), with extra
    samples: unassociated alpha or unspecified ones are dropped; an
    associated (premultiplied) alpha is divided out first, as PIL's
    ``RGBa`` unpacker does;
  - palette at 1, 2, 4 and 8 bits, the 16-bit colormap narrowed to its
    high byte, an index past it black; a palette index with an extra
    sample;
  - CMYK (photometric 5) at 8 bits, with one or two unspecified extra
    samples, and at 16 bits (the high byte), whatever its InkSet: PIL opens
    it as ``CMYK``, not inverted, and its ``cmyk2rgb`` gives RGB;
  - YCbCr (photometric 6), compressed: PIL has libtiff's RGBA interface
    read it: the data units of YCbCrSubsampling (1, 2 or 4 across, 1, 2 or
    4 down, vertical at most horizontal but 1x2; 2x2 where the tag is
    absent) with their chroma replicated, libtiff's ``TIFFYCbCrToRGB``
    tables from YCbCrCoefficients and ReferenceBlackWhite (float32 as
    libtiff computes them), and two libtiff quirks kept: a strip is read as
    whole scanlines of ``TIFFScanlineSize``, which rounds down, so with 4x4
    units and an odd number of them across the strip's last bytes read as
    zero; a 4x4 tile cut at the image's edge skips its hidden units by the
    size of 4x2 ones; predictor 2 runs at a stride of three bytes over
    libtiff's rows (a strip's scanline size, three bytes a pixel of a
    tile's width), or not at all where they do not divide the block
    (libtiff fails on it, and the RGBA read, not stopping on errors, draws
    the bytes as decoded). Uncompressed YCbCr raises: PIL reads its samples as
    RGBX, four bytes a pixel, and fails or reads past them. One-sample YCbCr opens as ``L`` uncompressed, and fails
    in PIL otherwise;
  - CIELab (photometric 8) at 8 bits, as PIL's ``LAB`` (the bytes as
    stored; in planes PIL's A and B band unpackers flip a* and b*'s sign
    bit, and so does the port) and its LittleCMS transform to sRGB
    (``image_lab``).

JPEG-in-TIFF (compression 7): the JPEGTables stream (tag 347) is read
before each strip's or tile's abbreviated stream, which goes through
``image_io.decode_jpeg`` with the colour space libtiff gives libjpeg: the
photometric, not libjpeg's guess (2: RGB samples as they are; 6: YCbCr,
converted with fancy upsampling, as libtiff's JPEGCOLORMODE_RGB that PIL
sets; 1: greyscale; 5: CMYK samples, then ``cmyk2rgb``; 8: CIELab). As in
libtiff, the first component's sampling must be YCbCrSubsampling (2x2
where the tag is absent and the stream says otherwise: libtiff reads the
tag from the stream) for YCbCr and 1x1 for the rest, the others' 1x1; a
stream larger than its strip or tile raises, but a last strip's stream
that runs past the image, which libtiff cuts to the image; tiles are cut
at the image's edge. In planes each plane's strips or tiles are
one-component streams. 12-bit greyscale goes through libtiff's 12-bit
codec, whose samples PIL unpacks as ``I;12`` (other 12-bit kinds PIL has
no mode for). One libjpeg decompressor reads a file's streams in PIL's
order (a row of strips or tiles at a time, each plane's in turn), so the
tables a stream defines stay for the streams after it; and a stream that
runs out, or is damaged, reads as libjpeg reads it past its warnings
(``decode_jpeg(libtiff="jpeg")``).

The Orientation tag (274) is applied as PIL 12.1 applies it on load
(``ImageOps.exif_transpose``: 2 mirrors, 3 turns 180 degrees, 4 flips,
5 transposes, 6 turns 90 degrees clockwise, 7 transverses, 8 turns 90
degrees anticlockwise). Orientation 5-8 on an uncompressed file whose one
strip or tile covers the image, in a mode PIL maps straight into memory
(L, P, RGBA, CMYK, I;16, I;16B read as stored), raises: PIL
misreads it, taking the pixels in file order as an image of the swapped
size. Old-style JPEG (compression 6) whose JPEGInterchangeFormat stream
covers the image, or with baseline tables in tags and one strip or
several (``_old_jpeg_stream``), reads as libtiff's OJPEG codec decodes it
(``_old_jpeg``). Other old-style JPEG (several tiles of tables-in-tags
data, several strips big-endian or whose restart markers come out of turn,
lossless processes), the
compressions PIL fails on (WebP: its libtiff is built without it; SGILog
and SGILog24: libtiff decodes them only for the LogL and LogLuv
photometrics, for which PIL has no mode) and other unknown ones, 64-bit
and other sample formats, and the other photometric interpretations
(transparency mask, ICCLab, ITULab, LogL, LogLuv) raise a ``ValueError``
that names them; so do a file that ends before a strip or tile, and
compressed data that decodes to less than its strip or tile, but YCbCr,
which PIL reads through libtiff's RGBA interface: it draws the bytes
decoded, zero after them.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

from . import image_ccitt, image_lab, image_zstd
from .image_io import _samples as _unpack
from .image_io import cmyk_to_rgb, decode_jpeg

_PHOTOMETRIC = {4: "transparency-mask", 9: "ICCLab", 10: "ITULab",
                32844: "LogL (PIL has no mode for it)", 32845: "LogLuv (PIL has no mode for it)"}
_COMPRESSION = {
    34676: "SGILog: libtiff decodes it only for the LogL and LogLuv photometrics, for which "
           "PIL has no mode, and so PIL fails on every such file",
    34677: "SGILog24: libtiff decodes it only for the LogLuv photometric, for which PIL has no "
           "mode, and so PIL fails on every such file",
    50001: "WebP: PIL's libtiff is built without WebP support (WEBP compression support is not "
           "configured), and so PIL fails on every such file"}
_FAX = (2, 3, 4, 32771)
# ThunderScan's 2- and 3-bit deltas (tif_thunder.c); 2 and 4 skip a pixel
_DELTA2 = (0, 1, None, -1)
_DELTA3 = (0, 1, 2, 3, None, -3, -2, -1)
# bytes of each TIFF field type, and its struct code (RATIONAL and SRATIONAL
# give pairs, read as float32 quotients as libtiff does)
_TYPES = {1: (1, "B"), 2: (1, "B"), 3: (2, "H"), 4: (4, "I"), 5: (8, "I"), 6: (1, "b"),
          7: (1, "B"), 8: (2, "h"), 9: (4, "i"), 10: (8, "i"), 11: (4, "f"), 12: (8, "d"),
          13: (4, "I"), 16: (8, "Q"), 17: (8, "q"), 18: (8, "Q")}
_CLEAR, _EOI = 256, 257
# ImageOps.exif_transpose on (H, W, C) arrays
_ORIENT = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
           5: lambda a: a.transpose(1, 0, 2), 6: lambda a: np.rot90(a, -1),
           7: lambda a: np.rot90(a, 2).transpose(1, 0, 2), 8: lambda a: np.rot90(a, 1)}
# bit-reversed bytes, for FillOrder 2
_REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def _header(data: bytes, path: str) -> Tuple[str, bool]:
    """(byte order, BigTIFF) of the file's header."""
    if data[:4] in (b"II*\x00", b"MM\x00*") and len(data) >= 8:
        return ("<" if data[:2] == b"II" else ">"), False
    if data[:4] == b"MM\x00+":
        raise ValueError(f"{path}: big-endian BigTIFF: PIL fails on it (it takes the version "
                         f"from the third byte), so the port does not read it")
    if data[:4] == b"II+\x00" and len(data) >= 16:
        order = "<"
        if struct.unpack(order + "HH", data[4:8]) != (8, 0):
            raise ValueError(f"{path}: BigTIFF with an offset size other than 8")
        return order, True
    raise ValueError(f"{path}: not a TIFF file, or one cut short in its header")


def _ifd(data: bytes, order: str, path: str, big: bool = False) -> Dict[int, tuple]:
    """The tags of the first IFD: tag -> values (integers; floats for
    RATIONAL, SRATIONAL, FLOAT and DOUBLE). As PIL's reader, the tags up to
    the first whose entry or values the file cuts short."""
    if big:
        (off,) = struct.unpack(order + "Q", data[8:16])
        nsize, head, esize, inline = 8, "HHQ", 20, 8
    else:
        (off,) = struct.unpack(order + "I", data[4:8])
        nsize, head, esize, inline = 2, "HHI", 12, 4
    tags = {}
    if off + nsize > len(data):
        return tags
    (n,) = struct.unpack(order + ("Q" if big else "H"), data[off:off + nsize])
    for i in range(n):
        e = off + nsize + esize * i
        if e + esize > len(data):  # as PIL: stop at the first entry the file cuts
            break
        tag, kind, count = struct.unpack(order + head, data[e:e + esize - inline])
        if kind not in _TYPES:
            continue
        size, code = _TYPES[kind]
        where = e + esize - inline
        if size * count > inline:
            (where,) = struct.unpack(order + ("Q" if big else "I"), data[where:where + inline])
        if where + size * count > len(data):  # PIL warns and keeps the tags before it
            break
        if kind in (5, 10):
            pairs = struct.unpack(f"{order}{2 * count}{code}", data[where:where + size * count])
            tags[tag] = tuple(float(np.float32(a / b)) if b else 0.0
                              for a, b in zip(pairs[0::2], pairs[1::2]))
        else:
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
    """libtiff's PackBits decoder, to at most ``size`` bytes: a literal run
    or a repeat that the data cuts short ends it, without its bytes."""
    out = bytearray()
    pos, n = 0, len(src)
    while pos < n and len(out) < size:
        h = src[pos]
        pos += 1
        if h < 128:  # h + 1 literal bytes
            if pos + min(h + 1, size - len(out)) > n:
                break
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


def _unxz(src: bytes, size: int, path: str) -> bytes:
    """libtiff's LZMA codec: an xz stream, read until ``size`` bytes came
    out. libtiff stops there, and takes what came out before an error found
    in the same call (a bad check, data after the strip's): so where the
    whole stream fails, it is read again a byte at a time, and the strip
    fails only where it comes out short. Damage that shows only in the
    range coder's check at the end of the last chunk, after all the
    strip's bytes, still raises here (Python's lzma module drops those
    bytes with the error) where libtiff takes them."""
    try:
        import lzma
    except ImportError:
        raise ValueError(f"{path}: LZMA TIFF, and this Python has no lzma module (_lzma) to "
                         f"read it") from None
    try:
        out = lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(src, size)
    except lzma.LZMAError as e:
        error = e
    else:
        if len(out) < size:
            raise ValueError(f"{path}: truncated TIFF LZMA data: a strip or tile gives "
                             f"{len(out)} of {size} bytes")
        return out
    d, out = lzma.LZMADecompressor(lzma.FORMAT_XZ), bytearray()
    try:
        for i in range(len(src)):
            out += d.decompress(src[i:i + 1], size - len(out))
            if len(out) >= size:
                return bytes(out)
    except lzma.LZMAError:
        pass
    raise ValueError(f"{path}: corrupt TIFF LZMA data: {error}")


def _thunderscan(src: bytes, rows: int, width: int, path: str) -> bytes:
    """libtiff's ThunderScan decoder (``ThunderDecode``): rows of 4-bit
    pixels from runs of the last pixel, 2- and 3-bit deltas from it, and
    raw values; a row that gets fewer or more pixels than the image is
    wide fails the strip."""
    stride = (width + 1) // 2
    out = bytearray()
    bp = 0
    for y in range(rows):
        row = bytearray(stride)
        op = last = npx = 0

        def put(v):
            nonlocal op, last, npx
            last = v & 15
            if npx < width:
                if npx & 1:
                    row[op] |= last
                    op += 1
                else:
                    row[op] = last << 4
                npx += 1

        while bp < len(src) and npx < width:
            n = src[bp]
            bp += 1
            code = n & 0xC0
            if code == 0x00:  # a run of the last pixel, n long
                if npx & 1:
                    row[op] |= last
                    last = row[op]
                    op += 1
                    npx += 1
                    n -= 1
                else:
                    last |= last << 4
                npx += n
                if npx <= width:  # a run past the row is not written (and fails the row)
                    while n > 0:
                        row[op] = last
                        op += 1
                        n -= 2
                if n == -1:
                    op -= 1
                    row[op] &= 0xF0
                last &= 15
            elif code == 0x40:
                for d in ((n >> 4) & 3, (n >> 2) & 3, n & 3):
                    if _DELTA2[d] is not None:
                        put(last + _DELTA2[d])
            elif code == 0x80:
                for d in ((n >> 3) & 7, n & 7):
                    if _DELTA3[d] is not None:
                        put(last + _DELTA3[d])
            else:
                put(n)
        if npx != width:
            raise ValueError(f"{path}: corrupt ThunderScan data: row {y} of a strip has {npx} "
                             f"pixels, not {width} (libtiff fails the strip, and PIL with it)")
        out += row
    return bytes(out)


def _samples(raw: bytes, rows: int, cols: int, spp: int, bits: int, order: str,
             predictor: int, fmt: int) -> np.ndarray:
    """A strip's or tile's bytes -> (rows, cols, spp) samples (int64, or
    float32 for sample format 3), each row starting on a byte, the
    predictor undone."""
    stride = (cols * spp * bits + 7) // 8
    buf = np.frombuffer(raw, np.uint8, rows * stride).reshape(rows, stride)
    nb = bits // 8
    if predictor == 3:  # libtiff's fpAcc: bytes summed at a stride of spp, then byte planes
        acc = np.cumsum(buf.reshape(rows, cols * nb, spp).astype(np.int64), axis=1) & 255
        planes = acc.reshape(rows, nb, cols * spp).transpose(0, 2, 1).astype(np.uint8)
        return np.ascontiguousarray(planes).view(">f4").reshape(rows, cols, spp)
    if bits in (16, 32):
        px = buf.view(f"{order}u{nb}").astype(np.int64).reshape(rows, cols, spp)
    elif bits == 12:  # I;12: 12-bit samples packed most significant bit first
        b = np.unpackbits(buf, axis=1)[:, :cols * spp * 12].reshape(rows, cols, spp, 12)
        px = b.astype(np.int64) @ (1 << np.arange(11, -1, -1))
    else:
        px = _unpack(buf, cols, spp, bits).astype(np.int64)
    if predictor == 2:
        px = np.cumsum(px, axis=1) & ((1 << bits) - 1)
    if fmt == 3:
        return px.astype(np.uint32).view(np.float32)
    if fmt == 2:
        return np.where(px >= 1 << (bits - 1), px - (1 << bits), px)
    return px


def _mode(tags, order: str, comp: int, path: str) -> Tuple[str, int, int, int, int]:
    """PIL's ``_setup`` checks: (kind, photometric, bits per sample,
    samples per pixel, sample format), or a ValueError where PIL has no mode
    or the port lacks one."""
    photo = tags.get(262, (0,))[0]
    if photo in _PHOTOMETRIC:
        raise ValueError(f"{path}: {_PHOTOMETRIC[photo]} TIFF (photometric {photo}) is not read "
                         f"by the port")
    if photo not in (0, 1, 2, 3, 5, 6, 8):
        raise ValueError(f"{path}: TIFF photometric interpretation {photo} is not read")
    fill = tags.get(266, (1,))[0]
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
    if fmt not in ((1,), (2,), (3,)):
        raise ValueError(f"{path}: TIFF sample format {fmt} is not read by the port")
    bits = bps[0]
    kind = None
    if fmt == (3,):
        if grey and bps == (32,) and not extra:
            kind = "F"
    elif fmt == (2,):
        if photo == 1 and bps in ((16,), (32,)) and not extra:
            kind = "I"
    elif grey and not extra:
        if bps in ((1,), (2,), (4,), (8,), (16,)):
            kind = "grey"
            if bps == (16,) and photo == 0 and order == ">":
                raise ValueError(f"{path}: 16-bit big-endian WhiteIsZero TIFF: PIL has no mode "
                                 f"for it")
        elif bps in ((12,), (32,)) and photo == 1 and order == "<":
            kind = "grey" if bits == 12 else "I"  # I;12 and I;32N
    elif photo == 1:
        if bps == (8, 8) and extra == (2,):
            kind = "grey"
    elif photo == 2:
        if bps == (8,) * spp:
            ok = ((spp == 3 and not extra)
                  or (spp == 4 and extra in ((), (0,), (1,), (2,), (999,)))
                  or (spp in (5, 6) and len(extra) == spp - 3 and extra[0] in (0, 1, 2)
                      and not any(extra[1:])))
        else:
            ok = bps == (16,) * spp and ((spp == 3 and not extra)
                                         or (spp == 4 and extra in ((), (0,), (1,), (2,))))
        if ok:  # in planes, compressed, PIL takes an unnamed fourth sample as associated alpha
            assoc = spp == 4 and not extra and bits == 8 and comp != 1 and tags.get(
                284, (1,))[0] == 2
            kind = "RGBa" if extra[:1] == (1,) or assoc else "RGB"
    elif photo == 3:
        if (bps in ((1,), (2,), (4,), (8,)) and not extra) or (bps == (8, 8)
                                                               and extra in ((0,), (2,))):
            kind = "P"
    elif photo == 5:
        if (bps == (8,) * spp and extra == (0,) * (spp - 4) and spp in (4, 5, 6)) or (
                bps == (16,) * 4 and not extra):
            kind = "CMYK"
    elif photo == 6:
        if bps == (8, 8, 8) and not extra:
            kind = "YCbCr"
        elif bps == (8,) and not extra:
            if comp != 1:
                raise ValueError(f"{path}: compressed one-sample YCbCr TIFF: PIL fails on it "
                                 f"(libtiff's RGBA interface takes three samples)")
            kind = "grey"  # PIL opens it as L
    elif photo == 8:
        if bps == (8, 8, 8) and not extra:
            kind = "LAB"
    if kind is None:
        raise ValueError(f"{path}: TIFF photometric {photo} with {bps} bits, sample format "
                         f"{fmt[0]} and extra samples {extra}: PIL has no mode for it")
    if fill == 2 and not ((grey and not extra and fmt == (1,) and (
            bits in (1, 2, 4, 8) or (bits == 16 and photo == 1 and order == "<")))
            or (kind == "RGB" and bps == (8, 8, 8) and not extra)
            or (kind == "P" and not extra)):
        raise ValueError(f"{path}: TIFF with FillOrder 2 in photometric {photo} at {bps} bits: "
                         f"PIL has no mode for it")
    if fill == 2 and comp == 1 and ((kind == "grey" and photo == 0 and bits == 8)
                                    or (kind == "P" and bits < 8)):
        raise ValueError(f"{path}: uncompressed TIFF with FillOrder 2 in photometric {photo} at "
                         f"{bits} bits: PIL has no unpacker for it")
    if fill not in (1, 2):
        raise ValueError(f"{path}: TIFF FillOrder {fill} is not a valid one")
    if kind in ("F", "I") and comp != 1 and order == ">" and bits > 8:
        raise ValueError(f"{path}: compressed big-endian {bits}-bit signed or floating-point "
                         f"TIFF: PIL misreads it (libtiff gives native-order samples, PIL takes "
                         f"them as big-endian), so the port does not read it")
    return kind, photo, bits, spp, fmt[0]


def decode_tiff(data: bytes, path: str) -> np.ndarray:
    """The first image of a TIFF file's bytes as (H, W, 3) uint8 RGB (see the module
    docstring)."""
    order, big = _header(data, path)
    tags = _ifd(data, order, path, big)
    if 256 not in tags or 257 not in tags:
        raise ValueError(f"{path}: TIFF without its image width or length")
    width, height = tags[256][0], tags[257][0]
    comp = tags.get(259, (1,))[0]
    if comp == 6:
        rgb = _old_jpeg(data, tags, width, height, path, order)
        orient = tags.get(274, (1,))[0]
        return np.ascontiguousarray(_ORIENT[orient](rgb)) if orient in _ORIENT else rgb
    if comp in _COMPRESSION:
        raise ValueError(f"{path}: TIFF compression {comp}, {_COMPRESSION[comp]}")
    if comp not in (1, 5, 7, 8, 32773, 32809, 32946, 34925, 50000) + _FAX:
        raise ValueError(f"{path}: TIFF compression {comp} is not read by the port")
    kind, photo, bits, spp, fmt = _mode(tags, order, comp, path)
    if comp in _FAX and tags.get(258, (1,))[0] != 1:
        raise ValueError(f"{path}: CCITT fax TIFF at {tags.get(258)} bits a sample: libtiff "
                         f"fails on it (Bits/sample must be 1 for Group 3/4 encoding/decoding), "
                         f"and so does PIL")
    if comp == 32809 and (bits != 4 or 324 in tags):
        raise ValueError(f"{path}: ThunderScan TIFF at {bits} bits a sample or in tiles: "
                         f"libtiff's Thunder decoder reads only 4-bit strips (PIL fails on the "
                         f"other bit depths)")
    predictor = tags.get(317, (1,))[0] if comp in (5, 8, 32946, 34925, 50000) else 1
    if predictor not in (1, 2, 3) or (predictor == 2 and bits not in (8, 16, 32)) or (
            predictor == 3 and (fmt != 3 or order == ">")):
        raise ValueError(f"{path}: TIFF predictor {predictor} at {bits} bits is not read")
    planar = tags.get(284, (1,))[0]
    sub = tags.get(530, (2, 2))[:2] if kind == "YCbCr" else (1, 1)
    if kind == "YCbCr" and comp == 1:
        raise ValueError(f"{path}: uncompressed YCbCr TIFF: PIL reads its samples as RGBX, "
                         f"four bytes a pixel, and fails on it or misreads it")
    if kind == "YCbCr" and (comp != 7 or planar == 2) and (
            sub not in ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))
            or (planar == 2 and sub != (1, 1))):
        raise ValueError(f"{path}: YCbCr TIFF with subsampling {sub} and planar "
                         f"configuration {planar}: libtiff's RGBA interface, which PIL reads "
                         f"it with, fails on it")
    if comp == 7 and bits not in (8, 12):  # 12 bits: greyscale only, as PIL's modes
        raise ValueError(f"{path}: JPEG-in-TIFF at {bits} bits is not read by the port")
    if planar == 2 and spp == 1 and comp == 1 and not (
            (bits == 8 and photo != 0 and kind in ("grey", "P")) or (bits == 1 and photo == 1)
            or (kind in ("F", "I") and bits == 32 and order == "<")):
        raise ValueError(f"{path}: uncompressed one-sample TIFF in planes: PIL reads it by the "
                         f"first letter of its raw mode and fails on it or misreads it")
    tiled = 324 in tags
    extra = tags.get(338, ())
    if planar == 2 and spp > 1 and kind not in ("YCbCr", "CMYK", "LAB"):
        # compressed: PIL fails on extra samples in strips, reads them in tiles
        if (comp == 1 and (bits != 8 or kind != "RGB" or extra not in ((), (2,)))) or (
                comp != 1 and not tiled and (spp > 4 or extra == (0,) or (
                    spp == 4 and not extra and kind != "RGBa"))
        ) or (comp != 1 and tiled and ((spp == 4 and not extra and kind != "RGBa")
                                       or (kind, extra) == ("P", (0,)))):
            raise ValueError(f"{path}: planar TIFF with {spp} samples of {bits} bits, extra "
                             f"samples {extra} and compression {comp}: PIL fails on it or "
                             f"mis-reads it, and the port does not read it")
    if planar == 2 and comp == 1 and tiled and tags.get(256, (0,))[0] % tags[322][0] and spp != (
            {2: 3, 6: 3, 8: 3, 5: 4}.get(photo, 1) + len(extra)):
        raise ValueError(f"{path}: uncompressed planar TIFF with {spp} samples but "
                         f"{len(extra)} extra samples and a tile cut at the image's edge: PIL "
                         f"misreads that tile's stride")
    if planar == 2 and comp == 1 and tags.get(266, (1,))[0] == 2:
        raise ValueError(f"{path}: uncompressed planar TIFF with FillOrder 2: PIL reads each "
                         f"plane by its raw mode's first letter, without the bit reversal")
    if planar == 2 and kind == "CMYK" and (
            (spp != 4 and (comp == 1 or not tiled)) or (bits == 16 and comp == 1)):
        raise ValueError(f"{path}: planar CMYK TIFF at {bits} bits with {spp} samples: PIL "
                         f"fails on it or mis-reads it, and the port does not read it")
    if tiled:
        offsets, counts = tags[324], tags.get(325)
        bw, bh = tags[322][0], tags[323][0]
    elif 273 in tags:
        offsets, counts = tags[273], tags.get(279)
        bw, bh = width, min(tags.get(278, (height,))[0], height)
    else:
        raise ValueError(f"{path}: TIFF without strip or tile offsets")
    per_plane = 1 if planar == 1 else spp
    if comp == 7 and bits == 12 and bw % 2:
        raise ValueError(f"{path}: 12-bit JPEG-in-TIFF {bw} samples wide: libtiff's 12-bit "
                         f"codec packs samples in pairs and leaves the last of a row "
                         f"unwritten, so PIL shows memory it never set")
    cols, rows = -(-width // bw), -(-height // bh)
    orient = tags.get(274, (1,))[0]
    if orient in (5, 6, 7, 8) and comp == 1 and cols * rows == 1 and (
            planar == 1 or spp == 1) and _mapped(kind, photo, bits, spp, order, tags):
        raise ValueError(f"{path}: Orientation {orient} on an uncompressed single-strip or "
                         f"single-tile TIFF (PIL misreads it) is not read by the port")
    if len(offsets) < cols * rows * (spp if planar == 2 else 1):
        raise ValueError(f"{path}: TIFF with {len(offsets)} strips or tiles for "
                         f"{cols * rows} blocks")
    tables = bytes(tags.get(347, ()))
    reverse = tags.get(266, (1,))[0] == 2 and comp != 7
    fax = image_ccitt.decoder(bw, comp, tags) if comp in _FAX else None
    px = np.zeros((height, width, spp), np.float32 if fmt == 3 else np.int64)
    # PIL reads the blocks a row of strips or tiles at a time, each plane's
    # block in turn, through one libjpeg decompressor for JPEG: the tables a
    # stream defines stay for the streams read after it
    jpeg_tables = ({}, {})
    for by in range(rows):
        for bx in range(cols):
            for plane in range(spp if planar == 2 else 1):
                k = (plane * rows + by) * cols + bx
                off = offsets[k]
                n = counts[k] if counts else len(data) - off
                y0, x0 = by * bh, bx * bw
                h, w = min(bh, height - y0), min(bw, width - x0)
                block_rows = bh if tiled else h
                src = data[off:off + n]
                if reverse:
                    src = src.translate(_REVERSED)
                if comp == 7:  # in planes, each plane's streams have one component
                    block = _jpeg_block(src, b"" if k else tables, jpeg_tables,
                                        kind if planar == 1 else "plane", block_rows, bw,
                                        not tiled and by == rows - 1, tags, path, bits)
                    sl = slice(plane, plane + 1) if planar == 2 else slice(None)
                    px[y0:y0 + h, x0:x0 + w, sl] = block[:h, :w]
                    continue
                if kind == "YCbCr" and planar == 1:  # data units: hs x vs Y, then Cb, Cr
                    hs, vs = sub
                    urows = -(-block_rows // vs)
                    row_bytes = -(-bw // hs) * (hs * vs + 2)
                    # a strip is read as whole scanlines of TIFFScanlineSize, which
                    # rounds row_bytes / vs down (4x4 units, an odd number across)
                    need = urows * (row_bytes if tiled else vs * (row_bytes // vs))
                else:
                    need = block_rows * ((bw * (spp // per_plane) * bits + 7) // 8)
                if comp == 1:
                    raw = src
                elif comp == 5:
                    raw = _lzw(src, need)
                elif comp == 32773:
                    raw = _packbits(src, need)
                elif comp == 34925:
                    raw = _unxz(src, need, path)
                elif comp == 50000:
                    try:
                        raw = image_zstd.decompress(src, need)
                    except ValueError as e:
                        raise ValueError(f"{path}: TIFF {e}") from None
                elif fax is not None:
                    raw = image_ccitt.decode_block(fax, src, block_rows, off, path)
                elif comp == 32809:
                    raw = _thunderscan(src, block_rows, bw, path)
                else:
                    raw = _inflate(src, need)
                # libtiff's RGBA interface, which PIL reads YCbCr with, draws a
                # block that decodes short from a zeroed buffer, no predictor
                short = len(raw) < need
                if short and kind != "YCbCr":
                    raise ValueError(f"{path}: truncated TIFF data: a strip or tile gives "
                                     f"{len(raw)} of {need} bytes")
                raw = raw[:need] + bytes(max(0, need - len(raw)))
                if kind == "YCbCr" and planar == 1:
                    if predictor == 2 and not short:  # over scanlines, or 3 x a tile's width
                        raw = _hor_acc8(raw, 3 * bw if tiled else row_bytes // vs)
                    block = _ycbcr_units(raw, urows, bw, w if tiled else bw, sub)
                else:
                    block = _samples(raw, block_rows, bw, spp // per_plane, bits, order,
                                     1 if short else predictor, fmt)
                sl = slice(plane, plane + 1) if planar == 2 else slice(None)
                px[y0:y0 + h, x0:x0 + w, sl] = block[:h, :w]
    if kind == "LAB" and planar == 2:  # PIL's A and B band unpackers flip the sign bit
        px[:, :, 1:] ^= 128
    if comp == 7 and kind == "YCbCr" and planar == 1:
        rgb = px.astype(np.uint8)
    else:
        rgb = _to_rgb(px, kind, photo, bits, tags, path)
    return np.ascontiguousarray(_ORIENT[orient](rgb)) if orient in _ORIENT else \
        np.ascontiguousarray(rgb)


def _old_jpeg(data: bytes, tags, width: int, height: int, path: str,
              order: str = "<") -> np.ndarray:
    """Old-style JPEG-in-TIFF (compression 6) with a JPEGInterchangeFormat
    stream (tag 513) of the whole image, or baseline tables in tags and one
    strip, as libtiff's OJPEG codec and PIL read it: PIL takes the
    photometric as YCbCr for its mode (three samples RGB, one L); libtiff
    decodes the stream's components at their own size and, for three,
    repeats the chroma over its data units and converts with
    ``TIFFYCbCrToRGB``."""
    spp = tags.get(277, (3,))[0]
    if tags.get(258, (8,))[:1] != (8,) or spp not in (1, 3):
        raise ValueError(f"{path}: old-style JPEG-in-TIFF with {spp} samples of "
                         f"{tags.get(258)} bits: PIL has no mode for it")
    if 513 in tags:
        off = tags[513][0]
        stream = data[off:off + tags[514][0]] if 514 in tags else data[off:]
    else:
        stream = _old_jpeg_stream(data, tags, width, height, spp, path, order)
    # libtiff's OJPEG codec fails on one component sampled other than 1x1
    planes = decode_jpeg(stream, path, "replicated", sampling=(1, 1) if spp == 1 else None,
                         libtiff="ojpeg")
    if planes.shape[:2] != (height, width) or planes.shape[2] != spp:
        raise ValueError(f"{path}: old-style JPEG stream of {planes.shape} for a "
                         f"{width} x {height} TIFF of {spp} samples")
    if spp == 1:
        return np.repeat(planes, 3, axis=2)
    return _ycbcr_to_rgb(planes.astype(np.int64), tags, path)


def _old_jpeg_stream(data: bytes, tags, width: int, height: int, spp: int, path: str,
                     order: str = "<") -> bytes:
    """The baseline JPEG stream of an old-style JPEG-in-TIFF whose tables
    are in tags (JPEGQTables 519, JPEGDCTables 520, JPEGACTables 521; the
    i-th of each for component i) and whose strips, or one tile, hold the
    entropy-coded data: the first component sampled by YCbCrSubsampling
    (2x2 where the tag is absent), the others 1x1. As libtiff's OJPEG codec
    builds it: the strips' data one after the other with an RST marker
    between two strips (RST0, RST1, ... RST7, RST0, ...) and, where the
    strips are fewer rows than the image, a restart interval of one strip's
    MCUs whatever JPEGRestartInterval says (a strip whose rows are not a
    whole number of MCU rows fails in libtiff, and in PIL); one strip takes
    JPEGRestartInterval (515) as its restart interval."""
    if tags.get(512, (1,))[0] != 1 or not all(t in tags for t in (519, 520, 521)):
        raise ValueError(f"{path}: old-style JPEG-in-TIFF without a JPEGInterchangeFormat "
                         f"stream or baseline tables in tags is not read by the port")
    offsets = tags.get(273) or tags.get(324)
    counts = tags.get(279) or tags.get(325)
    if not offsets or (273 not in tags and len(offsets) != 1):
        raise ValueError(f"{path}: old-style JPEG-in-TIFF with its tables in tags and "
                         f"{len(offsets or ())} tiles is not read by the port")

    def segment(marker: int, body: bytes) -> bytes:
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    out = b"\xff\xd8"
    hs, vs = tags.get(530, (2, 2))[:2] if spp == 3 else (1, 1)
    for i in range(spp):
        q = data[tags[519][i]:tags[519][i] + 64]
        dc, ac = (data[tags[t][i]:tags[t][i] + 16] for t in (520, 521))
        dc += data[tags[520][i] + 16:tags[520][i] + 16 + sum(dc)]
        ac += data[tags[521][i] + 16:tags[521][i] + 16 + sum(ac)]
        out += segment(0xDB, bytes([i]) + q) + segment(0xC4, bytes([i]) + dc)
        out += segment(0xC4, bytes([0x10 | i]) + ac)
    comps = b"".join(bytes([i + 1, (hs << 4 | vs) if i == 0 else 0x11, i]) for i in range(spp))
    out += segment(0xC0, struct.pack(">BHHB", 8, height, width, spp) + comps)
    restart = tags.get(515, (0,))[0]
    rows = tags.get(278, (height,))[0] if 273 in tags else height
    if rows < height:
        if rows % (8 * vs):
            raise ValueError(f"{path}: old-style JPEG-in-TIFF in strips of {rows} rows, not a "
                             f"whole number of {8 * vs}-row MCU rows: libtiff fails on it "
                             f"(Incompatible vertical subsampling and image strip/tile "
                             f"length), and so does PIL")
        restart = -(-width // (8 * hs)) * (rows // (8 * vs))
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    out += segment(0xDA, bytes([spp]) + b"".join(bytes([i + 1, i << 4 | i])
                                                 for i in range(spp)) + b"\x00\x3f\x00")
    n_strips = -(-height // rows)
    if n_strips > 1 and order == ">":
        raise ValueError(f"{path}: big-endian old-style JPEG-in-TIFF with its tables in tags "
                         f"over {n_strips} strips: PIL reads the strips after the first "
                         f"otherwise than in the same file little-endian, which the port does "
                         f"not follow")
    for i, off in enumerate(offsets[:n_strips]):
        n = counts[i] if counts and i < len(counts) else len(data) - off
        out += data[off:off + n] + (bytes([0xFF, 0xD0 + i % 8]) if i < n_strips - 1 else b"")
    return out + b"\xff\xd9"


def _jpeg_block(src: bytes, tables: bytes, persist, kind: str, rows: int, cols: int,
                last_strip: bool, tags, path: str, bits: int = 8) -> np.ndarray:
    """One strip's or tile's JPEG stream, as libtiff's JPEG codec hands it to
    PIL: (rows, cols, C) samples, YCbCr already RGB; at 12 bits libtiff's
    12-bit JPEG codec, whose samples PIL unpacks as ``I;12``. ``persist``
    holds the tables of the JPEGTables stream and the blocks read before."""
    if kind == "YCbCr":
        sampling = tuple(tags[530][:2]) if 530 in tags else None
        block = decode_jpeg(src, path, "ycc", tables, sampling=sampling or "any",
                            persist=persist, libtiff="jpeg")
    else:
        block = decode_jpeg(src, path, "planes", tables, sampling=(1, 1), precision=bits,
                            persist=persist, libtiff="jpeg")
    h, w = block.shape[:2]
    if last_strip and w == cols and h > rows:
        block = block[:rows]  # libtiff cuts a last strip's stream to the image
    elif h > rows or w > cols:
        raise ValueError(f"{path}: JPEG-in-TIFF stream of {w} x {h} exceeds its strip or tile "
                         f"of {cols} x {rows}")
    elif h < rows or w < cols:
        raise ValueError(f"{path}: JPEG-in-TIFF stream of {w} x {h} is smaller than its strip "
                         f"or tile of {cols} x {rows}")
    return block


def _hor_acc8(raw: bytes, rowsize: int) -> bytes:
    """libtiff's ``horAcc8`` with a stride of three samples over each row of
    ``rowsize`` bytes (its ``TIFFScanlineSize`` for a YCbCr strip, which
    cuts through data units). Where the rows do not divide the block, or
    three a row, libtiff fails on the block before it accumulates a byte;
    PIL's RGBA read does not stop on errors and draws the bytes as they
    were decoded."""
    if not rowsize or len(raw) % rowsize or rowsize % 3:
        return raw
    rows = np.frombuffer(raw, np.uint8).reshape(-1, rowsize // 3, 3).astype(np.int64)
    return (np.cumsum(rows, axis=1) & 255).astype(np.uint8).tobytes()


def _ycbcr_units(raw: bytes, urows: int, cols: int, shown: int,
                 sub: Tuple[int, int]) -> np.ndarray:
    """YCbCr data units (hs x vs luma samples, then Cb and Cr) of a strip or
    tile ``cols`` wide -> (urows * vs, shown units * hs, 3) samples, the
    chroma replicated, as libtiff's ``putcontig8bitYCbCr*tile`` walk them:
    the bytes past ``raw`` are zero, and in a tile cut at the image's edge
    each row of units skips the units past ``shown`` columns, by 4x2 units
    in a 4x4 tile, as libtiff does."""
    hs, vs = sub
    n = hs * vs + 2
    ucols, vis = -(-cols // hs), -(-shown // hs)
    skip = ((cols - shown) // hs) * (10 if sub == (4, 4) else n)
    starts = (np.arange(urows)[:, None] * (vis * n + skip) + np.arange(vis)[None, :] * n)
    buf = np.zeros(max(len(raw), urows * ucols * n), np.int64)
    buf[:len(raw)] = np.frombuffer(raw, np.uint8)
    u = buf[np.minimum(starts[:, :, None] + np.arange(n), buf.size - 1)]
    y = u[:, :, :hs * vs].reshape(urows, vis, vs, hs).transpose(0, 2, 1, 3).reshape(
        urows * vs, vis * hs)
    cb, cr = (np.repeat(np.repeat(u[:, :, i], vs, axis=0), hs, axis=1) for i in (-2, -1))
    return np.stack([y, cb, cr], axis=-1)


def _ycbcr_to_rgb(ycc: np.ndarray, tags, path: str) -> np.ndarray:
    """libtiff's ``TIFFYCbCrToRGBInit`` tables (float32 arithmetic, as in
    tif_color.c) and ``TIFFYCbCrtoRGB``."""
    f32 = np.float32
    luma = [f32(v) for v in tags.get(529, (0.299, 0.587, 0.114))[:3]]
    rbw = [f32(v) for v in tags.get(532, (0, 255, 128, 255, 128, 255))[:6]]
    if len(luma) < 3 or len(rbw) < 6 or any(np.isnan(luma)) or luma[1] == 0 or any(
            not (-0x7FFFFFFF + 128 < v < 0x7FFFFFFF) for v in rbw):
        raise ValueError(f"{path}: YCbCr TIFF with invalid YCbCrCoefficients or "
                         f"ReferenceBlackWhite (libtiff fails on it)")

    def fix(v):
        return int(np.float64(np.clip(v, f32(0), f32(2))) * 65536 + 0.5)

    f1 = f32(2) - f32(2) * luma[0]
    d1 = fix(f1)
    d2 = -fix(luma[0] * f1 / luma[1])
    f3 = f32(2) - f32(2) * luma[2]
    d3 = fix(f3)
    d4 = -fix(luma[2] * f3 / luma[1])

    def code2v(c, rb, rw, cr):
        den = f32(rw - rb) if rw - rb != 0 else f32(1)
        v = (c - np.int64(np.trunc(rb))).astype(f32) * f32(cr) / den
        return np.trunc(np.clip(v, f32(-128 * 32), f32(128 * 32))).astype(np.int64)

    x = np.arange(-128, 128)
    cr = code2v(x, rbw[4] - f32(128), rbw[5] - f32(128), 127)
    cb = code2v(x, rbw[2] - f32(128), rbw[3] - f32(128), 127)
    cr_r, cb_b = (d1 * cr + 32768) >> 16, (d3 * cb + 32768) >> 16
    cr_g, cb_g = d2 * cr, d4 * cb + 32768
    y_tab = code2v(x + 128, rbw[0], rbw[1], 255)
    yv = y_tab[ycc[:, :, 0]]
    c_b, c_r = ycc[:, :, 1], ycc[:, :, 2]
    rgb = np.stack([yv + cr_r[c_r], yv + ((cb_g[c_b] + cr_g[c_r]) >> 16), yv + cb_b[c_b]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _mapped(kind: str, photo: int, bits: int, spp: int, order: str, tags) -> bool:
    """Whether PIL's mode equals its raw mode and is one it memory-maps:
    L, P, RGBA, CMYK, I;16 and I;16B."""
    extra = tags.get(338, ())
    if kind == "grey":
        return spp == 1 and ((bits == 8 and photo in (1, 6))
                             or (bits == 16 and (order == "<" or photo == 1)))
    if kind == "P":
        return bits == 8 and spp == 1
    if kind == "CMYK":
        return bits == 8 and spp == 4
    return kind == "RGB" and bits == 8 and spp == 4 and extra in ((), (2,), (999,))


def _to_rgb(px: np.ndarray, kind: str, photo: int, bits: int, tags, path: str) -> np.ndarray:
    """Samples -> RGB as PIL opens the mode and converts it."""
    if kind == "P":
        cmap = tags.get(320)
        if cmap is None or len(cmap) < 3:
            raise ValueError(f"{path}: palette TIFF without a colormap")
        n = len(cmap) // 3
        pal = np.zeros((256, 3), np.uint8)
        m = min(n, 256)
        pal[:m] = (np.asarray(cmap[:3 * n], np.int64).reshape(3, n).T[:m] >> 8)
        return pal[px[:, :, 0]]
    if kind in ("F", "I"):
        v = px[:, :, 0]
        if kind == "F":  # F -> L: 0 at or below 0 and for NaN, 255 at or above 255, truncated
            v = np.where(v >= 255, 255, np.where(v > 0, np.trunc(np.nan_to_num(v)), 0))
        else:  # I;32N: unsigned samples taken as int32
            v = np.where(v >= 1 << 31, v - (1 << 32), v)
        v = np.clip(v, 0, 255).astype(np.uint8)
        return np.repeat(v[:, :, None], 3, axis=2)
    if kind == "grey":
        v = px[:, :, 0].astype(np.int64)
        if bits >= 12:
            v = np.minimum(v, 255)
        else:
            if photo == 0:
                v = (1 << bits) - 1 - v
            v = v * (255 // ((1 << bits) - 1))
        return np.repeat(v.astype(np.uint8)[:, :, None], 3, axis=2)
    v = px[:, :, :4].astype(np.int64)
    if bits == 16:
        v = v >> 8
    if kind == "CMYK":
        return cmyk_to_rgb(*np.moveaxis(v, -1, 0))
    if kind == "YCbCr":
        return _ycbcr_to_rgb(v, tags, path)
    if kind == "LAB":
        return image_lab.lab_to_rgb(v[:, :, :3].astype(np.uint8))
    if kind == "RGBa":
        a = v[:, :, 3:4]
        v = np.where(a == 0, 0, np.where(a == 255, v, np.minimum(v * 255 // np.maximum(a, 1),
                                                                  255)))
    return np.ascontiguousarray(v[:, :, :3].astype(np.uint8))
