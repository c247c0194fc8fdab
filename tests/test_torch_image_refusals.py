"""Refusal parity: each ValueError the port's image readers still raise on
a file PIL can write or a test can build is one where PIL 12.1 also fails,
or one where PIL reads the file in a documented wrong way, asserted here
pixel for pixel. ``refused`` holds each case: the port must raise with a
message that names the format and what it lacks (``match``), and PIL must
fail (``misread`` None) or give ``misread(file)``'s pixels.

Covered: FillOrder 2 where PIL has no mode or no unpacker; 12-bit JPEG and
lossless JPEG at other precisions; lossless JPEG in YCbCr or YCCK, with a
restart interval of part of an MCU row, arithmetic-coded (SOF11);
hierarchical JPEG; uncompressed YCbCr TIFF (PIL fails, or reads four
bytes a pixel where the file goes on); old-style JPEG-in-TIFF of one
component sampled 2x2; Orientation 5-8 on a single-block uncompressed TIFF
PIL maps into memory (PIL takes the pixels in file order as an image of
the swapped size, then turns it), in L and in CMYK; compressed big-endian
float, int32 and signed 16-bit TIFF (PIL takes libtiff's native-order
samples as big-endian); planar uncompressed 16-bit CMYK and RGB (PIL takes
each plane's first H x W bytes as 8-bit samples), one WhiteIsZero sample
in planes (PIL cuts its raw mode to the first letter, so the samples are
not inverted), planes with FillOrder 2 (the bytes taken as stored, bits
reversed), planar RGBA without ExtraSamples in tiles cut at the edge (PIL
divides the tile's row of four samples by three: a stride of 21 bytes,
not 16); big-endian BigTIFF; PAM and colour PFM; TGA with 32-bit colour
maps or run packets across rows; a PNG cursor.
"""

import io

import numpy as np
import pytest
from PIL import Image

from audioeditingcode_tpu_torch.utils import image_io as tio
from test_torch_image_codecs import write
from test_torch_image_formats import _pattern, _pil
from test_torch_image_jpeg_processes import ADOBE_RGB, JFIF, lossless_jpeg
from test_torch_image_pnm_tga_ico import ico, tga
from test_torch_image_tiff import old_jpeg_tiff


def _jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _sof_patched(data: bytes, marker=None, precision=None) -> bytes:
    out = bytearray(data)
    i = out.index(b"\xff\xc0")
    if marker is not None:
        out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


RNG = np.random.default_rng(7)
GREY = RNG.integers(0, 256, (9, 13, 1))
YCC = RNG.integers(0, 256, (9, 13, 3))
RGBA = RNG.integers(0, 256, (19, 27, 4))
CMYK8 = RNG.integers(0, 256, (9, 13, 4))
IMG = _pattern(24, 24, noise=0.3)


def _tiff(**kw):
    def build(path):
        return write(path, **kw)
    return build


def _bytes(data_fn):
    def build(path):
        with open(path, "wb") as f:
            f.write(data_fn())
        return path
    return build


def _rgbx(path):
    """Uncompressed YCbCr as PIL reads it: RGBX, four bytes a pixel, past the
    strip's end into the file."""
    data = open(path, "rb").read()
    w = YCC.shape[1]  # the strip starts after BigTIFF's 16-byte header
    return ("first row", np.frombuffer(data, np.uint8, 4 * w, 16).reshape(w, 4)[:, :3])


# Orientation 5-8 as PIL applies it on load, to (H, W, bands)
_ORIENTED = {5: lambda a: a.transpose(1, 0, 2), 6: lambda a: np.rot90(a, -1),
             7: lambda a: np.rot90(a, 2).transpose(1, 0, 2), 8: lambda a: np.rot90(a, 1)}


def _swapped_order(orientation, h, w):
    """A memory-mapped L strip as PIL reads it: the pixels in file order as
    an image of the swapped size, then turned."""
    def misread(path):
        return ("L", _ORIENTED[orientation](GREY.astype(np.uint8).reshape(w, h, 1))[:, :, 0])
    return misread


def _byteswapped(dtype):
    """Compressed big-endian samples as PIL reads them from libtiff: the
    native (little-endian) samples taken as big-endian."""
    def misread(path):
        v = SAMPLES[dtype].astype(">" + dtype).astype("<" + dtype).view(">" + dtype).astype(
            np.float64)
        v = np.nan_to_num(v, nan=0.0, posinf=255, neginf=0)
        v = np.where(v >= 255, 255, np.where(v > 0, np.trunc(v), 0))
        return ("L", v[:, :, 0].astype(np.uint8))
    return misread


SAMPLES = {"f4": (RNG.standard_normal((9, 13, 1)) * 150 + 100).astype(np.float32),
           "i4": RNG.integers(-40000, 40000, (9, 13, 1)).astype(np.int32),
           "i2": RNG.integers(-400, 400, (9, 13, 1)).astype(np.int16)}


CMYK16 = RNG.integers(0, 65536, (9, 13, 4))
RGB16 = RNG.integers(0, 65536, (9, 13, 3))
REVERSED_BITS = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _bands(want):
    """A misread given as PIL's own bands, before any conversion."""
    def misread(path):
        return ("bands", want)
    return misread


def _first_bytes_of_planes(samples):
    """Planar 16-bit samples as PIL reads them: each plane's first H x W
    bytes (the little-endian samples' low and high bytes in turn) as 8-bit
    samples."""
    h, w, n = samples.shape
    return _bands(np.stack([np.frombuffer(samples[:, :, b].astype("<u2").tobytes()[:h * w],
                                          np.uint8).reshape(h, w) for b in range(n)], -1))


def _tile_stride_21(path):
    """Planar RGBA tiles of 16 x 16 without ExtraSamples, as PIL reads them:
    whole tiles right, but each tile cut at the right edge read at a row
    stride of int(16 * 32 / 8 / 3) = 21 bytes from its offset (PIL divides
    by the three samples RGB has without ExtraSamples), running into the
    file's next tile."""
    data = open(path, "rb").read()
    offsets = Image.open(path).tag_v2[324]  # per plane, row-major over the 2 x 2 tiles
    want = RGBA.astype(np.uint8).copy()
    for b in range(4):
        for ty in (0, 1):
            off = offsets[b * 4 + ty * 2 + 1]
            for r in range(min(16, RGBA.shape[0] - 16 * ty)):
                want[16 * ty + r, 16:, b] = np.frombuffer(data, np.uint8, 11, off + 21 * r)
    return ("bands", want)


# each case: (build(path) -> path, misread or None, what the port's message must name)
refused = {
    "fill order 2, 8-bit WhiteIsZero, raw": (_tiff(px=GREY, bits=8, photo=0, fill=2), None,
                                             r"uncompressed TIFF with FillOrder 2"),
    "fill order 2, 4-bit palette, raw": (_tiff(px=GREY % 16, bits=4, photo=3, fill=2, more={
        320: (3, list(RNG.integers(0, 65536, 48)))}), None, r"uncompressed TIFF with FillOrder 2"),
    "fill order 2, 16-bit big-endian": (_tiff(px=GREY * 200, bits=16, photo=1, order=">",
                                              comp=5, fill=2), None, r"TIFF with FillOrder 2"),
    "fill order 2, RGBA": (_tiff(px=RNG.integers(0, 256, (9, 13, 4)), bits=8, photo=2, fill=2,
                                 more={338: (3, [2])}), None, r"TIFF with FillOrder 2"),
    "12-bit JPEG": (_bytes(lambda: _sof_patched(_jpeg(IMG), precision=12)), None,
                    r"12-bit JPEG"),
    "lossless JPEG, 12-bit": (_bytes(lambda: lossless_jpeg([IMG[:, :, 0].astype(np.int64) * 16],
                                                           [(1, 1)], 1, precision=12)), None,
                              r"12-bit JPEG"),
    "lossless JPEG, 4-bit": (_bytes(lambda: lossless_jpeg([IMG[:, :, 0] // 16], [(1, 1)], 1,
                                                          precision=4)), None, r"4-bit JPEG"),
    "lossless JPEG in YCbCr (JFIF)": (_bytes(lambda: lossless_jpeg(
        [IMG[:, :, i] for i in range(3)], [(1, 1)] * 3, 1, app=JFIF)), None,
        r"lossless JPEG in YCbCr"),
    "lossless JPEG, restart in an MCU row": (_bytes(lambda: lossless_jpeg(
        [IMG[:, :, 0]], [(1, 1)], 1, restart_rows=1).replace(
        b"\xff\xdd\x00\x04\x00\x18", b"\xff\xdd\x00\x04\x00\x05")), None,
        r"lossless JPEG restart interval 5"),
    "lossless JPEG in YCCK (Adobe transform 2)": (_bytes(lambda: lossless_jpeg(
        [IMG[:, :, i % 3] for i in range(4)], [(1, 1)] * 4, 1, app=ADOBE_RGB[:-1] + b"\x02")),
        None, r"lossless YCCK JPEG"),
    "arithmetic-coded lossless JPEG (SOF11)": (_bytes(lambda: lossless_jpeg(
        [IMG[:, :, 0]], [(1, 1)], 1, sof=0xCB)), None, r"arithmetic-coded lossless JPEG \(SOF11\)"),
    "hierarchical JPEG (SOF5)": (_bytes(lambda: _sof_patched(_jpeg(IMG), marker=0xC5)), None,
                                 r"hierarchical JPEG \(SOF5\)"),
    "uncompressed YCbCr TIFF from PIL": (
        lambda path: Image.fromarray(IMG).convert("YCbCr").save(path, format="TIFF") or path,
        None, r"uncompressed YCbCr TIFF"),
    "uncompressed YCbCr BigTIFF, data after the strip": (
        _tiff(px=YCC, bits=8, photo=6, big=True,
              more={530: (3, [1, 1])}), _rgbx, r"uncompressed YCbCr TIFF"),
    "old-style JPEG, one component sampled 2x2": (
        lambda path: old_jpeg_tiff(path, IMG[:, :, 0], 1, 2), None,
        r"JPEG sampling factors \[\(2, 2\)\] where libtiff requires \(1, 1\)"),
    **{f"Orientation {o}, single-strip uncompressed L": (
        _tiff(px=GREY, bits=8, photo=1, more={274: (3, [o])}), _swapped_order(o, 9, 13),
        rf"Orientation {o} on an uncompressed single-strip or single-tile TIFF")
       for o in (5, 6, 7, 8)},
    **{f"compressed big-endian {name}": (
        _tiff(px=SAMPLES[dt], bits=8 * int(dt[1]), photo=1, order=">", comp=8, fmt=fmt),
        _byteswapped(dt), rf"compressed big-endian {bits}-bit signed or floating-point TIFF")
       for name, dt, fmt, bits in (("float32", "f4", 3, 32), ("int32", "i4", 2, 32),
                                   ("int16", "i2", 2, 16))},
    "planar uncompressed 16-bit CMYK": (_tiff(px=CMYK16, bits=16, photo=5, planar=2),
                                        _first_bytes_of_planes(CMYK16),
                                        r"planar CMYK TIFF at 16 bits"),
    "planar uncompressed 16-bit RGB": (_tiff(px=RGB16, bits=16, photo=2, planar=2),
                                       _first_bytes_of_planes(RGB16),
                                       r"planar TIFF with 3 samples of 16 bits"),
    "big-endian BigTIFF": (_tiff(px=GREY, bits=8, photo=1, order=">", big=True), None,
                           r"big-endian BigTIFF"),
    "one uncompressed 8-bit WhiteIsZero sample in planes": (
        _tiff(px=GREY, bits=8, photo=0, planar=2), _bands(GREY[:, :, 0]),
        r"uncompressed one-sample TIFF in planes"),
    "uncompressed planar RGB, FillOrder 2": (
        _tiff(px=YCC, bits=8, photo=2, planar=2, fill=2), _bands(REVERSED_BITS[YCC]),
        r"uncompressed planar TIFF with FillOrder 2"),
    "uncompressed planar RGBA without ExtraSamples, a tile cut at the edge": (
        _tiff(px=RGBA, bits=8, photo=2, planar=2, tile=(16, 16)), _tile_stride_21,
        r"planar TIFF with 4 samples but 0 extra samples and a tile cut at the image's edge"),
    "Orientation 6, single-strip uncompressed CMYK": (
        _tiff(px=CMYK8, bits=8, photo=5, more={274: (3, [6])}),
        _bands(_ORIENTED[6](CMYK8.astype(np.uint8).reshape(13, 9, 4))),
        r"Orientation 6 on an uncompressed single-strip or single-tile TIFF"),
    "one uncompressed 16-bit sample in planes": (
        _tiff(px=GREY * 200, bits=16, photo=1, planar=2), None,
        r"uncompressed one-sample TIFF in planes"),
    "PAM (P7)": (_bytes(lambda: b"P7\nWIDTH 2\nHEIGHT 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n"
                        + bytes(4)), None, r"Netpbm magic b'P7'"),
    "colour PFM (PF)": (_bytes(lambda: b"PF\n2 2\n-1.0\n" + bytes(48)), None,
                        r"Netpbm magic b'PF'"),
    "TGA, 32-bit colour map": (_bytes(lambda: tga(1, 8, bytes(8), 4, 2, cmap=bytes(16),
                                                  cmap_depth=32)), None,
                               r"TGA colour map of 32-bit entries"),
    "TGA, run packet across a row": (_bytes(lambda: tga(10, 24, b"\x85" + bytes(3), 3, 2)),
                                     None, r"TGA run packet across a row"),
    "PNG cursor": (_bytes(lambda: ico([(16, 16, 0, 32, _png16())], cur=True)), None,
                   r"PNG cursor"),
}


def _png16():
    buf = io.BytesIO()
    Image.fromarray(_pattern(16, 16)).save(buf, "PNG")
    return buf.getvalue()


@pytest.mark.parametrize("case", sorted(refused))
def test_refusal_is_pil_failing_or_misreading(tmp_path, case):
    build, misread, names = refused[case]
    path = build(str(tmp_path / "f"))
    with pytest.raises(ValueError, match=names):
        tio.read_image(path)
    if misread is None:
        with pytest.raises(Exception):
            _pil(path)
        return
    how, want = misread(path)
    if how == "first row":
        np.testing.assert_array_equal(_pil(path)[0], want)
    elif how == "bands":  # PIL's own bands, before any conversion
        np.testing.assert_array_equal(np.asarray(Image.open(path)), want)
    else:  # "L": PIL's own single-band reading
        np.testing.assert_array_equal(np.asarray(Image.open(path).convert("L")), want)


def test_every_case_compares():
    assert len(refused) == 35
