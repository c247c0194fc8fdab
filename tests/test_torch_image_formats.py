"""The port's image decoders (utils/image_io.py, numpy only) against PIL
12.1's ``np.array(Image.open(p).convert("RGB"))``, the JAX CLIs' reader,
on the CPU. Every case must be bit-equal.

- PNG in every colour type and bit depth (1, 2, 4, 8, 16), non-interlaced
  and Adam7 (also at sizes under 8 px, where some passes are empty), with
  all five scanline filters and with ``tRNS``, from the small zlib encoder
  below (Pillow writes no Adam7 and no 16-bit colour PNG).
- Baseline JPEG from PIL at quality 5, 75 and 100, subsampling 4:4:4,
  4:2:2 and 4:2:0, greyscale, optimized Huffman tables, odd sizes (1 x 1,
  17 x 9, 511 x 383), with and without restart markers; re-ordered tables,
  APPn/COM segments, SOF1 and the Adobe APP14 RGB flag.
- Progressive JPEG from PIL (``progressive=True``) at the same qualities,
  subsamplings, greyscale and odd sizes, with and without restart
  markers; a truncated progressive file raises, as PIL does; a
  progressive file whose last refinement scans are cut off is smoothed as
  libjpeg smooths it (``image_jpeg_smooth``; more cases in
  test_torch_image_jpeg_processes.py).
- ``load_image`` on each, and on one committed input of each kind added
  since (TIFF kinds, animated WebP, Netpbm, TGA, ICO, lossless and
  arithmetic-coded JPEG), equals the JAX ``load_image``.
- The JPEG processes left out (hierarchical, arithmetic-coded lossless and
  12-bit JPEG) raise a ValueError naming them. GIF, BMP, TIFF, WebP and
  CMYK/YCCK JPEG are held against PIL in test_torch_image_codecs.py; the
  kinds added since in test_torch_image_tiff.py, _webp_anim.py,
  _pnm_tga_ico.py and _jpeg_processes.py.
- The inputs ``chip_smoke.py`` decodes on the card (tests/data/images/)
  are what ``make_chip_inputs`` writes, and their sha256 file holds the
  hash of PIL's decode.
"""

import hashlib
import json
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from audioeditingcode_tpu.utils import image_io as jio
from audioeditingcode_tpu_torch.utils import image_io as tio
from test_torch_helpers import REPO

DATA = os.path.join(REPO, "tests", "data", "images")
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


# ------------------------------------------------------------ PNG encoder
def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def _pack(samples: np.ndarray, bits: int) -> np.ndarray:
    """(h, w, c) samples -> (h, stride) scanline bytes."""
    h, w, c = samples.shape
    if bits == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if bits == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    per = 8 // bits
    flat = samples.reshape(h, -1).astype(np.uint8)
    pad = (-flat.shape[1]) % per
    flat = np.pad(flat, ((0, 0), (0, pad))).reshape(h, -1, per)
    return sum(flat[:, :, i] << (8 - bits * (i + 1)) for i in range(per)).astype(np.uint8)


def _filter(rows: np.ndarray, bpp: int, first: int) -> bytes:
    """Each scanline with a filter byte, the types 0-4 taken in turn from
    ``first``."""
    out = b""
    prior = np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        ftype = (first + y) % 5
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if ftype == 0:
            pred = np.zeros_like(row)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prior
        elif ftype == 3:
            pred = (left + prior) >> 1
        else:
            p = left + prior - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, up_left))
        out += bytes([ftype]) + ((row - pred) % 256).astype(np.uint8).tobytes()
        prior = row
    return out


def write_test_png(path, samples, bits, ctype, interlace=False, palette=None, trns=None):
    """A PNG of (h, w, c) samples at ``bits`` in colour type ``ctype``,
    Adam7 when ``interlace``, filters 0-4 in turn, zlib level 9."""
    h, w, c = samples.shape
    bpp = max(1, c * bits // 8)
    passes = ([samples[y0::dy, x0::dx] for x0, y0, dx, dy in _ADAM7] if interlace
              else [samples])
    raw = b"".join(_filter(_pack(p, bits), bpp, i) for i, p in enumerate(passes)
                   if p.shape[0] and p.shape[1])
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bits, ctype,
                                                             0, 0, int(interlace)))
    if palette is not None:
        data += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    data += _chunk(b"IDAT", zlib.compress(raw, 9)) + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)
    return path


def _pil(path):
    return np.asarray(Image.open(path).convert("RGB"))


def _samples(rng, h, w, c, bits):
    """Random samples with the edge values of the depth present."""
    s = rng.integers(0, 1 << bits, (h, w, c))
    edges = [0, (1 << bits) - 1, min(255, (1 << bits) - 1), min(256, (1 << bits) - 1)]
    flat = s.reshape(-1)
    flat[:min(4, flat.size)] = edges[:min(4, flat.size)]
    return s


PNG_CASES = [(ctype, bits) for ctype, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)),
                                                 (3, (1, 2, 4, 8)), (4, (8, 16)), (6, (8, 16)))
             for bits in depths]
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("ctype,bits", PNG_CASES)
def test_png_is_bit_equal_to_pil(tmp_path, ctype, bits, interlace):
    rng = np.random.default_rng(ctype * 100 + bits)
    for h, w in ((1, 1), (3, 5), (7, 9), (13, 29)):
        s = _samples(rng, h, w, CHANNELS[ctype], bits)
        palette = None
        if ctype == 3:
            n = max(1, (1 << bits) - 3)  # a palette shorter than the index range
            palette = rng.integers(0, 256, (n, 3))
        path = write_test_png(str(tmp_path / f"{h}x{w}.png"), s, bits, ctype, interlace,
                              palette)
        np.testing.assert_array_equal(tio.read_png_rgb(path), _pil(path), err_msg=f"{h}x{w}")
        np.testing.assert_array_equal(tio.read_image(path), _pil(path))


@pytest.mark.parametrize("ctype,bits,trns", [(0, 8, b"\x00\x07"), (0, 16, b"\x01\x00"),
                                             (2, 8, b"\x00\x01\x00\x02\x00\x03"),
                                             (2, 16, b"\x01\x00\x02\x00\x03\x00"),
                                             (3, 4, b"\x00\x80\xff")])
def test_png_transparency_chunk_is_ignored(tmp_path, ctype, bits, trns):
    rng = np.random.default_rng(7)
    s = _samples(rng, 6, 11, CHANNELS[ctype], bits)
    palette = rng.integers(0, 256, (16, 3)) if ctype == 3 else None
    path = write_test_png(str(tmp_path / "t.png"), s, bits, ctype, True, palette, trns)
    assert "transparency" in Image.open(path).info
    np.testing.assert_array_equal(tio.read_png_rgb(path), _pil(path))


def test_png_sixteen_bit_rules():
    """The narrowing rules of the module docstring, on PIL's own decode:
    RGB keeps the high byte, greyscale clamps."""
    import tempfile

    vals = np.array([0, 1, 255, 256, 300, 4095, 65535])
    with tempfile.TemporaryDirectory() as d:
        rgb = write_test_png(os.path.join(d, "rgb.png"),
                             np.repeat(vals[None, :, None], 3, axis=2), 16, 2)
        grey = write_test_png(os.path.join(d, "grey.png"), vals[None, :, None], 16, 0)
        assert tio.read_png_rgb(rgb)[0, :, 0].tolist() == [0, 0, 0, 1, 1, 15, 255] == \
            _pil(rgb)[0, :, 0].tolist()
        assert tio.read_png_rgb(grey)[0, :, 0].tolist() == [0, 1, 255, 255, 255, 255, 255] == \
            _pil(grey)[0, :, 0].tolist()


# ------------------------------------------------------------------- JPEG
def _pattern(h, w, noise=0.1, seed=0):
    """write_image's pattern (chip_smoke.py): colour waves over noise."""
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.stack([np.sin(2 * np.pi * (3 * x + k / 3)) * np.cos(2 * np.pi * (2 * y - k / 5))
                    for k in range(3)], -1) * 0.7
    img += noise * np.random.default_rng(seed).standard_normal(img.shape)
    return (np.clip((img + 1) / 2, 0, 1) * 255).round().astype(np.uint8)


JPEG_SIZES = [(1, 1), (9, 17), (383, 511)]


@pytest.mark.parametrize("quality", [5, 75, 100])
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
def test_jpeg_is_bit_equal_to_pil(tmp_path, quality, subsampling):
    for h, w in JPEG_SIZES:
        for extra in ({}, {"optimize": True}, {"restart_marker_blocks": 3},
                      {"restart_marker_rows": 1}):
            path = str(tmp_path / "a.jpg")
            try:
                Image.fromarray(_pattern(h, w)).save(path, quality=quality,
                                                     subsampling=subsampling, **extra)
            except OSError:  # Pillow's optimize=True buffer is too small for a 1 x 1
                assert extra.get("optimize")  # image and for noise at quality 100
                continue
            np.testing.assert_array_equal(tio.read_jpeg_rgb(path), _pil(path),
                                          err_msg=f"{h}x{w} {extra}")


@pytest.mark.parametrize("quality", [5, 75, 100])
def test_greyscale_jpeg_is_bit_equal_to_pil(tmp_path, quality):
    for h, w in JPEG_SIZES:
        for extra in ({}, {"optimize": True, "restart_marker_blocks": 2}):
            path = str(tmp_path / "g.jpg")
            try:
                Image.fromarray(_pattern(h, w)).convert("L").save(path, quality=quality,
                                                                  **extra)
            except OSError:
                continue
            assert Image.open(path).mode == "L"
            np.testing.assert_array_equal(tio.read_image(path), _pil(path))


PROGRESSIVE_SIZES = [(1, 1), (9, 17), (45, 31), (383, 511)]


@pytest.mark.parametrize("quality", [5, 75, 100])
@pytest.mark.parametrize("subsampling", [0, 1, 2, "grey"], ids=["444", "422", "420", "grey"])
def test_progressive_jpeg_is_bit_equal_to_pil(tmp_path, quality, subsampling):
    for h, w in PROGRESSIVE_SIZES:
        for extra in ({}, {"restart_marker_blocks": 3}, {"restart_marker_rows": 1}):
            path = str(tmp_path / "p.jpg")
            img = Image.fromarray(_pattern(h, w))
            kw = {"subsampling": subsampling}
            if subsampling == "grey":
                img, kw = img.convert("L"), {}
            try:
                img.save(path, quality=quality, progressive=True, **kw, **extra)
            except OSError:  # Pillow's progressive buffer is too small for noise
                assert quality == 100  # at quality 100
                continue
            data = open(path, "rb").read()
            assert b"\xff\xc2" in data and data.count(b"\xff\xda") > 2
            np.testing.assert_array_equal(tio.read_image(path), _pil(path),
                                          err_msg=f"{h}x{w} {extra}")


def _scans(data: bytes):
    """The byte offsets of each SOS marker of a JPEG file."""
    out, pos = [], data.index(b"\xff\xda")
    while pos >= 0:
        out.append(pos)
        pos = data.find(b"\xff\xda", pos + 2)
    return out


def test_truncated_progressive_jpeg_raises_as_pil_does(tmp_path):
    path = str(tmp_path / "p.jpg")
    Image.fromarray(_pattern(64, 96)).save(path, quality=75, progressive=True, subsampling=2)
    data = open(path, "rb").read()
    cuts = [int(len(data) * f) for f in (0.05, 0.3, 0.5, 0.8, 0.95)] + [len(data) - 2]
    cuts += _scans(data)[3:5]  # between two scans
    for n in cuts:
        cut = str(tmp_path / f"cut{n}.jpg")
        open(cut, "wb").write(data[:n])
        with pytest.raises(OSError, match="truncated"):
            _pil(cut)
        with pytest.raises(ValueError, match="truncated"):
            tio.read_image(cut)


def test_progressive_jpeg_without_its_last_refinements_raises(tmp_path):
    """The final refinement scans cut off and the file closed with EOI:
    libjpeg smooths the blocks, and so does the port: bit-equal to PIL."""
    path = str(tmp_path / "p.jpg")
    Image.fromarray(_pattern(64, 96)).save(path, quality=75, progressive=True, subsampling=0)
    data = open(path, "rb").read()
    short = str(tmp_path / "short.jpg")
    open(short, "wb").write(data[:_scans(data)[-3]] + b"\xff\xd9")
    assert _pil(short).shape == (64, 96, 3)
    np.testing.assert_array_equal(tio.read_image(short), _pil(short))


def _segments(data: bytes):
    """(marker, segment with its length) of each segment before the first
    scan, and the rest of the file from the SOS marker on."""
    out, pos = [], 2
    while data[pos + 1] != 0xDA:
        (n,) = struct.unpack(">H", data[pos + 2:pos + 4])
        out.append((data[pos + 1], data[pos:pos + 2 + n]))
        pos += 2 + n
    return out, data[pos:]


def test_jpeg_markers_tables_and_frame_types(tmp_path):
    """Tables after the frame header and split into several segments,
    APPn and COM segments in between, and SOF1: the same pixels as PIL."""
    path = str(tmp_path / "a.jpg")
    Image.fromarray(_pattern(40, 70)).save(path, quality=80, subsampling=2, optimize=True)
    data = open(path, "rb").read()
    segs, rest = _segments(data)
    sof = [s for m, s in segs if m == 0xC0]
    tables = [s for m, s in segs if m in (0xC4, 0xDB)]
    com = b"\xff\xfe" + struct.pack(">H", 7) + b"hello"
    app = b"\xff\xe5" + struct.pack(">H", 6) + b"\x01\x02\x03\x04"
    for frame, name in ((sof[0], "sof0"), (b"\xff\xc1" + sof[0][2:], "sof1")):
        out = str(tmp_path / f"{name}.jpg")
        with open(out, "wb") as f:
            f.write(b"\xff\xd8" + app + frame + com + b"".join(reversed(tables)) + app + rest)
        np.testing.assert_array_equal(tio.read_jpeg_rgb(out), _pil(out), err_msg=name)


def test_jpeg_adobe_rgb_flag(tmp_path):
    """Pillow's keep_rgb writes RGB samples under an Adobe APP14 marker with
    transform 0 and no JFIF marker: no colour conversion."""
    path = str(tmp_path / "rgb.jpg")
    Image.fromarray(_pattern(37, 53, noise=0.3)).save(path, keep_rgb=True, subsampling=0,
                                                       quality=85)
    data = open(path, "rb").read()
    assert b"Adobe" in data and b"JFIF" not in data
    np.testing.assert_array_equal(tio.read_jpeg_rgb(path), _pil(path))


# one committed input of each kind read by the TIFF, WebP, Netpbm, TGA, ICO and JPEG
# process decoders (tests/data/images)
LOAD_INPUTS = {"cmyk_tiff": "cmyk_lzw.tif", "ycbcr_tiff": "ycbcr_422_deflate.tif",
               "cielab_tiff": "lab_lzw.tif", "float_tiff": "float32_predictor3.tif",
               "signed_tiff": "int16_signed.tif", "jpeg_in_tiff": "photo_jpeg_ycbcr.tif",
               "bigtiff": "bigtiff_deflate.tif", "animated_webp": "animated.webp",
               "netpbm": "photo_16bit.ppm", "tga": "rle_bottom_up.tga", "ico": "icon.ico",
               "lossless_jpeg": "lossless_pred6.jpg", "arithmetic_jpeg": "arith_progressive.jpg",
               "flc": "photo_brun.flc", "pcd": "photo_turned.pcd", "iptc": "photo_jpeg.iim",
               "dds_dxt1": "photo_dxt1.dds", "dds_bc7": "bc7_mode6.dds", "blp": "photo_jpeg.blp",
               "ftex": "photo_dxt1.ftc", "icns": "icon_it32.icns", "jpeg2000_97": "photo_97.jp2",
               "j2k_53": "tiled_rpcl_53.j2k", "jpeg2000_sycc": "sycc420_origin.jp2"}


@pytest.mark.parametrize("fmt", ["png16", "adam7", "jpeg420", "jpeg444_grey"] + list(LOAD_INPUTS))
def test_load_image_matches_jax(tmp_path, fmt):
    path = str(tmp_path / ("a.png" if fmt.startswith(("png", "adam")) else "a.jpg"))
    img = _pattern(90, 130)
    if fmt in LOAD_INPUTS:
        path = os.path.join(DATA, LOAD_INPUTS[fmt])
    elif fmt == "png16":
        write_test_png(path, img.astype(np.uint16) * 257 + 3, 16, 2)
    elif fmt == "adam7":
        write_test_png(path, img, 8, 2, interlace=True)
    elif fmt == "jpeg420":
        Image.fromarray(img).save(path, quality=90, subsampling=2)
    else:
        Image.fromarray(img).convert("L").save(path, quality=90)
    want = jio.load_image(path, left=3, top=2, resize=(64, 64))
    got = tio.load_image(path, left=3, top=2, resize=(64, 64))
    assert got.shape == want.shape == (1, 3, 64, 64)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------- left out formats
def _patched(src, dst, marker_from, marker_to=None, at=None, value=None):
    data = bytearray(open(src, "rb").read())
    i = data.index(bytes([0xFF, marker_from]))
    if marker_to is not None:
        data[i + 1] = marker_to
    if at is not None:
        data[i + at] = value
    open(dst, "wb").write(bytes(data))
    return dst


def test_formats_left_out_raise_and_name_themselves(tmp_path):
    img = _pattern(24, 24)
    base = str(tmp_path / "base.jpg")
    Image.fromarray(img).save(base, quality=80)
    cases = {"hierarchical progressive JPEG": _patched(base, str(tmp_path / "hp.jpg"), 0xC0,
                                                       0xC6),
             "arithmetic-coded lossless": _patched(base, str(tmp_path / "al.jpg"), 0xC0, 0xCB),
             "arithmetic-coded hierarchical": _patched(base, str(tmp_path / "ah.jpg"), 0xC0,
                                                       0xCD),
             "12-bit": _patched(base, str(tmp_path / "12.jpg"), 0xC0, at=4, value=12),
             "hierarchical lossless": _patched(base, str(tmp_path / "hl.jpg"), 0xC0, 0xC7)}
    for name, path in cases.items():
        with pytest.raises(ValueError, match=name):
            tio.read_image(path)
        with pytest.raises(ValueError, match=name):
            tio.load_image(path)


# ------------------------------------------------------ the card's inputs
CHIP_INPUTS = {"photo_420_restart.jpg": "JPEG, 512 x 384, 4:2:0, quality 90, restart "
                                        "interval of one MCU row",
               "adam7_rgb16.png": "PNG, 192 x 128, 16-bit RGB, Adam7, filters 0-4 in turn",
               "photo_progressive_422.jpg": "progressive JPEG, 333 x 251, 4:2:2, quality 85, "
                                            "restart interval of 7 MCUs",
               "photo_alpha.webp": "lossy WebP, 512 x 384, quality 80, VP8X with a "
                                   "compressed ALPH chunk",
               "lossless.webp": "lossless WebP, 333 x 251",
               "tiled_lzw.tif": "TIFF, 300 x 200 RGB, LZW, predictor 2, 64 x 48 tiles cut at "
                                "the edges, big-endian",
               "interlaced_local.gif": "GIF, 333 x 251 screen, a 320 x 240 interlaced image "
                                       "at (5, 4) with a local table and transparency",
               "cmyk_progressive.jpg": "progressive CMYK JPEG, 333 x 251, quality 85, Adobe "
                                       "APP14",
               "rle8.bmp": "BMP, 333 x 251, RLE8 with absolute runs, 200 colours",
               "photo_jpeg_ycbcr.tif": "JPEG-in-TIFF, 512 x 384, YCbCr 4:2:0 in 128 x 64 tiles, "
                                       "quality 85, restart markers, JPEGTables",
               "cmyk_lzw.tif": "TIFF, 160 x 120 CMYK, LZW, written by PIL",
               "ycbcr_422_deflate.tif": "TIFF, 161 x 119 YCbCr, 2 x 1 data units, Deflate, "
                                        "strips of 16 rows",
               "lab_lzw.tif": "TIFF, 160 x 120 CIELab (PIL's LAB of an RGB pattern), LZW, "
                              "strips of 32 rows",
               "float32_predictor3.tif": "TIFF, 128 x 96 float32 BlackIsZero, Deflate, "
                                         "predictor 3, NaN and infinities",
               "int16_signed.tif": "TIFF, 128 x 96 signed 16-bit, LZW, predictor 2",
               "bigtiff_deflate.tif": "BigTIFF, 160 x 120 RGB, Deflate, 64 x 64 tiles",
               "animated.webp": "animated lossy WebP with alpha, 200 x 150 canvas, a 120 x 90 "
                                "first frame at (20, 16), a second frame",
               "photo_16bit.ppm": "Netpbm P6, 160 x 120, maxval 1023",
               "rle_bottom_up.tga": "TGA, 200 x 150, 24-bit RLE, bottom-up, image ID",
               "icon.ico": "ICO, 64 x 64 8-bit DIB with AND mask, 48 x 48 24-bit, 32 x 32 PNG",
               "lossless_pred6.jpg": "lossless JPEG (SOF3), 160 x 120 RGB, predictor 6, "
                                     "restart every 2 MCU rows",
               "arith_progressive.jpg": "arithmetic-coded progressive JPEG (SOF10), 200 x 150, "
                                        "4:2:0, quality 85, restart interval of 4 MCUs"}

# the QOI, PCX/DCX, SGI, PSD, SUN, MSP, XBM, XPM and IM inputs (test_torch_image_dispatch.py)
RASTER_INPUTS = {
    "photo_packbits.psd": "PSD, 512 x 384 RGB, PackBits, image resources and a layer section "
                          "skipped",
    "rle16_rgb.sgi": "SGI, 160 x 120 RGB at 16 bits, RLE",
    "palette_rle.pcx": "PCX, 320 x 240 8-bit, RLE, 200 colours in the trailing palette",
    "photo.qoi": "QOI, 256 x 192 RGB",
    "rle_cmap.ras": "Sun raster, 200 x 150, type 2 (RLE), 8 bits with a colour map",
    "rle_v2.msp": "MSP version 2, 320 x 200, run-length rows",
    "icon.xbm": "XBM, 64 x 48, hot spot",
    "icon.xpm": "XPM, 48 x 32, 2 characters a pixel, 40 colours and None",
    "lut_palette.im": "IM, 160 x 120 palette image (Greyscale with a colour Lut), written by PIL",
    "pages.dcx": "DCX, two 8-bit PCX pages of 96 x 64, the first read",
}
CHIP_INPUTS.update(RASTER_INPUTS)
# the FLI, PCD, IPTC, ICNS (test_torch_image_fli_pcd_iptc_icns.py) and texture
# (test_torch_image_textures.py) inputs
CHIP_INPUTS.update({
    "photo_brun.flc": "FLC, 320 x 200, 256 colours: a BRUN first frame, then an LC delta frame",
    "photo_turned.pcd": "Photo CD base image, 768 x 512, orientation 1 (read as 512 x 768)",
    "photo_jpeg.iim": "IPTC/NAA L record holding a 160 x 120 RGB JPEG over two (8, 10) fields",
    "icon_it32.icns": "ICNS: a 128 x 128 it32 run-length entry with its t8mk mask (the one "
                      "read), 16 x 16 PNG entries at scales 1 and 2",
    "photo_dxt1.dds": "DDS, 512 x 384 photo saved by PIL as DXT1 (BC1)",
    "bc7_mode6.dds": "DDS DX10 BC7 (UNORM_SRGB), 256 x 128: mode-6 blocks of a photo, then rows "
                     "of random blocks of every mode",
    "photo_jpeg.blp": "BLP1 JPEG, 256 x 192, a shared JPEG header and the first mipmap",
    "photo_dxt1.ftc": "FTEX, 128 x 96 DXT1 (PIL's encoder)"})
# the fax, LZMA, Zstandard and GZIP_1 FITS inputs (test_torch_image_tiff_fax.py,
# test_torch_image_tiff_lzma_zstd.py)
CHIP_INPUTS.update({
    "page_g4.tif": "TIFF, CCITT Group 4, a 1728 x 2200 fax page (PIL's writer)",
    "page_g3_2d.tif": "TIFF, CCITT Group 3 2-D with EOL fill bits, a 1728 x 2200 fax page in "
                      "strips of 256 rows (PIL's writer)",
    "photo_zstd_pred2.tif": "TIFF, 512 x 384 RGB photo, Zstandard, predictor 2 (PIL's writer)",
    "photo_lzma.tif": "TIFF, 512 x 384 RGB photo, LZMA (PIL's writer)",
    "tiles_gzip1.fits": "FITS, a 160 x 120 tile-compressed GZIP_1 image of ZBITPIX 16, a gzip "
                        "member a row"})
# the JPEG 2000 inputs (test_torch_image_jpeg2000.py)
CHIP_INPUTS.update({
    "photo_97.jp2": "JPEG 2000 JP2, 512 x 384 RGB photo, 9/7 at rate 20 (PIL's writer)",
    "tiled_rpcl_53.j2k": "raw J2K codestream, 160 x 120 RGB, 5/3 lossless, 64 x 48 tiles, RPCL, "
                         "32 x 32 precincts, 4 resolutions (PIL's writer)",
    "sycc420_origin.jp2": "JPEG 2000 JP2 by the tests' encoder: sYCC 4:2:0, 80 x 60 at image "
                          "origin (5, 4), 40 x 32 tiles at (1, 2), BYPASS and VSC code-blocks"})
# JPEG-in-TIFF in planes, at 12 bits and old-style over strips, cut-short
# TIFF, Part 2 JPEG 2000 markers, WebP's simple filter (test_torch_image_
# tiff_jpeg_kinds.py, _tiff_cut.py, _jpeg2000_part2.py, _webp_filter.py)
CHIP_INPUTS.update({
    "planar_jpeg_rgba.tif": "JPEG-in-TIFF in planes, 256 x 192 RGBA, 64 x 64 tiles, quality "
                            "80 (PIL's libtiff)",
    "jpeg12_grey_strips.tif": "12-bit greyscale JPEG-in-TIFF, 160 x 120 in strips of 32 rows "
                              "spliced from libtiff's single-strip files",
    "old_jpeg_strips_420.tif": "old-style JPEG-in-TIFF, 200 x 150 YCbCr 4:2:0, tables in "
                               "tags, a strip an MCU row",
    "ycbcr_lzw_cut.tif": "TIFF, 200 x 150 YCbCr 2 x 2 data units, LZW, strips of 16 rows, the "
                         "fourth strip cut to half its bytes",
    "ycbcr_jpeg_cut.tif": "JPEG-in-TIFF, 256 x 192 YCbCr 4:2:0 in 64 x 64 tiles, restart "
                          "markers, every tile's stream cut to 60 % of its bytes",
    "part2_mco_offsets.j2k": "raw J2K codestream, 160 x 120 RGB, 9/7, with Part 2 MCT (a "
                             "float32 matrix, int32 offsets), MCC and MCO markers (PIL's "
                             "writer, markers put in)",
    "photo_simple_filter.webp": "lossy WebP, 256 x 192 photo, quality 80, the simple loop "
                                "filter at strength 60 (PIL's libwebp, filter_type 0)"})
# damaged JPEG data: a renumbered and a deleted restart marker, a byte
# XOR-ed in a progressive, an arithmetic-coded, a lossless JPEG and a
# JPEG-in-TIFF tile (test_torch_image_jpeg_damage.py)
CHIP_INPUTS.update({
    "photo_420_restart_rst4.jpg": "photo_420_restart.jpg with RST3 renumbered RST4",
    "photo_420_restart_no_rst.jpg": "photo_420_restart.jpg with its fourth restart marker "
                                    "deleted",
    "photo_progressive_422_hit.jpg": "photo_progressive_422.jpg with a byte of an AC scan "
                                     "XOR-ed",
    "arith_progressive_hit.jpg": "arith_progressive.jpg with a byte of its data XOR-ed",
    "lossless_pred6_hit.jpg": "lossless_pred6.jpg with a byte of its data XOR-ed",
    "photo_jpeg_ycbcr_hit.tif": "photo_jpeg_ycbcr.tif with a byte of its second tile XOR-ed"})


def make_chip_inputs(d: str) -> dict:
    """Write the images chip_smoke.py decodes on the card, and return
    {file: {"shape", "sha256" of PIL's convert("RGB") bytes, "what"}}."""
    os.makedirs(d, exist_ok=True)
    jpeg = os.path.join(d, "photo_420_restart.jpg")
    Image.fromarray(_pattern(384, 512)).save(jpeg, quality=90, subsampling=2,
                                             restart_marker_rows=1)
    Image.fromarray(_pattern(251, 333, seed=1)).save(
        os.path.join(d, "photo_progressive_422.jpg"), quality=85, subsampling=1,
        progressive=True, restart_marker_blocks=7)
    y, x = np.mgrid[0:128, 0:192]
    smooth = np.stack([(x * 341 + y * 97 * k) % 65536 for k in (1, 2, 3)], -1)
    write_test_png(os.path.join(d, "adam7_rgb16.png"), smooth, 16, 2, interlace=True)
    _make_other_inputs(d)
    _make_new_inputs(d)
    from test_torch_image_dispatch import make_raster_inputs
    from test_torch_image_fli_pcd_iptc_icns import make_fli_pcd_iptc_icns_inputs
    from test_torch_image_jpeg2000 import make_jpeg2000_inputs
    from test_torch_image_textures import make_texture_inputs
    from test_torch_image_tiff_fax import make_fax_inputs
    from test_torch_image_tiff_lzma_zstd import make_compression_inputs

    make_raster_inputs(d)
    make_fli_pcd_iptc_icns_inputs(d)
    make_texture_inputs(d)
    make_jpeg2000_inputs(d)
    make_fax_inputs(d)
    make_compression_inputs(d)
    from test_torch_image_jpeg2000_part2 import make_part2_inputs
    from test_torch_image_tiff_cut import make_cut_inputs
    from test_torch_image_tiff_jpeg_kinds import make_jpeg_kind_inputs
    from test_torch_image_webp_filter import make_webp_filter_inputs

    make_jpeg_kind_inputs(d)
    make_cut_inputs(d)
    make_part2_inputs(d)
    make_webp_filter_inputs(d)
    from test_torch_image_jpeg_damage import make_damage_inputs

    make_damage_inputs(d)
    out = {}
    for name, what in CHIP_INPUTS.items():
        px = _pil(os.path.join(d, name))
        out[name] = {"shape": list(px.shape), "sha256": hashlib.sha256(px.tobytes()).hexdigest(),
                     "what": what}
    return out


def _make_other_inputs(d: str) -> None:
    """The WebP, TIFF, GIF, CMYK JPEG and BMP inputs of CHIP_INPUTS."""
    from test_torch_image_codecs import rle8, write_bmp, write_gif, write_tiff

    photo = _pattern(384, 512, seed=2)
    y, x = np.mgrid[0:384, 0:512]
    alpha = np.clip(x // 2 + (y - 192) ** 2 // 300, 0, 255).astype(np.uint8)
    alpha[:64, :96] = 0  # colour kept under transparent pixels
    Image.fromarray(np.concatenate([photo, alpha[:, :, None]], -1)).save(
        os.path.join(d, "photo_alpha.webp"), quality=80)
    Image.fromarray(_pattern(251, 333, noise=0.03, seed=3)).save(os.path.join(d, "lossless.webp"),
                                                                 lossless=True)
    write_tiff(os.path.join(d, "tiled_lzw.tif"), _pattern(200, 300, noise=0.03, seed=4), 8, 2,
               ">", 5, predictor=2, tile=(64, 48))
    quant = Image.fromarray(_pattern(240, 320, seed=5)).quantize(200)
    pal = np.asarray(quant.getpalette()[:768]).reshape(-1, 3)
    pal = np.concatenate([pal, np.zeros((256 - len(pal), 3), np.int64)])
    write_gif(os.path.join(d, "interlaced_local.gif"), np.asarray(quant), screen=(333, 251),
              offset=(5, 4), gtab=pal[:4], ltab=pal, interlace=True, transparency=201)
    Image.fromarray(_pattern(251, 333, seed=6)).convert("CMYK").save(
        os.path.join(d, "cmyk_progressive.jpg"), quality=85, progressive=True)
    quant = Image.fromarray(_pattern(251, 333, noise=0.02, seed=7)).quantize(200)
    pal = np.asarray(quant.getpalette()[:600]).reshape(-1, 3)
    write_bmp(os.path.join(d, "rle8.bmp"), rle8(np.asarray(quant)), 333, 251, 8, compression=1,
              palette=pal)


def _make_new_inputs(d: str) -> None:
    """The TIFF kinds, animated WebP, Netpbm, TGA, ICO, lossless and
    arithmetic-coded JPEG inputs of CHIP_INPUTS."""
    import io

    from test_torch_image_jpeg_processes import arith_jpeg, lossless_jpeg
    from test_torch_image_pnm_tga_ico import _dib, ico, tga, tga_rle
    from test_torch_image_codecs import write
    from test_torch_image_tiff import _jpeg_tiff, ycbcr_units
    from test_torch_image_webp_anim import _still_chunks, animated

    _jpeg_tiff(os.path.join(d, "photo_jpeg_ycbcr.tif"), _pattern(384, 512, seed=8), 6,
               tile=(128, 64), sub=(2, 2), jpeg_kw={"subsampling": 2, "restart_marker_rows": 1})
    Image.fromarray(_pattern(120, 160, noise=0.03, seed=9)).convert("CMYK").save(
        os.path.join(d, "cmyk_lzw.tif"), compression="tiff_lzw")
    ycc = np.asarray(Image.fromarray(_pattern(119, 161, noise=0.03, seed=10)).convert("YCbCr"))
    write(os.path.join(d, "ycbcr_422_deflate.tif"), ycc, 8, 6, "<", 8, rows=16,
          raw_blocks=[ycbcr_units(ycc[y:y + 16], 2, 1) for y in range(0, 119, 16)],
          more={530: (3, [2, 1])})
    lab = np.asarray(Image.fromarray(_pattern(120, 160, noise=0.03, seed=11)).convert("LAB"))
    write(os.path.join(d, "lab_lzw.tif"), lab, 8, 8, "<", 5, rows=32)
    y, x = np.mgrid[0:96, 0:128]
    f = ((x * 2.1 + y * 1.3) % 300 - 20).astype(np.float32)
    f[0, :3] = [np.nan, np.inf, -np.inf]
    write(os.path.join(d, "float32_predictor3.tif"), f[:, :, None], 32, 1, "<", 8, 3, 3)
    write(os.path.join(d, "int16_signed.tif"), ((x * 5 - y * 3) % 700 - 200).astype(
        np.int16)[:, :, None], 16, 1, "<", 5, 2, 2)
    write(os.path.join(d, "bigtiff_deflate.tif"), _pattern(120, 160, noise=0.03, seed=12), 8, 2,
          "<", 8, tile=(64, 64), big=True)
    frame = np.concatenate([_pattern(90, 120, seed=13), np.full((90, 120, 1), 200, np.uint8)], -1)
    with open(os.path.join(d, "animated.webp"), "wb") as fh:
        fh.write(animated((200, 150), [(20, 16, (120, 90), _still_chunks(frame, quality=80)),
                                       (0, 0, (200, 150), _still_chunks(
                                           _pattern(150, 200, seed=14), quality=60))]))
    v = (_pattern(120, 160, noise=0.03, seed=15).astype(np.int64) * 1023 // 255)
    with open(os.path.join(d, "photo_16bit.ppm"), "wb") as fh:
        fh.write(b"P6\n# 10-bit samples\n160 120\n1023\n" + v.astype(">u2").tobytes())
    rows = _pattern(150, 200, noise=0.02, seed=16)[::-1, :, ::-1].tobytes()
    with open(os.path.join(d, "rle_bottom_up.tga"), "wb") as fh:
        fh.write(tga(10, 24, tga_rle(rows, 3, 200), 200, 150, flags=0x00, ident=b"port test"))
    quant = Image.fromarray(_pattern(64, 64, seed=17)).quantize(200)
    pal = np.asarray(quant.getpalette()[:768]).reshape(-1, 3)
    png = io.BytesIO()
    Image.fromarray(_pattern(32, 32, seed=18)).save(png, "PNG")
    with open(os.path.join(d, "icon.ico"), "wb") as fh:
        fh.write(ico([(48, 48, 0, 24, _dib(_pattern(48, 48, seed=19)[:, :, ::-1], 24)),
                      (64, 64, 0, 8, _dib(np.asarray(quant), 8, pal)),
                      (32, 32, 0, 32, png.getvalue())]))
    img = _pattern(120, 160, noise=0.02, seed=20)
    with open(os.path.join(d, "lossless_pred6.jpg"), "wb") as fh:
        fh.write(lossless_jpeg([img[:, :, i] for i in range(3)], [(1, 1)] * 3, 6,
                               restart_rows=2))
    with open(os.path.join(d, "arith_progressive.jpg"), "wb") as fh:
        fh.write(arith_jpeg(_pattern(150, 200, noise=0.05, seed=21),
                            sampling=((2, 2), (1, 1), (1, 1)), quality=85, progressive=True,
                            restart=4))


def test_committed_chip_inputs_are_what_the_maker_writes(tmp_path):
    want = make_chip_inputs(str(tmp_path))
    with open(os.path.join(DATA, "sha256.json")) as f:
        assert json.load(f) == want
    for name in CHIP_INPUTS:
        with open(os.path.join(DATA, name), "rb") as a, open(tmp_path / name, "rb") as b:
            assert a.read() == b.read(), name
        px = tio.read_image(os.path.join(DATA, name))
        assert hashlib.sha256(px.tobytes()).hexdigest() == want[name]["sha256"]


if __name__ == "__main__":  # write the card's inputs: python tests/test_torch_image_formats.py
    with open(os.path.join(DATA, "sha256.json"), "w") as f:
        json.dump(make_chip_inputs(DATA), f, indent=2)
        f.write("\n")
