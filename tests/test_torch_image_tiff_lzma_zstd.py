"""The port's LZMA (34925), Zstandard (50000) and ThunderScan (32809) TIFF
readers, FITS GZIP_1 reader, and the TIFF kinds it still refuses, against
PIL 12.1's ``np.array(Image.open(p).convert("RGB"))``, bit for bit, on the
CPU.

- LZMA and Zstandard TIFFs PIL writes (through libtiff) in modes 1, L,
  I;16, F, RGB, RGBA and CMYK, with predictor 2 and, for F, 3, in one strip
  and in several; tiles built here (PIL writes none), with predictor 2,
  little- and big-endian 16-bit samples; data cut short or bit-flipped
  (equal where PIL reads it, a ValueError naming the codec where it
  fails, and on a few files that only libzstd's fast path or libtiff's
  full-strip rule lets through).
- ThunderScan: random 4-bit code streams (runs, 2- and 3-bit deltas, raw
  pixels) in strips; other bit depths fail in PIL and raise here.
- FITS GZIP_1: PIL's ``FitsGzipDecoder`` over ZBITPIX 8, 16 and 32, one
  gzip member or one a row, and the files it fails on (ZBITPIX -32 and
  -64, data short of four bytes a pixel, not gzip).
- Refusals: WebP-in-TIFF (PIL's libtiff lacks WebP), SGILog and SGILog24
  (no PIL mode for LogL and LogLuv, and libtiff decodes them for no other
  photometric), the LogL and LogLuv photometrics uncompressed.
"""

import gzip
import io
import lzma
import math
import os

import numpy as np
import pytest
from PIL import Image

from audioeditingcode_tpu_torch.utils import image_io as tio
from test_torch_image_codecs import layout, sample_bytes
from test_torch_image_formats import _pattern
from test_torch_image_raster import both_fail, check, put, same_or_both_fail

zstandard = pytest.importorskip("zstandard")

CODECS = {"lzma": 34925, "zstd": 50000}


def _image(mode: str, h: int = 37, w: int = 53) -> Image.Image:
    img = _pattern(h, w, seed=3)
    if mode == "1":
        return Image.fromarray(img[:, :, 0] > 128)
    if mode == "L":
        return Image.fromarray(img[:, :, 0])
    if mode == "I;16":
        return Image.frombytes("I;16", (w, h), (img[:, :, 0].astype("<u2") * 251).tobytes())
    if mode == "F":
        return Image.fromarray(img[:, :, 0].astype(np.float32) * 1.3 - 20)
    if mode == "RGBA":
        return Image.fromarray(np.dstack([img, img[:, :, :1]]))
    return Image.fromarray(img).convert(mode)


MODES = ["1", "L", "I;16", "F", "RGB", "RGBA", "CMYK"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("codec", ["lzma", "zstd"])
def test_from_pil(tmp_path, codec, mode):
    """Each predictor PIL writes for the mode (libtiff refuses 2 on 1-bit
    samples and 3 on integers), in one strip and in strips of 8 rows."""
    img = _image(mode)
    predictors = [None] + ([2] if mode != "1" else []) + ([3] if mode == "F" else [])
    for pred in predictors:
        for kw in ({}, {"strip_size": 8 * len(img.tobytes()) // img.height}):
            path = str(tmp_path / f"{codec}_{pred}.tif")
            img.save(path, compression=codec, tiffinfo={317: pred} if pred else {}, **kw)
            assert Image.open(path).tag_v2[259] == CODECS[codec]
            check(path, "TIFF")


def _compress(raw: bytes, codec: str) -> bytes:
    if codec == "lzma":
        return lzma.compress(raw, format=lzma.FORMAT_XZ, preset=6)
    return zstandard.ZstdCompressor(level=9).compress(raw)


def _tiled(path, px, bits, photo, codec, order="<", predictor=1, tile=(32, 16), fmt=1):
    h, w, spp = px.shape
    tw, th = tile
    blocks = []
    for y in range(0, h, th):
        for x in range(0, w, tw):
            b = np.zeros((th, tw, spp), px.dtype)
            part = px[y:y + th, x:x + tw]
            b[:part.shape[0], :part.shape[1]] = part
            blocks.append(_compress(sample_bytes(b, bits, order, fmt, predictor), codec))
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [CODECS[codec]]),
            262: (3, [photo]), 277: (3, [spp]), 322: (4, [tw]), 323: (4, [th])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if fmt != 1:
        tags[339] = (3, [fmt] * spp)
    return put(str(path), layout(blocks, tags, order, tiled=True))


@pytest.mark.parametrize("codec", ["lzma", "zstd"])
def test_tiles_built_by_hand(tmp_path, codec):
    """RGB and 16-bit greyscale in tiles cut at the edges, with and without
    predictor 2, in both byte orders; float32 with predictor 3."""
    rgb = _pattern(50, 70, seed=4)
    grey16 = (rgb[:, :, :1].astype(np.int64) * 257 + np.arange(70)[None, :, None])
    checked = 0
    for order in ("<", ">"):
        for pred in (1, 2):
            checked += check(_tiled(tmp_path / "rgb.tif", rgb, 8, 2, codec, order, pred))
            checked += check(_tiled(tmp_path / "g16.tif", grey16, 16, 1, codec, order, pred))
    f = (rgb[:, :, :1].astype(np.float32) * 1.7 - 30)
    checked += check(_tiled(tmp_path / "f.tif", f, 32, 1, codec, "<", 3, fmt=3))
    assert checked == 9


@pytest.mark.parametrize("codec", ["lzma", "zstd"])
def test_cut_short_or_bit_flipped(tmp_path, codec):
    """Strips of PIL's files cut short or with a bit flipped: equal where
    PIL reads the file, a ValueError naming the codec where it fails. The
    port may also raise, naming the codec, on a few files PIL reads: for
    Zstandard it holds each frame to RFC 8878's rules, which libzstd's fast
    Huffman path does not all check; for LZMA, Python's lzma module raises
    on damage that shows only in the range coder's check at the end of the
    strip's last chunk, after all its bytes came out, which libtiff
    ignores once its strip is full."""
    rng = np.random.default_rng(5)
    name = {"lzma": "LZMA", "zstd": "Zstandard"}[codec]
    outcome = {"equal": 0, "both fail": 0, "stricter": 0}
    src = str(tmp_path / "src.tif")
    _image("RGB", 40, 61).save(src, compression=codec, strip_size=10 * 61 * 3)
    im = Image.open(src)
    data = open(src, "rb").read()
    blocks = [data[o:o + n] for o, n in zip(im.tag_v2[273], im.tag_v2[279])]
    tags = {256: (4, [61]), 257: (4, [40]), 258: (3, [8, 8, 8]), 259: (3, [CODECS[codec]]),
            262: (3, [2]), 277: (3, [3]), 278: (4, [10])}
    path = str(tmp_path / "c.tif")
    for i in range(30):
        bad = [bytearray(b) for b in blocks]
        k = int(rng.integers(0, len(bad)))
        if i % 2:
            bad[k] = bad[k][:int(rng.integers(0, len(bad[k])))]
        else:
            bit = int(rng.integers(0, 8 * len(bad[k])))
            bad[k][bit // 8] ^= 1 << (bit % 8)
        put(path, layout([bytes(b) for b in bad], tags))
        try:
            want = np.asarray(Image.open(path).convert("RGB"))
        except Exception:
            with pytest.raises(ValueError, match=name):
                tio.read_image(path)
            outcome["both fail"] += 1
            continue
        try:
            got = tio.read_image(path)
        except ValueError as e:
            assert name in str(e), e
            outcome["stricter"] += 1
            continue
        np.testing.assert_array_equal(got, want)
        outcome["equal"] += 1
    assert outcome["both fail"] >= 10 and outcome["stricter"] <= 5, outcome


# ------------------------------------------------------------- ThunderScan
def _thunder_rows(rng, w: int, h: int) -> bytes:
    """ThunderScan codes for ``h`` rows of ``w`` pixels, mostly exact."""
    codes = []
    for _ in range(h):
        npx = 0
        while npx < w:
            k = int(rng.integers(0, 4))
            if k == 0:
                n = int(rng.integers(0, min(64, w - npx + 1)))
                codes.append(n)
                npx += n
            elif k == 1:
                codes.append(0x40 | int(rng.integers(0, 64)))
                npx += 3
            elif k == 2:
                codes.append(0x80 | int(rng.integers(0, 64)))
                npx += 2
            else:
                codes.append(0xC0 | int(rng.integers(0, 16)))
                npx += 1
    return bytes(codes)


def test_thunderscan(tmp_path):
    """Random ThunderScan strips (PIL reads them through libtiff): equal
    where PIL reads them, both fail where a row gets too many or too few
    pixels; 8-bit ThunderScan fails in PIL and raises."""
    rng = np.random.default_rng(6)
    outcome = {"equal": 0, "both fail": 0}
    path = str(tmp_path / "t.tif")
    for i in range(120):
        w, h = int(rng.integers(1, 24)), int(rng.integers(1, 7))
        rows = int(rng.integers(1, h + 1))
        blocks = [_thunder_rows(rng, w, min(rows, h - y)) for y in range(0, h, rows)]
        tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [4]), 259: (3, [32809]),
                262: (3, [i % 2]), 277: (3, [1]), 278: (4, [rows])}
        outcome[same_or_both_fail(put(path, layout(blocks, tags)))] += 1
    assert outcome["equal"] >= 20 and outcome["both fail"] >= 20, outcome
    exact = bytes(0xC0 | v for v in range(12))
    tags = {256: (4, [12]), 257: (4, [1]), 258: (3, [8]), 259: (3, [32809]), 262: (3, [1]),
            277: (3, [1]), 278: (4, [1])}
    both_fail(put(path, layout([exact], tags)), "Thunder decoder reads only 4-bit")
    tags[258] = (3, [4])
    check(put(path, layout([exact], tags)), "TIFF")


# ----------------------------------------------------------------- FITS
def _card(text: str) -> bytes:
    return text.ljust(80).encode()


def gzip_fits(w: int, h: int, zbitpix: int, payload: bytes, rows: int = 1) -> bytes:
    """A primary unit without data, then a BINTABLE tile-compressed image
    unit (ZIMAGE, ZCMPTYPE 'GZIP_1'): a table of ``rows`` 8-byte rows,
    then ``payload``."""
    primary = b"".join(_card(c) for c in ("SIMPLE  =                    T",
                                          "BITPIX  =                    8",
                                          "NAXIS   =                    0", "END"))
    ext = ["XTENSION= 'BINTABLE'", "BITPIX  =                    8",
           "NAXIS   =                    2", "NAXIS1  =                    8",
           f"NAXIS2  = {rows:20d}", "ZIMAGE  =                    T", "ZCMPTYPE= 'GZIP_1  '",
           f"ZBITPIX = {zbitpix:20d}", "ZNAXIS  =                    2",
           f"ZNAXIS1 = {w:20d}", f"ZNAXIS2 = {h:20d}", "END"]
    head = primary.ljust(2880, b" ") + b"".join(_card(c) for c in ext).ljust(2880, b" ")
    body = bytes(8 * rows) + payload
    return head + body.ljust(math.ceil(len(body) / 2880) * 2880, b"\0")


@pytest.mark.parametrize("zbitpix", [8, 16, 32])
def test_fits_gzip_1(tmp_path, zbitpix):
    """Big-endian 4-byte elements gzipped in one member and in one member a
    row: PIL keeps each element's last ZBITPIX / 8 bytes, reads them in its
    little-endian raw mode, and turns the rows."""
    rng = np.random.default_rng(zbitpix)
    w, h = 13, 9
    el = rng.integers(-2 ** 31, 2 ** 31, w * h).astype(">i4").tobytes()
    path = str(tmp_path / "g.fits")
    check(put(path, gzip_fits(w, h, zbitpix, gzip.compress(el))), "FITS")
    rows = b"".join(gzip.compress(el[i:i + 4 * w]) for i in range(0, len(el), 4 * w))
    check(put(path, gzip_fits(w, h, zbitpix, rows, rows=h)), "FITS")


def test_fits_gzip_1_failures(tmp_path):
    """ZBITPIX -32 and -64 (PIL keeps no byte of an element), data that
    inflates to fewer than four bytes a pixel, data that is not gzip or is
    cut short: PIL fails, the port raises."""
    el = bytes(range(4 * 7 * 5))
    path = str(tmp_path / "f.fits")
    for zbitpix in (-32, -64):
        both_fail(put(path, gzip_fits(7, 5, zbitpix, gzip.compress(el))), "not enough image data")
    both_fail(put(path, gzip_fits(7, 5, 16, gzip.compress(el[:-3]))), "not enough image data")
    both_fail(put(path, gzip_fits(7, 5, 16, b"not gzip data")), "corrupt GZIP_1")
    both_fail(put(path, gzip_fits(7, 5, 16, gzip.compress(el)[:-6])), "corrupt GZIP_1")


# ------------------------------------------------------------- refusals
def _tags(w, h, comp, photo, bps=(8,), extra=None):
    t = {256: (4, [w]), 257: (4, [h]), 258: (3, list(bps)), 259: (3, [comp]),
         262: (3, [photo]), 277: (3, [len(bps)]), 278: (4, [h])}
    t.update(extra or {})
    return t


def test_refusals(tmp_path):
    """WebP-in-TIFF laid out as libtiff's tif_webp.c writes it (a WebP
    bitstream a strip); SGILog with an ordinary photometric and with LogL;
    SGILog24 with LogLuv; LogL uncompressed: PIL fails on each, the port
    raises naming why."""
    path = str(tmp_path / "r.tif")
    rgb = _pattern(8, 8)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "WEBP", lossless=True)
    both_fail(put(path, layout([buf.getvalue()], _tags(8, 8, 50001, 2, (8, 8, 8)))),
              "built without WebP")
    both_fail(put(path, layout([bytes(64)], _tags(4, 4, 34676, 1, (16,)))), "SGILog")
    both_fail(put(path, layout([bytes(64)], _tags(4, 4, 34676, 32844, (16,),
                                                  {339: (3, [2])}))), "SGILog|LogL")
    both_fail(put(path, layout([bytes(64)], _tags(4, 4, 34677, 32845, (8, 8, 8)))),
              "SGILog24|LogLuv")
    both_fail(put(path, layout([bytes(64)], _tags(4, 4, 1, 32844, (16,)))), "LogL")


# --------------------------------------------------------- the card's inputs
def make_compression_inputs(d: str) -> None:
    """The LZMA, Zstandard and GZIP_1 FITS inputs of CHIP_INPUTS."""
    Image.fromarray(_pattern(384, 512, seed=17)).save(
        os.path.join(d, "photo_zstd_pred2.tif"), compression="zstd", tiffinfo={317: 2})
    Image.fromarray(_pattern(384, 512, noise=0.03, seed=18)).save(
        os.path.join(d, "photo_lzma.tif"), compression="lzma")
    y, x = np.mgrid[0:120, 0:160]
    el = ((x * 7 + y * 5) % 256 * 256 + (x ^ y)).astype(">i4").tobytes()
    rows = b"".join(gzip.compress(el[i:i + 4 * 160], mtime=0) for i in range(0, len(el), 640))
    put(os.path.join(d, "tiles_gzip1.fits"), gzip_fits(160, 120, 16, rows, rows=120))


def test_compression_inputs(tmp_path):
    make_compression_inputs(str(tmp_path))
    for name, fmt in (("photo_zstd_pred2.tif", "TIFF"), ("photo_lzma.tif", "TIFF"),
                      ("tiles_gzip1.fits", "FITS")):
        check(os.path.join(tmp_path, name), fmt)
