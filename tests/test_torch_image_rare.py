"""The port's SPIDER, PIXAR, McIdas, GBR, XV thumbnail, IMT and FITS
readers (utils/image_spider.py, image_pixar.py, image_mcidas.py,
image_gbr.py, image_xvthumb.py, image_imt.py, image_fits.py) against PIL
12.1's ``np.array(Image.open(p).convert("RGB"))``, bit for bit, on the CPU.

PIL writes only SPIDER of these, so the others are built here from the
formats' layouts:

- SPIDER: what PIL writes; big- and little-endian headers, a stack (its
  first image), an image within a stack and a non-2-D iform (PIL fails or
  passes the file on), a NaN in a stack field.
- PIXAR: RGB "dumped" pixels; other channel codes pass the file on.
- McIdas: 1, 2 and 4 bytes a sample, line prefixes, several bands, rows
  that overlap where PIL maps the file (and read zeros past its end).
- GBR: versions 1 and 2, greyscale and RGBA brushes.
- XV thumbnails: comment lines, the 3-3-2 palette; a size line of one word
  makes PIL fail.
- IMT: comments, a header without ``pixel n8`` (passed on) or without a
  form feed (PIL fails to load).
- FITS: BITPIX 8, 16, 32, -32 and -64 (PIL's little-endian raw modes on
  big-endian data, reproduced), one and two axes, comments after values,
  no axes ("No image data"), a file that ends in its header.
- Each: random headers and bodies, some cut short: equal to PIL where both
  read, both fail otherwise; and the port's ``load_image`` equal to the JAX
  ``load_image`` on one file.
"""

import math
import struct

import numpy as np
import pytest
from PIL import Image

from audioeditingcode_tpu_torch.utils import image_io as tio
from test_torch_image_raster import both_fail, check, put, same_or_both_fail


def spider(w, h, order=">", istack=0, imgnumber=0, iform=1, body=None, nan_field=False,
           rng=None):
    rng = rng or np.random.default_rng(0)
    lenbyt = 4 * w
    labrec = math.ceil(1024 / lenbyt)
    hdr = [0.0] * 27
    hdr[0], hdr[1], hdr[4], hdr[11], hdr[12] = 1, h, iform, w, labrec
    hdr[21], hdr[22], hdr[23], hdr[25], hdr[26] = labrec * lenbyt, lenbyt, istack, 2, imgnumber
    if nan_field:
        hdr[23] = float("nan")
    head = struct.pack(order + "27f", *hdr).ljust(labrec * lenbyt, b"\0")
    if body is None:
        body = (rng.standard_normal(w * h) * 200 + 100).astype(order + "f4").tobytes()
    return head + (head if istack > 0 else b"") + body


def pixar(w, h, pixels, codes=(14, 2)):
    head = b"\200\350\000\000" + bytes(412) + struct.pack("<6H", h, w, 0, 0, *codes)
    return head.ljust(1024, b"\0") + pixels


def mcidas(w, h, nbytes, body, bands=1, prefix=0, offset=256):
    v = [0] * 64
    v[1], v[8], v[9], v[10], v[13], v[14], v[33] = 4, h, w, nbytes, bands, prefix, offset
    return struct.pack(">64i", *v) + body


def gbr(w, h, depth, pixels, version=1, name=b"brush\0"):
    if version == 1:
        return struct.pack(">5I", 20 + len(name), 1, w, h, depth) + name + pixels
    return (struct.pack(">5I", 28 + len(name), 2, w, h, depth) + b"GIMP"
            + struct.pack(">I", 10) + name + pixels)


def fits(w, h, bitpix, body, naxis=2, extra=(), pad=True):
    cards = ["SIMPLE  =                    T", f"BITPIX  = {bitpix:20d}",
             f"NAXIS   = {naxis:20d}"]
    cards += [f"NAXIS{i + 1}  = {n:20d}" for i, n in enumerate((w, h)[:naxis])]
    head = b"".join(c.ljust(80).encode() for c in cards + list(extra) + ["END"])
    head = head.ljust(math.ceil(len(head) / 2880) * 2880, b" ")
    return head + (body.ljust(2880, b"\0") if pad else body)


# ---------------------------------------------------------------- SPIDER
def test_spider_from_pil_and_built_by_hand(tmp_path):
    rng = np.random.default_rng(1)
    path = str(tmp_path / "a.spi")
    checked = 0
    for h, w in ((1, 1), (17, 23)):
        Image.fromarray((rng.standard_normal((h, w)) * 200 + 100).astype(np.float32)).save(
            path, format="SPIDER")
        checked += check(path, "SPIDER")
    for order in (">", "<"):
        checked += check(put(path, spider(9, 7, order, rng=rng)), "SPIDER")
        checked += check(put(path, spider(9, 7, order, istack=1, rng=rng)), "SPIDER")
    failed = both_fail(put(path, spider(9, 7, imgnumber=2)), r"within a stack")
    failed += both_fail(put(path, spider(9, 7, iform=3)), r"cannot identify")
    failed += both_fail(put(path, spider(9, 7, nan_field=True)), r"not finite")
    failed += both_fail(put(path, spider(9, 7)[:-5]), r"truncated SPIDER data")
    assert (checked, failed) == (6, 4)


# ----------------------------------------------------------------- PIXAR
def test_pixar_built_by_hand(tmp_path):
    rng = np.random.default_rng(2)
    path = str(tmp_path / "a.pxr")
    px = rng.integers(0, 256, 3 * 11 * 6).astype(np.uint8).tobytes()
    checked = check(put(path, pixar(11, 6, px)), "PIXAR")
    failed = both_fail(put(path, pixar(11, 6, px, codes=(14, 1))), r"cannot identify")
    failed += both_fail(put(path, pixar(11, 6, px[:-1])), r"truncated PIXAR data")
    assert (checked, failed) == (1, 2)


# ---------------------------------------------------------------- McIdas
def test_mcidas_built_by_hand(tmp_path):
    """1, 2 and 4 bytes a sample, a line prefix, two bands, and a stride
    below the row's bytes where PIL maps the file (overlapping rows, zeros
    past its end) and where it decodes (fails)."""
    path = str(tmp_path / "a.area")
    body = bytes(range(256)) * 3
    checked = 0
    for nbytes in (1, 2, 4):
        for bands, prefix in ((1, 0), (1, 3), (2, 2)):
            checked += check(put(path, mcidas(5, 4, nbytes, body, bands, prefix)), "MCIDAS")
    checked += check(put(path, mcidas(8, 3, 1, body[:14], 0, 3)), "MCIDAS")
    failed = both_fail(put(path, mcidas(2, 3, 4, body, 0, 3)), r"codec configuration error")
    failed += both_fail(put(path, mcidas(8, 3, 1, body[:23], 0)), r"buffer is not large enough")
    failed += both_fail(put(path, mcidas(8, 3, 4, body[:23])), r"truncated McIdas data")
    assert (checked, failed) == (10, 3)


# ------------------------------------------------------------------- GBR
@pytest.mark.parametrize("version", [1, 2])
def test_gbr_built_by_hand(tmp_path, version):
    rng = np.random.default_rng(3)
    path = str(tmp_path / "a.gbr")
    checked = 0
    for depth in (1, 4):
        px = rng.integers(0, 256, 7 * 5 * depth).astype(np.uint8).tobytes()
        checked += check(put(path, gbr(7, 5, depth, px, version)), "GBR")
    failed = both_fail(put(path, gbr(7, 5, 4, px[:-1], version)), r"not enough image data")
    failed += both_fail(put(path, gbr(7, 5, 3, px, version)), r"cannot identify")
    assert (checked, failed) == (2, 2)


# ----------------------------------------------------------- XV thumbnail
def test_xvthumb_built_by_hand(tmp_path):
    rng = np.random.default_rng(4)
    path = str(tmp_path / "a.xv")
    px = rng.integers(0, 256, 12 * 5).astype(np.uint8).tobytes()
    comments = b"#XVVERSION:Version 2.28\n#BUILTIN:STIPPLE\n#END_OF_COMMENTS\n"
    checked = check(put(path, b"P7 332\n" + comments + b"12 5 255\n" + px), "XVThumb")
    checked += check(put(path, b"P7 332 extra\n12 5\n" + px), "XVThumb")
    failed = both_fail(put(path, b"P7 332\n" + comments + b"12\n" + px), r"size line")
    failed += both_fail(put(path, b"P7 332\n" + comments + b"12 5 255\n" + px[:-1]),
                        r"truncated XV thumbnail")
    assert (checked, failed) == (2, 2)


# ------------------------------------------------------------------- IMT
def test_imt_built_by_hand(tmp_path):
    rng = np.random.default_rng(5)
    path = str(tmp_path / "a.imt")
    px = rng.integers(0, 256, 6 * 4).astype(np.uint8).tobytes()
    checked = check(put(path, b"width 6\n* comment\nheight 4\npixel n8\n\x0c" + px), "IMT")
    checked += check(put(path, b"pixel n8\nheight 4\nwidth 6\n\x0c" + px), "IMT")
    failed = both_fail(put(path, b"width 6\nheight 4\n\x0c" + px), r"cannot identify")
    failed += both_fail(put(path, b"width 6\nheight 4\npixel n8\n"), r"without a form feed")
    failed += both_fail(put(path, b"width x\nheight 4\npixel n8\n\x0c" + px), r"not an integer")
    assert (checked, failed) == (2, 3)


# ------------------------------------------------------------------ FITS
@pytest.mark.parametrize("bitpix", [8, 16, 32, -32, -64])
def test_fits_built_by_hand(tmp_path, bitpix):
    """Each BITPIX as PIL reads it (16 and 32 bits byte-swapped, -64 read as
    float32 pairs), two axes and one, with a comment card."""
    rng = np.random.default_rng(abs(bitpix))
    path = str(tmp_path / "a.fits")
    dt = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    checked = 0
    for naxis in (1, 2):
        vals = rng.standard_normal(7 * 5) * 300 + 100
        if bitpix > 0:
            vals = np.clip(vals, 0, 255) if bitpix == 8 else vals
        body = vals.astype(dt).tobytes()
        extra = ["BSCALE  =                  1.0 / not applied by PIL"]
        checked += check(put(path, fits(7, 5, bitpix, body, naxis, extra)), "FITS")
    assert checked == 2


def test_fits_refused_or_passed_on(tmp_path):
    """No axes, a file that ends in its header, BITPIX 12: PIL fails or
    passes the file on. Data shorter than a card: PIL takes the data to
    start 80 bytes before the end of what it read, inside the header's
    padding (read as PIL reads it), and fails where even that is short."""
    path = str(tmp_path / "b.fits")
    failed = both_fail(put(path, fits(7, 5, 8, bytes(35), naxis=0)), r"without image data")
    failed += both_fail(put(path, fits(7, 5, 8, b"", pad=False)), r"truncated FITS file")
    failed += both_fail(put(path, fits(7, 5, 12, bytes(35))), r"cannot identify")
    failed += both_fail(put(path, fits(7, 5, 32, bytes(5), pad=False)), r"truncated FITS data")
    checked = check(put(path, fits(7, 5, 16, bytes(range(35)), pad=False)), "FITS")
    assert (failed, checked) == (4, 1)


# ---------------------------------------------------------------- random
def test_random_rare_files_match_pil(tmp_path):
    """300 files over the seven formats, headers drawn at random, some cut
    short: equal where both read, both fail otherwise."""
    rng = np.random.default_rng(7)
    path = str(tmp_path / "r")
    outcome = {"equal": 0, "both fail": 0}
    for i in range(300):
        w, h = (int(v) for v in rng.integers(1, 9, 2))
        kind = i % 7
        if kind == 0:
            data = spider(w, h, str(rng.choice([">", "<"])), istack=int(rng.choice([0, 0, 1])),
                          imgnumber=int(rng.choice([0, 0, 0, 1])), rng=rng)
        elif kind == 1:
            data = pixar(w, h, bytes(3 * w * h), codes=(14, int(rng.choice([2, 2, 1]))))
        elif kind == 2:
            data = mcidas(w, h, int(rng.choice([1, 2, 4, 3])), bytes(range(256)) * 2,
                          int(rng.choice([0, 1, 2])), int(rng.choice([0, 0, 3])))
        elif kind == 3:
            depth = int(rng.choice([1, 4]))
            data = gbr(w, h, depth, rng.integers(0, 256, w * h * depth).astype(
                np.uint8).tobytes(), int(rng.choice([1, 2])))
        elif kind == 4:
            data = b"P7 332\n#c\n%d %d 255\n" % (w, h) + bytes(w * h)
        elif kind == 5:
            data = b"width %d\nheight %d\npixel n8\n\x0c" % (w, h) + bytes(w * h)
        else:
            bitpix = int(rng.choice([8, 16, 32, -32, -64]))
            dt = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
            data = fits(w, h, bitpix, (rng.standard_normal(w * h) * 100).astype(dt).tobytes(),
                        int(rng.choice([1, 2, 2])))
        if rng.random() < 0.2:
            data = data[:int(rng.integers(0, len(data)))]
        outcome[same_or_both_fail(put(path, data))] += 1
    assert outcome["equal"] > 150 and outcome["both fail"] > 20, outcome


def _rare_files(rng):
    w, h = 37, 29
    grey = rng.integers(0, 256, w * h).astype(np.uint8).tobytes()
    return {"spider": spider(w, h, rng=rng), "pixar": pixar(w, h, grey * 3),
            "mcidas": mcidas(w, h, 1, grey), "gbr": gbr(w, h, 4, grey * 4, version=2),
            "xvthumb": b"P7 332\n#c\n%d %d 255\n" % (w, h) + grey,
            "imt": b"width %d\nheight %d\npixel n8\n\x0c" % (w, h) + grey,
            "fits": fits(w, h, 8, grey)}


@pytest.mark.parametrize("fmt", ["fits", "gbr", "imt", "mcidas", "pixar", "spider", "xvthumb"])
def test_load_image_matches_jax(tmp_path, fmt):
    """The port's ``load_image`` against the JAX ``load_image`` (PIL),
    exactly, as ``test_torch_image_formats.py`` compares them."""
    from audioeditingcode_tpu.utils import image_io as jio

    path = put(str(tmp_path / fmt), _rare_files(np.random.default_rng(8))[fmt])
    want = jio.load_image(path, left=3, top=2, resize=(24, 24))
    got = tio.load_image(path, left=3, top=2, resize=(24, 24))
    assert got.shape == want.shape == (1, 3, 24, 24)
    np.testing.assert_array_equal(got, want)
