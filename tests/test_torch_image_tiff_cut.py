"""Compressed TIFF strips and tiles cut short, which PIL 12.1 still reads,
against PIL's ``np.array(Image.open(p).convert("RGB"))`` bit for bit, on
the CPU:

- YCbCr under LZW, Deflate and PackBits, which PIL reads through libtiff's
  RGBA interface (``TIFFReadRGBAStrip``, ``TIFFReadRGBATile``). That
  interface does not stop on a block that fails to decode: it draws the
  bytes decoded before the data ran out, and zero after them, from a
  buffer it zeroes each call, without undoing the predictor. libtiff's
  PackBits decoder drops a run the data cuts short. Held also against
  libtiff's RGBA calls made directly (tests/pil_libs.py): data units at
  1x1, 2x1, 2x2 and 4x2, in strips and tiles, chunky and (1x1) in planes,
  with predictor 2;
- JPEG-in-TIFF, through libtiff's JPEG codec, which ends a stream that
  runs out with an EOI of its own: libjpeg decodes the MCU that runs out
  from zero bits and leaves the MCUs after it in its restart interval, and
  in every interval after the data's end, zero (grey); in YCbCr at 4:2:0,
  4:2:2 and 4:4:4, RGB and greyscale, strips and tiles, with restart
  intervals and without;
- the other kinds, which PIL reads with libtiff's strip reader: PIL fails
  on a cut block, and the port raises.

``make_cut_inputs`` writes two such files for the card
(tests/test_torch_image_formats.py)."""

import os
import struct

import numpy as np
import pytest
from PIL import Image

from audioeditingcode_tpu_torch.utils import image_io as tio
from pil_libs import tiff_read_rgba
from test_torch_image_codecs import _both_raise, _check, compress, layout, sample_bytes
from test_torch_image_formats import _pattern, _pil
from test_torch_image_tiff import _jpeg_tiff, ycbcr_units

YCC = np.asarray(Image.fromarray(_pattern(37, 45, noise=0.2)).convert("YCbCr"))
CUTS = (0.1, 0.5, 0.9)


def _hor_diff(raw: bytes, rowsize: int) -> bytes:
    """Predictor 2 at a stride of three bytes over rows of ``rowsize``."""
    rows = np.frombuffer(raw, np.uint8).reshape(-1, rowsize // 3, 3).astype(np.int64)
    return (np.diff(rows, axis=1, prepend=0) & 255).astype(np.uint8).tobytes()


def cut_ycbcr(path, ycc, comp, sub, cut, block, tile=None, rows=16, planar=1, predictor=1):
    """A YCbCr TIFF of ``ycc`` whose block ``block`` keeps the first
    ``cut`` of its compressed bytes: data units of ``sub`` in strips of
    ``rows`` rows or ``tile`` (width, length) tiles, or 1x1 in planes."""
    hs, vs = sub
    h, w = ycc.shape[:2]
    parts = []
    for plane in ([ycc] if planar == 1 else [ycc[:, :, i:i + 1] for i in range(3)]):
        if tile:
            tw, th = tile
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    part = np.zeros((th, tw, plane.shape[2]), np.uint8)
                    src = plane[y:y + th, x:x + tw]
                    part[:src.shape[0], :src.shape[1]] = src
                    parts.append(part)
        else:
            parts += [plane[y:y + rows] for y in range(0, h, rows)]
    blocks = []
    for part in parts:
        if planar == 2:
            raw = sample_bytes(part, 8, "<", 1, predictor)
        else:
            raw = ycbcr_units(part, hs, vs)
            if predictor == 2:
                width = part.shape[1]
                rowsize = 3 * width if tile else -(-width // hs) * (hs * vs + 2) // vs
                if len(raw) % rowsize == 0 and rowsize % 3 == 0:  # else libtiff leaves it
                    raw = _hor_diff(raw, rowsize)
        blocks.append(compress(raw, comp))
    blocks[block] = blocks[block][:max(1, int(len(blocks[block]) * cut))]
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * 3), 259: (3, [comp]), 262: (3, [6]),
            277: (3, [3]), 284: (3, [planar]), 530: (3, [hs, vs])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if tile:
        tags.update({322: (4, [tile[0]]), 323: (4, [tile[1]])})
    else:
        tags[278] = (4, [rows])
    with open(path, "wb") as f:
        f.write(layout(blocks, tags, tiled=bool(tile)))
    return str(path)


def _rgba_read(path, n_blocks, tile):
    """The image as libtiff's RGBA calls give it, block by block."""
    h, w = YCC.shape[:2]
    if tile is None:
        return np.concatenate([tiff_read_rgba(path, k) for k in range(n_blocks)])[:, :, :3]
    tw, th = tile
    across = -(-w // tw)
    rows = [np.concatenate([tiff_read_rgba(path, r * across + c, (th, tw))
                            for c in range(across)], axis=1) for r in range(-(-h // th))]
    return np.concatenate(rows)[:h, :w, :3]


@pytest.mark.parametrize("comp", [5, 8, 32773], ids=["lzw", "deflate", "packbits"])
@pytest.mark.parametrize("tile", [None, (16, 16)], ids=["strips", "tiles"])
@pytest.mark.parametrize("sub", [(1, 1), (2, 1), (2, 2), (4, 2)], ids=["1x1", "2x1", "2x2",
                                                                       "4x2"])
def test_cut_ycbcr_matches_pil_and_libtiff(tmp_path, comp, tile, sub):
    """The first, a middle and the last block cut at a tenth, a half and
    nine tenths of its bytes, with and without predictor 2: the port, PIL
    and libtiff's RGBA calls give the same pixels."""
    h, w = YCC.shape[:2]
    n = -(-h // 16) * (-(-w // 16) if tile else 1)
    checked = 0
    for predictor in ((1, 2) if comp != 32773 else (1,)):
        for block in (0, n // 2, n - 1):
            for cut in CUTS:
                path = cut_ycbcr(str(tmp_path / "c.tif"), YCC, comp, sub, cut, block, tile,
                                 predictor=predictor)
                _check(path)
                np.testing.assert_array_equal(tio.read_image(path), _rgba_read(path, n, tile))
                checked += 1
    assert checked == 9 * (2 if comp != 32773 else 1)


@pytest.mark.parametrize("comp", [5, 8, 32773], ids=["lzw", "deflate", "packbits"])
def test_cut_ycbcr_in_planes(tmp_path, comp):
    """1x1 YCbCr in planes (libtiff's RGBA interface reads each plane's
    strip): a Cb strip cut short, with and without predictor 2."""
    for predictor in ((1, 2) if comp != 32773 else (1,)):
        for cut in CUTS:
            path = cut_ycbcr(str(tmp_path / "p.tif"), YCC, comp, (1, 1), cut, 3, planar=2,
                             predictor=predictor)
            _check(path)
            np.testing.assert_array_equal(tio.read_image(path), _rgba_read(path, 3, None))


def _cut_counts(path, cut, which):
    """Rewrite the byte counts of the blocks ``which`` to ``cut`` of theirs."""
    data = bytearray(open(path, "rb").read())
    im = Image.open(path)
    key = 279 if 279 in im.tag_v2 else 325
    counts = list(im.tag_v2[key])
    new = [max(1, int(c * cut)) if i in which else c for i, c in enumerate(counts)]
    old = struct.pack(f"<{len(counts)}I", *counts)
    if len(counts) == 1:
        at = data.index(struct.pack("<HHI", key, 4, 1) + old) + 8
    else:
        at = data.index(old)
    data[at:at + len(old)] = struct.pack(f"<{len(counts)}I", *new)
    with open(path, "wb") as f:
        f.write(bytes(data))


JPEG_KINDS = {"YCbCr 4:2:0": (6, (2, 2), {"subsampling": 2}),
              "YCbCr 4:2:2": (6, (2, 1), {"subsampling": 1}),
              "YCbCr 4:4:4": (6, (1, 1), {"subsampling": 0}),
              "RGB": (2, None, {}), "grey": (1, None, {})}


@pytest.mark.parametrize("tile", [None, (32, 32)], ids=["strips", "tiles"])
@pytest.mark.parametrize("kind", list(JPEG_KINDS))
def test_cut_jpeg_in_tiff_matches_pil(tmp_path, kind, tile):
    """Every block cut at a fifth, a half and nine tenths of its stream,
    with a restart interval of three MCUs and without one."""
    photo, sub, kw = JPEG_KINDS[kind]
    img = _pattern(48, 64, noise=0.2)
    path = str(tmp_path / "j.tif")
    for restart in (None, 3):
        jpeg_kw = dict(kw, **({"restart_marker_blocks": restart} if restart else {}))
        for cut in (0.2, 0.5, 0.9):
            _jpeg_tiff(path, img if photo != 1 else img[:, :, 0], photo, tile=tile,
                       rows=None if tile else 16, sub=sub, jpeg_kw=jpeg_kw)
            _cut_counts(path, cut, range(6))
            _check(path)


@pytest.mark.parametrize("comp", [5, 8, 32773], ids=["lzw", "deflate", "packbits"])
def test_other_kinds_cut_short_raise_as_pil(tmp_path, comp):
    """RGB through libtiff's strip reader: PIL fails on a cut strip, the port
    raises naming it."""
    img = _pattern(32, 40, noise=0.2)
    blocks = [compress(img[y:y + 16].tobytes(), comp) for y in (0, 16)]
    blocks[1] = blocks[1][:len(blocks[1]) // 2]
    path = str(tmp_path / "r.tif")
    with open(path, "wb") as f:
        f.write(layout(blocks, {256: (4, [40]), 257: (4, [32]), 258: (3, [8] * 3),
                                259: (3, [comp]), 262: (3, [2]), 277: (3, [3]),
                                278: (4, [16])}))
    _both_raise(path)
    with pytest.raises(ValueError, match="truncated TIFF data"):
        tio.read_image(path)


# ------------------------------------------------------ the card's inputs
def make_cut_inputs(d: str) -> None:
    ycc = np.asarray(Image.fromarray(_pattern(150, 200, noise=0.05, seed=40)).convert("YCbCr"))
    cut_ycbcr(os.path.join(d, "ycbcr_lzw_cut.tif"), ycc, 5, (2, 2), 0.5, 3)
    path = os.path.join(d, "ycbcr_jpeg_cut.tif")
    _jpeg_tiff(path, _pattern(192, 256, noise=0.05, seed=41), 6, tile=(64, 64), sub=(2, 2),
               jpeg_kw={"subsampling": 2, "restart_marker_blocks": 4})
    _cut_counts(path, 0.6, range(12))
    assert _pil(path).shape == (192, 256, 3)
