"""The port's block-compressed texture readers (utils/image_bcn.py,
image_dds.py, image_ftex.py, image_blp.py) against PIL 12.1's
``np.array(Image.open(p).convert("RGB"))``, bit for bit, on the CPU.

- BCn fuzz: random blocks of every BC kind through DDS files (BC1 with
  both colour orders, BC2, BC3, BC4, BC5 unsigned and signed, BC6H UF16
  and SF16, BC7), the mode bits forced so that every BC6H mode (and the
  invalid ones) and every BC7 mode (and the empty first byte) gets at
  least 64 blocks, at sizes that are not multiples of 4.
- DDS: one file per pixel format of PIL's reader: RGB and RGBA bit masks
  through its Python ``dds_rgb`` decoder (also cut short, which it reads
  as zeros), luminance L and LA, an 8-bit palette, every FourCC and DX10
  DXGI format it takes (the sRGB tags too); the formats it refuses raise.
- FTEX: DXT1 and raw RGB; more than one format, another format, a
  mipmap cut short fail as in PIL.
- BLP: BLP1 JPEG (3 and 4 components, at a size other than the header's,
  read as BGR as PIL reads it) and palette (encodings 4 and 5, with and
  without alpha); BLP2 palette at each alpha depth and DXT1/3/5 through
  PIL's Python decoders, at widths that shear the rows as in PIL; the
  compressions and encodings PIL refuses raise.
- ``make_texture_inputs`` writes the committed DDS (DXT1 photo, BC7),
  BLP1 JPEG and FTEX inputs of ``test_torch_image_formats.CHIP_INPUTS``.
"""

import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

from audioeditingcode_tpu_torch.utils import image_bcn
from audioeditingcode_tpu_torch.utils import image_io as tio
from test_torch_image_formats import _pattern
from test_torch_image_raster import both_fail, check, pil, put, same_or_both_fail


# --------------------------------------------------------------- writers
def dds(width, height, pfflags, fourcc=b"\0\0\0\0", bitcount=0, masks=(0, 0, 0, 0), dxgi=None,
        body=b"", hsize=124):
    """A DDS file: the 128-byte header, a DX10 header where ``dxgi`` is
    given, then ``body``."""
    head = struct.pack("<4sIIIIIII", b"DDS ", hsize, 0x1007, height, width, 0, 0, 0) + bytes(44)
    head += struct.pack("<II4sI4I", 32, pfflags, fourcc, bitcount, *masks)
    head += struct.pack("<4I", 0x1000, 0, 0, 0) + bytes(4)
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return head + body


def ftex(width, height, fmt, mipmap, formats=1, where=None, size=None):
    where = 32 if where is None else where
    head = b"FTEX" + struct.pack("<5i", 1, width, height, 1, formats) + struct.pack("<2i", fmt,
                                                                                     where)
    head = head.ljust(where, b"\0")
    return head + struct.pack("<i", len(mipmap) if size is None else size) + mipmap


def blp1(width, height, compression, alpha, encoding, body, offsets=(), lengths=()):
    offs = list(offsets) + [0] * (16 - len(offsets))
    lens = list(lengths) + [0] * (16 - len(lengths))
    return (b"BLP1" + struct.pack("<iIIIii", compression, alpha, width, height, encoding, 0)
            + struct.pack("<16I", *offs) + struct.pack("<16I", *lens) + body)


def blp1_jpeg(jpeg: bytes, width, height, alpha=0, cut=None, gap=0):
    """BLP1 JPEG: the stream cut at its first SOS (or ``cut``) into the
    shared header and the first mipmap, ``gap`` bytes skipped between."""
    k = jpeg.index(b"\xff\xda") if cut is None else cut
    mip = jpeg[k:]
    offset = 28 + 128 + 4 + k + gap
    body = struct.pack("<I", k) + jpeg[:k] + b"\x55" * gap + mip
    return blp1(width, height, 0, alpha, 5, body, [offset], [len(mip)])


def blp2(width, height, encoding, alpha_depth, alpha_encoding, palette, data, compression=1):
    offset = 20 + 128 + 1024
    return (b"BLP2" + struct.pack("<ibbbb", compression, encoding, alpha_depth, alpha_encoding, 0)
            + struct.pack("<II", width, height) + struct.pack("<16I", offset, *[0] * 15)
            + struct.pack("<16I", len(data), *[0] * 15) + palette + data)


def _blocks(rng, n, size):
    return rng.integers(0, 256, (n, size), dtype=np.uint8)


def bc7_mode6(img: np.ndarray) -> bytes:
    """A small BC7 encoder: mode 6 blocks of an (H, W, 3) image (H, W
    multiples of 4), opaque, the endpoints the ends of each block's colours
    along their principal axis (7 bits and a p-bit of 0), the indices the
    nearest of the 16 weights between them."""
    h, w = img.shape[:2]
    blk = img.reshape(h // 4, 4, w // 4, 4, 3).transpose(0, 2, 1, 3, 4).reshape(-1, 16, 3)
    blk = blk.astype(np.float64)
    mean = blk.mean(1)
    c = blk - mean[:, None]
    cov = np.einsum("nki,nkj->nij", c, c)
    axis = np.ones_like(mean)
    for _ in range(8):  # power iteration
        axis = np.einsum("nij,nj->ni", cov, axis)
        axis /= np.linalg.norm(axis, axis=1, keepdims=True) + 1e-9
    t = np.einsum("nki,ni->nk", c, axis)
    ends = [np.clip(np.rint(mean + t.min(1)[:, None] * axis), 0, 255).astype(np.int64) >> 1,
            np.clip(np.rint(mean + t.max(1)[:, None] * axis), 0, 255).astype(np.int64) >> 1]
    e0, e1 = ends
    lo, hi = e0 << 1, e1 << 1
    d = (hi - lo).astype(np.float64)
    t = ((blk - lo[:, None]) * d[:, None]).sum(-1) / np.maximum((d * d).sum(-1), 1)[:, None]
    weights = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64]) / 64
    idx = np.abs(np.clip(t, 0, 1)[:, :, None] - weights).argmin(-1)
    swap = idx[:, 0] >= 8  # the anchor index keeps its top bit 0
    e0[swap], e1[swap] = e1[swap].copy(), e0[swap].copy()
    idx[swap] = 15 - idx[swap]
    out = []
    for b in range(len(blk)):
        v, pos = 1 << 6, 7
        for ch in range(3):
            for e in (e0[b, ch], e1[b, ch]):
                v |= int(e) << pos
                pos += 7
        v |= 127 << pos | 127 << (pos + 7)  # opaque (alpha 254), p-bits 0
        pos += 16
        for i in range(16):
            v |= int(idx[b, i]) << pos
            pos += 3 if i == 0 else 4
        out.append(v.to_bytes(16, "little"))
    return b"".join(out)


# ------------------------------------------------------------- BCn fuzz
# kind -> (FourCC, DXGI format, block bytes)
KINDS = {"DXT1": (b"DXT1", None, 8), "DXT3": (b"DXT3", None, 16), "DXT5": (b"DXT5", None, 16),
         "BC4": (b"ATI1", None, 8), "BC5U": (b"ATI2", None, 16), "BC5S": (b"BC5S", None, 16),
         "BC6H_UF16": (b"DX10", 95, 16), "BC6H_SF16": (b"DX10", 96, 16),
         "BC7": (b"DX10", 98, 16)}
# the first byte's low bits of the 14 BC6H modes, then two invalid ones
BC6_MODE_BITS = (0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15, 19, 31)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_bcn_fuzz_is_bit_equal_to_pil(tmp_path, kind):
    fourcc, dxgi, size = KINDS[kind]
    rng = np.random.default_rng(sorted(KINDS).index(kind))
    if kind.startswith("BC6"):
        modes = len(BC6_MODE_BITS)
    elif kind == "BC7":
        modes = 9
    else:
        modes = 4
    bw, bh = 32, 2 * modes  # 64 blocks a mode
    blocks = _blocks(rng, bw * bh, size)
    mode = np.arange(bw * bh) % modes
    if kind.startswith("BC6"):
        bits = np.array(BC6_MODE_BITS)[mode]
        keep = np.where(bits < 2, 0xFC, 0xE0)
        blocks[:, 0] = (blocks[:, 0] & keep) | bits
    elif kind == "BC7":  # mode m: bit m set above m zeros; mode 8: a zero first byte
        low = (1 << mode) & 255
        blocks[:, 0] = np.where(mode < 8, (blocks[:, 0].astype(np.int64) & ~((low << 1) - 1))
                                | low, 0).astype(np.uint8)
    elif kind == "DXT1":  # both colour orders
        swap = mode % 2 == 1
        blocks[swap, :4] = blocks[swap][:, [2, 3, 0, 1]]
    path = put(str(tmp_path / "f.dds"), dds(4 * bw - 3, 4 * bh - 1, 4, fourcc, dxgi=dxgi,
                                            body=blocks.tobytes()))
    assert check(path, "DDS")


def test_bc7_encoder_blocks_and_bc6h_layouts_are_pils():
    """The test's mode-6 encoder gives blocks PIL reads close to the image,
    and each BC6H mode's endpoint bits (decoded alone) land where PIL's
    do: one endpoint bit set at a time in an otherwise zero block."""
    img = _pattern(64, 96, noise=0.0, seed=50)
    data = dds(96, 64, 4, b"DX10", dxgi=98, body=bc7_mode6(img))
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert np.abs(want.astype(int) - img).mean() < 6  # one line per block: a crude encoder
    np.testing.assert_array_equal(image_bcn.decode(data[148:], 96, 64, 7, "BC7", "x")[:, :, :3],
                                  want)
    blocks = []
    for m, packing in enumerate(image_bcn._BC6_PACKINGS):
        start = 2 if m < 2 else 5
        for i in range(len(packing)):
            v = BC6_MODE_BITS[m] | 1 << (start + i)
            blocks.append(v.to_bytes(16, "little"))
    for fmt, dxgi in (("BC6H", 95), ("BC6HS", 96)):
        data = dds(4 * len(blocks), 4, 4, b"DX10", dxgi=dxgi, body=b"".join(blocks))
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        got = image_bcn.decode(data[148:], 4 * len(blocks), 4, 6, fmt, "x")[:, :, :3]
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------- DDS
def _dds_cases():
    rng = np.random.default_rng(7)
    px = rng.integers(0, 256, 12 * 10 * 4, dtype=np.uint8).tobytes()
    blocks16, blocks8 = _blocks(rng, 9, 16).tobytes(), _blocks(rng, 9, 8).tobytes()
    cases = {
        "RGB 24-bit BGR masks": dds(12, 10, 0x40, bitcount=24, masks=(0xFF0000, 0xFF00, 0xFF, 0),
                                    body=px[:360]),
        "RGB 16-bit 5-6-5": dds(12, 10, 0x40, bitcount=16, masks=(0xF800, 0x7E0, 0x1F, 0),
                                body=px[:240]),
        "RGBA 32-bit": dds(12, 10, 0x41, bitcount=32,
                           masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000), body=px[:480]),
        "RGB padded masks and a zero one": dds(12, 10, 0x40, bitcount=16,
                                               masks=(0b11, 0b1100, 0, 0), body=px[:240]),
        "RGB 32-bit cut short": dds(12, 10, 0x40, bitcount=32,
                                    masks=(0xFF0000, 0xFF00, 0xFF, 0), body=px[:301]),
        "L": dds(12, 10, 0x20000, bitcount=8, body=px[:120]),
        "LA": dds(12, 10, 0x20001, bitcount=16, body=px[:240]),
        "P": dds(12, 10, 0x20, body=rng.integers(0, 256, 1024, dtype=np.uint8).tobytes()
                 + px[:120]),
    }
    for fourcc in (b"DXT1", b"DXT3", b"DXT5", b"BC4U", b"ATI1", b"BC5U", b"ATI2", b"BC5S"):
        body = blocks8 if fourcc in (b"DXT1", b"BC4U", b"ATI1") else blocks16
        cases[f"FourCC {fourcc.decode()}"] = dds(12, 10, 4, fourcc, body=body)
    for dxgi in (70, 71, 73, 74, 76, 77, 79, 80, 82, 83, 84, 95, 96, 97, 98, 99):
        body = blocks8 if dxgi in (70, 71, 79, 80) else blocks16
        cases[f"DXGI {dxgi}"] = dds(12, 10, 4, b"DX10", dxgi=dxgi, body=body)
    for dxgi in (27, 28, 29):
        cases[f"DXGI {dxgi} raw RGBA"] = dds(12, 10, 4, b"DX10", dxgi=dxgi, body=px[:480])
    return cases


DDS_CASES = _dds_cases()


@pytest.mark.parametrize("case", sorted(DDS_CASES))
def test_dds_pixel_format_is_bit_equal_to_pil(tmp_path, case):
    assert check(put(str(tmp_path / "f.dds"), DDS_CASES[case]), "DDS")


@pytest.mark.parametrize("pixel_format", ["DXT1", "DXT3", "DXT5", "BC2", "BC3", "BC5"])
def test_dds_written_by_pil(tmp_path, pixel_format):
    path = str(tmp_path / "f.dds")
    img = Image.fromarray(_pattern(37, 53, noise=0.05, seed=51))
    (img.convert("RGBA") if pixel_format != "BC5" else img).save(path, pixel_format=pixel_format)
    assert check(path, "DDS")
    for mode in ("RGB", "RGBA", "L", "LA"):
        img.convert(mode).save(path)
        assert check(path, "DDS")


def test_dds_failures_raise_as_pil_fails(tmp_path):
    blocks = bytes(range(128))
    cases = {"Unimplemented pixel format": [dds(8, 8, 4, f, body=blocks)
                                            for f in (b"DXT2", b"DXT4", b"BC4S", b"ETC1")],
             "Unimplemented DXGI format": [dds(8, 8, 4, b"DX10", dxgi=g, body=blocks)
                                           for g in (2, 81, 100, 87)],
             "unknown pixel format flags": [dds(8, 8, 0x2, body=blocks)],
             "unsupported bitcount": [dds(8, 8, 0x20000, bitcount=16, body=blocks)],
             "header size": [dds(8, 8, 4, b"DXT1", body=blocks, hsize=100)],
             "image file is truncated": [dds(8, 8, 4, b"DXT3", body=blocks[:40]),
                                         dds(8, 8, 0x20000, bitcount=8, body=blocks[:40]),
                                         dds(8, 8, 0x20, body=blocks)]}
    for names, files in cases.items():
        for i, data in enumerate(files):
            both_fail(put(str(tmp_path / f"{i}.dds"), data), names)
    both_fail(put(str(tmp_path / "cut.dds"), dds(8, 8, 4, b"DXT1")[:100]), "incomplete header")
    both_fail(put(str(tmp_path / "w0.dds"), dds(0, 8, 4, b"DXT1", body=blocks)),
              "cannot identify image file")


# ------------------------------------------------------------------ FTEX
def test_ftex_is_bit_equal_to_pil(tmp_path):
    rng = np.random.default_rng(9)
    blocks = _blocks(rng, 4 * 3, 8).tobytes()
    assert check(put(str(tmp_path / "a.ftc"), ftex(15, 10, 0, blocks)), "FTEX")
    assert check(put(str(tmp_path / "b.ftu"), ftex(7, 5, 1, bytes(range(105)), where=40)),
                 "FTEX")
    assert check(put(str(tmp_path / "c.ftc"), ftex(8, 4, 0, blocks[:16] + b"tail", size=-1)),
                 "FTEX")
    both_fail(put(str(tmp_path / "d.ftc"), ftex(8, 8, 0, blocks, formats=2)), "single format")
    both_fail(put(str(tmp_path / "e.ftc"), ftex(8, 8, 3, blocks)),
              "invalid texture compression format")
    both_fail(put(str(tmp_path / "f.ftu"), ftex(8, 8, 1, bytes(100))), "image file is truncated")
    both_fail(put(str(tmp_path / "g.ftc"), ftex(0, 8, 0, blocks)), "cannot identify image file")


# ------------------------------------------------------------------- BLP
def _jpeg(img, **kw) -> bytes:
    out = io.BytesIO()
    img.save(out, "JPEG", **kw)
    return out.getvalue()


def test_blp1_jpeg_is_read_as_bgr_as_pil_reads_it(tmp_path):
    img = Image.fromarray(_pattern(40, 56, noise=0.05, seed=52))
    rgb, cmyk, grey = _jpeg(img, quality=85), _jpeg(img.convert("CMYK")), _jpeg(img.convert("L"))
    files = {"rgb": blp1_jpeg(rgb, 56, 40), "alpha": blp1_jpeg(rgb, 56, 40, alpha=8, gap=7),
             "cmyk": blp1_jpeg(cmyk, 56, 40), "grey": blp1_jpeg(grey, 56, 40, cut=20),
             "narrower header": blp1_jpeg(rgb, 50, 30), "progressive": blp1_jpeg(
                 _jpeg(img, progressive=True), 56, 40)}
    for name, data in files.items():
        assert check(put(str(tmp_path / f"{name}.blp"), data), "BLP")
    got = tio.read_image(str(tmp_path / "rgb.blp"))
    np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(rgb)))[:, :, ::-1])
    both_fail(put(str(tmp_path / "wider.blp"), blp1_jpeg(rgb, 60, 40)), "not enough image data")
    both_fail(put(str(tmp_path / "cut.blp"), blp1_jpeg(rgb, 56, 40)[:400]),
              "Truncated File Read")


def test_blp_palettes_are_bit_equal_to_pil(tmp_path):
    quant = Image.fromarray(_pattern(30, 45, noise=0.05, seed=53)).quantize(60)
    for version in ("BLP1", "BLP2"):
        quant.save(str(tmp_path / f"{version}.blp"), blp_version=version)
        assert check(str(tmp_path / f"{version}.blp"), "BLP")
    rgba = quant.convert("RGBA")
    rgba.putalpha(90)
    rgba.quantize(60).save(str(tmp_path / "alpha.blp"))
    assert check(str(tmp_path / "alpha.blp"), "BLP")
    rng = np.random.default_rng(10)
    pal = rng.integers(0, 256, 1024, dtype=np.uint8).tobytes()
    idx = rng.integers(0, 256, 45 * 30, dtype=np.uint8).tobytes()
    for enc in (4, 5):
        for alpha in (0, 1):
            data = blp1(45, 30, 1, alpha, enc, pal + idx, [9999], [len(idx)])
            assert check(put(str(tmp_path / f"b1_{enc}_{alpha}.blp"), data), "BLP")
    for depth in (0, 1, 4, 8, -1):
        data = blp2(45, 30, 1, depth, 8, pal, idx + b"extra")
        assert check(put(str(tmp_path / f"b2_{depth}.blp"), data), "BLP")
    both_fail(put(str(tmp_path / "short.blp"), blp2(45, 30, 1, 0, 0, pal, idx[:-1])),
              "not enough image data")
    both_fail(put(str(tmp_path / "enc3.blp"), blp1(45, 30, 1, 0, 3, pal + idx, [0], [100])),
              "encoding")


@pytest.mark.parametrize("alpha_encoding", [0, 1, 7])
@pytest.mark.parametrize("alpha_depth", [0, 1, 8])
def test_blp2_dxt_through_pils_python_decoders(tmp_path, alpha_encoding, alpha_depth):
    rng = np.random.default_rng(11 + alpha_encoding + 3 * alpha_depth)
    size = 8 if alpha_encoding == 0 else 16
    pal = bytes(1024)
    for w, h in ((16, 8), (13, 9), (3, 2)):
        blocks = _blocks(rng, ((w + 3) // 4) * ((h + 3) // 4), size)
        if alpha_encoding == 0:
            blocks[::2, :4] = blocks[::2][:, [2, 3, 0, 1]]
        data = blp2(w, h, 2, alpha_depth, alpha_encoding, pal, blocks.tobytes())
        path = put(str(tmp_path / f"{w}x{h}.blp"), data)
        try:
            want = pil(path)
        except ValueError:  # DXT1 without alpha at a width the rows do not fill
            both_fail(path, "not enough image data")
            continue
        np.testing.assert_array_equal(tio.read_image(path), want)


def test_blp_failures_raise_as_pil_fails(tmp_path):
    pal, blocks = bytes(1024), bytes(64)
    cases = {"compression": blp2(8, 8, 2, 0, 0, pal, blocks, compression=0),
             "encoding 3": blp2(8, 8, 3, 0, 0, pal, blocks),
             "alpha encoding 2": blp2(8, 8, 2, 0, 2, pal, blocks),
             "Truncated File Read": blp2(8, 8, 2, 0, 1, pal, blocks[:40])}
    for i, (names, data) in enumerate(cases.items()):
        both_fail(put(str(tmp_path / f"{i}.blp"), data), names.split(" ")[0])
    both_fail(put(str(tmp_path / "pal.blp"), blp2(8, 8, 1, 0, 0, pal[:500], b"")),
              "Truncated File Read")
    both_fail(put(str(tmp_path / "h0.blp"), blp2(8, 0, 1, 0, 0, pal, blocks)),
              "cannot identify image file")


# ------------------------------------------------------ committed inputs
def make_texture_inputs(d: str) -> None:
    """Write these inputs of ``test_torch_image_formats.CHIP_INPUTS`` into ``d``."""
    Image.fromarray(_pattern(384, 512, noise=0.02, seed=60)).convert("RGBA").save(
        os.path.join(d, "photo_dxt1.dds"), pixel_format="DXT1")
    photo = bc7_mode6(_pattern(96, 256, noise=0.02, seed=61))
    rng = np.random.default_rng(62)
    rand = _blocks(rng, 64 * 8, 16)
    low = (1 << (np.arange(len(rand)) % 8)).astype(np.int64)
    rand[:, 0] = ((rand[:, 0].astype(np.int64) & ~((low << 1) - 1)) | low).astype(np.uint8)
    with open(os.path.join(d, "bc7_mode6.dds"), "wb") as f:
        f.write(dds(256, 128, 4, b"DX10", dxgi=99, body=photo + rand.tobytes()))
    jpeg = _jpeg(Image.fromarray(_pattern(192, 256, noise=0.02, seed=63)), quality=90)
    with open(os.path.join(d, "photo_jpeg.blp"), "wb") as f:
        f.write(blp1_jpeg(jpeg, 256, 192, gap=3))
    tmp = io.BytesIO()
    Image.fromarray(_pattern(96, 128, noise=0.02, seed=64)).convert("RGBA").save(
        tmp, "DDS", pixel_format="DXT1")
    with open(os.path.join(d, "photo_dxt1.ftc"), "wb") as f:
        f.write(ftex(128, 96, 0, tmp.getvalue()[128:]))


# --------------------------------------------------------- random files
def test_random_dds_ftex_blp_files_match_pil_or_both_fail(tmp_path):
    rng = np.random.default_rng(12)
    outcomes = {"equal": 0, "both fail": 0}
    fourccs = [b"DXT1", b"DXT3", b"DXT5", b"ATI1", b"ATI2", b"BC5S", b"BC4U", b"DX10", b"DXT2"]
    dxgis = [28, 29, 71, 74, 77, 80, 83, 84, 95, 96, 98, 81, 2]
    for i in range(240):
        w, h = (int(v) for v in rng.integers(0, 14, 2))
        body = rng.integers(0, 256, int(rng.integers(0, 900)), dtype=np.uint8).tobytes()
        kind = i % 4
        if kind < 2:
            pf = int(rng.choice([0x40, 0x41, 0x20000, 0x20001, 0x20, 0x4, 0x4, 0x4, 0x2]))
            masks = [int(m) for m in rng.integers(0, 2 ** 32, 4, dtype=np.uint64)]
            if rng.random() < 0.5:
                masks = [0xFF << 8 * int(k) for k in rng.permutation(4)]
            data = dds(w, h, pf, fourccs[int(rng.integers(len(fourccs)))],
                       int(rng.choice([0, 8, 12, 16, 24, 32, 40])), masks,
                       dxgis[int(rng.integers(len(dxgis)))], body)
        elif kind == 2:
            data = ftex(w, h, int(rng.integers(0, 3)), body, formats=1 + int(rng.random() < 0.1))
        else:
            pal = rng.integers(0, 256, 1024, dtype=np.uint8).tobytes()
            if rng.random() < 0.5:
                data = blp2(w, h, int(rng.integers(1, 4)), int(rng.choice([0, 1, 8])),
                            int(rng.choice([0, 1, 7, 3])), pal, body)
            else:
                data = blp1(w, h, int(rng.integers(0, 3)), int(rng.integers(0, 2)),
                            int(rng.integers(3, 6)), pal + body, [9999], [int(rng.integers(
                                0, 300))])
        outcomes[same_or_both_fail(put(str(tmp_path / f"{i}"), data))] += 1
    assert outcomes["equal"] > 40 and outcomes["both fail"] > 40
