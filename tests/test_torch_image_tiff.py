"""The port's TIFF reader (utils/image_tiff.py) on the kinds PIL 12.1 reads
beyond the ones of test_torch_image_codecs.py, each against PIL's
``np.array(Image.open(p).convert("RGB"))``, bit for bit, on the CPU.

- Files PIL writes: CMYK, YCbCr, CIELab, float32 and int32 under every
  compression PIL writes (raw, PackBits, LZW, Deflate), JPEG-in-TIFF from
  RGB, YCbCr, L, CMYK and LAB images, BigTIFF.
- Files built here by ``test_torch_image_codecs.write``, a TIFF writer
  after the TIFF 6.0 spec and the BigTIFF layout: 16-bit CMYK, CMYK with extra samples, planar CMYK,
  InkSet 2; YCbCr data units at every subsampling libtiff's RGBA interface
  takes, with and without the tag, with non-default coefficients and
  reference black and white, and under each Orientation, sizes that
  leave 4x4 units cut at the edges; signed and
  floating-point samples at 16 and 32 bits in both byte orders with
  predictors 2 and 3, NaN and infinities; 12-bit greyscale; FillOrder 2;
  BigTIFF under every compression; JPEG-in-TIFF in strips and tiles from
  PIL's own JPEG streams, split into JPEGTables and abbreviated streams,
  with restart markers and 4:2:0 chroma.
- Each kind PIL fails on or mis-reads raises a ValueError in the port.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from audioeditingcode_tpu_torch.utils import image_io as tio
from test_torch_image_codecs import _both_raise, _check, layout, write
from test_torch_image_formats import _pattern, _pil

def _reads_or_both_raise(path):
    """PIL reads the file and the port gives its pixels, or PIL fails and
    the port raises a ValueError. Returns whether PIL read it."""
    try:
        _pil(path)
    except Exception:
        _both_raise(path)
        return False
    _check(path)
    return True


PIL_COMPRESSIONS = ["raw", "packbits", "tiff_lzw", "tiff_adobe_deflate"]


# ------------------------------------------------------------------- CMYK
@pytest.mark.parametrize("compression", PIL_COMPRESSIONS)
def test_cmyk_from_pil(tmp_path, compression):
    path = str(tmp_path / "c.tif")
    Image.fromarray(_pattern(37, 53, noise=0.3)).convert("CMYK").save(path,
                                                                       compression=compression)
    assert Image.open(path).mode == "CMYK"
    _check(path)
    rng = np.random.default_rng(1)
    Image.fromarray(rng.integers(0, 256, (19, 23, 4)).astype(np.uint8), "CMYK").save(
        path, compression=compression)
    _check(path)


@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("comp", [1, 5, 8, 32773])
def test_cmyk_built_by_hand(tmp_path, comp, order):
    """16-bit CMYK, one and two extra samples, an alpha extra sample (no mode
    in PIL), planes, tiles, predictor 2 and InkSet 2."""
    rng = np.random.default_rng(comp)
    path = str(tmp_path / "c.tif")
    read = 0
    for bits, spp, extra in ((8, 4, ()), (16, 4, ()), (8, 5, (0,)), (8, 6, (0, 0)), (8, 5, (2,)),
                             (16, 5, (0,))):
        px = rng.integers(0, 1 << bits, (13, 21, spp))
        more = {338: (3, list(extra))} if extra else {}
        for kw in ({}, {"planar": 2}, {"tile": (16, 16)}, {"rows": 4}, {"predictor": 2},
                   {"more": {**more, 332: (3, [2])}}):
            if kw.get("predictor") and comp not in (5, 8):
                continue
            write(path, px, bits, 5, order, comp, **{"more": more, **kw})
            if kw.get("planar") and (bits, spp, comp) == (16, 4, 1):  # PIL misreads it
                with pytest.raises(ValueError, match="planar CMYK"):
                    tio.read_image(path)
                continue
            read += _reads_or_both_raise(path)
    assert read == {1: 17, 5: 22, 8: 22, 32773: 18}[comp]


# ------------------------------------------------------------------ YCbCr
@pytest.mark.parametrize("compression", PIL_COMPRESSIONS)
def test_ycbcr_from_pil(tmp_path, compression):
    """PIL writes YCbCr with subsampling 1x1; uncompressed, PIL fails on it
    and the port raises."""
    path = str(tmp_path / "y.tif")
    Image.fromarray(_pattern(37, 53, noise=0.3)).convert("YCbCr").save(path,
                                                                        compression=compression)
    if compression == "raw":
        _both_raise(path)
    else:
        _check(path)


def ycbcr_units(ycc, hs, vs) -> bytes:
    """(h, w, 3) YCbCr samples as TIFF data units: each hs x vs block's luma
    (the edges repeated), then its first pixel's Cb and Cr."""
    h, w, _ = ycc.shape
    ph, pw = -(-h // vs) * vs, -(-w // hs) * hs
    p = np.pad(ycc, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    y = p[:, :, 0].reshape(ph // vs, vs, pw // hs, hs).transpose(0, 2, 1, 3).reshape(
        ph // vs, pw // hs, vs * hs)
    c = p[::vs, ::hs, 1:]
    return np.concatenate([y, c], -1).astype(np.uint8).tobytes()


SUBSAMPLINGS = [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (1, 2), (2, 4), (3, 1)]


@pytest.mark.parametrize("sub", SUBSAMPLINGS, ids=[f"{h}x{v}" for h, v in SUBSAMPLINGS])
def test_ycbcr_subsampling_built_by_hand(tmp_path, sub):
    """Data units at each subsampling, in strips (rows a multiple of the
    vertical subsampling) and tiles, odd sizes, LZW and Deflate; without the
    tag (libtiff's default 2x2); 2x4 and 3x1 fail in libtiff and raise."""
    hs, vs = sub
    rng = np.random.default_rng(hs * 10 + vs)
    ycc = rng.integers(0, 256, (19, 27, 3))
    ycc[0, :4] = [[0, 0, 0], [255, 255, 255], [0, 255, 0], [255, 0, 255]]
    path = str(tmp_path / "y.tif")
    checked = 0
    for comp in (5, 8):
        rows = 4 * vs
        blocks = [ycbcr_units(ycc[y:y + rows], hs, vs) for y in range(0, 19, rows)]
        more = {530: (3, [hs, vs])}
        checked += _reads_or_both_raise(write(path, ycc, 8, 6, "<", comp, rows=rows,
                                              raw_blocks=blocks, more=more))
        tiles = []
        for y in range(0, 19, 16):
            for x in range(0, 27, 16):
                t = np.zeros((16, 16, 3), np.int64)
                part = ycc[y:y + 16, x:x + 16]
                t[:part.shape[0], :part.shape[1]] = part
                tiles.append(ycbcr_units(t, hs, vs))
        checked += _reads_or_both_raise(write(path, ycc, 8, 6, ">", comp, tile=(16, 16),
                                              raw_blocks=tiles, more=more))
        if sub == (2, 2):  # no tag: libtiff's default
            checked += _reads_or_both_raise(write(path, ycc, 8, 6, "<", comp, rows=rows,
                                                  raw_blocks=blocks))
    assert checked == (0 if sub in ((2, 4), (3, 1)) else 6 if sub == (2, 2) else 4)


def test_ycbcr_coefficients_reference_and_planes(tmp_path):
    """Non-default YCbCrCoefficients and ReferenceBlackWhite go through
    libtiff's float32 tables; planar 1x1 data; predictor 2 at 1x1."""
    rng = np.random.default_rng(5)
    ycc = rng.integers(0, 256, (16, 256, 3))
    ycc[:, :, 0] = np.arange(256)
    ycc[:8, :, 1] = np.arange(256)
    ycc[8:, :, 2] = np.arange(256)
    path = str(tmp_path / "y.tif")
    one = {530: (3, [1, 1])}
    for coef, ref in (((299, 587, 114), (0, 255, 128, 255, 128, 255)),
                      ((2126, 7152, 722), (16, 235, 128, 240, 128, 240)),
                      ((2990, 5870, 1140), (15, 236, 130, 241, 120, 250)),
                      ((333, 334, 333), (0, 255, 0, 255, 0, 255))):
        more = {**one, 529: (5, [(c, 10000) for c in coef]),
                532: (5, [(r, 1) for r in ref])}
        _check(write(path, ycc, 8, 6, "<", 8, rows=5, more=more))
    _check(write(path, ycc, 8, 6, "<", 5, planar=2, rows=5, more=one))
    _check(write(path, ycc, 8, 6, ">", 8, predictor=2, more=one))
    _both_raise(write(path, ycc, 8, 6, "<", 5, planar=2, rows=4))  # planar 2x2: libtiff fails


@pytest.mark.parametrize("orientation", range(1, 9))
def test_ycbcr_orientation(tmp_path, orientation):
    """PIL turns the RGBA interface's raster by the Orientation tag."""
    rng = np.random.default_rng(orientation)
    ycc = rng.integers(0, 256, (11, 17, 3))
    path = write(str(tmp_path / "y.tif"), ycc, 8, 6, "<", 5, rows=4,
                 more={530: (3, [1, 1]), 274: (3, [orientation])})
    _check(path)


# ----------------------------------------------------------------- CIELab
@pytest.mark.parametrize("compression", PIL_COMPRESSIONS)
def test_cielab_from_pil(tmp_path, compression):
    path = str(tmp_path / "l.tif")
    Image.fromarray(_pattern(37, 53, noise=0.3)).convert("LAB").save(path,
                                                                      compression=compression)
    assert Image.open(path).mode == "LAB"
    _check(path)


def test_cielab_across_the_cube(tmp_path):
    """PIL's LittleCMS transform (33-point CLUT, tetrahedral interpolation)
    over 65536 random LAB triples, each grey axis value, and the cube's
    edges and corners, in one CIELab TIFF; and on other layouts (tiles,
    big-endian, Deflate, planes)."""
    rng = np.random.default_rng(11)
    edge = np.array([0, 1, 127, 128, 129, 254, 255])
    corners = np.stack(np.meshgrid(edge, edge, edge, indexing="ij"), -1).reshape(-1, 3)
    grey = np.stack([np.arange(256), np.full(256, 0), np.full(256, 0)], -1)
    lab = np.concatenate([rng.integers(0, 256, (65536, 3)), corners, grey,
                          grey + [0, 128, 128]])
    lab = np.concatenate([lab, np.zeros((-len(lab) % 256, 3), np.int64)]).reshape(-1, 256, 3)
    _check(write(str(tmp_path / "c.tif"), lab, 8, 8, "<", 5, rows=64))
    small = rng.integers(0, 256, (19, 27, 3))
    _check(write(str(tmp_path / "t.tif"), small, 8, 8, ">", 8, tile=(16, 16)))
    _check(write(str(tmp_path / "r.tif"), small, 8, 8, "<", 1, rows=5))
    for comp in (1, 5):  # in planes PIL's band unpackers flip a* and b*'s sign bit
        _check(write(str(tmp_path / "p.tif"), small, 8, 8, "<", comp, planar=2, rows=8))


# ------------------------------------------------ signed and float samples
SPECIAL = np.array([-1e30, -5, -0.5, -0.0, 0, 1e-40, 0.3, 0.99, 1, 1.5, 127.5, 254.99, 255,
                    255.5, 1e30, np.nan, np.inf, -np.inf], np.float32)


@pytest.mark.parametrize("compression", PIL_COMPRESSIONS)
def test_float_and_int_from_pil(tmp_path, compression):
    rng = np.random.default_rng(2)
    f = (rng.standard_normal((19, 23)) * 150 + 100).astype(np.float32)
    f.reshape(-1)[:SPECIAL.size] = SPECIAL
    i = rng.integers(-2 ** 31, 2 ** 31, (19, 23)).astype(np.int32)
    i[0, :8] = [-2 ** 31, -1, 0, 1, 255, 256, 2 ** 31 - 1, 128]
    i[1] = rng.integers(-50, 300, 23)
    for arr, mode in ((f, "F"), (i, "I")):
        path = str(tmp_path / f"{mode}.tif")
        Image.fromarray(arr).save(path, compression=compression)
        assert Image.open(path).mode == mode
        _check(path)


@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("comp", [1, 5, 8, 32773])
def test_signed_and_float_built_by_hand(tmp_path, comp, order):
    """Float32 (WhiteIsZero and BlackIsZero), signed 16 and 32, unsigned 32
    and 12-bit greyscale, with predictors 2 and 3; the compressed big-endian
    ones PIL misreads raise."""
    rng = np.random.default_rng(comp)
    path = str(tmp_path / "s.tif")
    f = (rng.standard_normal((13, 21, 1)) * 150 + 100).astype(np.float32)
    f.reshape(-1)[:SPECIAL.size] = SPECIAL
    cases = [(f, 32, 1, 3), (f, 32, 0, 3),
             (rng.integers(-40000, 40000, (13, 21, 1)).astype(np.int32), 32, 1, 2),
             (rng.integers(-400, 400, (13, 21, 1)).astype(np.int16), 16, 1, 2),
             (rng.integers(0, 2 ** 32, (13, 21, 1), dtype=np.uint64).astype(np.uint32), 32, 1, 1),
             (rng.integers(0, 4096, (13, 21, 1)), 12, 1, 1),
             (rng.integers(-100, 100, (13, 21, 1)).astype(np.int8), 8, 1, 2),
             (rng.integers(-100, 100, (13, 21, 1)).astype(np.int16), 16, 0, 2)]
    read = misread = 0
    for px, bits, photo, fmt in cases:
        for kw in ({}, {"predictor": 2}, {"predictor": 3}, {"tile": (16, 16)}, {"rows": 5}):
            if kw.get("predictor") and (comp not in (5, 8) or bits == 12
                                        or (kw["predictor"] == 3 and fmt != 3)):
                continue
            write(path, px, bits, photo, order, comp, fmt, **kw)
            if comp != 1 and order == ">" and bits > 8 and (fmt == 3 or (fmt, photo) == (2, 1)):
                with pytest.raises(ValueError, match="PIL misreads it"):
                    tio.read_image(path)
                misread += 1
                continue
            read += _reads_or_both_raise(path)
    assert (read, misread) == {(1, "<"): (21, 0), (1, ">"): (15, 0), (5, "<"): (29, 0),
                               (5, ">"): (4, 18), (8, "<"): (29, 0), (8, ">"): (4, 18),
                               (32773, "<"): (21, 0), (32773, ">"): (3, 12)}[comp, order]


# ------------------------------------------------------------ FillOrder 2
def test_fill_order_2(tmp_path):
    """Bits reversed in each stored byte: read where PIL has a FillOrder 2
    mode and an unpacker for it (uncompressed), or a FillOrder 2 mode
    (compressed, where libtiff reverses the bits); raise where it fails."""
    rng = np.random.default_rng(3)
    path = str(tmp_path / "f.tif")
    read = {}
    for bits, photo, spp, order in ((1, 1, 1, "<"), (1, 0, 1, ">"), (2, 1, 1, "<"),
                                    (2, 0, 1, ">"), (4, 1, 1, ">"), (4, 0, 1, "<"),
                                    (8, 1, 1, ">"), (8, 0, 1, "<"), (16, 1, 1, "<"),
                                    (16, 1, 1, ">"), (8, 2, 3, "<"), (8, 2, 4, "<"),
                                    (8, 5, 4, "<"), (1, 3, 1, "<"), (2, 3, 1, ">"),
                                    (4, 3, 1, ">"), (8, 3, 1, "<")):
        px = rng.integers(0, 1 << bits, (9, 13, spp))
        more = {320: (3, list(rng.integers(0, 65536, 3 << bits)))} if photo == 3 else {}
        for comp in (1, 5, 8, 32773):
            write(path, px, bits, photo, order, comp, more=more, fill=2)
            read[bits, photo, spp, order, comp] = _reads_or_both_raise(path)
    assert sum(read.values()) == 52, read


# ------------------------------------------------------------------ BigTIFF
def test_bigtiff_from_pil(tmp_path):
    path = str(tmp_path / "b.tif")
    img = Image.fromarray(_pattern(37, 53, noise=0.3))
    for im in (img, img.convert("L"), img.convert("CMYK"), img.convert("RGBA")):
        im.save(path, big_tiff=True)
        assert open(path, "rb").read(4) == b"II+\x00"
        _check(path)


@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("comp", [1, 5, 8, 32773])
def test_bigtiff_built_by_hand(tmp_path, comp, order):
    """BigTIFF under each compression (PIL writes only uncompressed ones):
    strips, tiles, 16-bit, palette, CMYK, YCbCr, float, LONG8 offsets."""
    rng = np.random.default_rng(comp)
    path = str(tmp_path / "b.tif")
    for px, bits, photo, more in (
            (rng.integers(0, 256, (13, 21, 3)), 8, 2, {}),
            (rng.integers(0, 65536, (13, 21, 1)), 16, 1, {}),
            (rng.integers(0, 16, (13, 21, 1)), 4, 3, {320: (3, list(rng.integers(0, 65536, 48)))}),
            (rng.integers(0, 256, (13, 21, 4)), 8, 5, {}),
            (rng.integers(0, 256, (13, 21, 3)), 8, 6, {530: (3, [1, 1])})):
        for kw in ({}, {"tile": (16, 16)}, {"rows": 4}):
            write(path, px, bits, photo, order, comp, big=True, more=more, **kw)
            assert open(path, "rb").read(4) in (b"II+\x00", b"MM\x00+")
            if order == ">":  # PIL fails on MM BigTIFF
                _both_raise(path)
            elif photo == 6 and comp == 1:  # PIL reads four bytes a pixel
                with pytest.raises(ValueError, match="uncompressed YCbCr"):
                    tio.read_image(path)
            else:
                _check(path)


# ------------------------------------------------------------ JPEG-in-TIFF
@pytest.mark.parametrize("mode", ["RGB", "YCbCr", "L", "CMYK", "LAB"])
def test_jpeg_in_tiff_from_pil(tmp_path, mode):
    """PIL writes JPEG-in-TIFF through libtiff with JPEGTables; RGB is
    written with photometric 2, YCbCr 6, L 1, CMYK 5, LAB 8."""
    img = Image.fromarray(_pattern(45, 67, noise=0.2)).convert(mode)
    path = str(tmp_path / "j.tif")
    for quality in (30, 90):
        for info in ({}, {278: 16}):
            img.save(path, compression="jpeg", quality=quality, tiffinfo=info)
            im = Image.open(path)
            assert im.tag_v2[259] == 7 and 347 in im.tag_v2
            _check(path)


def _split_jpeg(data: bytes):
    """A JPEG file -> (tables-only stream, abbreviated stream without the
    DQT and DHT segments)."""
    tables, rest, pos = b"", b"", 2
    while data[pos + 1] != 0xDA:
        (n,) = struct.unpack(">H", data[pos + 2:pos + 4])
        seg = data[pos:pos + 2 + n]
        if data[pos + 1] in (0xDB, 0xC4):
            tables += seg
        elif data[pos + 1] != 0xE0:  # the JFIF marker goes
            rest += seg
        pos += 2 + n
    return b"\xff\xd8" + tables + b"\xff\xd9", b"\xff\xd8" + rest + data[pos:]


def _jpeg_tiff(path, img, photo, tile=None, rows=None, sub=None, jpeg_kw=None, order="<",
               tables_in_stream=False, big=False):
    """JPEG-in-TIFF from PIL's JPEG streams of each strip or tile (a tile
    padded with its edge), JPEGTables from the first."""
    h, w = img.shape[:2]
    spp = 1 if img.ndim == 2 else img.shape[2]
    mode = {1: "L", 2: "RGB", 6: "RGB", 5: "CMYK"}[photo]
    kw = dict(quality=85, **(jpeg_kw or {}))
    if photo == 2:
        kw.setdefault("keep_rgb", True)
    if photo == 6:
        kw.setdefault("subsampling", 0)
    parts = []
    if tile:
        for y in range(0, h, tile[1]):
            for x in range(0, w, tile[0]):
                part = img[y:y + tile[1], x:x + tile[0]]
                pad = [(0, tile[1] - part.shape[0]), (0, tile[0] - part.shape[1])]
                parts.append(np.pad(part, pad + [(0, 0)] * (img.ndim - 2), mode="edge"))
    else:
        parts = [img[y:y + (rows or h)] for y in range(0, h, rows or h)]
    blocks, tables = [], None
    for part in parts:  # a stream whose tables differ from the first's keeps them
        buf = io.BytesIO()
        Image.fromarray(part, mode).save(buf, "JPEG", **kw)
        t, stream = _split_jpeg(buf.getvalue())
        tables = tables or t
        blocks.append(buf.getvalue() if tables_in_stream or t != tables else stream)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * spp), 259: (3, [7]),
            262: (3, [photo]), 277: (3, [spp]), 347: (7, tables)}
    if sub:
        tags[530] = (3, list(sub))
    if tile:
        tags.update({322: (4, [tile[0]]), 323: (4, [tile[1]])})
    else:
        tags[278] = (4, [rows or h])
    with open(path, "wb") as f:
        f.write(layout(blocks, tags, order, big, tiled=bool(tile)))
    return str(path)


JPEG_TIFF_CASES = {
    "ycbcr_420_strips": dict(photo=6, rows=16, sub=(2, 2), jpeg_kw={"subsampling": 2}),
    "ycbcr_420_no_tag": dict(photo=6, rows=32, jpeg_kw={"subsampling": 2}),
    "ycbcr_422_tiles": dict(photo=6, tile=(32, 16), sub=(2, 1), jpeg_kw={"subsampling": 1}),
    "ycbcr_444_restart": dict(photo=6, rows=24, sub=(1, 1),
                              jpeg_kw={"restart_marker_blocks": 3}),
    "ycbcr_420_restart_tiles": dict(photo=6, tile=(48, 32), sub=(2, 2), order=">",
                                    jpeg_kw={"subsampling": 2, "restart_marker_rows": 1}),
    "rgb_tiles": dict(photo=2, tile=(16, 16)),
    "rgb_strips_restart": dict(photo=2, rows=8, jpeg_kw={"restart_marker_blocks": 5}),
    "grey_tiles": dict(photo=1, tile=(32, 32)),
    "cmyk_strips": dict(photo=5, rows=16),
    "tables_in_each_stream": dict(photo=6, rows=16, sub=(1, 1), tables_in_stream=True),
    "bigtiff_ycbcr": dict(photo=6, rows=16, sub=(2, 2), jpeg_kw={"subsampling": 2}, big=True),
    "progressive_strips": dict(photo=6, rows=16, sub=(1, 1), jpeg_kw={"progressive": True}),
}


@pytest.mark.parametrize("case", sorted(JPEG_TIFF_CASES))
def test_jpeg_in_tiff_built_by_hand(tmp_path, case):
    kw = JPEG_TIFF_CASES[case]
    rgb = _pattern(45, 67, noise=0.2)
    img = {1: rgb[:, :, 0], 2: rgb, 6: rgb,
           5: np.asarray(Image.fromarray(rgb).convert("CMYK"))}[kw["photo"]]
    _check(_jpeg_tiff(str(tmp_path / "j.tif"), img, **kw))


def test_jpeg_in_tiff_sampling_rules_and_truncation(tmp_path):
    """A stream whose sampling differs from YCbCrSubsampling, subsampled
    chroma under photometric RGB, and a truncated file: PIL fails, the port
    raises."""
    rgb = _pattern(45, 67, noise=0.2)
    _both_raise(_jpeg_tiff(str(tmp_path / "a.tif"), rgb, 6, rows=16, sub=(1, 1),
                           jpeg_kw={"subsampling": 2}))
    _both_raise(_jpeg_tiff(str(tmp_path / "b.tif"), rgb, 2, rows=16,
                           jpeg_kw={"subsampling": 2, "keep_rgb": False}))
    path = str(tmp_path / "c.tif")
    Image.fromarray(rgb).save(path, compression="jpeg")
    data = open(path, "rb").read()
    for n in (12, len(data) // 2):
        open(tmp_path / "d.tif", "wb").write(data[:n])
        _both_raise(str(tmp_path / "d.tif"))


# ------------------------------------------------------- old-style JPEG
def old_jpeg_tiff(path, img, photo=6, sub=None, layout_kind="interchange", order="<"):
    """Old-style JPEG-in-TIFF (compression 6) from PIL's baseline JPEG of
    ``img``: "interchange" (JPEGInterchangeFormat at the strip, which holds
    the whole stream), "scan" (the strip holds the scan data only) or
    "tables" (no interchange stream: JPEGQTables, JPEGDCTables and
    JPEGACTables in tags, the strip the scan data)."""
    h, w = img.shape[:2]
    spp = 1 if img.ndim == 2 else 3
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=80, subsampling=sub if sub is not None else 2)
    jp = buf.getvalue()
    sos = jp.index(b"\xff\xda")
    scan = jp[sos + 2 + struct.unpack(">H", jp[sos + 2:sos + 4])[0]:]
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * spp), 259: (3, [6]),
            262: (3, [photo]), 277: (3, [spp]), 278: (4, [h])}
    if spp == 3 and sub is not None:
        tags[530] = (3, [[1, 1], [2, 1], [2, 2]][sub])
    if layout_kind == "tables":
        qt, dc, ac, pos = [], [], [], 2
        while jp[pos + 1] != 0xDA:
            (n,) = struct.unpack(">H", jp[pos + 2:pos + 4])
            body, k = jp[pos + 4:pos + 2 + n], 0
            while jp[pos + 1] == 0xDB and k < len(body):
                qt.append(body[k + 1:k + 65])
                k += 65
            while jp[pos + 1] == 0xC4 and k < len(body):
                total = sum(body[k + 1:k + 17])
                (dc if body[k] >> 4 == 0 else ac).append(body[k + 1:k + 17 + total])
                k += 17 + total
            pos += 2 + n
        base = 8 + len(scan) + len(scan) % 2
        blob, offs = b"", {}
        for key, tables in ((519, qt), (520, dc), (521, ac)):
            offs[key] = []
            for t in tables:
                offs[key].append(base + len(blob))
                blob += t
            offs[key] += offs[key][-1:] * (spp - len(offs[key]))
        tags.update({512: (3, [1]), 519: (4, offs[519][:spp]), 520: (4, offs[520][:spp]),
                     521: (4, offs[521][:spp])})
        data = layout([scan + bytes(len(scan) % 2) + blob], tags, order)
        data = data.replace(struct.pack(order + "HHII", 279, 4, 1, len(scan) + len(scan) % 2
                                        + len(blob)), struct.pack(order + "HHII", 279, 4, 1,
                                                                  len(scan)))
    else:
        tags.update({513: (4, [8]), 514: (4, [len(jp)])})
        data = layout([jp], tags, order)
        if layout_kind == "scan":  # the strip offset moved onto the scan data
            data = data.replace(struct.pack(order + "HHII", 273, 4, 1, 8),
                                struct.pack(order + "HHII", 273, 4, 1, 8 + len(jp) - len(scan)))
            data = data.replace(struct.pack(order + "HHII", 279, 4, 1, len(jp)),
                                struct.pack(order + "HHII", 279, 4, 1, len(scan)))
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


@pytest.mark.parametrize("kind", ["interchange", "scan", "tables"])
def test_old_style_jpeg_in_tiff(tmp_path, kind):
    """Compression 6 as libtiff's OJPEG codec decodes it for PIL: the
    stream's components at their own size, the chroma repeated over the
    data units, libtiff's YCbCr -> RGB; photometric YCbCr or RGB, every
    subsampling PIL writes, odd sizes, greyscale (a one-component stream
    sampled 2x2 fails in libtiff, and raises), big-endian."""
    path = str(tmp_path / "o.tif")
    checked = 0
    for h, w in ((24, 32), (37, 53)):
        img = _pattern(h, w, noise=0.2, seed=w)
        for sub in (0, 1, 2, None):
            for photo in (6, 2):
                _check(old_jpeg_tiff(path, img, photo, sub, kind, ">" if sub == 1 else "<"))
                checked += 1
        _check(old_jpeg_tiff(path, img[:, :, 0], 1, 0, kind))
        checked += 1
        grey = old_jpeg_tiff(path, img[:, :, 0], 1, 2, kind)  # one component sampled 2x2
        if kind == "tables":  # the stream built from the tags samples it 1x1
            _check(grey)
        else:  # libtiff's OJPEG codec fails on it
            _both_raise(grey)
    assert checked == 18


@pytest.mark.parametrize("kind", ["cmyk", "ycbcr", "lab", "float", "bigtiff", "jpeg", "old_jpeg"])
def test_new_kinds_truncated_raise_as_pil(tmp_path, kind):
    """Each new kind cut at a third, a half and short of its last bytes:
    PIL fails and the port raises, or (a cut tag past the image data: PIL
    keeps the tags before it) both read the same pixels."""
    img = _pattern(40, 50, noise=0.3)
    path = str(tmp_path / "a.tif")
    if kind in ("cmyk", "ycbcr", "lab"):
        Image.fromarray(img).convert({"cmyk": "CMYK", "ycbcr": "YCbCr", "lab": "LAB"}[kind]).save(
            path, compression="tiff_lzw")
    elif kind == "float":
        Image.fromarray(img[:, :, 0].astype(np.float32) * 1.5).save(path)
    elif kind == "bigtiff":
        Image.fromarray(img).save(path, big_tiff=True)
    elif kind == "jpeg":
        _jpeg_tiff(path, img, 6, rows=16, sub=(2, 2), jpeg_kw={"subsampling": 2})
    else:
        old_jpeg_tiff(path, img, 6, 2)
    data = open(path, "rb").read()
    read = 0
    for n in (len(data) // 3, len(data) // 2, len(data) - 40):
        open(tmp_path / "c.tif", "wb").write(data[:n])
        read += _reads_or_both_raise(str(tmp_path / "c.tif"))
    assert read == (1 if kind == "lab" else 0)  # its ICC profile tag comes last


@pytest.mark.parametrize("sub", [(1, 1), (2, 1), (2, 2), (4, 2), (4, 4)],
                         ids=["1x1", "2x1", "2x2", "4x2", "4x4"])
def test_ycbcr_predictor_2(tmp_path, sub):
    """Predictor 2 on YCbCr data units: libtiff undoes it over rows of its
    scanline size (a strip) or of three bytes a pixel of the tile's width,
    at a stride of three bytes, across the units; where those rows do not
    divide the block, libtiff fails on it and PIL's RGBA read, which does
    not stop on errors, draws its bytes unaccumulated."""
    hs, vs = sub
    rng = np.random.default_rng(hs + vs)
    ycc = rng.integers(0, 256, (16, 24, 3))
    path = str(tmp_path / "p.tif")
    more = {530: (3, [hs, vs]), 317: (3, [2])}
    checked = 0
    for comp in (5, 8):
        checked += _reads_or_both_raise(write(path, ycc, 8, 6, "<", comp, rows=16, more=more,
                                              raw_blocks=[ycbcr_units(ycc, hs, vs)]))
        tile = np.zeros((16, 16, 3), np.int64)
        tiles = []
        for x in range(0, 24, 16):
            t = tile.copy()
            part = ycc[:, x:x + 16]
            t[:, :part.shape[1]] = part
            tiles.append(ycbcr_units(t, hs, vs))
        checked += _reads_or_both_raise(write(path, ycc, 8, 6, ">", comp, tile=(16, 16),
                                              more=more, raw_blocks=tiles))
    assert checked == 4


def test_planar_extra_samples_in_tiles(tmp_path):
    """Compressed planes with unspecified extra samples: PIL fails on them in
    strips and reads them in tiles; CMYK's too."""
    rng = np.random.default_rng(12)
    path = str(tmp_path / "p.tif")
    read = 0
    for photo, bits, spp, extra in ((2, 8, 4, (0,)), (2, 8, 5, (0, 0)), (2, 16, 4, (0,)),
                                    (2, 8, 6, (1, 0, 0)), (5, 8, 5, (0,)), (5, 8, 6, (0, 0)),
                                    (3, 8, 2, (2,))):
        px = rng.integers(0, 1 << bits, (19, 27, spp))
        more = {338: (3, list(extra))}
        if photo == 3:
            more[320] = (3, list(rng.integers(0, 65536, 768)))
        for kw in ({"tile": (16, 16)}, {"rows": 5}):
            read += _reads_or_both_raise(write(path, px, bits, photo, ">", 8, planar=2, more=more,
                                               **kw))
    assert read == 8  # every tiled file, and palette + alpha in strips


def test_random_tiffs_match_pil_or_raise_naming_it(tmp_path):
    """600 TIFFs drawn at random over photometrics, depths, sample formats,
    extra samples, compressions, predictors, planes, strips and tiles,
    byte orders, fill orders and orientations: where PIL and the port both
    read a file, the pixels are equal; the port never reads a file PIL
    fails on; where PIL reads and the port raises, the port's message names
    PIL (a mode or layout PIL fails on or misreads)."""
    rng = np.random.default_rng(19)
    path = str(tmp_path / "r.tif")
    outcome = {"equal": 0, "both fail": 0, "PIL misreads": 0}
    for _ in range(600):
        photo = int(rng.choice([0, 1, 2, 3, 5, 6, 8]))
        bits = int(rng.choice([1, 2, 4, 8, 8, 8, 12, 16, 16, 32]))
        fmt = int(rng.choice([1, 1, 1, 2, 3]))
        spp = {0: 1, 1: 1, 3: 1, 2: 3, 5: 4, 6: 3, 8: 3}[photo]
        more = {274: (3, [int(rng.choice([1, 1, 3, 6]))])}
        if rng.random() < 0.2:
            spp += 1
            more[338] = (3, [int(rng.choice([0, 1, 2]))])
        h, w = int(rng.integers(3, 20)), int(rng.integers(3, 20))
        if fmt == 3 and bits == 32:
            px = (rng.standard_normal((h, w, spp)) * 100).astype(np.float32)
        elif fmt == 2 and bits in (16, 32):
            px = rng.integers(-300, 300, (h, w, spp)).astype(np.int16 if bits == 16 else np.int32)
        else:
            fmt = 1
            px = rng.integers(0, 1 << min(bits, 16), (h, w, spp))
        if photo == 3:
            more[320] = (3, list(rng.integers(0, 65536, 3 << min(bits, 8))))
        if photo == 6:
            more[530] = (3, [1, 1])
        comp = int(rng.choice([1, 5, 8, 32773]))
        layout_kw = [{}, {"rows": 4}, {"tile": (16, 16)}][int(rng.integers(3))]
        write(path, px, bits, photo, str(rng.choice(["<", ">"])), comp, fmt,
              predictor=int(rng.choice([1, 1, 2, 3])) if comp in (5, 8) else 1,
              planar=int(rng.choice([1, 1, 2])), more=more, fill=int(rng.choice([1, 1, 1, 2])),
              **layout_kw)
        try:
            want = _pil(path)
        except Exception:
            want = None
        try:
            got, error = tio.read_image(path), None
        except ValueError as e:
            got, error = None, str(e)
        if want is None:
            assert got is None, "the port reads a file PIL fails on"
            outcome["both fail"] += 1
        elif got is not None:
            np.testing.assert_array_equal(got, want)
            outcome["equal"] += 1
        else:
            assert "PIL" in error, error
            outcome["PIL misreads"] += 1
    assert outcome["equal"] > 150 and sum(outcome.values()) == 600, outcome
