"""The port's JPEG 2000 reader on files PIL's writer cannot make, against
PIL 12.1's ``convert("RGB")`` (OpenJPEG 2.5.4), bit for bit, on the CPU.

- Hand-built by ``j2k_encode`` (one layer, LRCP, the 5/3 transform): odd
  image and tile origins, subsampled components (4:2:0, 4:2:2 and more, as
  sYCC, as sRGB and in raw codestreams, which PIL reads as sYCC where only
  the colour differences are subsampled), ``pclr`` palettes (P and PA, RGB
  and RGBA entries, a repeated colour, indices past the palette, a grey
  colour space PIL fails on), precisions 1, 4, 9, 12 and 16, signed
  samples, each of the six code-block styles and all at once, RGN's ROI
  shift, and five components (which PIL's opener passes on); tiles whose
  subsampled planes PIL's unpacker reads past (zeros there); a seeded fuzz
  of 80 hand-built files over all of these.
- PIL-written files re-serialised with the port's own tier-2 parse
  (``j2k_encode.repack``): packet headers in PPM (main header) or PPT
  (tile-part header) markers, SOP and EPH markers, the packets in every
  progression order (PCRP too, which PIL's writer fails on) and under POC
  markers; PIL must decode each as it decodes the original.
- Quantisation PIL's writer does not use: scalar derived steps (a PIL 9/7
  file's QCD rewritten to the LL band's step only), and 1 to 7 guard bits.
- COD asking for SOP or EPH markers the packets lack (a missing EPH fails,
  a missing SOP does not), and JP2 colour spaces OpenJPEG does not know
  (read as unspecified) or PIL cannot unpack (eYCC).
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

import j2k_encode as enc
from audioeditingcode_tpu_torch.utils import image_io as tio
from test_torch_image_formats import _pattern
from test_torch_image_jpeg2000 import pil_rgb, same, save

LAZY, RESET, TERMALL, VSC, PTERM, SEGSYM = (enc.t1.LAZY, enc.t1.RESET, enc.t1.TERMALL,
                                            enc.t1.VSC, enc.t1.PTERM, enc.t1.SEGSYM)


def grey(h=24, w=20, seed=0):
    return _pattern(h, w, seed=seed)[..., 0].astype(np.int64)


def rgb_planes(h=24, w=20, seed=0):
    p = _pattern(h, w, seed=seed).astype(np.int64)
    return [p[..., i] for i in range(3)]


def both_fail(data: bytes, names: str) -> None:
    with pytest.raises(Exception):
        pil_rgb(data)
    with pytest.raises(ValueError, match=names):
        tio.decode_image(data, "f")


STYLES = {"BYPASS": LAZY, "RESET": RESET, "TERMALL": TERMALL, "VSC": VSC, "PTERM": PTERM,
          "SEGSYM": SEGSYM, "all six": LAZY | RESET | TERMALL | VSC | PTERM | SEGSYM,
          "BYPASS+TERMALL": LAZY | TERMALL}


@pytest.mark.parametrize("style", sorted(STYLES))
def test_code_block_styles(style):
    """Each style bit, with blocks of 8 x 8 over many bit-planes (BYPASS
    reaches its raw passes); PIL decodes them losslessly, as the port."""
    p = grey(19, 21)
    data = enc.encode([p * 11 % 4096], prec=12, style=STYLES[style], cblk=(3, 3))
    same(data)


ORIGINS = {"image origin": {"origin": (3, 5)},
           "image origin, 3 levels": {"origin": (7, 1), "levels": 3},
           "tiles": {"tile": (8, 7)},
           "odd image and tile origins": {"origin": (3, 5), "tile": (7, 6), "tile_origin": (1, 2)},
           "tile origin past the image origin's tile": {"origin": (9, 4), "tile": (6, 5),
                                                        "tile_origin": (5, 3)}}


@pytest.mark.parametrize("case", sorted(ORIGINS))
def test_origins_and_tiles(case):
    kw = ORIGINS[case]
    same(enc.encode(rgb_planes(), **kw))
    same(enc.encode([grey()], **kw))


SUBSAMPLING = {"4:2:0": [(1, 1), (2, 2), (2, 2)], "4:2:2": [(1, 1), (2, 1), (2, 1)],
               "4:4:0": [(1, 1), (1, 2), (1, 2)], "one chroma": [(1, 1), (2, 2), (1, 1)],
               "all three": [(2, 2), (2, 2), (2, 2)], "luma only": [(2, 1), (1, 1), (1, 1)],
               "alpha": [(1, 1), (1, 1), (1, 1), (2, 2)],
               "4:2:0 with alpha": [(1, 1), (2, 2), (2, 2), (1, 1)]}


def _sub_planes(sub, h, w):
    return [_pattern(-(-h * sub[0][1] // dy), -(-w * sub[0][0] // dx), seed=i)[..., 0]
            .astype(np.int64) for i, (dx, dy) in enumerate(sub)]


@pytest.mark.parametrize("size", [(24, 20), (23, 19)])
@pytest.mark.parametrize("case", sorted(SUBSAMPLING))
def test_subsampled_components(case, size):
    """Raw codestreams (read as sYCC where only the colour differences are
    subsampled), and JP2 as sRGB and as sYCC; odd sizes give PIL's own
    row lengths (w // dx) and plane offsets."""
    sub = SUBSAMPLING[case]
    h, w = size
    cs = enc.encode(_sub_planes(sub, h, w), sub=sub)
    same(cs)
    ph, pw = h * sub[0][1], w * sub[0][0]
    for enumcs in (16, 18):
        same(enc.jp2(cs, len(sub), ph, pw, 7, enumcs=enumcs))


def test_subsampled_image_origin():
    sub = [(1, 1), (2, 2), (2, 2)]
    same(enc.jp2(enc.encode(_sub_planes(sub, 24, 20), sub=sub, origin=(5, 3)), 3, 24, 20, 7,
                 enumcs=18))


def test_subsampled_grey_fails_as_in_pil():
    both_fail(enc.encode(_sub_planes([(2, 2)], 12, 10), sub=[(2, 2)]), "no unpacker")
    both_fail(enc.encode(_sub_planes([(1, 1), (2, 2)], 12, 10), sub=[(1, 1), (2, 2)]),
              "no unpacker")


PALETTES = {"rgb": [(10, 20, 30), (200, 0, 0), (0, 255, 0), (10, 20, 30), (1, 2, 3), (9, 9, 9)],
            "rgba": [(1, 2, 3, 4), (5, 6, 7, 8), (1, 2, 3, 4), (9, 9, 9, 9), (20, 21, 22, 23)]}


@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("kind", sorted(PALETTES))
def test_pclr_palettes(kind, alpha):
    """P and PA: the entries gathered as ``ImagePalette.getcolor`` gathers
    them (a repeated colour once), indices past them black."""
    rng = np.random.default_rng(7)
    idx = rng.integers(0, 9, (16, 18))
    planes = [idx] + ([rng.integers(0, 256, (16, 18))] if alpha else [])
    data = enc.jp2(enc.encode(planes), len(planes), 16, 18, 7, enumcs=16,
                   pclr=(PALETTES[kind], 8))
    assert Image.open(io.BytesIO(data)).mode == ("PA" if alpha else "P")
    same(data)


def test_pclr_in_grey_fails_as_in_pil():
    data = enc.jp2(enc.encode([grey() % 6]), 1, 24, 20, 7, enumcs=17,
                   pclr=(PALETTES["rgb"], 8))
    both_fail(data, "no unpacker for mode P")


@pytest.mark.parametrize("prec", [1, 4, 9, 12, 16])
def test_precisions(prec):
    """Grey (L, or I;16 past 8 bits in a codestream and past 9 in JP2's
    ihdr, which PIL then clamps) and RGB, shifted to 8 bits with PIL's
    rounding."""
    rng = np.random.default_rng(prec)
    v = rng.integers(0, 1 << prec, (17, 13))
    v[0, :4] = [0, (1 << prec) - 1, min(255, (1 << prec) - 1), (1 << prec) // 2]
    cs = enc.encode([v], prec=prec)
    same(cs)
    same(enc.jp2(cs, 1, 17, 13, prec - 1, enumcs=17))
    same(enc.encode([rng.integers(0, 1 << prec, (17, 13)) for _ in range(3)], prec=prec))


@pytest.mark.parametrize("prec", [8, 12])
def test_signed_samples(prec):
    rng = np.random.default_rng(prec)
    lo, hi = -(1 << (prec - 1)), 1 << (prec - 1)
    v = rng.integers(lo, hi, (17, 13))
    v[0, :3] = [lo, hi - 1, 0]
    same(enc.encode([v], prec=prec, sgnd=True))
    same(enc.encode([v, v[::-1], -v - 1], prec=prec, sgnd=True))


@pytest.mark.parametrize("shift", [3, 9])
def test_rgn_roi_shift(shift):
    same(enc.encode([grey()], roishift=[shift], levels=1 if shift > 8 else 2))
    same(enc.encode(rgb_planes(), roishift=[shift, 0, shift]))


def test_rct_from_the_encoder():
    same(enc.encode(rgb_planes(), mct=True))


def test_five_components_pass_on():
    """PIL's opener passes on a codestream of five components (SIZ) and a
    JP2 whose ihdr says five: nothing else takes them."""
    cs = enc.encode([grey()] * 5)
    for data in (cs, enc.jp2(cs, 5, 24, 20, 7)):
        with pytest.raises(Exception, match="cannot identify"):
            pil_rgb(data)
        with pytest.raises(ValueError, match="cannot identify image file"):
            tio.decode_image(data, "f")


# ------------------------------------------------------- re-serialised
SOURCES = {"layers": {"quality_layers": [30, 10, 1]},
           "tiles and precincts": {"tile_size": (24, 16), "quality_layers": [20, 2],
                                   "precinct_size": (32, 32), "num_resolutions": 3}}
REPACKS = {"PPM": {"ppm": True}, "PPT": {"ppt": True}, "SOP": {"sop": True},
           "EPH": {"eph": True}, "SOP and EPH": {"sop": True, "eph": True},
           "PPM with SOP and EPH": {"ppm": True, "sop": True, "eph": True},
           "PPT with EPH": {"ppt": True, "eph": True},
           "LRCP": {"progression": 0}, "RLCP": {"progression": 1}, "RPCL": {"progression": 2},
           "PCRP": {"progression": 3}, "CPRL": {"progression": 4},
           "POC by resolution": {"poc": [(0, 0, 3, 2, 3, 2), (2, 0, 3, 6, 3, 4)]},
           "POC by layer": {"poc": [(0, 0, 1, 6, 3, 3), (0, 0, 3, 6, 3, 1)]},
           "POC by component": {"poc": [(0, 0, 3, 6, 2, 0), (0, 2, 3, 6, 3, 3)]}}


@pytest.mark.parametrize("source", sorted(SOURCES))
@pytest.mark.parametrize("repack", sorted(REPACKS))
def test_repacked_packets(repack, source):
    data = save(Image.fromarray(_pattern(40, 44)), no_jp2=True, **SOURCES[source])
    out = enc.repack(data, **REPACKS[repack])
    np.testing.assert_array_equal(pil_rgb(out), pil_rgb(data))
    same(out)


def _derived_qcd(data: bytes) -> bytes:
    """A raw 9/7 codestream with its QCD rewritten as scalar derived (the LL
    band's step only; the others derived per level)."""
    i = data.index(b"\xff\x5c")
    (length,) = struct.unpack(">H", data[i + 2:i + 4])
    sqcd = data[i + 4]
    assert sqcd & 31 == 2  # scalar expounded, as PIL writes 9/7
    qcd = bytes([(sqcd & 0xE0) | 1]) + data[i + 5:i + 7]
    return data[:i] + b"\xff\x5c" + struct.pack(">H", 2 + len(qcd)) + qcd + data[i + 2 + length:]


@pytest.mark.parametrize("levels", [1, 3, 5])
def test_scalar_derived_quantisation(levels):
    data = save(Image.fromarray(_pattern(40, 44)), no_jp2=True, irreversible=True,
                num_resolutions=levels + 1)
    same(_derived_qcd(data))


@pytest.mark.parametrize("guard", [1, 3, 7])
def test_guard_bits(guard):
    same(enc.encode([grey() // 4], guard=guard, prec=6))


def _with_scod(data: bytes, bits: int) -> bytes:
    i = data.index(b"\xff\x52")
    return data[:i + 4] + bytes([data[i + 4] | bits]) + data[i + 5:]


def test_missing_eph_fails_and_missing_sop_does_not():
    """COD asks for SOP or EPH markers the packets lack: OpenJPEG only warns
    on a missing SOP, and fails on a missing EPH."""
    data = enc.repack(save(Image.fromarray(_pattern(33, 29)), no_jp2=True))
    for packed in ({}, {"ppm": True}):
        source = enc.repack(data, **packed)
        same(_with_scod(source, 2))
        both_fail(_with_scod(source, 4), "Expected EPH marker")


COLR = {"enumcs 99": struct.pack(">BBBI", 1, 0, 0, 99), "ICC profile": bytes([2, 0, 0]) + bytes(20),
        "method 3": struct.pack(">BBBI", 3, 0, 0, 16), "no colr box": None}


@pytest.mark.parametrize("case", sorted(COLR))
def test_colour_space_left_unspecified(case):
    """A JP2 whose colour space OpenJPEG does not know reads as a raw
    codestream would (subsampled colour differences as sYCC); eYCC fails."""
    sub = [(1, 1), (2, 2), (2, 2)]
    for planes, kw in ((_sub_planes(sub, 12, 10), {"sub": sub}), ([grey()] * 3, {}),
                       ([grey()], {})):
        cs = enc.encode(planes, **kw)
        h, w = planes[0].shape
        data = enc.jp2(cs, len(planes), h, w, 7, colr=COLR[case])
        same(data)
        np.testing.assert_array_equal(pil_rgb(data), pil_rgb(cs))
    both_fail(enc.jp2(enc.encode([grey()] * 3), 3, 24, 20, 7, enumcs=24), "no unpacker")


ODD_TILES = {"4:2:0, tiles of 15 and 3 rows": dict(h=18, w=4, sub=[(1, 1), (2, 2), (2, 2)],
                                                   tile=(9, 15)),
             "4:2:2, tiles 13 wide": dict(h=9, w=26, sub=[(1, 1), (2, 1), (2, 1)], tile=(13, 4)),
             "4:4:0, tiles 9 high": dict(h=14, w=24, sub=[(1, 1), (1, 2), (1, 2)], tile=(7, 9)),
             "4:2:0, odd origins": dict(h=7, w=14, sub=[(1, 1), (2, 2), (2, 2)], tile=(9, 6),
                                        origin=(8, 4), tile_origin=(6, 3))}


@pytest.mark.parametrize("case", sorted(ODD_TILES))
def test_subsampled_tiles_pil_reads_past(case):
    """Tiles whose subsampled planes PIL's unpacker reads past (its row
    length and offsets from w // dx and h // dy): those reads see zeros."""
    kw = dict(ODD_TILES[case])
    h, w, sub = kw.pop("h"), kw.pop("w"), kw["sub"]
    x0, y0 = kw.get("origin", (0, 0))
    rng = np.random.default_rng(len(case))
    planes = [rng.integers(0, 256, (-(-(y0 + h) // dy) - -(-y0 // dy),
                                    -(-(x0 + w) // dx) - -(-x0 // dx))) for dx, dy in sub]
    same(enc.encode(planes, levels=1, **kw))


def random_encoder_file(rng: np.random.Generator) -> bytes:
    """A random hand-built codestream (or JP2): components, precision,
    signedness, origins, tiles, subsampled colour differences, levels,
    code-block sizes and styles, ROI shifts, RCT."""
    nc = int(rng.choice([1, 2, 3, 4]))
    prec = int(rng.choice([1, 4, 8, 8, 10, 12, 16]))
    sgnd = bool(rng.random() < 0.2)
    h, w = int(rng.integers(1, 24)), int(rng.integers(1, 24))
    sub = [(1, 1)] * nc
    if nc >= 3 and rng.random() < 0.4:
        sub = [(1, 1)] + [tuple(int(v) for v in rng.choice([1, 2], 2))] * 2 + sub[3:]
    x0, y0 = (int(rng.integers(0, 9)), int(rng.integers(0, 9))) if rng.random() < 0.5 else (0, 0)
    kw = {}
    if rng.random() < 0.4:
        kw["tile"] = (int(rng.integers(4, 20)), int(rng.integers(4, 20)))
        to = (int(rng.integers(0, x0 + 1)), int(rng.integers(0, y0 + 1)))
        if to[0] + kw["tile"][0] <= x0 or to[1] + kw["tile"][1] <= y0:
            to = (x0, y0)
        kw["tile_origin"] = to
    lo, hi = (-(1 << (prec - 1)), 1 << (prec - 1)) if sgnd else (0, 1 << prec)
    planes = [rng.integers(lo, hi, (-(-(y0 + h) // dy) - -(-y0 // dy),
                                    -(-(x0 + w) // dx) - -(-x0 // dx))) for dx, dy in sub]
    cs = enc.encode(planes, prec=prec, sgnd=sgnd, origin=(x0, y0), sub=sub,
                    levels=int(rng.integers(0, 4)),
                    cblk=(int(rng.integers(2, 5)), int(rng.integers(2, 5))),
                    style=int(rng.integers(0, 64)) if rng.random() < 0.5 else 0,
                    roishift=[int(rng.integers(0, 6)) if rng.random() < 0.2 else 0
                              for _ in range(nc)],
                    mct=nc >= 3 and sub[1] == sub[2] == (1, 1) and rng.random() < 0.3, **kw)
    if rng.random() < 0.5:
        return cs
    return enc.jp2(cs, nc, h, w, prec - 1, enumcs=int(rng.choice([16, 17, 18, 12, 99])))


@pytest.mark.parametrize("seed", range(2))
def test_seeded_fuzz_of_hand_built_files(seed):
    """40 random hand-built files a seed: each equal to PIL, or failing
    where PIL fails (a mode PIL has no unpacker for)."""
    from test_torch_image_jpeg2000_streams import outcome

    rng = np.random.default_rng(2000 + seed)
    seen = [outcome(random_encoder_file(rng)) for _ in range(40)]
    assert seen.count("equal") >= 25
