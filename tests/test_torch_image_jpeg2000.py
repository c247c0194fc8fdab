"""The port's JPEG 2000 reader (utils/image_jpeg2000.py with
image_j2k_t1.py and image_j2k_dwt.py) on the files PIL 12.1's own writer
makes, against ``np.array(Image.open(p).convert("RGB"))`` (OpenJPEG 2.5.4),
bit for bit, on the CPU.

- Every mode PIL writes (L, LA, RGB, RGBA, I;16, CMYK, and YCbCr, which it
  marks sYCC and reads back as RGB) and every save option (irreversible,
  tile_size, each progression PIL writes, precinct_size, quality_layers,
  quality_mode, codeblock_size, num_resolutions, mct, no_jp2, plt, signed,
  cinema_mode), each with the 5/3 and the 9/7 wavelet: one case each.
- A seeded fuzz of 240 random PIL-written files (modes, sizes up to 64 px,
  options at random; at least 200 of them PIL's writer makes): every one
  equal to PIL.
- ``make_jpeg2000_inputs`` writes the committed JPEG 2000 inputs of
  ``test_torch_image_formats.CHIP_INPUTS`` (the 9/7 photo, a tiled RPCL
  raw codestream, a hand-built sYCC 4:2:0 file with an odd origin).
"""

import io
import os

import numpy as np
import pytest
from PIL import Image

from audioeditingcode_tpu_torch.utils import image_io as tio
from test_torch_image_formats import _pattern


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def same(data: bytes) -> None:
    """The port reads the bytes as PIL does, bit for bit."""
    want = pil_rgb(data)
    got = tio.decode_image(data, "f")
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def save(img: Image.Image, **kw) -> bytes:
    b = io.BytesIO()
    img.save(b, "JPEG2000", **kw)
    return b.getvalue()


def _image(mode: str, h: int = 37, w: int = 45, seed: int = 3) -> Image.Image:
    rgb = _pattern(h, w, seed=seed)
    alpha = _pattern(h, w, seed=seed + 1)[..., :1]
    if mode == "I;16":
        return Image.fromarray(rgb[..., 0].astype(np.uint16) * 257 + 3).convert("I;16")
    if mode in ("LA", "RGBA"):
        return Image.fromarray(np.concatenate([rgb, alpha], -1)).convert(mode)
    return Image.fromarray(rgb).convert(mode)


MODES = ["L", "LA", "RGB", "RGBA", "I;16", "CMYK", "YCbCr"]


@pytest.mark.parametrize("irreversible", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_every_mode_pil_writes(mode, irreversible):
    same(save(_image(mode), irreversible=irreversible))


OPTIONS = {"tile_size": {"tile_size": (16, 24)},
           "progression_RLCP": {"progression": "RLCP"},
           "progression_RPCL": {"progression": "RPCL"},
           "progression_CPRL": {"progression": "CPRL"},
           "precinct_size": {"precinct_size": (64, 64)},
           "precinct_size_tiles": {"precinct_size": (32, 32), "num_resolutions": 3,
                                   "tile_size": (24, 16)},
           "quality_layers": {"quality_layers": [40, 10, 1]},
           "quality_mode_dB": {"quality_mode": "dB", "quality_layers": [30, 45]},
           "codeblock_size": {"codeblock_size": (8, 16)},
           "num_resolutions_1": {"num_resolutions": 1},
           "num_resolutions_4": {"num_resolutions": 4},
           "mct": {"mct": 1},
           "no_jp2": {"no_jp2": True},
           "plt": {"plt": True},
           "signed": {"signed": True},
           "cinema_mode": {"cinema_mode": "cinema2k-24"},
           "comment": {"comment": "port test"}}


@pytest.mark.parametrize("irreversible", [False, True])
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_every_save_option(option, irreversible):
    same(save(_image("RGB"), irreversible=irreversible, **OPTIONS[option]))


def test_yccbcr_is_read_back_as_rgb():
    """PIL writes YCbCr as sYCC (colr 18) and reads it back as RGB, through
    its own YCbCr -> RGB (not the YCbCr planes)."""
    img = _image("YCbCr")
    data = save(img)
    assert data[data.index(b"colr") + 7:data.index(b"colr") + 11] == b"\0\0\0\x12"
    assert Image.open(io.BytesIO(data)).mode == "RGB"
    same(data)


def test_lossless_and_lossy_rates():
    """5/3 is lossless; 9/7 at PIL's default rate lies within a few steps of
    its source (and the port equals PIL on both)."""
    img = _image("RGB", 48, 64)
    data = save(img)
    same(data)
    np.testing.assert_array_equal(pil_rgb(data), np.asarray(img))
    data = save(img, irreversible=True)
    same(data)
    assert np.abs(pil_rgb(data).astype(int) - np.asarray(img)).max() <= 3


def random_pil_file(rng: np.random.Generator):
    """A random image and PIL save options (PIL's 9/7 encoder asserts on a
    line of one sample, so 9/7 is kept to tiles wide enough for its levels)."""
    h, w = int(rng.integers(1, 65)), int(rng.integers(1, 65))
    mode = str(rng.choice(MODES))
    nch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "I;16": 1, "CMYK": 4, "YCbCr": 3}[mode]
    if rng.random() < 0.5:
        y, x = np.mgrid[0:h, 0:w]
        a = np.stack([(x * rng.integers(1, 9) + y * rng.integers(1, 9) + rng.integers(0, 255))
                      % 256 for _ in range(nch)], -1)
    else:
        a = rng.integers(0, 256, (h, w, nch))
    if mode == "I;16":
        img = Image.fromarray((a[..., 0] * 257).astype(np.uint16)).convert("I;16")
    elif nch == 1:
        img = Image.fromarray(a[..., 0].astype(np.uint8), "L")
    else:
        img = Image.fromarray(a.astype(np.uint8), mode)
    kw = {"irreversible": bool(rng.random() < 0.5)}
    levels = max(1, min(int(np.log2(max(1, min(h, w)))) + 1, 6))
    if rng.random() < 0.5:
        kw["num_resolutions"] = int(rng.integers(1, levels + 1))
    if rng.random() < 0.3:
        kw["tile_size"] = (int(rng.integers(8, 40)), int(rng.integers(8, 40)))
    if rng.random() < 0.4:
        kw["quality_layers"] = sorted([float(rng.choice([1, 2, 5, 10, 20, 40, 80]))
                                       for _ in range(int(rng.integers(1, 4)))], reverse=True)
    if rng.random() < 0.3:
        cb = (int(2 ** rng.integers(2, 7)), int(2 ** rng.integers(2, 7)))
        if cb[0] * cb[1] <= 4096:
            kw["codeblock_size"] = cb
    if rng.random() < 0.3:
        kw["progression"] = str(rng.choice(["LRCP", "RLCP", "RPCL", "CPRL"]))
    if rng.random() < 0.2:
        kw["precinct_size"] = (int(2 ** rng.integers(5, 8)),) * 2
    for key, p in (("mct", 0.2), ("no_jp2", 0.3), ("plt", 0.1), ("signed", 0.1)):
        if rng.random() < p:
            kw[key] = 1 if key == "mct" else True
    if kw["irreversible"]:
        nres = kw.get("num_resolutions", 6)
        tw, th = kw.get("tile_size", (w, h))
        dims = [min(w, tw), min(h, th)] + [v % t for v, t in ((w, tw), (h, th)) if v % t]
        if min(dims) <= 2 ** max(nres - 2, 0):
            kw["irreversible"] = False
    return img, kw


@pytest.mark.parametrize("seed", range(4))
def test_seeded_fuzz_of_pil_written_files(seed):
    """60 random files a seed (240 in all): every one PIL writes and reads,
    the port reads equal (PIL's writer refuses a few option sets)."""
    rng = np.random.default_rng(1000 + seed)
    equal = 0
    for _ in range(60):
        img, kw = random_pil_file(rng)
        try:
            data = save(img, **kw)
        except (OSError, SystemError, ValueError):
            continue
        same(data)
        equal += 1
    assert equal >= 50


def test_photo_of_the_card_decodes_as_pil():
    img = Image.fromarray(_pattern(384, 512, seed=40))
    data = save(img, irreversible=True, quality_layers=[20])
    same(data)


# ---------------------------------------------------- committed inputs
def make_jpeg2000_inputs(d: str) -> None:
    """Write the JPEG 2000 files of ``test_torch_image_formats.CHIP_INPUTS``
    into ``d``."""
    import j2k_encode

    with open(os.path.join(d, "photo_97.jp2"), "wb") as f:
        f.write(save(Image.fromarray(_pattern(384, 512, seed=40)), irreversible=True,
                     quality_layers=[20]))
    with open(os.path.join(d, "tiled_rpcl_53.j2k"), "wb") as f:
        f.write(save(Image.fromarray(_pattern(120, 160, seed=41)), no_jp2=True,
                     tile_size=(64, 48), progression="RPCL", precinct_size=(32, 32),
                     num_resolutions=4))
    ycc = np.asarray(Image.fromarray(_pattern(60, 80, seed=42)).convert("YCbCr")).astype(np.int64)
    planes = [ycc[..., 0], ycc[::2, ::2, 1], ycc[::2, ::2, 2]]
    cs = j2k_encode.encode(planes, origin=(5, 4), tile=(40, 32), tile_origin=(1, 2),
                           sub=[(1, 1), (2, 2), (2, 2)], levels=2,
                           style=j2k_encode.t1.LAZY | j2k_encode.t1.VSC)
    with open(os.path.join(d, "sycc420_origin.jp2"), "wb") as f:
        f.write(j2k_encode.jp2(cs, 3, 60, 80, 7, enumcs=18))
