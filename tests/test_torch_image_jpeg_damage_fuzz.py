"""A seeded fuzz of damaged JPEG data against PIL 12.1: one byte after the
first SOS marker (inside a strip or tile for JPEG-in-TIFF) XOR-ed, set or
deleted, at places drawn with numpy's ``default_rng``. Every draw must give
the port's pixels equal to PIL's, or raise in both, or raise a ValueError
naming a case ROADMAP item 19 lists (``NAMED``); no draw may give pixels
that differ without raising. Sources: PIL-saved 160 x 120 photos of each
process it writes (baseline 4:2:0 and 4:4:4, greyscale, a restart marker
every MCU row or every 3 MCUs, progressive, progressive with restarts,
progressive greyscale, CMYK) and the committed JPEGs and JPEG-in-TIFFs."""

import io
import os

import numpy as np
import pytest
from PIL import Image

from test_torch_image_formats import DATA, _pattern
from test_torch_image_jpeg_damage import outcome

SAVED = {"baseline_420": {}, "baseline_444": dict(subsampling=0), "grey": {},
         "restart_rows": dict(restart_marker_rows=1),
         "restart_blocks": dict(restart_marker_blocks=3),
         "progressive": dict(progressive=True),
         "progressive_restart": dict(progressive=True, restart_marker_rows=1),
         "progressive_grey": dict(progressive=True), "cmyk": {}}
COMMITTED = ["photo_420_restart.jpg", "photo_progressive_422.jpg", "cmyk_progressive.jpg",
             "lossless_pred6.jpg", "arith_progressive.jpg", "photo_jpeg_ycbcr.tif",
             "planar_jpeg_rgba.tif", "old_jpeg_strips_420.tif", "jpeg12_grey_strips.tif"]
OPS = ("xor", "set", "delete")
DRAWS = 12


def _source(name: str) -> bytes:
    if name in COMMITTED:
        with open(os.path.join(DATA, name), "rb") as f:
            return f.read()
    img = _pattern(120, 160, noise=0.1, seed=5)
    if "grey" in name:
        img = img[:, :, 0]
    im = Image.fromarray(img)
    if name == "cmyk":
        im = im.convert("CMYK")
    buf = io.BytesIO()
    im.save(buf, "JPEG", quality=85, **SAVED[name])
    return buf.getvalue()


def _region(data: bytes):
    """[start, end) of the bytes the fuzz damages."""
    if data.startswith(b"\xff\xd8"):
        return data.index(b"\xff\xda"), len(data)
    tags = Image.open(io.BytesIO(data)).tag_v2
    offsets = tags.get(273) or tags[324]
    counts = tags.get(279) or tags[325]
    return min(offsets), max(o + c for o, c in zip(offsets, counts))


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("name", list(SAVED) + COMMITTED)
def test_damage_reads_as_pil_reads(name, op):
    data = _source(name)
    start, end = _region(data)
    rng = np.random.default_rng([len(name), OPS.index(op), sum(name.encode())])
    seen = []
    for _ in range(DRAWS):
        pos = int(rng.integers(start, end))
        if op == "xor":
            damaged = data[:pos] + bytes([data[pos] ^ int(rng.integers(1, 256))]) + data[pos + 1:]
        elif op == "set":
            damaged = data[:pos] + bytes([int(rng.integers(0, 256))]) + data[pos + 1:]
        else:
            damaged = data[:pos] + data[pos + 1:]
        seen.append(outcome(damaged))
    assert seen.count("named refusal") <= DRAWS // 4, seen
