"""Lossy WebP with the simple loop filter, which PIL's save does not
write (``cwebp -nostrong`` does), against PIL 12.1's
``np.array(Image.open(p).convert("RGB"))`` bit for bit: files from PIL's
bundled libwebp through ``WebPEncode`` with ``filter_type`` 0 (tests/
pil_libs.py), at several filter strengths and sharpnesses, with one and
four segments, the port's decoder watched to take its simple filter.

libwebp 1.6 writes one token partition whatever ``partitions`` asks for
here (the file is the same byte for byte), so files of several partitions
stay out of reach of this test."""

import io
import os

import numpy as np
import pytest
from PIL import Image

from audioeditingcode_tpu_torch.utils import image_io as tio
from audioeditingcode_tpu_torch.utils import image_vp8
from pil_libs import webp_encode
from test_torch_image_formats import _pattern

IMG = _pattern(120, 200, noise=0.1)


def _decode(data: bytes, tmp_path, monkeypatch) -> tuple:
    """(the port's pixels, PIL's pixels, the filters the port ran)."""
    path = str(tmp_path / "f.webp")
    with open(path, "wb") as f:
        f.write(data)
    ran = []
    real = image_vp8._loop_filter

    def spy(planes, mbw, mbh, info, simple):
        ran.append("simple" if simple else "normal")
        return real(planes, mbw, mbh, info, simple)

    monkeypatch.setattr(image_vp8, "_loop_filter", spy)
    return tio.read_image(path), np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), ran


@pytest.mark.parametrize("sharpness", [0, 3, 7])
@pytest.mark.parametrize("strength", [30, 60, 100])
def test_simple_filter_matches_pil(tmp_path, monkeypatch, strength, sharpness):
    for segments in (1, 4):
        data = webp_encode(IMG, 80, filter_type=0, filter_strength=strength,
                           filter_sharpness=sharpness, segments=segments)
        got, want, ran = _decode(data, tmp_path, monkeypatch)
        assert ran == ["simple"]
        np.testing.assert_array_equal(got, want)
        assert np.abs(want.astype(int) - IMG).mean() < 12  # the picture, not noise


def test_strong_filter_and_partitions(tmp_path, monkeypatch):
    """The same encoder with ``filter_type`` 1 takes the normal filter;
    ``partitions`` 3 gives the file of ``partitions`` 0."""
    got, want, ran = _decode(webp_encode(IMG, 60, filter_type=1, filter_strength=60),
                             tmp_path, monkeypatch)
    assert ran == ["normal"]
    np.testing.assert_array_equal(got, want)
    assert (webp_encode(IMG, 80, filter_type=0, partitions=3)
            == webp_encode(IMG, 80, filter_type=0, partitions=0))


# ------------------------------------------------------ the card's input
def make_webp_filter_inputs(d: str) -> None:
    with open(os.path.join(d, "photo_simple_filter.webp"), "wb") as f:
        f.write(webp_encode(_pattern(192, 256, noise=0.05, seed=60), 80, filter_type=0,
                            filter_strength=60))
