"""The first frame of an animated WebP (utils/image_webp.py) against PIL
12.1's ``np.array(Image.open(p).convert("RGB"))``, bit for bit, on the CPU.

- Files PIL writes (``save_all=True``): lossy, lossy with alpha, lossless,
  mixed; PIL's writer makes the first frame cover the canvas.
- Files built here: a VP8X canvas with the animation flag, an ANIM chunk
  with a background colour (which libwebp's animation decoder ignores),
  and a first ANMF frame smaller than the canvas, at an offset, holding
  PIL's own VP8 (with or without ALPH) or VP8L stream; frames that run past
  the canvas and truncated files raise where PIL fails.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from audioeditingcode_tpu_torch.utils import image_webp
from test_torch_image_codecs import _both_raise, _check, _riff
from test_torch_image_formats import _pattern


@pytest.mark.parametrize("kind", ["lossy", "lossy_alpha", "lossless", "lossless_alpha"])
def test_animated_webp_from_pil(tmp_path, kind):
    img = _pattern(45, 67, noise=0.2)
    if kind.endswith("alpha"):
        a = np.clip(np.add.outer(np.arange(45) * 6, np.arange(67) * 4), 0, 255).astype(np.uint8)
        a[:6, :9] = 0
        img = np.concatenate([img, a[:, :, None]], -1)
    frames = [Image.fromarray(img), Image.fromarray(img[::-1].copy())]
    path = str(tmp_path / "a.webp")
    frames[0].save(path, save_all=True, append_images=frames[1:], duration=100, loop=0,
                   lossless=kind.startswith("lossless"), quality=70)
    assert b"ANMF" in open(path, "rb").read()
    _check(path)
    np.testing.assert_array_equal(image_webp.read_webp_rgba(path),
                                  np.asarray(Image.open(path).convert("RGBA")))


def _still_chunks(img, **kw):
    """The chunks of a still WebP PIL writes, without RIFF or VP8X."""
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="WEBP", **kw)
    data, out, pos = buf.getvalue(), [], 12
    while pos + 8 <= len(data):
        tag, n = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        if tag != b"VP8X":
            out.append((tag, data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def _chunk(tag, body):
    return tag + struct.pack("<I", len(body)) + body + bytes(len(body) % 2)


def animated(canvas, frames, flags=0x02 | 0x10, background=(255, 0, 255, 255)):
    """A VP8X + ANIM + ANMF file: ``frames`` as (x, y, chunks) with x and y
    even, each frame's size from its image."""
    cw, ch = canvas
    vp8x = bytes([flags, 0, 0, 0]) + (cw - 1).to_bytes(3, "little") + (ch - 1).to_bytes(
        3, "little")
    anim = bytes(background[2::-1]) + bytes([background[3]]) + struct.pack("<H", 0)
    parts = [(b"VP8X", vp8x), (b"ANIM", anim)]
    for x, y, (fw, fh), chunks in frames:
        head = ((x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little")
                + (fw - 1).to_bytes(3, "little") + (fh - 1).to_bytes(3, "little")
                + (100).to_bytes(3, "little") + bytes([0x02]))
        parts.append((b"ANMF", head + b"".join(_chunk(t, b) for t, b in chunks)))
    return _riff(*parts)


FRAME_CASES = {"lossy": ({"quality": 60}, False), "lossy_alpha": ({"quality": 60}, True),
               "lossless": ({"lossless": True}, False),
               "lossless_alpha": ({"lossless": True}, True)}


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_first_frame_smaller_and_offset(tmp_path, case):
    """Frames smaller than the canvas at offsets (0, 0), (6, 4) and touching
    the far corner, with and without the VP8X alpha flag, a second frame
    after them; each read as PIL reads it."""
    kw, alpha = FRAME_CASES[case]
    rng = np.random.default_rng(len(case))
    img = _pattern(21, 33, noise=0.3, seed=len(case))
    if alpha:
        img = np.concatenate([img, rng.integers(0, 256, (21, 33, 1)).astype(np.uint8)], -1)
    chunks = _still_chunks(img, **kw)
    second = _still_chunks(_pattern(40, 60, seed=9), quality=50)
    path = str(tmp_path / "f.webp")
    checked = 0
    for x, y in ((0, 0), (6, 4), (60 - 34, 40 - 22)):
        for flags in (0x02 | 0x10, 0x02):
            with open(path, "wb") as f:
                f.write(animated((60, 40), [(x, y, (33, 21), chunks),
                                            (0, 0, (60, 40), second)], flags))
            _check(path)
            checked += 1
    assert checked == 6


def test_frames_past_the_canvas_and_truncated_raise(tmp_path):
    img = _pattern(21, 33, noise=0.3)
    chunks = _still_chunks(img, quality=60)
    path = str(tmp_path / "p.webp")
    with open(path, "wb") as f:
        f.write(animated((40, 30), [(10, 12, (33, 21), chunks)]))
    _both_raise(path)
    frames = [Image.fromarray(img), Image.fromarray(img[::-1].copy())]
    frames[0].save(path, save_all=True, append_images=frames[1:], duration=100)
    data = open(path, "rb").read()
    for n in (40, len(data) // 4):
        open(tmp_path / "t.webp", "wb").write(data[:n])
        _both_raise(str(tmp_path / "t.webp"))
