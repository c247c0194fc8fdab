"""The port's PSD reader (utils/image_psd.py) against PIL 12.1's
``np.array(Image.open(p).convert("RGB"))``, bit for bit, on the CPU.

PIL writes no PSD, so ``psd`` below writes one from the format's layout:
the header, colour mode data, image resources, a layer and mask section,
and the composite image raw or in PackBits with its per-row byte counts.

- Every colour mode PIL opens: bitmap, greyscale, indexed (with a 768-byte
  palette and without one: PIL's palette of zeros), RGB (3 channels, and 4:
  RGBA with alpha dropped), CMYK (stored inverted), multichannel, duotone
  and Lab (a* and b* offset by 128, converted by LittleCMS's transform), raw
  and PackBits, with resources and a layer section skipped.
- Extra channels: PIL reads only the mode's channels; in PackBits it reads
  the byte counts of those channels only, so the rest of the count table
  is taken as image data. The port reproduces that reading (asserted
  against PIL's pixels).
- Refused: fewer channels than the mode (PIL fails), compression 2 (PIL
  has no tile and fails), 16-bit (PIL passes the file on; nothing else
  takes it), a composite that ends early.
- 300 random PSDs: equal to PIL where both read, both fail otherwise.
"""

import struct

import numpy as np
import pytest

from audioeditingcode_tpu_torch.utils import image_io as tio
from test_torch_image_formats import _pattern
from test_torch_image_raster import both_fail, check, put, same_or_both_fail

MODES = {"bitmap": (0, 1, 1), "grey": (1, 8, 1), "indexed": (2, 8, 1), "rgb": (3, 8, 3),
         "rgba": (3, 8, 4), "cmyk": (4, 8, 4), "multichannel": (7, 8, 1), "duotone": (8, 8, 1),
         "lab": (9, 8, 3)}


def packbits(row: bytes) -> bytes:
    """PackBits: runs of 3 or more as (257 - n, byte), else literals."""
    out, i, n = bytearray(), 0, len(row)
    while i < n:
        j = i
        while j < n and j - i < 128 and row[j] == row[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), row[i]])
            i = j
            continue
        k = i
        while k < n and k - i < 128 and not (k + 2 < n and row[k] == row[k + 1] == row[k + 2]):
            k += 1
        k = max(k, i + 1)
        out += bytes([k - i - 1]) + row[i:k]
        i = k
    return bytes(out)


def resource(rid: int, name: bytes, payload: bytes) -> bytes:
    """One image resource block, its name and data padded to even."""
    nm = bytes([len(name)]) + name
    nm += b"\0" * (len(nm) % 2)
    return (b"8BIM" + struct.pack(">H", rid) + nm + struct.pack(">I", len(payload)) + payload
            + b"\0" * (len(payload) % 2))


def psd(planes: np.ndarray, mode: int, bits: int = 8, compression: int = 1, width=None,
        channels=None, mode_data=b"", resources=b"", layers=b"") -> bytes:
    """A PSD whose composite is ``planes`` ((c, h, row bytes) uint8; for
    bitmap, rows of packed bits and ``width`` given)."""
    c, h, line = planes.shape
    width = line if width is None else width
    head = (b"8BPS" + struct.pack(">H", 1) + bytes(6)
            + struct.pack(">HIIHH", c if channels is None else channels, h, width, bits, mode))
    out = (head + struct.pack(">I", len(mode_data)) + mode_data
           + struct.pack(">I", len(resources)) + resources
           + struct.pack(">I", len(layers)) + layers + struct.pack(">H", compression))
    if compression != 1:
        return out + planes.tobytes()
    rows = [packbits(planes[k, y].tobytes()) for k in range(c) for y in range(h)]
    return out + struct.pack(f">{len(rows)}H", *map(len, rows)) + b"".join(rows)


def photo_planes(mode_name: str, h: int, w: int, seed: int = 0) -> np.ndarray:
    """Photo-like planes for a mode: the pattern in RGB, grey or CMYK,
    indices, packed bits or Lab's offset bytes."""
    img = _pattern(h, w, noise=0.05, seed=seed)
    rng = np.random.default_rng(seed)
    grey = img.mean(-1).astype(np.uint8)
    if mode_name == "bitmap":
        return np.packbits(grey > 127, axis=1)[None]
    if mode_name in ("grey", "multichannel", "duotone", "indexed"):
        return grey[None]
    if mode_name == "cmyk":
        return np.concatenate([255 - img, rng.integers(0, 60, (h, w, 1))], -1).astype(
            np.uint8).transpose(2, 0, 1)
    if mode_name == "rgba":
        return np.concatenate([img, rng.integers(0, 256, (h, w, 1))], -1).astype(
            np.uint8).transpose(2, 0, 1)
    return np.ascontiguousarray(img.transpose(2, 0, 1))


@pytest.mark.parametrize("compression", [0, 1], ids=["raw", "packbits"])
@pytest.mark.parametrize("name", sorted(MODES))
def test_psd_modes(tmp_path, name, compression):
    mode, bits, _ = MODES[name]
    rng = np.random.default_rng(1)
    path = str(tmp_path / "a.psd")
    checked = 0
    for h, w in ((1, 1), (13, 21)):
        planes = photo_planes(name, h, w)
        mode_data = (rng.integers(0, 256, 768).astype(np.uint8).tobytes()
                     if name == "indexed" else b"")
        data = psd(planes, mode, bits, compression, width=w, mode_data=mode_data)
        checked += check(put(path, data), "PSD")
    if name == "indexed":  # no palette: PIL's palette of zeros
        checked += check(put(path, psd(planes, mode, bits, compression, width=w)), "PSD")
    assert checked == (3 if name == "indexed" else 2)


def test_psd_resources_and_layers_are_skipped(tmp_path):
    """Image resources with names of odd and even length and data of odd
    length, a layer and mask section, and colour mode data on an RGB file."""
    path = str(tmp_path / "b.psd")
    planes = photo_planes("rgb", 9, 14, seed=2)
    res = resource(1005, b"", bytes(16)) + resource(1039, b"icc", b"x" * 7) + resource(
        1061, b"ab", b"")
    checked = 0
    for compression in (0, 1):
        checked += check(put(path, psd(planes, 3, 8, compression, resources=res,
                                       layers=bytes(4) + b"layers" * 5, mode_data=b"dd")), "PSD")
    assert checked == 2


@pytest.mark.parametrize("compression", [0, 1], ids=["raw", "packbits"])
def test_psd_extra_channels_read_as_pil_reads_them(tmp_path, compression):
    """RGB with 4 or 5 channels, grey with 2 or 4, CMYK with 5: PIL reads
    the mode's channels (RGB with exactly 4 as RGBA); in PackBits its
    byte-count table holds only theirs, so the counts of the others are
    taken as image data: PIL's misread, which the port reproduces where PIL
    reads the file (asserted) and where PIL then runs out of data (both
    fail)."""
    path = str(tmp_path / "c.psd")
    outcome = {"equal": 0, "both fail": 0}
    for name, extra in (("rgb", 2), ("grey", 1), ("cmyk", 1), ("rgb", 1), ("grey", 3)):
        planes = photo_planes(name, 8, 12, seed=3)
        planes = np.concatenate([planes, np.full((extra, 8, 12), 200, np.uint8)])
        outcome[same_or_both_fail(put(path, psd(planes, MODES[name][0], 8, compression)))] += 1
    assert outcome == ({"equal": 5, "both fail": 0} if compression == 0 else
                       {"equal": 3, "both fail": 2}), outcome


def test_psd_refused_as_pil_fails(tmp_path):
    path = str(tmp_path / "d.psd")
    rgb = photo_planes("rgb", 6, 8, seed=4)
    failed = both_fail(put(path, psd(rgb[:2], 3, 8, 1)), r"not enough channels")
    failed += both_fail(put(path, psd(rgb, 3, 8, 2)), r"PSD compression 2")
    failed += both_fail(put(path, psd(rgb.astype(">u2").view(np.uint8), 3, 16, 0, width=8)),
                        r"cannot identify")
    failed += both_fail(put(path, psd(rgb, 3, 8, 0)[:-20]), r"truncated PSD data")
    failed += both_fail(put(path, psd(rgb, 3, 8, 1)[:-20]), r"truncated PSD PackBits data")
    assert failed == 5


def test_random_psds_match_pil(tmp_path):
    """300 PSDs over modes, depths, channel counts, compressions, resources
    and layer sections, some cut short: equal where both read, both fail
    otherwise."""
    rng = np.random.default_rng(5)
    path = str(tmp_path / "r.psd")
    outcome = {"equal": 0, "both fail": 0}
    for _ in range(300):
        mode = int(rng.choice([0, 1, 2, 3, 4, 7, 8, 9]))
        bits = 1 if mode == 0 and rng.random() < 0.7 else int(rng.choice([8, 8, 8, 16]))
        need = {0: 1, 1: 1, 2: 1, 3: 3, 4: 4, 7: 1, 8: 1, 9: 3}[mode]
        c = need + int(rng.choice([0, 0, 0, 1, 2]))
        w, h = (int(v) for v in rng.integers(1, 14, 2))
        line = (w + 7) // 8 if bits == 1 else w
        planes = rng.integers(0, 256, (c, h, line)).astype(np.uint8)
        if rng.random() < 0.5:
            planes = planes // 64 * 64
        mode_data = (rng.integers(0, 256, 768).astype(np.uint8).tobytes()
                     if mode == 2 and rng.random() < 0.8 else b"")
        res = b"".join(resource(int(rng.integers(1000, 1100)), b"ab"[:int(rng.integers(0, 3))],
                                bytes(int(rng.integers(0, 9))))
                       for _ in range(int(rng.integers(0, 3))))
        data = psd(planes, mode, bits, int(rng.choice([0, 1, 1, 2])), width=w,
                   channels=c if rng.random() > 0.05 else need - 1, mode_data=mode_data,
                   resources=res, layers=bytes(int(rng.choice([0, 0, 12]))))
        if rng.random() < 0.15:
            data = data[:int(rng.integers(0, len(data)))]
        outcome[same_or_both_fail(put(path, data))] += 1
    assert outcome["equal"] > 100 and outcome["both fail"] > 50, outcome


def test_read_image_names_psd(tmp_path):
    path = put(str(tmp_path / "e.psd"), psd(photo_planes("lab", 4, 5), 9, 8, 1))
    assert tio.format_name(path) == "PSD"
