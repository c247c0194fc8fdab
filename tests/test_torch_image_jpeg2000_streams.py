"""The port's JPEG 2000 reader on broken streams, its opener and its ICNS
entries, against PIL 12.1 (OpenJPEG 2.5.4), on the CPU.

- Truncated files (JP2 and raw codestreams, one and several tiles, several
  layers): PIL reads a JPEG 2000 tile by tile and fails on any stream that
  ends before its EOC, as the port does; cut inside the JP2 header, both
  fail too.
- Corrupt bytes anywhere in the file: the port equals PIL where PIL reads
  (a changed byte of code-block data decodes to what OpenJPEG makes of it)
  and raises a ``ValueError`` where PIL fails (a JP2 header whose size
  disagrees with SIZ, a marker out of place, a segment longer than the
  data).
- A marker segment that ends inside a field raises the "truncated or
  corrupt JPEG2000 data" ``ValueError`` through ``image_io.decode_image``.
- The opener (``image_identify``): PIL's mode from SIZ and ``ihdr``
  (``colr`` 12 makes CMYK, ``pclr`` makes P), "Malformed JP2 header" and a
  codestream of five components passed on.
- ICNS files whose entries PIL wrote as JP2 and as raw codestreams, in L,
  RGB, RGBA and the other modes, the entry at a size the file does not
  allow, and an entry cut short.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

import j2k_encode as enc
from audioeditingcode_tpu_torch.utils import image_io as tio
from audioeditingcode_tpu_torch.utils.image_identify import PassOn
from audioeditingcode_tpu_torch.utils.image_jpeg2000 import decode_jpeg2000, header
from test_torch_image_fli_pcd_iptc_icns import icns, packed
from test_torch_image_formats import _pattern
from test_torch_image_jpeg2000 import pil_rgb, same, save


def outcome(data: bytes) -> str:
    """'equal' where both read the same, 'both fail' where both fail."""
    try:
        want = pil_rgb(data)
    except Exception:
        want = None
    try:
        got = tio.decode_image(data, "f")
    except ValueError as e:
        assert want is None, f"PIL reads it; the port raises {e}"
        return "both fail"
    assert want is not None, "the port reads a file PIL fails on"
    np.testing.assert_array_equal(got, want)
    return "equal"


SOURCES = {"jp2": {}, "j2k": {"no_jp2": True}, "9/7": {"irreversible": True},
           "tiles and layers": {"tile_size": (16, 16), "quality_layers": [20, 5]}}


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_truncated_streams_fail_as_in_pil(source):
    data = save(Image.fromarray(_pattern(40, 48)), **SOURCES[source])
    rng = np.random.default_rng(len(source))
    cuts = set(rng.integers(1, len(data), 30).tolist()) | {len(data) - 1, len(data) - 2}
    assert {outcome(data[:cut]) for cut in sorted(cuts)} == {"both fail"}


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_corrupt_bytes_read_as_pil_reads_them(source):
    data = save(Image.fromarray(_pattern(40, 48)), **SOURCES[source])
    rng = np.random.default_rng(7 + len(source))
    seen = []
    for _ in range(40):
        broken = bytearray(data)
        broken[int(rng.integers(0, len(data)))] = int(rng.integers(0, 256))
        seen.append(outcome(bytes(broken)))
    assert "equal" in seen  # and every file PIL fails on, the port fails on too


def test_jp2_size_must_agree_with_siz():
    data = bytearray(save(Image.fromarray(_pattern(40, 48)), tile_size=(16, 16)))
    i = data.index(b"ihdr") + 4
    for h, w in ((39, 48), (41, 48), (40, 47), (80, 96)):
        data[i:i + 8] = struct.pack(">II", h, w)
        assert outcome(bytes(data)) == "both fail"


def test_marker_ending_inside_a_field_raises_by_name():
    """A COC with no bytes (OpenJPEG fails on it): the decoder's IndexError
    comes out of ``decode_jpeg2000``, and so of ``decode_image`` and of an
    ICNS entry, as the truncated-data ValueError."""
    data = save(Image.fromarray(_pattern(24, 24)), no_jp2=True)
    i = data.index(b"\xff\x5c")
    broken = data[:i] + b"\xff\x53\x00\x02" + data[i:]
    with pytest.raises(Exception):
        pil_rgb(broken)
    for read in (decode_jpeg2000, tio.decode_image):
        with pytest.raises(ValueError, match="truncated or corrupt JPEG2000 data"):
            read(broken, "f")
    entry = save(Image.fromarray(_pattern(32, 32)), no_jp2=True)
    i = entry.index(b"\xff\x5c")
    with pytest.raises(ValueError, match="truncated or corrupt JPEG2000 data"):
        tio.decode_image(icns([(b"icp5", entry[:i] + b"\xff\x53\x00\x02" + entry[i:])]), "f")


def _cod_style(data: bytes, bits: int) -> bytes:
    i = data.index(b"\xff\x52") + 12  # COD's code-block style
    return data[:i] + bytes([data[i] | bits]) + data[i + 1:]


@pytest.mark.parametrize("cause", ["header", "size", "code-blocks"])
def test_errors_name_the_path_once(cause):
    """The header's, the size check's and the decoder's own ValueErrors each
    name the file once."""
    j2k = save(Image.fromarray(_pattern(20, 24)), no_jp2=True)
    data = {"header": save(Image.fromarray(_pattern(20, 24)))[:50],
            "size": j2k[:8] + struct.pack(">II", 20000, 20000) + j2k[16:],
            "code-blocks": _cod_style(j2k, 0x40)}[cause]  # HT (Part 15), refused
    with pytest.raises(ValueError) as got:
        decode_jpeg2000(data, "img.jp2")
    assert str(got.value).startswith("img.jp2: ") and str(got.value).count("img.jp2") == 1


MODES = {"L": "L", "LA": "LA", "RGB": "RGB", "RGBA": "RGBA", "I;16": "I;16", "CMYK": "CMYK"}


@pytest.mark.parametrize("codec", ["jp2", "j2k"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_opener_mode_is_pils(mode, codec):
    img = Image.fromarray(_pattern(20, 24)).convert(mode if mode != "I;16" else "L")
    if mode == "I;16":
        img = Image.fromarray(np.asarray(img).astype(np.uint16) * 257).convert("I;16")
    data = save(img, no_jp2=codec == "j2k")
    want = Image.open(io.BytesIO(data))
    head = header(data, "f")
    assert (head["mode"], head["size"]) == (want.mode, want.size)


def test_opener_passes_on_what_pil_passes_on():
    data = save(Image.fromarray(_pattern(20, 24)))
    i = data.index(b"ihdr") + 12
    five = data[:i] + struct.pack(">H", 5) + data[i + 2:]  # ihdr of five components
    with pytest.raises(PassOn, match="Malformed JP2 header"):
        header(five, "f")
    with pytest.raises(PassOn, match="unable to determine J2K image mode"):
        header(enc.encode([_pattern(8, 8)[..., 0].astype(np.int64)] * 5), "f")
    for data in (five, enc.encode([_pattern(8, 8)[..., 0].astype(np.int64)] * 6)):
        with pytest.raises(ValueError, match="cannot identify image file"):
            tio.decode_image(data, "f")


# ---------------------------------------------------------------- ICNS
def _entry(mode: str, no_jp2: bool, side: int = 32) -> bytes:
    rgba = np.concatenate([_pattern(side, side, seed=5), _pattern(side, side, seed=6)[..., :1]],
                          -1)
    img = Image.fromarray(rgba).convert(mode if mode != "I;16" else "L")
    if mode == "I;16":
        img = Image.fromarray(np.asarray(img).astype(np.uint16) * 257).convert("I;16")
    return save(img, no_jp2=no_jp2)


@pytest.mark.parametrize("codec", ["jp2", "j2k"])
@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "I;16", "CMYK"])
def test_icns_jpeg2000_entries(mode, codec):
    """PIL opens the entry's own bytes with its JPEG 2000 plugin and
    converts it to RGBA: the port reads the same pixels."""
    data = icns([(b"is32", packed(_pattern(16, 16))), (b"icp5", _entry(mode, codec == "j2k"))])
    same(data)


def test_icns_jpeg2000_entries_pil_fails_on():
    wrong = icns([(b"icp5", _entry("RGB", False, side=24))])
    cut = icns([(b"icp5", _entry("RGB", False)[:-20])])
    j2k = _entry("RGB", True)
    head = icns([(b"icp5", j2k[:5 + struct.unpack(">H", j2k[4:6])[0]])])  # a marker's 1st byte
    for data, names in ((wrong, "not one of the allowed sizes"), (cut, "truncated or corrupt"),
                        (head, "not a JPEG 2000 file PIL opens")):
        with pytest.raises(Exception):
            pil_rgb(data)
        with pytest.raises(ValueError, match=names):
            tio.decode_image(data, "f")
    same(icns([(b"icp5", _entry("RGB", False, side=16))]))  # a size the file allows


@pytest.mark.parametrize("components", [1, 2, 3, 4])
def test_unpacker_by_mode_colour_space_and_components(components):
    """PIL picks its unpacker by the mode of the JP2 header (ihdr's count),
    OpenJPEG's colour space (colr) and the codestream's components (SIZ),
    with and without subsampled components: every pairing reads as PIL
    reads it or fails where it fails."""
    rng = np.random.default_rng(components)
    for sub in ([(1, 1)] * components, [(1, 1)] + [(1, 2)] * (components - 1)):
        planes = [rng.integers(0, 256, (6 // dy, 5)) for _, dy in sub]
        cs = enc.encode(planes, sub=sub)
        for nc in (1, 2, 3, 4):
            for enumcs in (16, 17, 18, 12, 99):
                outcome(enc.jp2(cs, nc, 6, 5, 7, enumcs=enumcs))
