"""Damaged JPEG entropy-coded data in the port's JPEG path
(utils/image_jpeg_stream.py, image_io.py, image_jpeg_arith.py,
image_jpeg_lossless.py) against PIL 12.1's
``np.array(Image.open(p).convert("RGB"))``, bit for bit, on the CPU.

PIL's decoder goes on past libjpeg-turbo 3.1's warnings, so a JPEG whose
data is damaged still loads in the JAX package, and must load the same in
the port, or raise where PIL raises:

- restart markers read by number (``read_restart_marker`` and
  ``jpeg_resync_to_restart``): RST3 of ``photo_420_restart.jpg`` renumbered
  to each other RSTn, a non-restart marker, a byte below SOF0 and EOI where
  it is due, a restart marker deleted, bytes put in before one;
- data that runs out: a file cut and closed with EOI reads (the MCU that
  runs out from zero bits, the rest of its interval grey); cut with no EOI
  it raises in both; one whose data runs to the end of the file reads or
  raises as the fills of libjpeg's bit reader fall; FF FF 00 in data
  without restart markers, which libjpeg's fast reader takes for a marker;
- a bad DC and a bad AC Huffman code (17 bits, the value 0), a run past
  coefficient 63 and a run past a progressive band's Se, built by hand;
- damage in each progressive scan kind, in an arithmetic-coded stream and
  in a lossless one (the encoders of test_torch_image_jpeg_processes.py),
  and in a JPEG-in-TIFF strip;
- the JAX package's ``load_image`` and the port's on the damaged inputs.

``make_damage_inputs`` writes the damaged inputs chip_smoke.py phase 10
decodes (test_torch_image_formats.py's ``CHIP_INPUTS``).

The seeded fuzz over many files is test_torch_image_jpeg_damage_fuzz.py.
"""

import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

from audioeditingcode_tpu.utils import image_io as jio
from audioeditingcode_tpu_torch.utils import image_io as tio
from audioeditingcode_tpu_torch.utils.image_jpeg_stream import STD_HUFFMAN
from test_torch_image_formats import CHIP_INPUTS, DATA, _pattern
from test_torch_image_jpeg_processes import BitWriter, _segment, arith_jpeg, lossless_jpeg

RESTART = os.path.join(DATA, "photo_420_restart.jpg")
# the damaged inputs of the card
DAMAGED = [n for n in CHIP_INPUTS
           if n.endswith(("_rst4.jpg", "_no_rst.jpg", "_hit.jpg", "_hit.tif"))]
RST3 = 13686  # the code byte of the fourth restart marker (RST3) of RESTART
# the refusal ROADMAP item 19 lists: where the port raises and PIL may read
NAMED = ("resynchronisation",)


def pil_bytes(data: bytes):
    """PIL's decode of ``data``, or the exception it raises."""
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception as e:  # noqa: BLE001  PIL raises OSError, SyntaxError, ...
        return e


def outcome(data: bytes) -> str:
    """"equal" (bit-equal pixels), "both raise" or "named refusal"; fails
    otherwise."""
    want = pil_bytes(data)
    try:
        got = tio.decode_image(data, "damaged")
    except ValueError as e:
        if isinstance(want, Exception):
            return "both raise"
        assert any(n in str(e) for n in NAMED), f"the port raises {e}, PIL reads it"
        return "named refusal"
    assert not isinstance(want, Exception), f"PIL raises {want!r}, the port reads it"
    assert got.shape == want.shape and (got == want).all(), (
        f"{int((got != want).any(axis=2).sum())} pixels differ")
    return "equal"


def _restart_file() -> bytes:
    with open(RESTART, "rb") as f:
        return f.read()


def with_marker(code: int) -> bytes:
    """``photo_420_restart.jpg`` with RST3's code byte replaced by ``code``."""
    data = bytearray(_restart_file())
    assert data[RST3 - 1:RST3 + 1] == b"\xff\xd3"
    data[RST3] = code
    return bytes(data)


# ------------------------------------------------------- restart markers
@pytest.mark.parametrize("n", [4, 5, 1, 2, 6])
def test_misnumbered_restart_marker_matches_pil(n):
    """RST3 renumbered: one or two ahead (RST4, RST5) is left in place and
    the interval after it left grey; one or two behind (RST1, RST2) is
    passed over to the next marker; RST6 is taken as RST3. Splitting the scan
    at any marker, as the port once did, gave 17403, 25597, 9214 and 9214
    pixels that differ, silently; RST6 changes nothing."""
    data = with_marker(0xD0 + n)
    assert outcome(data) == "equal"
    clean = pil_bytes(_restart_file())
    changed = int((pil_bytes(data) != clean).any(axis=2).sum())
    assert changed == {4: 17403, 5: 25597, 1: 9214, 2: 9214, 6: 0}[n]


@pytest.mark.parametrize("code", [0xD7, 0xC4, 0xE1, 0xD9, 0xD8, 0x12, 0xC0])
def test_other_markers_where_a_restart_is_due(code):
    """RST7 (three ahead: taken), DHT, APP1, EOI, SOI and SOF0 (left in
    place: the intervals after it grey, then what libjpeg makes of the
    marker after the scan) and a byte below SOF0 (passed over)."""
    assert outcome(with_marker(code)) in ("equal", "both raise")


def test_deleted_restart_marker_and_bytes_before_one():
    """A restart marker deleted: the interval before it reads on into the
    next one's data, which then fails to be where it is due. Bytes put in
    before a marker are skipped (``next_marker``)."""
    data = _restart_file()
    assert outcome(data[:RST3 - 1] + data[RST3 + 1:]) == "equal"
    for junk in (b"\x12", b"\x12\x34\xff\x00\x56", b"\xff\x00" * 3):
        assert outcome(data[:RST3 - 1] + junk + data[RST3 - 1:]) == "equal"


@pytest.mark.parametrize("name", ["photo_420_restart.jpg", "photo_progressive_422.jpg",
                                  "lossless_pred6.jpg"])
def test_cut_files(name):
    """Cut at 60 % and closed with EOI: read (sequential: the interval that
    runs out grey; progressive: the scans it has); cut with no EOI: PIL
    raises "image file is truncated", and so does the port."""
    with open(os.path.join(DATA, name), "rb") as f:
        data = f.read()
    cut = data[:int(len(data) * 0.6)]
    assert outcome(cut + b"\xff\xd9") == "equal"
    assert outcome(cut) == "both raise"


@pytest.mark.parametrize("name", ["baseline", "restart", "lossless_pred6.jpg"])
def test_data_that_runs_to_the_end_of_the_file(name):
    """EOI lost, FF or bytes after the data, the last bytes cut: PIL reads
    such a one-scan file only where no fill of libjpeg's bit reader needs
    a byte past the end (each fill loads until 57 bits are left), and
    raises "image file is truncated" where one does; so does the port
    (``image_jpeg_exact``), and both outcomes occur."""
    if name.endswith(".jpg"):
        with open(os.path.join(DATA, name), "rb") as f:
            data = f.read()
    else:
        buf = io.BytesIO()
        Image.fromarray(_pattern(120, 160, noise=0.1, seed=5)).save(
            buf, "JPEG", quality=85, restart_marker_rows=int(name == "restart"))
        data = buf.getvalue()
    body = data[:-2]
    seen = {outcome(body + tail) for tail in (b"", b"\xff", b"\xfe\xd9", b"\xff\xd0")}
    seen |= {outcome(body[:-k]) for k in (1, 3)}
    seen |= {outcome(body + bytes(range(1, k + 1))) for k in range(1, 12)}
    assert seen == {"equal", "both raise"}


@pytest.mark.parametrize("size", ["small", "past_64k"])
def test_ff_ff_00_in_data_without_restarts(size):
    """FF FF 00 in sequential data without restart markers: one FF byte to
    libjpeg's slow reader, a marker to its fast one, which runs where 512
    bytes a block are left in what PIL has handed over (64 KiB at a time)
    and gives the MCU up to the slow one, which decodes it over what the
    fast one wrote. An FF put before FF 00 near the start, the end and the
    64 KiB edges of the file."""
    shape, kw = {"small": ((120, 160), dict(quality=85, subsampling=0)),
                 "past_64k": ((300, 400), dict(quality=95))}[size]
    buf = io.BytesIO()
    Image.fromarray(_pattern(*shape, noise=0.3, seed=3)).save(buf, "JPEG", **kw)
    data = buf.getvalue()
    start = data.index(b"\xff\xda") + 20
    stuffed = [i for i in range(start, len(data) - 1) if data[i:i + 2] == b"\xff\x00"]
    places = stuffed[:2] + stuffed[-2:] + [min(stuffed, key=lambda i: abs(i - edge))
                                           for edge in range(65536, len(data), 65536)]
    changed = 0
    for i in places:
        damaged = data[:i - 1] + b"\xff" + data[i:]
        assert outcome(damaged) == "equal"
        changed += int((pil_bytes(damaged) != pil_bytes(data[:i - 1] + b"\x00" + data[i:])).any())
    assert changed


# ---------------------------------------------- codes built by hand
def _codes(counts: bytes, symbols: bytes) -> dict:
    """symbol -> (code, length) of a DHT table."""
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out[symbols[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return out


DC, AC = _codes(*STD_HUFFMAN[(0, 0)]), _codes(*STD_HUFFMAN[(1, 0)])


def _tables() -> bytes:
    return b"".join(_segment(0xC4, bytes([cls << 4]) + counts + symbols)
                    for cls, (counts, symbols) in ((0, STD_HUFFMAN[(0, 0)]),
                                                   (1, STD_HUFFMAN[(1, 0)])))


def grey_jpeg(scans, sof=0xC0, size=(16, 16)) -> bytes:
    """A greyscale JPEG of ``size`` with every quantizer 4, the K.3
    luminance tables and ``scans``: (Ss, Se, Ah, Al, bits) each, the bits a
    list of (value, length) written as they are."""
    h, w = size
    out = (b"\xff\xd8" + _segment(0xDB, b"\x00" + bytes([4] * 64)) + _tables()
           + _segment(sof, struct.pack(">BHHB", 8, h, w, 1) + b"\x01\x11\x00"))
    for ss, se, ah, al, bits in scans:
        writer = BitWriter()
        for value, length in bits:
            writer.put(value, length)
        out += _segment(0xDA, bytes([1, 1, 0, ss, se, (ah << 4) | al])) + writer.flush()
    return out + b"\xff\xd9"


def _block(dc_cat=2, dc_bits=3, acs=()):
    """One sequential block: a DC difference, then AC symbols with a one-bit
    value each, then EOB."""
    bits = [DC[dc_cat], (dc_bits, dc_cat)] if dc_cat else [DC[0]]
    for sym in acs:
        bits += [AC[sym], (1, sym & 15)]
    return bits + [AC[0x00]]


@pytest.mark.parametrize("case", ["bad_dc", "bad_ac", "past_63", "past_63_zrl"])
def test_bad_codes_and_runs_past_the_block(case):
    """A DC code no table entry starts (17 one bits), an AC one, a run
    from coefficient 50 over 63 (written to 63: libjpeg's natural-order
    table has 16 guard entries of 63), and ZRLs that reach 64."""
    good = _block(acs=(0x01, 0x21))
    bad = {"bad_dc": [((1 << 17) - 1, 17)] + _block(acs=(0x01,)),
           "bad_ac": [DC[0], ((1 << 17) - 1, 17), (0, 3)],
           "past_63": [DC[0]] + [AC[0xF0]] * 3 + [AC[0x11], (1, 1), AC[0xE1], (1, 1)],
           "past_63_zrl": [DC[0]] + [AC[0xF0]] * 4}[case]
    data = grey_jpeg([(0, 63, 0, 0, good + bad + good + good)])
    assert outcome(data) == "equal"


def test_runs_past_the_band_in_progressive_scans():
    """A progressive AC first scan of band 1-5 whose run ends at 8 (libjpeg
    writes the coefficient it reaches, outside the band), and a refinement
    of band 1-5 whose new coefficient falls past 5."""
    dc = [(0, 0, 0, 0, [DC[2], (3, 2)] * 4)]
    first = [(1, 5, 0, 1, [AC[0x71], (1, 1), AC[0x01], (0, 1), AC[0x00]] * 4)]
    refine = [(1, 5, 1, 0, [AC[0x51], (1, 1), (1, 1), AC[0x00]] * 4)]
    assert outcome(grey_jpeg(dc + first, sof=0xC2)) == "equal"
    assert outcome(grey_jpeg(dc + first + refine, sof=0xC2)) == "equal"


# ---------------------------------------------------------- scan kinds
def _scan_spans(data: bytes):
    """(start, end, Ss, Ah) of each scan's entropy-coded data."""
    spans, pos = [], 2
    while data[pos + 1] != 0xD9:
        marker, (length,) = data[pos + 1], struct.unpack(">H", data[pos + 2:pos + 4])
        pos += 2 + length
        if marker == 0xDA:
            n = data[pos - length + 2]
            ss, ah = data[pos - 3], data[pos - 1] >> 4
            end = pos
            while not (data[end] == 0xFF and data[end + 1] not in (0, *range(0xD0, 0xD8))):
                end += 1
            spans.append((pos, end, ss, ah, n))
            pos = end
    return spans


@pytest.mark.parametrize("kind", ["dc_first", "dc_refine", "ac_first", "ac_refine"])
def test_damage_in_each_progressive_scan_kind(kind):
    """A byte XOR-ed at eight seeded places of one scan of each kind of a
    progressive 4:2:0 photo with a restart marker every MCU row."""
    buf = io.BytesIO()
    Image.fromarray(_pattern(96, 128, noise=0.1, seed=7)).save(
        buf, "JPEG", quality=85, progressive=True, restart_marker_rows=1)
    data = buf.getvalue()
    spans = [s for s in _scan_spans(data)
             if (s[2] > 0, s[3] > 0) == {"dc_first": (False, False), "dc_refine": (False, True),
                                          "ac_first": (True, False),
                                          "ac_refine": (True, True)}[kind]]
    assert spans
    rng = np.random.default_rng(list(("dc_first", "dc_refine", "ac_first",
                                      "ac_refine")).index(kind))
    seen = set()
    for _ in range(8):
        start, end = spans[int(rng.integers(len(spans)))][:2]
        pos = int(rng.integers(start, end))
        damaged = data[:pos] + bytes([data[pos] ^ int(rng.integers(1, 256))]) + data[pos + 1:]
        seen.add(outcome(damaged))
    assert "equal" in seen


@pytest.mark.parametrize("case", ["seq_restart", "prog", "prog_restart"])
def test_damaged_arithmetic_streams(case):
    """Arithmetic-coded scans: a bad magnitude or a run past the block or
    band stops the interval (``ct = -1``), markers as above."""
    kw = {"seq_restart": dict(restart=3), "prog": dict(progressive=True),
          "prog_restart": dict(progressive=True, restart=5)}[case]
    data = arith_jpeg(_pattern(48, 64, noise=0.1, seed=8), sampling=((2, 2), (1, 1), (1, 1)),
                      quality=85, **kw)
    rng = np.random.default_rng(11)
    start = data.index(b"\xff\xda")
    seen = set()
    for _ in range(10):
        pos = int(rng.integers(start, len(data) - 2))
        damaged = data[:pos] + bytes([data[pos] ^ int(rng.integers(1, 256))]) + data[pos + 1:]
        seen.add(outcome(damaged))
    assert "equal" in seen


def test_arithmetic_scan_past_64_kib():
    """PIL hands libjpeg 64 KiB at a time, and libjpeg's arithmetic decoder
    cannot wait for more: a scan within the first 64 KiB reads, one that
    runs past them fails in both (JERR_CANT_SUSPEND)."""
    img = _pattern(256, 320, noise=0.25, seed=2)
    small, big = arith_jpeg(img, quality=80), arith_jpeg(img, quality=85)
    assert len(small) < 65536 < len(big)
    assert outcome(small) == "equal"
    assert outcome(big) == "both raise"


@pytest.mark.parametrize("interleaved", [True, False])
def test_damaged_lossless_streams(interleaved):
    """Lossless scans with a restart every two rows: a bad code is the
    difference 0; the row that runs out is decoded from zero bits, the
    rows after it up to the next marker restart the prediction."""
    img = _pattern(40, 48, noise=0.1, seed=9)
    data = lossless_jpeg([img[:, :, c] for c in range(3)], [(1, 1)] * 3, 6, restart_rows=2,
                         interleaved=interleaved)
    rng = np.random.default_rng(12)
    start = data.index(b"\xff\xda")
    seen = set()
    for _ in range(10):
        pos = int(rng.integers(start, len(data) - 2))
        damaged = data[:pos] + bytes([data[pos] ^ int(rng.integers(1, 256))]) + data[pos + 1:]
        seen.add(outcome(damaged))
    assert "equal" in seen


@pytest.mark.parametrize("sampling", [(1, 2), (2, 2)])
def test_lossless_restart_inside_an_imcu_row(sampling):
    """A scan of one component sampled v = 2 with a restart every 1 or 3
    rows: libjpeg undifferences an iMCU row (two rows) after decoding both,
    so a restart at its second row restarts the prediction at its first.
    The port restarted it at the row itself (1 x 2 sampling: 952 and 1219
    of 1920 pixels off PIL at 1 and 3 rows, silently). Then the same files
    damaged."""
    img = _pattern(40, 48, noise=0.1, seed=9)
    rng = np.random.default_rng(13)
    for rows in (1, 3):
        data = lossless_jpeg([img[:, :, c] for c in range(3)],
                             [sampling, (1, 1), (1, 1)], 4, restart_rows=rows,
                             interleaved=False)
        assert outcome(data) == "equal"
        start = data.index(b"\xff\xda")
        for _ in range(4):
            pos = int(rng.integers(start, len(data) - 2))
            outcome(data[:pos] + bytes([data[pos] ^ int(rng.integers(1, 256))])
                    + data[pos + 1:])


def test_damaged_jpeg_in_tiff_tiles():
    """libtiff hands libjpeg each strip or tile whole and an EOI past its end."""
    with open(os.path.join(DATA, "photo_jpeg_ycbcr.tif"), "rb") as f:
        data = f.read()
    tags = Image.open(io.BytesIO(data)).tag_v2
    offsets = tags.get(273) or tags[324]
    seen = set()
    for k, off in enumerate(offsets[:6]):
        pos = off + 200 + 37 * k
        seen.add(outcome(data[:pos] + bytes([data[pos] ^ 0x5A]) + data[pos + 1:]))
    assert "equal" in seen


# ----------------------------------------------------- the card's inputs


def _first_hit(data: bytes, start: int, end: int) -> bytes:
    """``data`` with the byte at the first of a fixed run of places from
    the middle of [start, end) XOR-ed with 0x5A where PIL reads the result
    and its pixels change."""
    clean = pil_bytes(data)
    for pos in range((start + end) // 2, end, 97):
        damaged = data[:pos] + bytes([data[pos] ^ 0x5A]) + data[pos + 1:]
        px = pil_bytes(damaged)
        if isinstance(px, np.ndarray) and (px != clean).any():
            return damaged
    raise AssertionError("no place to damage")


def make_damage_inputs(d: str) -> None:
    """Write the damaged inputs of ``CHIP_INPUTS`` (``DAMAGED``) into ``d``,
    from the clean inputs already there."""
    def read(name):
        with open(os.path.join(d, name), "rb") as f:
            return f.read()

    def write(name, data):
        with open(os.path.join(d, name), "wb") as f:
            f.write(data)

    data = read("photo_420_restart.jpg")
    write("photo_420_restart_rst4.jpg", data[:RST3] + b"\xd4" + data[RST3 + 1:])
    write("photo_420_restart_no_rst.jpg", data[:RST3 - 1] + data[RST3 + 1:])
    data = read("photo_progressive_422.jpg")
    start, end = [s for s in _scan_spans(data) if s[2] > 0][1][:2]
    write("photo_progressive_422_hit.jpg", _first_hit(data, start, end))
    for name in ("arith_progressive.jpg", "lossless_pred6.jpg"):
        data = read(name)
        write(name.replace(".jpg", "_hit.jpg"),
              _first_hit(data, data.index(b"\xff\xda"), len(data) - 2))
    data = read("photo_jpeg_ycbcr.tif")
    tags = Image.open(io.BytesIO(data)).tag_v2
    off, count = (tags.get(273) or tags[324])[1], (tags.get(279) or tags[325])[1]
    write("photo_jpeg_ycbcr_hit.tif", _first_hit(data, off, off + count))


@pytest.mark.parametrize("name", DAMAGED)
def test_damaged_chip_inputs_match_pil(name):
    """Each damaged input of the card reads bit-equal to PIL and differs
    from its clean file's decode."""
    with open(os.path.join(DATA, name), "rb") as f:
        data = f.read()
    assert outcome(data) == "equal"
    clean = name.replace("_rst4", "").replace("_no_rst", "").replace("_hit", "")
    assert (tio.read_image(os.path.join(DATA, name))
            != tio.read_image(os.path.join(DATA, clean))).any()


@pytest.mark.parametrize("name", DAMAGED)
def test_jax_and_port_load_image_agree_on_damaged_inputs(name):
    """The JAX package's ``load_image`` (PIL) and the port's, crop, square
    and bicubic resize included, give equal arrays."""
    path = os.path.join(DATA, name)
    want = jio.load_image(path, left=3, top=2, resize=(256, 256))
    got = tio.load_image(path, left=3, top=2, resize=(256, 256))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, np.asarray(want))
