"""The port's CCITT fax decoder (utils/image_ccitt.py, through
utils/image_tiff.py) against PIL 12.1's ``np.array(Image.open(p).convert(
"RGB"))``, bit for bit, on the CPU. PIL reads these compressions through
libtiff 4.7 and writes them with it, so most files here are PIL's own.

- Every run length of both colours from 0 to the width, at 1728 (a fax
  line) and 2561 (past the last extended make-up code, 2560), in CCITT
  RLE (2), Group 3 1-D and 2-D with and without EOL fill bits (3), and
  Group 4 (4); random images at widths 1 to 3000; both photometrics;
  several strips (the 2-D reference line restarts in each); tiles built
  from PIL's strips; FillOrder 2; T4Options and T6Options with the
  uncompressed-mode bit set.
- RLEW (32771, PIL's ``tiff_raw_16``): rows on 16-bit words, with its
  strips at odd and even file offsets (libtiff tests the word by the
  address of the next byte it reads).
- A 2-D row holding the uncompressed-mode extension code, which libtiff
  does not decode (the row ends there).
- Truncated and bit-flipped data: equal to PIL where PIL reads it, a
  ValueError where PIL fails, and a ValueError naming the rows libtiff
  leaves unwritten where PIL draws memory it never wrote (a Group 3 or
  Group 4 strip that ends early).
- BitsPerSample other than 1: PIL fails (libtiff's Fax3 setup), the port
  raises.
"""

import os
import struct

import numpy as np
import pytest
from PIL import Image

from audioeditingcode_tpu_torch.utils import image_io as tio
from test_torch_image_codecs import _REVERSED, layout
from test_torch_image_raster import both_fail, check, put

CODES = {"tiff_ccitt": 2, "group3": 3, "group4": 4, "tiff_raw_16": 32771}
# (PIL compression, T4Options): 1-D; 2-D; 2-D with EOL fill bits; 1-D with fill bits
KINDS = [("tiff_ccitt", None), ("group3", None), ("group3", 1), ("group3", 5), ("group3", 4),
         ("group4", None)]
KIND_IDS = ["rle", "g3_1d", "g3_2d", "g3_2d_fill", "g3_1d_fill", "g4"]


def pil_fax(path, bits, compression, t4=None, **kw):
    """``bits`` (H, W) booleans, black True, saved by PIL as mode 1."""
    info = dict(kw.pop("tiffinfo", {}))
    if t4 is not None:
        info[292] = t4
    Image.fromarray(bits).save(path, compression=compression, tiffinfo=info, **kw)
    return str(path)


def strips_of(path):
    """(tags as PIL reads them, each strip's bytes) of a TIFF PIL wrote."""
    im = Image.open(path)
    data = open(path, "rb").read()
    offsets, counts = im.tag_v2[273], im.tag_v2[279]
    return dict(im.tag_v2), [data[o:o + n] for o, n in zip(offsets, counts)]


def fax_tiff(path, blocks, w, h, comp, photo=1, rows=None, tile=None, more=None):
    """A TIFF of already encoded fax strips (or tiles) by ``layout``."""
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [1]), 259: (3, [comp]), 262: (3, [photo]),
            277: (3, [1])}
    if tile:
        tags.update({322: (4, [tile[0]]), 323: (4, [tile[1]])})
    else:
        tags[278] = (4, [rows or h])
    tags.update(more or {})
    return put(str(path), layout(blocks, tags, tiled=bool(tile)))


def every_run(width: int) -> np.ndarray:
    """Row k: a white run of k pixels, then black to the width; then rows
    of a black run of k, then white; then alternating short runs."""
    k = np.arange(width + 1)[:, None]
    x = np.arange(width)[None, :]
    white_first = x >= k
    black_first = x < k
    alt = ((x // (1 + np.arange(7)[:, None])) % 2).astype(bool)
    return np.concatenate([white_first, black_first, alt])


@pytest.mark.parametrize("width", [1728, 2561])
@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_every_run_length(tmp_path, kind, width):
    comp, t4 = kind
    check(pil_fax(tmp_path / "a.tif", every_run(width), comp, t4))


RANDOM_WIDTHS = [1, 2, 7, 8, 9, 15, 16, 17, 63, 64, 65, 100, 333, 1000, 3000]


@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_random_widths_from_pil(tmp_path, kind):
    """Random pictures at each width, with a blank row, a full row and
    alternating pixels."""
    comp, t4 = kind
    rng = np.random.default_rng(CODES[comp] * 7 + (t4 or 0))
    for w in RANDOM_WIDTHS:
        h = int(rng.integers(4, 24))
        bits = rng.random((h, w)) > rng.random()
        bits[1], bits[2], bits[3, ::2] = False, True, True
        check(pil_fax(tmp_path / f"w{w}.tif", bits, comp, t4))


@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_strips_photometric_and_fill_order(tmp_path, kind):
    """Strips of 5 rows from PIL; the same strips as WhiteIsZero; with
    their bits reversed under FillOrder 2."""
    comp, t4 = kind
    rng = np.random.default_rng(11)
    bits = rng.random((23, 77)) > 0.6
    bits[:, 30:40] = True
    path = pil_fax(tmp_path / "s.tif", bits, comp, t4, strip_size=5 * 10)
    tags, blocks = strips_of(path)
    assert tags[278] == 5 and len(blocks) == 5
    check(path)
    more = {292: (4, [t4])} if t4 is not None else {}
    check(fax_tiff(tmp_path / "white_is_zero.tif", blocks, 77, 23, CODES[comp], photo=0, rows=5,
                   more=more))
    reversed_blocks = [b.translate(_REVERSED) for b in blocks]
    check(fax_tiff(tmp_path / "fill2.tif", reversed_blocks, 77, 23, CODES[comp], rows=5,
                   more={266: (3, [2]), **more}))


@pytest.mark.parametrize("kind", KINDS, ids=KIND_IDS)
def test_tiles(tmp_path, kind):
    """32 x 16 tiles, each the strip PIL writes for the tile's pixels, the
    image cut at its right and bottom edges."""
    comp, t4 = kind
    rng = np.random.default_rng(12)
    bits = rng.random((40, 70)) > 0.5
    blocks = []
    for y in range(0, 40, 16):
        for x in range(0, 70, 32):
            tile = np.zeros((16, 32), bool)
            part = bits[y:y + 16, x:x + 32]
            tile[:part.shape[0], :part.shape[1]] = part
            blocks += strips_of(pil_fax(tmp_path / "t.tif", tile, comp, t4))[1]
    more = {292: (4, [t4])} if t4 is not None else {}
    check(fax_tiff(tmp_path / "tiled.tif", blocks, 70, 40, CODES[comp], tile=(32, 16),
                   more=more))


def test_uncompressed_mode_option_bits(tmp_path):
    """T4Options and T6Options with bit 1 (uncompressed mode allowed):
    libtiff writes ordinary codes and reads them; and a 2-D row with the
    extension code, which libtiff does not decode, ends there."""
    rng = np.random.default_rng(13)
    bits = rng.random((12, 50)) > 0.5
    check(pil_fax(tmp_path / "g3.tif", bits, "group3", 3))
    check(pil_fax(tmp_path / "g4.tif", bits, "group4", tiffinfo={293: 2}))
    # T.6: V0 V0 (two white rows of the reference), then the extension code
    # 0000001 111 in the third row, then an EOFB
    code = "1" * 2 + "0000001111" + "000000000001" * 2
    data = int(code.ljust(-(-len(code) // 8) * 8, "0"), 2).to_bytes(-(-len(code) // 8), "big")
    check(fax_tiff(tmp_path / "ext.tif", [data], 50, 3, 4, more={293: (4, [2])}))


def _odd_offset_tiff(strip: bytes, w: int, h: int, gap: int, fill: int = 1) -> bytes:
    """A little-endian TIFF whose one RLEW strip starts ``gap`` bytes past
    the header."""
    off = 8 + gap
    ifd = off + len(strip) + (off + len(strip)) % 2
    entries = [(256, 4, w), (257, 4, h), (258, 3, 1), (259, 3, 32771), (262, 3, 1),
               (266, 3, fill), (273, 4, off), (277, 3, 1), (278, 4, h), (279, 4, len(strip))]
    body = b"II*\0" + struct.pack("<I", ifd) + bytes(gap) + strip
    body += bytes(ifd - len(body))
    ifd_bytes = b"".join(struct.pack("<HHII", t, k, 1, v) if k == 4 else
                         struct.pack("<HHIHH", t, k, 1, v, 0) for t, k, v in entries)
    return body + struct.pack("<H", len(entries)) + ifd_bytes + bytes(4)


def test_rlew_from_pil_at_odd_and_even_offsets(tmp_path):
    """RLEW as PIL writes it, and its strip moved to odd and even offsets,
    with FillOrder 2 too: equal where PIL reads it, both fail elsewhere
    (libtiff's alignment by address misreads many of PIL's own files)."""
    rng = np.random.default_rng(14)
    outcome = {"equal": 0, "both fail": 0}
    for i in range(40):
        w, h = int(rng.integers(1, 70)), int(rng.integers(1, 9))
        bits = rng.random((h, w)) > rng.random()
        path = pil_fax(tmp_path / "r.tif", bits, "tiff_raw_16")
        strip = strips_of(path)[1][0]
        gap, fill = i % 4, 1 + (i % 3 == 0)
        if fill == 2:
            strip = strip.translate(_REVERSED)
        put(str(tmp_path / "o.tif"), _odd_offset_tiff(strip, w, h, gap, fill))
        for p in (path, str(tmp_path / "o.tif")):
            try:
                want = np.asarray(Image.open(p).convert("RGB"))
            except Exception:
                with pytest.raises(ValueError, match="CCITT"):
                    tio.read_image(p)
                outcome["both fail"] += 1
                continue
            np.testing.assert_array_equal(tio.read_image(p), want)
            outcome["equal"] += 1
    assert outcome["equal"] > 20 and outcome["both fail"] > 5, outcome


def _corrupt(rng, data: bytes) -> bytes:
    s = bytearray(data)
    how = rng.integers(0, 3)
    if how == 0 and len(s) > 1:
        return bytes(s[:int(rng.integers(1, len(s)))])
    if how == 1:
        for _ in range(int(rng.integers(1, 4))):
            k = int(rng.integers(0, 8 * len(s)))
            s[k // 8] ^= 1 << (k % 8)
        return bytes(s)
    return bytes(s) + bytes(int(rng.integers(0, 3)))


@pytest.mark.parametrize("kind", KINDS + [("tiff_raw_16", None)], ids=KIND_IDS + ["rlew"])
def test_truncated_and_bit_flipped_match_pil(tmp_path, kind):
    """Random pictures, each strip cut short, bit-flipped or padded: the
    port gives PIL's pixels where PIL reads the file, and a ValueError
    where PIL fails, or where libtiff leaves rows of a strip unwritten (PIL
    then shows memory it never wrote: not a result to match)."""
    comp, t4 = kind
    rng = np.random.default_rng(CODES[comp] + 10 * (t4 or 0))
    outcome = {"equal": 0, "both fail": 0, "rows unwritten": 0}
    path = str(tmp_path / "c.tif")
    for i in range(60):
        w, h = int(rng.integers(1, 90)), int(rng.integers(1, 12))
        bits = rng.random((h, w)) > rng.random()
        rows = int(rng.integers(1, h + 1))
        tags, blocks = strips_of(pil_fax(tmp_path / "p.tif", bits, comp, t4,
                                         strip_size=rows * ((w + 7) // 8)))
        blocks = [_corrupt(rng, b) for b in blocks]
        more = {292: (4, [t4])} if t4 is not None else {}
        fax_tiff(path, blocks, w, h, CODES[comp], photo=int(rng.integers(0, 2)),
                 rows=tags[278], more=more)
        try:
            want = np.asarray(Image.open(path).convert("RGB"))
        except Exception:
            want = None
        try:
            got = tio.read_image(path)
        except ValueError as e:
            if want is not None:
                assert "unwritten" in str(e), e
                outcome["rows unwritten"] += 1
            else:
                outcome["both fail"] += 1
            continue
        assert want is not None, "the port reads a file PIL fails on"
        np.testing.assert_array_equal(got, want)
        outcome["equal"] += 1
    # Group 3 1-D reads every strip: libtiff reads one that ends while an
    # EOL is skipped again from its start as data without EOLs
    assert outcome["equal"] >= 20, outcome


@pytest.mark.parametrize("comp", [2, 3, 4, 32771])
def test_bits_per_sample_other_than_one(tmp_path, comp):
    """libtiff's Fax3 setup refuses it, so PIL fails; the port raises."""
    path = pil_fax(tmp_path / "a.tif", np.ones((4, 16), bool), "group4")
    data = strips_of(path)[1]
    tags = {256: (4, [8]), 257: (4, [4]), 258: (3, [8]), 259: (3, [comp]), 262: (3, [1]),
            277: (3, [1]), 278: (4, [4])}
    put(str(tmp_path / "b.tif"), layout(data, tags))
    both_fail(str(tmp_path / "b.tif"), "Bits/sample must be 1")


def fax_page(h: int = 2200, w: int = 1728, seed: int = 0) -> np.ndarray:
    """A fax page: lines of word-sized black blocks with letter gaps, a
    rule, a filled box and a frame (black True)."""
    rng = np.random.default_rng(seed)
    page = np.zeros((h, w), bool)
    for top in range(120, h - 200, 36):
        x = 100 + int(rng.integers(0, 40))
        while x < w - 160:
            word = int(rng.integers(20, 140))
            for cx in range(x, min(x + word, w - 100), 12):
                ch = int(rng.integers(4, 10))
                page[top + int(rng.integers(0, 6)):top + 22, cx:cx + ch] = True
            x += word + int(rng.integers(14, 30))
    page[60:64, 80:w - 80] = True
    page[h - 180:h - 100, w - 500:w - 100] = True
    page[:6], page[-6:], page[:, :6], page[:, -6:] = True, True, True, True
    return page


def make_fax_inputs(d: str) -> None:
    """The fax inputs of CHIP_INPUTS: a Group 4 and a 2-D Group 3 page."""
    page = fax_page()
    pil_fax(os.path.join(d, "page_g4.tif"), page, "group4")
    pil_fax(os.path.join(d, "page_g3_2d.tif"), fax_page(seed=1), "group3", 5,
            strip_size=256 * 216)


def test_fax_page(tmp_path):
    """The committed pages' kind: a 1728 x 2200 page in Group 4 and in
    2-D Group 3 with EOL fill bits in strips of 256 rows."""
    make_fax_inputs(str(tmp_path))
    for name in ("page_g4.tif", "page_g3_2d.tif"):
        check(os.path.join(tmp_path, name), "TIFF")
    assert Image.open(os.path.join(tmp_path, "page_g3_2d.tif")).tag_v2[278] == 256


def test_rle_matches_a_hand_encoded_row(tmp_path):
    """One RLE row by the T.4 tables: white 3 (1000), black 2 (11), white
    0 (00110101), black 3 (10): the decoder's tables, not PIL's writer."""
    code = "1000" + "11" + "00110101" + "10"
    data = int(code.ljust(24, "0"), 2).to_bytes(3, "big")
    path = fax_tiff(tmp_path / "h.tif", [data], 8, 1, 2)
    check(path)
    row = tio.read_image(path)[0, :, 0]
    np.testing.assert_array_equal(row, [0, 0, 0, 255, 255, 255, 255, 255])
