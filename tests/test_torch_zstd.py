"""The port's Zstandard decoder (utils/image_zstd.py, RFC 8878) against the
``zstandard`` package's compressor and decompressor, on the CPU.

- Hypothesis-drawn data (random bytes, runs, repeated words, random walks)
  at every level from -5 to 22, with and without the content checksum and
  the frame content size.
- Inputs above 128 KiB, so that frames hold several blocks; every kind of
  literals section and every mode of the three sequence tables (counted
  here).
- The empty input, frames back to back with skippable frames between
  them, a frame with a dictionary (refused), frames cut short with and
  without a byte limit, and bit flips (a ValueError where ``zstandard``
  fails; its output, or a ValueError where the port checks a rule that
  libzstd's fast paths do not, where it does not).
- The hand-typed constants (predefined distributions, length baselines)
  are held by every frame above; XXH64 by its published value of the empty
  input and by every frame with a checksum.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from audioeditingcode_tpu_torch.utils import image_zstd

zstandard = pytest.importorskip("zstandard")


def compress(data: bytes, level: int, checksum: bool = True, size: bool = True) -> bytes:
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                    write_content_size=size).compress(data)


def reference(frame: bytes) -> bytes:
    """``zstandard``'s decoding of one or more frames."""
    return zstandard.ZstdDecompressor().decompressobj(read_across_frames=True).decompress(frame)


def structured(seed: int, size: int, kind: int) -> bytes:
    rng = np.random.default_rng(seed)
    if kind == 0:  # words from a small vocabulary: matches and repeat offsets
        words = [bytes(rng.integers(97, 123, int(rng.integers(2, 9))).astype(np.uint8)) + b" "
                 for _ in range(40)]
        out = b"".join(words[int(i)] for i in rng.integers(0, 40, size // 3 + 1))
    elif kind == 1:  # a random walk: skewed literals
        out = (np.cumsum(rng.integers(-3, 4, size)) % 256).astype(np.uint8).tobytes()
    elif kind == 2:  # runs
        out = np.repeat(rng.integers(0, 256, size // 20 + 1), 20).astype(np.uint8).tobytes()
    else:  # random bytes: raw blocks and raw literals
        out = rng.integers(0, 256, size).astype(np.uint8).tobytes()
    return out[:size]


LEVELS = st.integers(-5, 22)


@settings(max_examples=150, deadline=None)
@given(data=st.binary(max_size=3000), level=LEVELS, checksum=st.booleans(), size=st.booleans())
def test_drawn_bytes(data, level, checksum, size):
    frame = compress(data, level, checksum, size)
    assert image_zstd.decompress(frame) == reference(frame) == data


@settings(max_examples=80, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), size=st.integers(0, 40000), kind=st.integers(0, 3),
       level=LEVELS, checksum=st.booleans())
def test_drawn_structured_data(seed, size, kind, level, checksum):
    data = structured(seed, size, kind)
    frame = compress(data, level, checksum, size=bool(seed & 1))
    assert image_zstd.decompress(frame) == data


@pytest.mark.parametrize("level", [-5, 1, 3, 9, 19, 22])
def test_several_blocks(level, monkeypatch):
    """300 KiB of words and a random walk: three blocks or more a frame,
    two of them compressed or more."""
    blocks = []
    block = image_zstd._compressed_block
    monkeypatch.setattr(image_zstd, "_compressed_block", lambda buf, frame, out, start: (
        blocks.append(len(buf)), block(buf, frame, out, start))[1])
    data = structured(level + 10, 200_000, 0) + structured(level + 5, 107_200, 1)
    frame = compress(data, level)
    assert image_zstd.decompress(frame) == data
    assert len(blocks) >= 2, blocks


def test_modes_over_all_levels(monkeypatch):
    """Over every level and the data kinds: Raw, Compressed and Treeless
    literals, and Predefined, RLE, FSE_Compressed and Repeat tables for each
    of literal lengths, offsets and match lengths; RLE literals from a block
    built here (held against ``zstandard`` too)."""
    seen = {"literals": set(), "tables": set()}
    literals, table = image_zstd._literals, image_zstd._sequence_table
    monkeypatch.setattr(image_zstd, "_literals", lambda buf, frame: (
        seen["literals"].add(buf[0] & 3), literals(buf, frame))[1])
    monkeypatch.setattr(image_zstd, "_sequence_table", lambda kind, mode, buf, pos, frame: (
        seen["tables"].add((kind, mode)), table(kind, mode, buf, pos, frame))[1])
    separated = b"".join(b"x" + bytes(np.random.default_rng(i).integers(0, 256, 5).astype(
        np.uint8)) * 2 for i in range(3000))
    cases = [(structured(3, 300_000, 0), (1, 9, 19)), (separated, (19,)),
             (b"".join(bytes([i % 251]) * 4 + b"ABCDEFGH" for i in range(40000)), (-5, 1))]
    cases += [(structured(40 + 4 * level + kind, 20_000, kind), (level,))
              for level in range(-5, 23, 3) for kind in range(4)]
    for data, levels in cases:
        for level in levels:
            assert image_zstd.decompress(compress(data, level)) == data
    # one compressed block: RLE literals (300 bytes of "q"), no sequences
    block = bytes([(300 << 4 | 1 << 2 | 1) & 255, 300 >> 4]) + b"q" + b"\0"
    frame = ((0xFD2FB528).to_bytes(4, "little") + bytes([0x60]) + (300 - 256).to_bytes(2, "little")
             + (len(block) << 3 | 2 << 1 | 1).to_bytes(3, "little") + block)
    assert image_zstd.decompress(frame) == reference(frame) == b"q" * 300
    assert seen["literals"] == {0, 1, 2, 3}, seen
    assert seen["tables"] == {(k, m) for k in ("LL", "OF", "ML") for m in range(4)}, seen


def test_empty_concatenated_and_skippable_frames():
    parts = [b"", b"first frame " * 50, structured(1, 5000, 1), b"x"]
    frames = [compress(p, 3, checksum=i % 2 == 0, size=i % 3 != 0) for i, p in enumerate(parts)]
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    empty_skip = (0x184D2A5F).to_bytes(4, "little") + bytes(4)
    stream = skip + frames[0] + frames[1] + empty_skip + frames[2] + skip + frames[3]
    assert image_zstd.decompress(frames[0]) == b""
    assert image_zstd.decompress(stream) == reference(stream) == b"".join(parts)
    assert image_zstd.decompress(b"") == b""


def test_dictionary_frame_raises():
    d = zstandard.train_dictionary(1024, [structured(i, 400, 0) for i in range(200)])
    frame = zstandard.ZstdCompressor(dict_data=d).compress(structured(999, 2000, 0))
    with pytest.raises(ValueError, match="Zstandard frame with a dictionary"):
        image_zstd.decompress(frame)


def test_cut_short():
    """A frame cut inside a block raises without a limit; with one, it
    gives the blocks before the cut where they reach the limit."""
    data = structured(5, 300_000, 1)
    frame = compress(data, 3)
    with pytest.raises(ValueError, match="truncated Zstandard data"):
        image_zstd.decompress(frame[:-10])
    with pytest.raises(ValueError, match="truncated Zstandard data"):
        image_zstd.decompress(frame[:-10], limit=len(data))
    part = image_zstd.decompress(frame[:len(frame) // 2], limit=100_000)
    assert len(part) >= 100_000 and data.startswith(part)
    assert image_zstd.decompress(frame[:-2], limit=len(data)) == data  # checksum cut off
    with pytest.raises(ValueError, match="Zstandard"):
        image_zstd.decompress(b"\x28\xb5\x2f")


def test_bit_flips_raise_or_match_zstandard():
    rng = np.random.default_rng(6)
    outcome = {"same": 0, "both fail": 0, "stricter": 0}
    for i in range(150):
        data = structured(i, int(rng.integers(1, 6000)), i % 4)
        frame = bytearray(compress(data, int(rng.integers(-5, 23)), checksum=bool(i % 2)))
        for _ in range(int(rng.integers(1, 3))):
            k = int(rng.integers(0, 8 * len(frame)))
            frame[k // 8] ^= 1 << (k % 8)
        try:
            want = reference(bytes(frame))
        except zstandard.ZstdError:
            with pytest.raises(ValueError, match="Zstandard"):
                image_zstd.decompress(bytes(frame))
            outcome["both fail"] += 1
            continue
        try:
            got = image_zstd.decompress(bytes(frame))
        except ValueError as e:
            # the port holds each stream to RFC 8878's rules (a Huffman
            # stream read exactly to its start, ...), which libzstd's fast
            # paths do not all check
            assert "Zstandard" in str(e), (i, e)
            outcome["stricter"] += 1
            continue
        assert got == want, i
        outcome["same"] += 1
    assert outcome["both fail"] > 50 and outcome["stricter"] <= 10, outcome


def test_xxh64():
    assert image_zstd.xxh64(b"") == 0xEF46DB3751D8E999
    for n in (1, 3, 4, 7, 8, 31, 32, 33, 100, 1000):
        data = structured(n, n, 3)
        frame = compress(data, 1, checksum=True)
        assert image_zstd.xxh64(data) & 0xFFFFFFFF == int.from_bytes(frame[-4:], "little")
