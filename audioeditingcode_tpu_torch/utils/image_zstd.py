"""A Zstandard decoder (RFC 8878), numpy and the standard library only, for
TIFF compression 50000 (libtiff's ``tif_zstd.c`` writes one frame a strip
or tile).

- Frames (magic 0xFD2FB528): the Frame_Header_Descriptor, the
  Window_Descriptor, the Frame_Content_Size (checked against what the
  frame gives) and the Content_Checksum (the low 32 bits of XXH64 of the
  frame's content, checked where present). A Dictionary_ID raises: no
  dictionary is given. Skippable frames (magic 0x184D2A50-5F) are skipped,
  and frames back to back are joined.
- Raw, RLE and Compressed blocks of at most min(Window_Size, 128 KiB).
- Literals sections Raw, RLE, Compressed and Treeless; the Huffman tree
  from direct 4-bit weights or FSE-compressed ones; one stream or four
  behind the jump table.
- Sequences sections with Predefined, RLE, FSE_Compressed and Repeat
  tables for literal lengths, offsets and match lengths, the three repeat
  offsets with the literal-length-0 shift.

Every malformed stream raises a ``ValueError`` naming Zstandard.
``decompress(data, limit)`` stops at the first block that the data cuts
short, and raises there only when less than ``limit`` bytes came out, as
libtiff's streaming read of a strip does.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

_MAGIC = 0xFD2FB528
_MAX_BLOCK = 128 * 1024
# literal-length and match-length codes: (baseline, extra bits) (RFC 8878 3.1.1.3.2.1.1)
_LL = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3), (48, 4), (64, 6),
    (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11), (4096, 12), (8192, 13), (16384, 14),
    (32768, 15), (65536, 16)]
_ML = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3), (67, 4), (83, 4),
    (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10), (2051, 11), (4099, 12), (8195, 13),
    (16387, 14), (32771, 15), (65539, 16)]
# the predefined distributions (RFC 8878 3.1.1.3.2.2): accuracy log, counts
_LL_DEFAULT = (6, [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3,
                   2, 1, 1, 1, 1, 1, -1, -1, -1, -1])
_ML_DEFAULT = (6, [1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7)
_OF_DEFAULT = (5, [1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5)
_MAX_LOG = {"LL": 9, "OF": 8, "ML": 9}
_MAX_SYMBOL = {"LL": 35, "OF": 31, "ML": 52}
_M64 = (1 << 64) - 1
_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P4, _P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5


def _fail(what: str):
    raise ValueError(f"corrupt Zstandard data: {what}")


class _Truncated(Exception):
    """The data ends inside a block or a frame header."""


# ------------------------------------------------------------------ bits
class _Backward:
    """A backward bit stream (RFC 8878 4.1): read from its last byte down,
    past the padding's highest set bit; bits past its start read as 0."""

    def __init__(self, buf: bytes):
        if not buf or buf[-1] == 0:
            _fail("a bit stream without its final padding bit")
        self.buf = bytes(buf) + bytes(8)
        self.pos = 8 * len(buf) - 8 + buf[-1].bit_length() - 1  # bits left

    def read(self, n: int) -> int:
        """The next ``n`` (at most 56) bits."""
        if n == 0:
            return 0
        self.pos -= n
        p = self.pos
        if p >= 0:
            return (int.from_bytes(self.buf[p >> 3:(p >> 3) + 8], "little") >> (p & 7)) & (
                (1 << n) - 1)
        return (int.from_bytes(self.buf[:8], "little") << -p) & ((1 << n) - 1)


def _peek_table(buf: bytes, width: int) -> Tuple[np.ndarray, int]:
    """For a backward stream: (for each count p of bits left, the next
    ``width`` bits, zeros past the start; bits in the stream)."""
    if not buf or buf[-1] == 0:
        _fail("a bit stream without its final padding bit")
    total = 8 * len(buf) - 8 + buf[-1].bit_length() - 1
    # two zero bytes before the stream's first: the peek at p bits left is
    # bits p - width .. p - 1 of it, read from the three bytes that hold them
    b = np.concatenate([np.zeros(2, np.int64), np.frombuffer(buf, np.uint8), np.zeros(2, np.uint8)])
    low = np.arange(total + 1) - width + 16
    k = low >> 3
    v = b[k] | (b[k + 1] << 8) | (b[k + 2] << 16)
    return (v >> (low & 7)) & ((1 << width) - 1), total


# ------------------------------------------------------------------- FSE
def _read_counts(buf: bytes, pos: int, max_log: int, max_symbol: int) -> Tuple[int, list, int]:
    """An FSE table description (RFC 8878 4.1.1): (accuracy log,
    normalized counts, the position after it)."""
    value = int.from_bytes(buf[pos:pos + 64], "little")
    avail = 8 * len(buf[pos:pos + 64])
    if avail < 4:
        _fail("an FSE table description cut short")
    log = (value & 15) + 5
    if log > max_log:
        _fail(f"FSE accuracy log {log} above {max_log}")
    bit = 4
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts: List[int] = []
    while remaining > 1:
        if len(counts) > max_symbol:
            _fail("an FSE table description with too many symbols")
        mx = (2 * threshold - 1) - remaining
        low = (value >> bit) & (threshold - 1)
        if low < mx:
            count, bit = low, bit + nbits - 1
        else:
            count = (value >> bit) & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            bit += nbits
        count -= 1
        remaining -= abs(count)
        counts.append(count)
        if count == 0:
            while True:
                rep = (value >> bit) & 3
                bit += 2
                counts.extend([0] * rep)
                if rep != 3:
                    break
        if remaining < threshold:
            if remaining <= 1:
                break
            nbits = remaining.bit_length()
            threshold = 1 << (nbits - 1)
        if bit > 8 * 56:  # refill: the description is at most 8 * 2^9 bits
            consumed = bit // 8
            pos += consumed
            bit -= 8 * consumed
            value = int.from_bytes(buf[pos:pos + 64], "little")
            avail = 8 * len(buf[pos:pos + 64])
    if remaining != 1 or len(counts) > max_symbol + 1 or bit > avail:
        _fail("a malformed FSE table description")
    return log, counts, pos + (bit + 7) // 8


def _fse_table(log: int, counts: list) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The decoding table of normalized counts: (symbol, bits, baseline)
    for each state (RFC 8878 4.1.1's spreading)."""
    size = 1 << log
    symbol = np.zeros(size, np.int64)
    high = size - 1
    nxt = []
    for s, c in enumerate(counts):
        if c == -1:
            symbol[high] = s
            high -= 1
            nxt.append(1)
        else:
            nxt.append(max(c, 0))
    step = (size >> 1) + (size >> 3) + 3
    mask, p = size - 1, 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbol[p] = s
            p = (p + step) & mask
            while p > high:
                p = (p + step) & mask
    if p != 0:
        _fail("FSE counts that do not fill the table")
    bits = np.zeros(size, np.int64)
    base = np.zeros(size, np.int64)
    for u in range(size):
        s = int(symbol[u])
        n = nxt[s]
        nxt[s] += 1
        b = log - (n.bit_length() - 1)
        bits[u] = b
        base[u] = (n << b) - size
    return symbol, bits, base


def _rle_table(sym: int):
    return np.array([sym]), np.zeros(1, np.int64), np.zeros(1, np.int64)


_DEFAULT_TABLES = {kind: (log, _fse_table(log, counts)) for kind, (log, counts) in (
    ("LL", _LL_DEFAULT), ("OF", _OF_DEFAULT), ("ML", _ML_DEFAULT))}


# --------------------------------------------------------------- Huffman
def _huffman_weights(buf: bytes, pos: int) -> Tuple[List[int], int]:
    """The Huffman tree description's weights, and the position after it."""
    if pos >= len(buf):
        _fail("a literals section cut short in its Huffman tree")
    head = buf[pos]
    pos += 1
    if head >= 128:
        n = head - 127
        raw = buf[pos:pos + (n + 1) // 2]
        if len(raw) < (n + 1) // 2:
            _fail("Huffman weights cut short")
        weights = [v for b in raw for v in (b >> 4, b & 15)][:n]
        return weights, pos + (n + 1) // 2
    end = pos + head
    if end > len(buf):
        _fail("FSE-compressed Huffman weights cut short")
    log, counts, start = _read_counts(buf[:end], pos, 6, 255)
    symbol, bits, base = _fse_table(log, counts)
    stream = _Backward(buf[start:end])
    s1, s2 = stream.read(log), stream.read(log)
    weights: List[int] = []
    while True:
        if len(weights) > 254:
            _fail("too many Huffman weights")
        weights.append(int(symbol[s1]))
        s1 = int(base[s1]) + stream.read(int(bits[s1]))
        if stream.pos < 0:
            weights.append(int(symbol[s2]))
            break
        weights.append(int(symbol[s2]))
        s2 = int(base[s2]) + stream.read(int(bits[s2]))
        if stream.pos < 0:
            weights.append(int(symbol[s1]))
            break
    return weights, end


def _huffman_table(weights: List[int]) -> Tuple[np.ndarray, np.ndarray, int]:
    """(symbol, code length) for each ``max_bits``-bit peek, and max_bits,
    from the weights (the last symbol's implied)."""
    if any(w > 12 for w in weights):
        _fail("a Huffman weight above 12")
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        _fail("Huffman weights all zero")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1) or max_bits > 11:
        _fail("Huffman weights that do not make a prefix code")
    weights = weights + [rest.bit_length()]
    size = 1 << max_bits
    sym = np.zeros(size, np.int64)
    length = np.zeros(size, np.int64)
    at = 0
    for w in range(1, max_bits + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                n = 1 << (w - 1)
                sym[at:at + n] = s
                length[at:at + n] = max_bits + 1 - w
                at += n
    return sym, length, max_bits


def _huffman_stream(buf: bytes, n: int, table) -> bytes:
    sym, length, max_bits = table
    peek, total = _peek_table(buf, max_bits)
    step = length[peek]
    out = bytearray(n)
    p = total
    syms = sym[peek].tolist()
    steps = step.tolist()
    for i in range(n):
        out[i] = syms[p]
        p -= steps[p]
        if p < 0:
            _fail("a Huffman stream read past its start")
    if p != 0:
        _fail("a Huffman stream not read to its start")
    return bytes(out)


# -------------------------------------------------------------- sections
class _Frame:
    def __init__(self):
        self.huffman = None
        self.tables = {"LL": None, "OF": None, "ML": None}
        self.reps = [1, 4, 8]


def _literals(buf: bytes, frame: _Frame) -> Tuple[bytes, int]:
    """The literals section: (literals, its size in the block)."""
    b0 = buf[0]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):
        if fmt in (0, 2):
            size, head = b0 >> 3, 1
        elif fmt == 1:
            size, head = (b0 >> 4) + (buf[1] << 4), 2
        else:
            size, head = (b0 >> 4) + (buf[1] << 4) + (buf[2] << 12), 3
        if kind == 0:
            if head + size > len(buf):
                _fail("raw literals cut short")
            return buf[head:head + size], head + size
        if head >= len(buf):
            _fail("RLE literals cut short")
        return buf[head:head + 1] * size, head + 1
    head = (3, 3, 4, 5)[fmt]
    if head > len(buf):
        _fail("a literals section header cut short")
    h = int.from_bytes(buf[:head], "little")
    bits = (10, 10, 14, 18)[fmt]
    size = (h >> 4) & ((1 << bits) - 1)
    csize = (h >> (4 + bits)) & ((1 << bits) - 1)
    streams = 1 if fmt == 0 else 4
    end = head + csize
    if end > len(buf):
        _fail("compressed literals cut short")
    pos = head
    if kind == 2:
        weights, pos = _huffman_weights(buf[:end], pos)
        frame.huffman = _huffman_table(weights)
    elif frame.huffman is None:
        _fail("treeless literals without an earlier Huffman tree")
    if streams == 1:
        return _huffman_stream(buf[pos:end], size, frame.huffman), end
    if pos + 6 > end:
        _fail("a jump table cut short")
    s1, s2, s3 = struct.unpack("<3H", buf[pos:pos + 6])
    pos += 6
    s4 = end - pos - s1 - s2 - s3
    if s4 < 1:
        _fail("a jump table past its literals")
    each = (size + 3) // 4
    if size < 3 * each:
        _fail("literals too few for four streams")
    out = b""
    for k, (s, n) in enumerate(((s1, each), (s2, each), (s3, each), (s4, size - 3 * each))):
        out += _huffman_stream(buf[pos:pos + s], n, frame.huffman)
        pos += s
    return out, end


def _sequence_table(kind: str, mode: int, buf: bytes, pos: int, frame: _Frame):
    if mode == 0:
        table = _DEFAULT_TABLES[kind]
    elif mode == 1:
        if pos >= len(buf):
            _fail("an RLE sequence table cut short")
        if buf[pos] > _MAX_SYMBOL[kind]:
            _fail(f"an RLE {kind} code {buf[pos]}")
        table, pos = (0, _rle_table(buf[pos])), pos + 1
    elif mode == 2:
        log, counts, pos = _read_counts(buf, pos, _MAX_LOG[kind], _MAX_SYMBOL[kind])
        table = (log, _fse_table(log, counts))
    else:
        if frame.tables[kind] is None:
            _fail(f"a repeated {kind} table without an earlier one")
        table = frame.tables[kind]
    frame.tables[kind] = table
    return table, pos


def _sequences(buf: bytes, frame: _Frame) -> List[Tuple[int, int, int]]:
    """The sequences section: (literal length, offset, match length)s."""
    if not buf:
        _fail("a block without its sequences section")
    b0 = buf[0]
    if b0 == 0:
        if len(buf) != 1:
            _fail("bytes after an empty sequences section")
        return []
    if b0 < 128:
        n, pos = b0, 1
    elif b0 < 255:
        if len(buf) < 2:
            _fail("a sequence count cut short")
        n, pos = ((b0 - 128) << 8) + buf[1], 2
    else:
        if len(buf) < 3:
            _fail("a sequence count cut short")
        n, pos = buf[1] + (buf[2] << 8) + 0x7F00, 3
    if pos >= len(buf):
        _fail("sequence table modes cut short")
    modes = buf[pos]
    pos += 1
    if modes & 3:
        _fail("reserved bits set in the sequence table modes")
    tables = {}
    for kind, shift in (("LL", 6), ("OF", 4), ("ML", 2)):
        tables[kind], pos = _sequence_table(kind, (modes >> shift) & 3, buf, pos, frame)
    stream = _Backward(buf[pos:])
    (ll_log, (ll_sym, ll_bits, ll_base)), (of_log, (of_sym, of_bits, of_base)), \
        (ml_log, (ml_sym, ml_bits, ml_base)) = tables["LL"], tables["OF"], tables["ML"]
    ll_sym, ll_bits, ll_base = ll_sym.tolist(), ll_bits.tolist(), ll_base.tolist()
    of_sym, of_bits, of_base = of_sym.tolist(), of_bits.tolist(), of_base.tolist()
    ml_sym, ml_bits, ml_base = ml_sym.tolist(), ml_bits.tolist(), ml_base.tolist()
    ll_state, of_state, ml_state = stream.read(ll_log), stream.read(of_log), stream.read(ml_log)
    reps = frame.reps
    read = stream.read
    out = []
    for i in range(n):
        of_code, ml_code, ll_code = of_sym[of_state], ml_sym[ml_state], ll_sym[ll_state]
        if of_code > 31:
            _fail(f"offset code {of_code}")
        value = (1 << of_code) + read(of_code)
        mb, mx = _ML[ml_code]
        ml = mb + read(mx)
        lb, lx = _LL[ll_code]
        ll = lb + read(lx)
        if value > 3:
            offset = value - 3
            reps[:] = [offset, reps[0], reps[1]]
        else:
            idx = value + (ll == 0)
            if idx == 1:
                offset = reps[0]
            elif idx == 2:
                offset = reps[1]
                reps[:] = [offset, reps[0], reps[2]]
            else:
                offset = reps[2] if idx == 3 else reps[0] - 1
                if offset == 0:
                    _fail("a repeat offset of 0")
                reps[:] = [offset, reps[0], reps[1]]
        out.append((ll, offset, ml))
        if i + 1 < n:
            ll_state = ll_base[ll_state] + read(ll_bits[ll_state])
            ml_state = ml_base[ml_state] + read(ml_bits[ml_state])
            of_state = of_base[of_state] + read(of_bits[of_state])
    if stream.pos != 0:
        _fail("a sequences bit stream not read to its start")
    return out


def _compressed_block(buf: bytes, frame: _Frame, out: bytearray, start: int) -> None:
    lits, pos = _literals(buf, frame)
    seqs = _sequences(buf[pos:], frame)
    at = 0
    for ll, offset, ml in seqs:
        if at + ll > len(lits):
            _fail("sequences past the literals")
        out += lits[at:at + ll]
        at += ll
        if offset > len(out) - start:
            _fail(f"an offset of {offset} before the frame's start")
        if offset >= ml:
            out += out[len(out) - offset:len(out) - offset + ml]
        else:
            piece = bytes(out[len(out) - offset:])
            out += (piece * (ml // offset + 1))[:ml]
    out += lits[at:]


# ---------------------------------------------------------------- XXH64
def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M64
    acc = ((acc << 31) | (acc >> 33)) & _M64
    return (acc * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data``."""
    n = len(data)
    p = 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed, (seed - _P1) & _M64]
        lanes = np.frombuffer(data, "<u8", (n // 32) * 4).reshape(-1, 4).tolist()
        for row in lanes:
            v = [_round(a, b) for a, b in zip(v, row)]
        p = (n // 32) * 32
        h = 0
        for k, r in zip(v, (1, 7, 12, 18)):
            h += ((k << r) | (k >> (64 - r))) & _M64
        h &= _M64
        for k in v:
            h = ((h ^ _round(0, k)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        k = _round(0, int.from_bytes(data[p:p + 8], "little"))
        h ^= k
        h = ((((h << 27) | (h >> 37)) & _M64) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h ^= (int.from_bytes(data[p:p + 4], "little") * _P1) & _M64
        h = ((((h << 23) | (h >> 41)) & _M64) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h ^= (data[p] * _P5) & _M64
        h = ((((h << 11) | (h >> 53)) & _M64) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


# ----------------------------------------------------------------- frames
def _frame(data: bytes, pos: int, out: bytearray) -> int:
    """One frame from ``pos`` (past its magic) onto ``out``; returns the
    position after it."""
    start = len(out)
    if pos >= len(data):
        raise _Truncated
    fhd = data[pos]
    pos += 1
    fcs_flag, single, checksum, did_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        _fail("a reserved bit set in the frame header")
    window = None
    if not single:
        if pos >= len(data):
            raise _Truncated
        wd = data[pos]
        pos += 1
        base = 1 << (10 + (wd >> 3))
        window = base + (base >> 3) * (wd & 7)
    did_size = (0, 1, 2, 4)[did_flag]
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if pos + did_size + fcs_size > len(data):
        raise _Truncated
    if did_size and int.from_bytes(data[pos:pos + did_size], "little"):
        raise ValueError("Zstandard frame with a dictionary, which is not given (libtiff writes "
                         "none)")
    pos += did_size
    content = None
    if fcs_size:
        content = int.from_bytes(data[pos:pos + fcs_size], "little") + (256 if fcs_size == 2
                                                                          else 0)
        pos += fcs_size
    if window is None:
        window = content
    block_max = min(window, _MAX_BLOCK)
    frame = _Frame()
    while True:
        if pos + 3 > len(data):
            raise _Truncated
        h = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        if kind == 3:
            _fail("a block of the reserved type")
        if size > block_max:
            _fail(f"a block of {size} bytes, above its maximum of {block_max}")
        if kind == 1:
            if pos >= len(data):
                raise _Truncated
            out += data[pos:pos + 1] * size
            pos += 1
        else:
            if pos + size > len(data):
                raise _Truncated
            if kind == 0:
                out += data[pos:pos + size]
            else:
                _compressed_block(data[pos:pos + size], frame, out, start)
            pos += size
        if last:
            break
    if content is not None and len(out) - start != content:
        _fail(f"a frame of {len(out) - start} bytes whose header says {content}")
    if checksum:
        if pos + 4 > len(data):
            raise _Truncated
        want = int.from_bytes(data[pos:pos + 4], "little")
        if xxh64(bytes(out[start:])) & 0xFFFFFFFF != want:
            _fail("the content checksum does not match")
        pos += 4
    return pos


def decompress(data: bytes, limit: Optional[int] = None) -> bytes:
    """The content of the Zstandard frames in ``data``. With ``limit``, a
    stream cut short inside a block or a frame is read up to there, and
    raises only where it gave fewer than ``limit`` bytes."""
    out = bytearray()
    pos = 0
    try:
        while pos < len(data):
            if pos + 4 > len(data):
                raise _Truncated
            magic = int.from_bytes(data[pos:pos + 4], "little")
            if magic & 0xFFFFFFF0 == 0x184D2A50:
                if pos + 8 > len(data):
                    raise _Truncated
                pos += 8 + int.from_bytes(data[pos + 4:pos + 8], "little")
                if pos > len(data):
                    raise _Truncated
                continue
            if magic != _MAGIC:
                _fail(f"bad magic number {magic:#010x}")
            pos = _frame(data, pos + 4, out)
            if limit is not None and len(out) >= limit:
                break
    except _Truncated:
        if limit is None or len(out) < limit:
            raise ValueError(f"truncated Zstandard data: {len(out)} bytes before its end") from None
    except IndexError:
        _fail("a section cut short")
    return bytes(out)
