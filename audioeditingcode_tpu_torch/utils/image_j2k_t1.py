"""JPEG 2000 tier-1 decoding (EBCOT) for ``image_jpeg2000``, numpy and the
standard library only, as OpenJPEG 2.5's ``t1.c`` and ``mqc.c`` decode a
code-block.

- The MQ decoder of ISO 15444-1 Annex C with its 47-state table, as
  OpenJPEG runs it: a segment's bytes are followed by 0xFF 0xFF, so a
  segment that ends early reads 1-bits; the register ``C`` is 32 bits. Raw
  (bypass) segments read bits with the stuffing rule after 0xFF.
- The three coding passes over stripes of four rows: significance
  propagation, magnitude refinement and cleanup with its run mode, with
  the zero-coding, sign and refinement contexts of the standard. The
  code-block style bits: BYPASS (raw significance and refinement passes
  from the fifth bit-plane on), RESET (the contexts reset after each MQ
  pass), TERMALL (a segment each pass), VSC (a stripe's last row does not
  see the stripe below), PTERM (nothing to do when decoding) and SEGSYM
  (four uniform decisions after each cleanup pass).
- The values are OpenJPEG's: twice the magnitude with the half bit set on
  significance and moved by each refinement, signed; then RGN's maxshift
  scales down each value at or past 2**roishift.

The passes touch only the coefficients they must: a significance pass
walks the coefficients not yet significant in scan order and decodes those
with a significant neighbour as it stands then, a refinement pass decodes its
decisions with contexts computed for the whole pass at once, and a cleanup
pass decodes the run-mode decisions of whole runs of empty columns at once
while the MQ decoder's state allows it (an MPS without renormalisation
only takes Qe off ``A`` and ``C``).
"""

from __future__ import annotations

import functools
from array import array
from typing import List, Tuple

import numpy as np

# code-block style bits of COD/COC
LAZY, RESET, TERMALL, VSC, PTERM, SEGSYM = 1, 2, 4, 8, 16, 32

# the MQ coder's states (Table C.2): Qe, next on MPS, next on LPS, switch
_QE = (0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801, 0x3001,
       0x2401, 0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801,
       0x2401, 0x2201, 0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1, 0x08A1,
       0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009,
       0x0005, 0x0001, 0x5601)
_NMPS = (1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
         25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45,
         46)
_NLPS = (1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16, 17, 18, 19, 19, 20,
         21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
         43, 46)
_SWITCH = (1, 0, 0, 0, 0, 0, 1) + (0,) * 7 + (1,) + (0,) * 32
# a context's state as 2 * state + MPS
_QE2 = tuple(_QE[s >> 1] for s in range(94))
_NMPS2 = tuple(2 * _NMPS[s >> 1] + (s & 1) for s in range(94))
_NLPS2 = tuple(2 * _NLPS[s >> 1] + ((s & 1) ^ _SWITCH[s >> 1]) for s in range(94))
_M32 = 0xFFFFFFFF

# contexts: zero coding 0-8, sign 9-13, refinement 14-16, run 17, uniform 18
_MR, _AGG, _UNI = 14, 17, 18
_START = [0] * 19
_START[0], _START[_AGG], _START[_UNI] = 2 * 4, 2 * 3, 2 * 46

# a coefficient's state bits, and its neighbours' significance and signs
_SIG, _PI, _MU, _NEG = 1, 2, 4, 8
_W, _E, _N, _S, _NW, _NE, _SW, _SE = 1, 2, 4, 8, 16, 32, 64, 128
_WNEG, _ENEG, _NNEG, _SNEG = 256, 512, 1024, 2048


def _zc(nb: int, orient: int) -> int:
    """The zero-coding context (Table D.1) for neighbour bits ``nb`` in a
    band of orientation 0 (LL), 1 (HL), 2 (LH) or 3 (HH)."""
    h = bool(nb & _W) + bool(nb & _E)
    v = bool(nb & _N) + bool(nb & _S)
    d = bool(nb & _NW) + bool(nb & _NE) + bool(nb & _SW) + bool(nb & _SE)
    if orient == 3:
        hv = h + v
        if d >= 3:
            return 8
        if d == 2:
            return 7 if hv else 6
        if d == 1:
            return (3, 4, 5)[min(hv, 2)]
        return (0, 1, 2)[min(hv, 2)]
    if orient == 1:
        h, v = v, h
    if h == 2:
        return 8
    if h == 1:
        return 7 if v else (6 if d else 5)
    if v:
        return 3 + (v == 2)
    return min(d, 2)


def _sc(nb: int) -> Tuple[int, int]:
    """The sign context and the bit it is XORed with (Table D.3)."""
    def part(sig_a, neg_a, sig_b, neg_b):
        s = (1 - 2 * bool(nb & neg_a) if nb & sig_a else 0) + \
            (1 - 2 * bool(nb & neg_b) if nb & sig_b else 0)
        return max(-1, min(1, s))
    h = part(_W, _WNEG, _E, _ENEG)
    v = part(_N, _NNEG, _S, _SNEG)
    if h == 0:
        return (9 + abs(v), int(v < 0))
    return (12 + h * v, int(h < 0))


_ZC = [array("B", (_zc(nb, o) for nb in range(4096))) for o in range(4)]
_SCX = array("B", (_sc(nb)[0] for nb in range(4096)))
_SXOR = array("B", (_sc(nb)[1] for nb in range(4096)))


class _MQ:
    """The MQ decoder (INITDEC, DECODE, RENORMD and BYTEIN of Annex C, as
    ``mqc.c``) and the raw bit reader, over one segment followed by
    0xFF 0xFF."""

    __slots__ = ("d", "bp", "a", "c", "ct", "cx")

    def __init__(self, cx: List[int]):
        self.cx = cx

    def start(self, seg: bytes) -> None:
        d = self.d = seg + b"\xff\xff"
        c, bp = d[0] << 16, 0
        if d[0] == 0xFF:
            if d[1] > 0x8F:
                c, ct = c + 0xFF00, 8
            else:
                bp, c, ct = 1, c + (d[1] << 9), 7
        else:
            bp, c, ct = 1, c + (d[1] << 8), 8
        self.bp, self.c, self.ct, self.a = bp, c << 7, ct - 7, 0x8000

    def start_raw(self, seg: bytes) -> None:
        self.d, self.bp, self.c, self.ct = seg + b"\xff\xff", 0, 0, 0

    def decode(self, k: int) -> int:
        cx = self.cx
        s = cx[k]
        q = _QE2[s]
        a = self.a - q
        c = self.c
        if (c >> 16) < q:
            if a < q:
                d, cx[k] = s & 1, _NMPS2[s]
            else:
                d, cx[k] = (s & 1) ^ 1, _NLPS2[s]
            a = q
        else:
            c -= q << 16
            if a & 0x8000:
                self.a, self.c = a, c
                return s & 1
            if a < q:
                d, cx[k] = (s & 1) ^ 1, _NLPS2[s]
            else:
                d, cx[k] = s & 1, _NMPS2[s]
        n = 16 - a.bit_length()
        ct = self.ct
        while n:
            if ct == 0:
                bp, dd = self.bp, self.d
                if dd[bp] == 0xFF:
                    if dd[bp + 1] > 0x8F:
                        c, ct = c + 0xFF00, 8
                    else:
                        bp += 1
                        c, ct = c + (dd[bp] << 9), 7
                else:
                    bp += 1
                    c, ct = c + (dd[bp] << 8), 8
                self.bp = bp
            k2 = n if n < ct else ct
            a <<= k2
            c = (c << k2) & _M32
            ct -= k2
            n -= k2
        self.a, self.c, self.ct = a, c, ct
        return d

    def zeros(self, k: int, m: int) -> int:
        """Decode up to ``m`` decisions in context ``k`` and stop after the
        first 1: the number of 0s before it (``m`` where all are 0). Runs of
        MPS decisions (MPS 0) that need no renormalisation are taken at once."""
        done = 0
        cx = self.cx
        while done < m:
            s = cx[k]
            if not s & 1:
                q = _QE2[s]
                run = min((self.a - 0x8000) // q, (self.c >> 16) // q, m - done)
                if run > 0:
                    self.a -= run * q
                    self.c -= (run * q) << 16
                    done += run
                    if done == m:
                        break
            if self.decode(k):
                return done
            done += 1
        return done

    def raw(self) -> int:
        ct = self.ct
        if ct == 0:
            bp, d = self.bp, self.d
            if self.c == 0xFF:
                if d[bp] > 0x8F:
                    self.c, ct = 0xFF, 8
                else:
                    self.c, ct, self.bp = d[bp], 7, bp + 1
            else:
                self.c, ct, self.bp = d[bp], 8, bp + 1
        ct -= 1
        self.ct = ct
        return (self.c >> ct) & 1


class _Shape:
    """The scan order of a w x h code-block in a padded flat array (stride
    w + 2): stripes of four rows, column by column."""

    def __init__(self, w: int, h: int):
        self.w, self.h = w, h
        sw = self.stride = w + 2
        order = []
        for y0 in range(0, h, 4):
            for x in range(w):
                for y in range(y0, min(y0 + 4, h)):
                    order.append((y + 1) * sw + x + 1)
        self.scan = np.array(order, np.int64)
        n = (h + 2) * sw
        rows = np.arange(n) // sw - 1
        self.top = (rows % 4 == 0).tolist()  # first row of a stripe
        self.full = h // 4  # stripes of four rows: the cleanup run mode's
        nf = self.full * 4 * w
        self.cols4 = self.scan[:nf].reshape(-1, 4)
        self.cols4_l = self.cols4.tolist()
        self.tail = order[nf:]
        # column (stripe * w + x) of each padded index in a full stripe
        col = [-1] * n
        for i, p in enumerate(order[:nf]):
            col[p] = i // 4
        self.col = col
        inner = np.zeros(n, bool)
        inner[self.scan] = True
        self.pad = np.flatnonzero(~inner)


@functools.lru_cache(maxsize=64)
def _shape(w: int, h: int) -> _Shape:
    return _Shape(w, h)


class _Block:
    """One code-block's coefficients while its passes run."""

    def __init__(self, w: int, h: int, orient: int, vsc: bool, cx: List[int]):
        sh = self.sh = _shape(w, h)
        n = (h + 2) * sh.stride
        self.st = bytearray(n)
        self.st_np = np.frombuffer(self.st, np.uint8)
        self.st_np[sh.pad] = _SIG  # never visited, never a candidate
        self.nb = array("H", bytes(2 * n))
        self.nb_np = np.frombuffer(self.nb, np.uint16)
        self.mag = np.zeros(n, np.int64)
        self.zc = _ZC[orient]
        self.vsc = vsc
        self.mq = _MQ(cx)
        self.new: List[int] = []

    def _significant(self, p: int, neg: int) -> None:
        """``p`` becomes significant with sign ``neg``: its neighbours'
        bits (a stripe's first row does not tell the row above under VSC)."""
        nb, sw = self.nb, self.sh.stride
        self.st[p] |= _SIG | (_NEG if neg else 0)
        self.new.append(p)
        nb[p - 1] |= _E | (_ENEG if neg else 0)
        nb[p + 1] |= _W | (_WNEG if neg else 0)
        q = p + sw
        nb[q] |= _N | (_NNEG if neg else 0)
        nb[q - 1] |= _NE
        nb[q + 1] |= _NW
        if not (self.vsc and self.sh.top[p]):
            q = p - sw
            nb[q] |= _S | (_SNEG if neg else 0)
            nb[q - 1] |= _SE
            nb[q + 1] |= _SW

    def _sign(self, p: int) -> int:
        lu = self.nb[p]
        return self.mq.decode(_SCX[lu]) ^ _SXOR[lu]

    def _settle(self, value: int) -> None:
        if self.new:
            self.mag[self.new] = value
            self.new = []

    def sigpass(self, one: int, raw: bool) -> None:
        sh, st, nb = self.sh, self.st, self.nb
        scan = sh.scan
        dec, zc, mq = self.mq.decode, self.zc, self.mq
        for p in scan[(self.st_np[scan] & _SIG) == 0].tolist():
            n = nb[p]  # as it stands now: neighbours earlier in this pass count
            if not n:
                continue
            if (mq.raw() if raw else dec(zc[n])):
                self._significant(p, mq.raw() if raw else self._sign(p))
            st[p] |= _PI
        self._settle(one | (one >> 1))

    def refpass(self, one: int, raw: bool) -> None:
        scan = self.sh.scan
        s = self.st_np[scan]
        pos = scan[(s & (_SIG | _PI)) == _SIG]
        if not len(pos):
            return
        if raw:
            bits = [self.mq.raw() for _ in range(len(pos))]
        else:
            ctx = np.where(self.st_np[pos] & _MU, _MR + 2,
                           np.where(self.nb_np[pos] != 0, _MR + 1, _MR)).tolist()
            dec = self.mq.decode
            bits = [dec(k) for k in ctx]
        half = one >> 1
        self.mag[pos] += np.where(np.array(bits, bool), half, -half)
        self.st_np[pos] |= _MU

    def clnpass(self, one: int, segsym: bool) -> None:
        sh, st, nb = self.sh, self.st, self.nb
        dec, zc, mq = self.mq.decode, self.zc, self.mq
        if sh.full:
            s4 = self.st_np[sh.cols4] & (_SIG | _PI)
            free = s4 == 0
            need = np.flatnonzero(free.any(1))
            runnable = (free.all(1) & (self.nb_np[sh.cols4] == 0).all(1))[need]
            todo = need.tolist()
            kinds = bytearray(runnable.astype(np.uint8).tobytes())
            tn = len(todo)
            nxt = np.where(runnable, tn, np.arange(tn))
            run_end = np.minimum.accumulate(nxt[::-1])[::-1].tolist()
            where = dict(zip(todo, range(tn)))
            cols4_l, col_of, w, full = sh.cols4_l, sh.col, sh.w, sh.full
            t = 0
            while t < tn:
                cells = cols4_l[todo[t]]
                first = 0
                if kinds[t]:
                    e = run_end[t]
                    f = kinds.find(0, t, e)
                    if f != -1:
                        e = f
                    z = mq.zeros(_AGG, e - t)
                    t += z
                    if t == e:
                        continue
                    cells = cols4_l[todo[t]]
                    first = dec(_UNI) << 1
                    first |= dec(_UNI)
                    p = cells[first]
                    self._significant(p, self._sign(p))
                    self._revoke(p, t, where, kinds, col_of, w, full)
                    first += 1
                for p in cells[first:]:
                    if not st[p] & (_SIG | _PI) and dec(zc[nb[p]]):
                        self._significant(p, self._sign(p))
                        self._revoke(p, t, where, kinds, col_of, w, full)
                t += 1
        for p in sh.tail:
            if not st[p] & (_SIG | _PI) and dec(zc[nb[p]]):
                self._significant(p, self._sign(p))
        if segsym:
            for _ in range(4):
                dec(_UNI)  # OpenJPEG only warns where these are not 1010
        self._settle(one | (one >> 1))
        self.st_np &= ~np.uint8(_PI)

    def _revoke(self, p, t, where, kinds, col_of, w, full) -> None:
        """The columns ahead whose run mode a new significant ``p`` ends:
        the next column of its stripe and, from a stripe's last row, three
        columns of the next stripe."""
        c = col_of[p]
        x, stripe = c % w, c // w
        cand = [c + 1] if x + 1 < w else []
        if self.sh.top[p + self.sh.stride] and stripe + 1 < full:  # p on a stripe's row 3
            cand += [c + w + dx for dx in (-1, 0, 1) if 0 <= x + dx < w]
        for c2 in cand:
            t2 = where.get(c2)
            if t2 is not None and t2 > t:
                kinds[t2] = 0


def decode_block(segments: List[Tuple[bytes, int]], w: int, h: int, orient: int, numbps: int,
                 style: int, roishift: int) -> np.ndarray:
    """A code-block's values, (h, w) int64, from its segments (bytes, number
    of passes) as OpenJPEG's ``opj_t1_decode_cblk`` and
    ``opj_t1_clbl_decode_processor`` give them before dequantisation.
    Raises ``ValueError`` where OpenJPEG fails on the block."""
    out = np.zeros((h, w), np.int64)
    if not w or not h:
        return out
    bpno = roishift + numbps
    if bpno >= 31:
        raise ValueError(f"code-block with {bpno} bit-planes (OpenJPEG supports fewer than 31)")
    cx = list(_START)
    blk = _Block(w, h, orient, bool(style & VSC), cx)
    mq = blk.mq
    passtype = 2
    for seg, npasses in segments:
        raw = bool(style & LAZY) and passtype < 2 and bpno <= numbps - 4
        if raw:
            mq.start_raw(seg)
        else:
            mq.start(seg)
        for _ in range(npasses):
            if bpno < 1:
                break
            one = 1 << bpno
            if passtype == 0:
                blk.sigpass(one, raw)
            elif passtype == 1:
                blk.refpass(one, raw)
            else:
                blk.clnpass(one, bool(style & SEGSYM))
            if style & RESET and not raw:
                cx[:] = _START
            passtype += 1
            if passtype == 3:
                passtype = 0
                bpno -= 1
    sh = blk.sh
    mag = blk.mag.reshape(h + 2, sh.stride)[1:-1, 1:-1]
    neg = (blk.st_np.reshape(h + 2, sh.stride)[1:-1, 1:-1] & _NEG) != 0
    out = np.where(neg, -mag, mag)
    if roishift:
        if roishift >= 31:
            return np.zeros((h, w), np.int64)
        big = np.abs(out) >= (1 << roishift)
        out = np.where(big, np.sign(out) * (np.abs(out) >> roishift), out)
    return out
