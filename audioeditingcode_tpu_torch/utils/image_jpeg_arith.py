"""Arithmetic-coded JPEG scans (SOF9 sequential, SOF10 progressive) for
``image_io.decode_jpeg``: the QM decoder of T.81 Annex D as libjpeg-turbo
3.1's ``jdarith.c`` runs it, standard library only.

- ``_Decoder.bit``: ``arith_decode``, its 16-bit A register and the C
  register fed a byte at a time (a stuffed 0xFF 0x00 is 0xFF; at a marker,
  zeros), and the 113-state probability estimator of Table
  D.2 plus libjpeg's fixed state 113 for the 0.5 decisions (signs and DC
  refinement bits); each statistics bin holds its state and its MPS.
- Sequential and progressive scans as ``decode_mcu``,
  ``decode_mcu_DC_first``, ``decode_mcu_AC_first``, ``decode_mcu_DC_refine``
  and ``decode_mcu_AC_refine``: DC differences in the 5 contexts of their
  last difference's size, conditioned by the DAC segment's L and U (0 and
  1 where absent); AC values in per-index EOB, zero-run and magnitude bins,
  the magnitude's bins split at the DAC segment's Kx (5 where absent); a
  refinement's correction bits where a coefficient is already non-zero and
  new +-1 coefficients past them.
- Each scan and each restart interval starts with zeroed statistics, DC
  predictions and contexts, and a fresh decoder; restart markers are read
  by number (``image_jpeg_stream.Source.restart``). A magnitude or a run
  past the block or band (damaged data) sets libjpeg's ``ct = -1``: the
  block keeps what it has, and nothing more is decoded up to the next
  restart marker. Past the 64 KiB PIL has handed libjpeg, the decoder
  fails, as libjpeg's does (it cannot wait for more data).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .image_jpeg_stream import Source

# (Qe << 16) | (next MPS << 8) | (switch << 7) | next LPS, T.81 Table D.2,
# then state 113: the fixed 0.5 estimate
_QE = (0x5a1d, 0x2586, 0x1114, 0x080b, 0x03d8, 0x01da, 0x00e5, 0x006f, 0x0036, 0x001a, 0x000d,
       0x0006, 0x0003, 0x0001, 0x5a7f, 0x3f25, 0x2cf2, 0x207c, 0x17b9, 0x1182, 0x0cef, 0x09a1,
       0x072f, 0x055c, 0x0406, 0x0303, 0x0240, 0x01b1, 0x0144, 0x00f5, 0x00b7, 0x008a, 0x0068,
       0x004e, 0x003b, 0x002c, 0x5ae1, 0x484c, 0x3a0d, 0x2ef1, 0x261f, 0x1f33, 0x19a8, 0x1518,
       0x1177, 0x0e74, 0x0bfb, 0x09f8, 0x0861, 0x0706, 0x05cd, 0x04de, 0x040f, 0x0363, 0x02d4,
       0x025c, 0x01f8, 0x01a4, 0x0160, 0x0125, 0x00f6, 0x00cb, 0x00ab, 0x008f, 0x5b12, 0x4d04,
       0x412c, 0x37d8, 0x2fe8, 0x293c, 0x2379, 0x1edf, 0x1aa9, 0x174e, 0x1424, 0x119c, 0x0f6b,
       0x0d51, 0x0bb6, 0x0a40, 0x5832, 0x4d1c, 0x438e, 0x3bdd, 0x34ee, 0x2eae, 0x299a, 0x2516,
       0x5570, 0x4ca9, 0x44d9, 0x3e22, 0x3824, 0x32b4, 0x2e17, 0x56a8, 0x4f46, 0x47e5, 0x41cf,
       0x3c3d, 0x375e, 0x5231, 0x4c0f, 0x4639, 0x415e, 0x5627, 0x50e7, 0x4b85, 0x5597, 0x504f,
       0x5a10, 0x5522, 0x59eb, 0x5a1d)
_NLPS = (1, 14, 16, 18, 20, 23, 25, 28, 30, 33, 35, 9, 10, 12, 15, 36, 38, 39, 40, 42, 43, 45,
         46, 48, 49, 51, 52, 54, 56, 57, 59, 60, 62, 63, 32, 33, 37, 64, 65, 67, 68, 69, 70, 72,
         73, 74, 75, 77, 78, 79, 48, 50, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 61, 61, 65, 80,
         81, 82, 83, 84, 86, 87, 87, 72, 72, 74, 74, 75, 77, 77, 80, 88, 89, 90, 91, 92, 93, 86,
         88, 95, 96, 97, 99, 99, 93, 95, 101, 102, 103, 104, 99, 105, 106, 107, 103, 105, 108,
         109, 110, 111, 110, 112, 112, 113)
_NMPS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 13, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
         25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 9, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46,
         47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 32, 65, 66, 67, 68,
         69, 70, 71, 72, 73, 74, 75, 76, 77, 78, 79, 48, 81, 82, 83, 84, 85, 86, 87, 71, 89, 90,
         91, 92, 93, 94, 86, 96, 97, 98, 99, 100, 93, 102, 103, 104, 99, 106, 107, 103, 109,
         107, 111, 109, 111, 113)
_SWITCH = (0, 14, 36, 64, 80, 88, 95, 105, 110, 112)
ARITAB = tuple((_QE[i] << 16) | (_NMPS[i] << 8) | ((i in _SWITCH) << 7) | _NLPS[i]
               for i in range(114))
DC_BINS, AC_BINS, FIXED = 64, 256, 113


class _Overflow(Exception):
    """A magnitude or a run past the block: libjpeg sets ``ct = -1`` and
    decodes nothing more up to the next restart marker."""


class _Decoder:
    """``arith_decode`` over the stream from the source's position: its
    bytes as ``get_byte`` takes them (a stuffed 0xFF 0x00 is 0xFF; at a
    marker, which it keeps unread, and past it, zeros)."""

    def __init__(self, src: Source):
        self.src = src
        self.c = 0
        self.a = 0
        self.ct = -16

    def _byte(self) -> int:
        src = self.src
        if src.unread:
            return 0
        d = src.byte()
        if d != 0xFF:
            return d
        while d == 0xFF:
            d = src.byte()
        if d == 0:
            return 0xFF
        src.unread = d
        return 0

    def bit(self, st: List[int], i: int) -> int:
        """Decode one decision with statistics bin ``st[i]``."""
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                c = (c << 8) | self._byte()
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                a = qe
                st[i] = (sv & 0x80) ^ nm
            else:
                a = qe
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


def _magnitude(dec: _Decoder, st: List[int], i: int, x: int) -> int:
    """Figures F.23 and F.24 for an AC value: the magnitude category from
    bin ``i`` (twice there, then bins from ``x``), then its bits; the value
    minus one."""
    m = dec.bit(st, i)
    if m and dec.bit(st, i):
        m <<= 1
        i = x
        while dec.bit(st, i):
            m <<= 1
            if m == 0x8000:
                raise _Overflow
            i += 1
    v = m
    i += 14
    m >>= 1
    while m:
        if dec.bit(st, i):
            v |= m
        m >>= 1
    return v


def _dc_diff(dec: _Decoder, st: List[int], ctx: List[int], ci: int,
             lu: Tuple[int, int]) -> int:
    """Figure F.19: a DC difference in context ``ctx[ci]``, which it updates."""
    s0 = ctx[ci]
    if not dec.bit(st, s0):
        ctx[ci] = 0
        return 0
    sign = dec.bit(st, s0 + 1)
    i = s0 + 2 + sign
    m = dec.bit(st, i)
    if m:
        i = 20
        while dec.bit(st, i):
            m <<= 1
            if m == 0x8000:
                raise _Overflow
            i += 1
    low, up = lu
    if m < (1 << low) >> 1:
        ctx[ci] = 0
    elif m > (1 << up) >> 1:
        ctx[ci] = 12 + sign * 4
    else:
        ctx[ci] = 4 + sign * 4
    v = m
    i += 14
    m >>= 1
    while m:
        if dec.bit(st, i):
            v |= m
        m >>= 1
    v += 1
    return -v if sign else v


def _ac_value(dec: _Decoder, st: List[int], i: int, k: int, kx: int,
              fixed: List[int]) -> int:
    """Figures F.21-F.24 for an AC value whose zero-run bin was ``i - 2``."""
    sign = dec.bit(fixed, 0)
    v = _magnitude(dec, st, i, 189 if k <= kx else 217) + 1
    return -v if sign else v


def _wrap(v: int) -> int:
    return ((v + 32768) & 65535) - 32768


def decode_scan(frame: dict, src: Source, members, restart: int, per_mcu: int, slots,
                coefs: List[List[int]], ss: int, se: int, ah: int, al: int,
                cond: Dict[Tuple[int, int], object]) -> None:
    """Decode one arithmetic-coded scan from ``src`` into ``coefs`` (zigzag
    order). ``slots``: the scan's blocks, (component, first coefficient
    index, DC table, AC table) each, in MCU order; ``members``: its
    components. Restart markers are read as libjpeg reads them
    (``Source.restart``), and libjpeg's arithmetic decoder cannot wait for
    data (``Source.arith``)."""
    progressive = frame["progressive"]
    natural_se = se if progressive else 63
    chunk = restart * per_mcu if restart else len(slots)
    src.arith = True
    try:
        for n, start in enumerate(range(0, len(slots), chunk)):
            if n:
                src.restart((n - 1) & 7)
            try:
                _interval(_Decoder(src), frame, members, slots[start:start + chunk], coefs,
                          progressive, natural_se, ss, se, ah, al, cond)
            except _Overflow:
                pass
    finally:
        src.arith = False


def _interval(dec: _Decoder, frame: dict, members, slots, coefs: List[List[int]],
              progressive: bool, natural_se: int, ss: int, se: int, ah: int, al: int,
              cond) -> None:
    """One restart interval's blocks, from zeroed statistics, DC predictions
    and contexts."""
    dc_stats = {t: [0] * DC_BINS for _, t, _ in members}
    ac_stats = {t: [0] * AC_BINS for _, _, t in members}
    fixed = [FIXED]
    last = [0] * len(frame["comps"])
    ctx = [0] * len(frame["comps"])
    for ci, base, dct, act in slots:
        out = coefs[ci]
        if not progressive or (ss == 0 and ah == 0):  # DC (first)
            d = _dc_diff(dec, dc_stats[dct], ctx, ci, cond.get((0, dct), (0, 1)))
            last[ci] = (last[ci] + d) & 0xFFFF
            out[base] = _wrap(last[ci] << al) if progressive else _wrap(last[ci])
            if progressive:
                continue
        elif ss == 0:  # DC refinement: the next bit, at a fixed estimate
            if dec.bit(fixed, 0):
                out[base] |= 1 << al
            continue
        st = ac_stats[act]
        kx = cond.get((1, act), 5)
        if not progressive or ah == 0:  # AC (first)
            k = 1 if not progressive else ss
            while k <= natural_se:
                i = 3 * (k - 1)
                if dec.bit(st, i):  # end of block
                    break
                while not dec.bit(st, i + 1):
                    i += 3
                    k += 1
                    if k > natural_se:
                        raise _Overflow
                v = _ac_value(dec, st, i + 2, k, kx, fixed)
                out[base + k] = _wrap(v << al) if progressive else v
                k += 1
            continue
        p1, m1 = 1 << al, -1 << al  # AC refinement
        kex = se
        while kex > 0 and not out[base + kex]:
            kex -= 1
        k = ss
        while k <= se:
            i = 3 * (k - 1)
            if k > kex and dec.bit(st, i):
                break
            while True:
                c = out[base + k]
                if c:
                    if dec.bit(st, i + 2):
                        out[base + k] = c + (m1 if c < 0 else p1)
                    break
                if dec.bit(st, i + 1):
                    out[base + k] = m1 if dec.bit(fixed, 0) else p1
                    break
                i += 3
                k += 1
                if k > se:
                    raise _Overflow
            k += 1
