"""VP8 key-frame decoding (lossy WebP) for ``image_webp``, numpy and the
standard library only, bit-exact with libwebp 1.6, which PIL 12.1 calls.

The bitstream is RFC 6386's, decoded as libwebp's ``vp8_dec.c``,
``tree_dec.c``, ``quant_dec.c`` and ``frame_dec.c`` decode it:

- the boolean decoder, loading bytes only when its window needs them, so
  that "past the end" means what libwebp's ``eof_`` means: a macroblock
  that reads past its partition raises;
- the frame header, segment header and map, filter header with mode and
  reference deltas, 1/2/4/8 token partitions, the quantiser with its five
  deltas and per-segment values (libwebp's ``kDcTable``/``kAcTable``, Y2 AC
  as ``x * 101581 >> 16``, at least 8), coefficient probability updates
  and the skip probability;
- intra modes: 16x16 (DC, V, H, TM; DC without top and/or left at the
  frame's edges), 4x4 B-modes with their top and left contexts (libwebp's
  mode order and ``kBModesProba``), chroma 8x8; borders of 127 above the
  frame and 129 left of it (129 above-left, but 127 in the top row), the
  above-right pixels of a macroblock's right column of 4x4 blocks taken
  from the macroblock row above (its last pixel repeated at the right
  edge);
- coefficient tokens with their contexts, dequantisation, the inverse
  Walsh-Hadamard transform of the Y2 block and the inverse DCT
  (``TransformOne``: 20091 and 35468 in 16-bit fixed point, the residual
  ``>> 3`` added to the prediction and clipped), all residuals at once in
  numpy;
- the normal and simple loop filters, macroblock by macroblock in
  libwebp's order (left edge, inner vertical edges, top edge, inner
  horizontal edges), with sharpness, per-segment levels and the B_PRED
  mode and intra reference deltas; inner edges only where the macroblock
  is 4x4-predicted or has a non-zero coefficient; no filtering at all when
  the frame's level is 0, as libwebp. Intra prediction reads the pixels
  before filtering.

Then libwebp's output path for RGBA: "fancy" upsampling of the 4:2:0
chroma (``upsampling.c``: each output pixel from its nearest chroma sample
and three neighbours, the 9-3-3-1 weights applied in two rounded steps,
rows in pairs; the first row, and the last of an even height, from one
chroma row) and the fixed-point YUV -> RGB of ``yuv.h`` (14-bit constants,
``>> 6`` and clipped).

Every feature is held against PIL on images PIL's encoder writes, except
two PIL's encoder does not write: several token partitions and the simple
loop filter, which follow the RFC and libwebp's code as read.
"""

from __future__ import annotations

from functools import partial
from typing import List

import numpy as np

# libwebp's quant_dec.c tables (RFC 6386 dc_qlookup, ac_qlookup)
_DC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20, 21, 21, 22, 22,
    23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42,
    43, 44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64,
    65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86,
    87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118, 122,
    124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157)
_AC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
    28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50,
    51, 52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88,
    90, 92, 94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131,
    134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189,
    193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269,
    274, 279, 284)
# RFC 6386 default_coeff_probs [4][8][3][11]
_COEF_PROBS = bytes.fromhex(
    "808080808080808080808080808080808080808080808080808080808080808080fd88feffe4db8080808080"
    "bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff8080800162f8ffece2ffff808080b585eefeddeaff9a808080"
    "4e86caf7c6b4ffdb80808001b9f9fff3ff8080808080b896f7ffece080808080804d6ed8ffece68080808080"
    "0165fbfff1ff8080808080aa8bf1fcecd1ffff8080802574c4f3e4ffffff80808001ccfefff5ff8080808080"
    "cfa0faffee8080808080806667e7ffd3ab80808080800198fcfff0ff8080808080b187f3ffeae18080808080"
    "5081d3ffc2e080808080800101ff8080808080808080f601ff8080808080808080ff80808080808080808080"
    "c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f92d095a7dda2ffdf800195f1ffdde0ffff808080"
    "b88deafddedcffc78080805163b5f2b0bef9caffff800181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080"
    "175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080802c82c9fdcdc0ffff808080"
    "0184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc780808001b6f9ffe8eb8080808080"
    "7c8ff1ffe3ea8080808080234db5fbc1d3ffcd808080019df7ffece7ffff808080798debffe1e3ffff808080"
    "2d63bcfbc3d9ffe08080800101fbffd5ff8080808080cb01f8ffff8080808080808901b1ffe0ff8080808080"
    "fd09f8fbcfd0ffc0808080af0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080"
    "ef5af4fad3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933dbffc4ba8080808080"
    "452ebeefc9daffe480808001bffbffff808080808080dfa5f9ffd5ff80808080808d7cf8ffff808080808080"
    "0110f8ffff808080808080be24e6ffecff80808080809501ff808080808080808001e2ff8080808080808080"
    "f7c0ff8080808080808080f080ff80808080808080800186fcffff808080808080d53efaffff808080808080"
    "375dff8080808080808080808080808080808080808080808080808080808080808080808080808080808080"
    "ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd8800170e6fac7bff79fffff80"
    "a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7f9dcffff807c4abff3b7c1faddffff80"
    "184782db9aaaf3b6ffff8001b6e1f9dbf0ffe08080809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff80"
    "0151e6fccccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8ffd8d58080808080"
    "a8aff6fcebcdffff8080802f74d7ffd3d4ffff8080800179ecfdd4d6ffff8080808d54d5fcc9caffdb808080"
    "2a50a0f0a2b9ffcd8080800101ff8080808080808080f401ff8080808080808080ee01ff8080808080808080")
# RFC 6386 coeff_update_probs [4][8][3][11]
_COEF_UPDATE_PROBS = bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0f6ffffffffffffffffff"
    "dff1fcfffffffffffffffff9fdfdfffffffffffffffffff4fcffffffffffffffffeafefeffffffffffffffff"
    "fdfffffffffffffffffffffff6feffffffffffffffffeffdfefffffffffffffffffefffeffffffffffffffff"
    "fff8fefffffffffffffffffbfffefffffffffffffffffffffffffffffffffffffffffdfeffffffffffffffff"
    "fbfefefffffffffffffffffefffefffffffffffffffffffefdfffefffffffffffffafffefffeffffffffffff"
    "feffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "d9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafaf1fafdfffdfefffffffffeffffffffffffffffff"
    "dffefeffffffffffffffffeefdfefefffffffffffffffff8fefffffffffffffffff9feffffffffffffffffff"
    "fffffffffffffffffffffffffdfffffffffffffffffff7feffffffffffffffffffffffffffffffffffffffff"
    "fffdfefffffffffffffffffcfffffffffffffffffffffffffffffffffffffffffffffefeffffffffffffffff"
    "fdfffffffffffffffffffffffffffffffffffffffffffffefdfffffffffffffffffaffffffffffffffffffff"
    "feffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "bafbfaffffffffffffffffeafbf4fefffffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffff"
    "ecfdfefffffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefeffffffffffffffff"
    "fffffffffffffffffffffffffefffffffffffffffffffefefffffffffffffffffffeffffffffffffffffffff"
    "fffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "f8fffffffffffffffffffffafefcfefffffffffffffff8fef9fdfffffffffffffffffdfdffffffffffffffff"
    "f6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcfffffffffffffffff8fefdffffffffffffffff"
    "fdfffefefffffffffffffffffbfefffffffffffffffff5fbfefffffffffffffffffdfdfeffffffffffffffff"
    "fffbfdfffffffffffffffffcfdfefffffffffffffffffffefffffffffffffffffffffcffffffffffffffffff"
    "f9fffefffffffffffffffffffffefffffffffffffffffffffdfffffffffffffffffaffffffffffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff")
# RFC 6386 kf_bmode_probs [10][10][9], above and left modes in libwebp's
# order: DC, TM, VE, HE, RD, VR, LD, VL, HD, HU
_BMODE_PROBS = bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98721a11a32cc3150a"
    "ad791850c31a3e2c405590470a26abd590221aaa2e371388a021ce473f14087272d00c09e251280b60b6541d"
    "102486b7598962656aa59448bb64829d6f204b504266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a6"
    "31179d412669a033341f7380684f0c1bd9ff5711075744472c72330fba172f290e6eb6b71511c2422d1966c5"
    "bd171216585893962a2e2dc4cd2b61b775552623b33d2735c8571a152be8ab3822336872661d5d4d271c55ab"
    "3aa55a6240221674ce17222ba6496b36201a3301512b1f44196a1640ab24e1722213156684bc104c7c3e124e"
    "5f5539323033c165239fd76f592e6f3c941facdbe415126f70714d55b3ff267872282a01c4f5d10a196d582b"
    "1d8ca6d5252b9a3d3f1e9b432d4401d16450082b9a01331a478e4e4e10ff8022c5ab29280566d3b70401dd33"
    "3211a8d1c01719528a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba65d499a282815748fd12227af"
    "2f0f10b722df312db72e1121b706620f20b7392e16188001361125412049731c801780cd2803097333c01206"
    "df572509733b4d40152f68372cda09363582e2405a46cd2829171a39363970b8052926a6d51e221a8598740a"
    "2086271335dd1a722049ff1f0941ea020f0176494b200c33c0ffa02b33581f2343665537ba553815176f3bcd"
    "2d25c03726467c49660122627d622a58685575af525f543559806471652d4b4f7b2f338051ab013911054766"
    "3935293126210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a558065c41a39120a66"
    "66d522142b75140f24a38044011a663d472522351ff3c0453c472649771cde25442d8022012f0bf5ab3e1113"
    "469255373e46252b259a64a355a0013f095c881c4020c9554b0f090940ffb8771056061c0540ff19f8013808"
    "118489ff3774803a0f145287391a7928a4321f899a851923da33672c83837b1f069e5628408794e02db78016"
    "1a1183f09a0e01d12d10155b40de0701c53815279b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab"
    "120b073f90ab0404f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033291420654b808b76927480"
    "5538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e9224131eabff611b148a2d3d3edb0151"
    "bc4020291475978e1415a370130c3dc380300418")
_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CAT = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
        (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# libwebp's modes: 16x16 and chroma use the first four
_DC, _TM, _VE, _HE, _RD, _VR, _LD, _VL, _HD, _HU = range(10)
# shifts that bring a range of 1..127 back to 128..255
_NORM = [0] + [7 - v.bit_length() + 1 for v in range(1, 128)]


class _Bool:
    """RFC 6386's boolean decoder: ``value`` holds the 8-bit window above
    ``count`` bits read ahead; bytes are loaded when the window needs them,
    past the end as zeros with ``eof`` set (libwebp's ``VP8LoadFinalBytes``)."""

    def __init__(self, data: bytes):
        self.data, self.pos, self.n = data, 0, len(data)
        self.value, self.count, self.range = 0, -8, 255
        self.eof = False

    def _load(self) -> None:
        if self.pos + 6 <= self.n:
            chunk = int.from_bytes(self.data[self.pos:self.pos + 6], "big")
            self.value = (self.value << 48) | chunk
            self.pos += 6
            self.count += 48
        elif self.pos < self.n:
            self.value = (self.value << 8) | self.data[self.pos]
            self.pos += 1
            self.count += 8
        elif not self.eof:
            self.value <<= 8
            self.count += 8
            self.eof = True
        else:
            self.count = 0

    def bit(self, prob: int) -> int:
        if self.count < 0:
            self._load()
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << self.count
        if self.value >= big:
            self.range -= split
            self.value -= big
            bit = 1
        else:
            self.range = split
            bit = 0
        if self.range < 128:
            s = _NORM[self.range]
            self.range <<= s
            self.count -= s
        return bit

    def value_bits(self, bits: int) -> int:
        v = 0
        for _ in range(bits):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, bits: int) -> int:
        v = self.value_bits(bits)
        return -v if self.bit(128) else v


def _large(bit, p) -> int:
    """``GetLargeValue``: a coefficient magnitude of 2 or more."""
    if not bit(p[3]):
        return 2 if not bit(p[4]) else 3 + bit(p[5])
    if not bit(p[6]):
        if not bit(p[7]):
            return 5 + bit(159)
        return 7 + 2 * bit(165) + bit(145)
    b1 = bit(p[8])
    cat = 2 * b1 + bit(p[9 + b1])
    v = 0
    for prob in _CAT[cat]:
        v = 2 * v + bit(prob)
    return v + 3 + (8 << cat)


def _coeffs(bit, prob, ctx: int, dq, n: int, out: List[int], base: int) -> int:
    """``GetCoeffs``: one block's tokens from position ``n``, dequantised
    into ``out[base:base + 16]`` (raster order); returns the position after
    the last token, as libwebp."""
    p = prob[n][ctx]
    while n < 16:
        if not bit(p[0]):
            return n
        while not bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = prob[n][0]
        if not bit(p[2]):
            v = 1
            p = prob[n + 1][1]
        else:
            v = _large(bit, p)
            p = prob[n + 1][2]
        if bit(128):
            v = -v
        out[base + _ZIGZAG[n]] = v * dq[n > 0]
        n += 1
    return 16


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def _idct(c: np.ndarray) -> np.ndarray:
    """``TransformOne`` without the prediction: (N, 16) raster coefficients
    -> (N, 4, 4) residuals, each ``>> 3``."""
    x = c.reshape(-1, 4, 4).astype(np.int64)
    a, b = x[:, 0] + x[:, 2], x[:, 0] - x[:, 2]
    cc, d = _mul2(x[:, 1]) - _mul1(x[:, 3]), _mul1(x[:, 1]) + _mul2(x[:, 3])
    t = np.stack([a + d, b + cc, b - cc, a - d], axis=1)  # (N, out row i, column)
    dc = t[:, :, 0] + 4
    a, b = dc + t[:, :, 2], dc - t[:, :, 2]
    cc, d = _mul2(t[:, :, 1]) - _mul1(t[:, :, 3]), _mul1(t[:, :, 1]) + _mul2(t[:, :, 3])
    return np.stack([a + d, b + cc, b - cc, a - d], axis=2) >> 3


def _iwht(c: np.ndarray) -> np.ndarray:
    """``TransformWHT``: (N, 16) Y2 coefficients -> (N, 16) DC values of
    the 16 luma blocks in raster order."""
    x = c.reshape(-1, 4, 4).astype(np.int64)
    a0, a1 = x[:, 0] + x[:, 3], x[:, 1] + x[:, 2]
    a2, a3 = x[:, 1] - x[:, 2], x[:, 0] - x[:, 3]
    t = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], axis=1)  # (N, row, column)
    dc = t[:, :, 0] + 3
    a0, a1 = dc + t[:, :, 3], t[:, :, 1] + t[:, :, 2]
    a2, a3 = t[:, :, 1] - t[:, :, 2], dc - t[:, :, 3]
    return (np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], axis=2) >> 3).reshape(-1, 16)


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4(mode: int, t: List[int], l: List[int]) -> List[List[int]]:
    """A 4x4 B-mode prediction from ``t`` (above-left, 4 above, 4
    above-right) and ``l`` (4 left): rows of 4 (libwebp's ``*4_C``)."""
    x, a, b, c, d, e, f, g, h = t
    i, j, k, m = l
    if mode == _DC:
        v = (a + b + c + d + i + j + k + m + 4) >> 3
        return [[v] * 4 for _ in range(4)]
    if mode == _TM:
        return [[min(255, max(0, lv + tv - x)) for tv in (a, b, c, d)] for lv in l]
    if mode == _VE:
        row = [_avg3(x, a, b), _avg3(a, b, c), _avg3(b, c, d), _avg3(c, d, e)]
        return [row] * 4
    if mode == _HE:
        return [[v] * 4 for v in (_avg3(x, i, j), _avg3(i, j, k), _avg3(j, k, m),
                                  _avg3(k, m, m))]
    if mode == _RD:
        s = [_avg3(j, k, m), _avg3(i, j, k), _avg3(x, i, j), _avg3(a, x, i), _avg3(b, a, x),
             _avg3(c, b, a), _avg3(d, c, b)]
        return [[s[3 - r + col] for col in range(4)] for r in range(4)]
    if mode == _LD:
        s = [_avg3(a, b, c), _avg3(b, c, d), _avg3(c, d, e), _avg3(d, e, f), _avg3(e, f, g),
             _avg3(f, g, h), _avg3(g, h, h)]
        return [[s[r + col] for col in range(4)] for r in range(4)]
    if mode == _VR:
        return [[_avg2(x, a), _avg2(a, b), _avg2(b, c), _avg2(c, d)],
                [_avg3(i, x, a), _avg3(x, a, b), _avg3(a, b, c), _avg3(b, c, d)],
                [_avg3(j, i, x), _avg2(x, a), _avg2(a, b), _avg2(b, c)],
                [_avg3(k, j, i), _avg3(i, x, a), _avg3(x, a, b), _avg3(a, b, c)]]
    if mode == _VL:
        return [[_avg2(a, b), _avg2(b, c), _avg2(c, d), _avg2(d, e)],
                [_avg3(a, b, c), _avg3(b, c, d), _avg3(c, d, e), _avg3(d, e, f)],
                [_avg2(b, c), _avg2(c, d), _avg2(d, e), _avg3(e, f, g)],
                [_avg3(b, c, d), _avg3(c, d, e), _avg3(d, e, f), _avg3(f, g, h)]]
    if mode == _HD:
        return [[_avg2(i, x), _avg3(i, x, a), _avg3(x, a, b), _avg3(a, b, c)],
                [_avg2(j, i), _avg3(j, i, x), _avg2(i, x), _avg3(i, x, a)],
                [_avg2(k, j), _avg3(k, j, i), _avg2(j, i), _avg3(j, i, x)],
                [_avg2(m, k), _avg3(m, k, j), _avg2(k, j), _avg3(k, j, i)]]
    # _HU
    return [[_avg2(i, j), _avg3(i, j, k), _avg2(j, k), _avg3(j, k, m)],
            [_avg2(j, k), _avg3(j, k, m), _avg2(k, m), _avg3(k, m, m)],
            [_avg2(k, m), _avg3(k, m, m), m, m],
            [m, m, m, m]]


def _pred_block(mode: int, top: np.ndarray, left: np.ndarray, corner: int, size: int,
                has_top: bool, has_left: bool) -> np.ndarray:
    """A 16x16 or 8x8 prediction (DC, TM, V, H); DC without an edge as
    libwebp's ``CheckMode`` picks it."""
    if mode == _DC:
        shift = 4 if size == 16 else 3
        if has_top and has_left:
            v = (int(top.sum()) + int(left.sum()) + size) >> (shift + 1)
        elif has_top:
            v = (int(top.sum()) + size // 2) >> shift
        elif has_left:
            v = (int(left.sum()) + size // 2) >> shift
        else:
            v = 128
        return np.full((size, size), v, np.int64)
    if mode == _TM:
        return np.clip(top[None, :] + left[:, None] - corner, 0, 255)
    if mode == _VE:
        return np.repeat(top[None, :], size, axis=0)
    return np.repeat(left[:, None], size, axis=1)


# ------------------------------------------------------------- loop filter
def _filter_common(p1, p0, q0, q1, outer: bool):
    """``DoFilter2`` (outer taps) or the first half of ``DoFilter4``:
    (new p0, new q0, a1)."""
    a = 3 * (q0 - p0) + (np.clip(p1 - q1, -128, 127) if outer else 0)
    a1 = np.clip((a + 4) >> 3, -16, 15)
    a2 = np.clip((a + 3) >> 3, -16, 15)
    return np.clip(p0 + a2, 0, 255), np.clip(q0 - a1, 0, 255), a1


def _edge(px: np.ndarray, thresh, ithresh, hev_t, mb_edge: bool) -> None:
    """``FilterLoop26`` (macroblock edge) or ``FilterLoop24`` (inner edge)
    on ``px`` (8, n): rows p3 p2 p1 p0 q0 q1 q2 q3, in place; the
    thresholds one per column, or one for all."""
    p3, p2, p1, p0, q0, q1, q2, q3 = (px[r].astype(np.int64) for r in range(8))
    need = (4 * np.abs(p0 - q0) + np.abs(p1 - q1)) <= 2 * thresh + 1
    for u, v in ((p3, p2), (p2, p1), (p1, p0), (q3, q2), (q2, q1), (q1, q0)):
        need &= np.abs(u - v) <= ithresh
    if not need.any():
        return
    hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
    n2p0, n2q0, _ = _filter_common(p1, p0, q0, q1, True)
    out = [p2, p1, p0, q0, q1, q2]
    if mb_edge:
        a = np.clip(3 * (q0 - p0) + np.clip(p1 - q1, -128, 127), -128, 127)
        a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        soft = [np.clip(p2 + a3, 0, 255), np.clip(p1 + a2, 0, 255), np.clip(p0 + a1, 0, 255),
                np.clip(q0 - a1, 0, 255), np.clip(q1 - a2, 0, 255), np.clip(q2 - a3, 0, 255)]
    else:
        n4p0, n4q0, a1 = _filter_common(p1, p0, q0, q1, False)
        a3 = (a1 + 1) >> 1
        soft = [p2, np.clip(p1 + a3, 0, 255), n4p0, n4q0, np.clip(q1 - a3, 0, 255), q2]
    hard = [p2, p1, n2p0, n2q0, q1, q2]
    for r in range(6):
        px[r + 1] = np.where(need, np.where(hev, hard[r], soft[r]), out[r])


def _simple_edge(px: np.ndarray, thresh) -> None:
    """The simple filter (``NeedsFilter`` + ``DoFilter2``) on ``px`` (4,
    n): rows p1 p0 q0 q1, in place."""
    p1, p0, q0, q1 = (px[r].astype(np.int64) for r in range(4))
    need = (4 * np.abs(p0 - q0) + np.abs(p1 - q1)) <= 2 * thresh + 1
    n2p0, n2q0, _ = _filter_common(p1, p0, q0, q1, True)
    px[1] = np.where(need, n2p0, p0)
    px[2] = np.where(need, n2q0, q0)


def _edges(plane: np.ndarray, ys: np.ndarray, xs: np.ndarray, size: int, offset: int,
           vertical: bool, half: int, fn, *params) -> None:
    """``fn`` on one edge of each macroblock (ys, xs) of ``plane``, all at
    once: the edge ``offset`` pixels into the block of ``size`` (a column
    edge, filtered across, unless ``vertical``), ``half`` pixels each side;
    ``params`` hold one value per macroblock."""
    if not len(ys):
        return
    k, span = len(ys), np.arange(2 * half) - half
    along = np.arange(size)
    if vertical:  # rows across the edge, columns along it
        rows = (ys * size + offset)[:, None] + span
        cols = (xs * size)[:, None] + along
        idx = rows[:, :, None], cols[:, None, :]
        px = plane[idx].transpose(1, 0, 2).reshape(2 * half, k * size)
    else:
        rows = (ys * size)[:, None] + along
        cols = (xs * size + offset)[:, None] + span
        idx = rows[:, :, None], cols[:, None, :]
        px = plane[idx].reshape(k * size, 2 * half).T.copy()
    fn(px, *(np.repeat(p, size) for p in params))
    if vertical:
        plane[idx] = px.reshape(2 * half, k, size).transpose(1, 0, 2)
    else:
        plane[idx] = px.T.reshape(k, size, 2 * half)


def _loop_filter(planes, mbw: int, mbh: int, info, simple: bool) -> None:
    """libwebp's ``DoFilter`` over every macroblock. libwebp goes macroblock
    by macroblock, row by row; a macroblock's edges touch its own pixels
    and the four rows above and columns to the left only, so the
    macroblocks of one wave x + 2y = t overlap none of each other, and
    filtering wave after wave keeps every overlapping pair in libwebp's
    order: each wave's left edges, inner column edges, top edges and inner
    row edges in turn, all of its macroblocks at once."""
    y_plane, u_plane, v_plane = planes
    grid = [[info[y][x] or (0, 0, 0, False) for x in range(mbw)] for y in range(mbh)]
    limit, ilevel, hev_t, inner = (np.array([[g[i] for g in row] for row in grid])
                                   for i in range(4))
    for t in range(mbw + 2 * mbh - 2):
        ys = np.arange(mbh)
        xs = t - 2 * ys
        keep = (xs >= 0) & (xs < mbw)
        ys, xs = ys[keep], xs[keep]
        keep = limit[ys, xs] > 0
        ys, xs = ys[keep], xs[keep]
        lim, il, hv, inn = (a[ys, xs] for a in (limit, ilevel, hev_t, inner))
        left, top = xs > 0, ys > 0
        if simple:
            _edges(y_plane, ys[left], xs[left], 16, 0, False, 2, _simple_edge, lim[left] + 4)
            for k in (4, 8, 12):
                _edges(y_plane, ys[inn], xs[inn], 16, k, False, 2, _simple_edge, lim[inn])
            _edges(y_plane, ys[top], xs[top], 16, 0, True, 2, _simple_edge, lim[top] + 4)
            for k in (4, 8, 12):
                _edges(y_plane, ys[inn], xs[inn], 16, k, True, 2, _simple_edge, lim[inn])
            continue
        mb_edge, inner_edge = partial(_edge, mb_edge=True), partial(_edge, mb_edge=False)
        for vertical, edge in ((False, left), (True, top)):
            mb = (lim[edge] + 4, il[edge], hv[edge])
            at_inner = (lim[inn], il[inn], hv[inn])
            _edges(y_plane, ys[edge], xs[edge], 16, 0, vertical, 4, mb_edge, *mb)
            for c in (u_plane, v_plane):
                _edges(c, ys[edge], xs[edge], 8, 0, vertical, 4, mb_edge, *mb)
            for k in (4, 8, 12):
                _edges(y_plane, ys[inn], xs[inn], 16, k, vertical, 4, inner_edge, *at_inner)
            for c in (u_plane, v_plane):
                _edges(c, ys[inn], xs[inn], 8, 4, vertical, 4, inner_edge, *at_inner)


# ---------------------------------------------------------------- output
def fancy_upsample(chroma: np.ndarray, height: int, width: int) -> np.ndarray:
    """libwebp's ``UpsampleRgbaLinePair`` on one (ceil(H/2), ceil(W/2))
    chroma plane -> (H, W): for output row y its nearest chroma row N and
    the other F (row 0, and the last of an even H, use one row twice); per
    column its nearest sample and the neighbour, weighted 9-3-3-1 in two
    rounded steps, the first column (and the last of an even W) 3-1."""
    c = chroma.astype(np.int64)
    rows = np.arange(height)
    near = np.where(rows % 2 == 1, (rows - 1) // 2, rows // 2)
    far = np.where(rows == 0, 0, np.where(rows % 2 == 1, (rows + 1) // 2, rows // 2 - 1))
    far = np.minimum(far, c.shape[0] - 1)
    n, f = c[near], c[far]
    out = np.empty((height, width), np.int64)
    out[:, 0] = (3 * n[:, 0] + f[:, 0] + 2) >> 2
    pairs = (width - 1) >> 1
    if pairs:
        nl, nr, fl, fr = n[:, :pairs], n[:, 1:pairs + 1], f[:, :pairs], f[:, 1:pairs + 1]
        avg = nl + nr + fl + fr + 8
        diag_left = (avg + 2 * (nr + fl)) >> 3  # nearest sample on the left
        diag_right = (avg + 2 * (nl + fr)) >> 3
        out[:, 1:2 * pairs:2] = (diag_left + nl) >> 1
        out[:, 2:2 * pairs + 1:2] = (diag_right + nr) >> 1
    if width % 2 == 0:
        out[:, width - 1] = (3 * n[:, -1] + f[:, -1] + 2) >> 2
    return out


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """libwebp's ``VP8YuvToRgb`` (yuv.h): 14-bit fixed point, ``>> 6``,
    clipped to [0, 255]."""
    def hi(x, k):
        return (x * k) >> 8

    y, u, v = (a.astype(np.int64) for a in (y, u, v))
    r = hi(y, 19077) + hi(v, 26149) - 14234
    g = hi(y, 19077) - hi(u, 6419) - hi(v, 13320) + 8708
    b = hi(y, 19077) + hi(u, 33050) - 17685
    return np.stack([np.clip(c >> 6, 0, 255) for c in (r, g, b)], axis=-1).astype(np.uint8)


# ----------------------------------------------------------------- frame
def decode_vp8(data: bytes, path: str = "VP8") -> np.ndarray:
    """A VP8 key frame (the payload of a ``VP8 `` chunk) -> (H, W, 3) uint8
    RGB as libwebp gives it (see the module docstring)."""
    y, u, v = decode_vp8_yuv(data, path)
    height, width = y.shape
    return yuv_to_rgb(y, fancy_upsample(u, height, width), fancy_upsample(v, height, width))


def decode_vp8_yuv(data: bytes, path: str = "VP8"):
    """A VP8 key frame -> its decoded, filtered planes: Y (H, W) and U, V
    (ceil(H/2), ceil(W/2)), int64."""
    if len(data) < 10:
        raise ValueError(f"{path}: truncated WebP lossy data: no frame header")
    bits = data[0] | (data[1] << 8) | (data[2] << 16)
    if bits & 1:
        raise ValueError(f"{path}: VP8 interframe in a WebP file (a key frame is needed)")
    if (bits >> 1) & 7 > 3 or not (bits >> 4) & 1:
        raise ValueError(f"{path}: corrupt VP8 frame header (profile or show flag)")
    part0 = bits >> 5
    if data[3:6] != b"\x9d\x01\x2a":
        raise ValueError(f"{path}: corrupt VP8 data: no key frame start code")
    width = (data[6] | (data[7] << 8)) & 0x3FFF
    height = (data[8] | (data[9] << 8)) & 0x3FFF
    if width == 0 or height == 0:
        raise ValueError(f"{path}: VP8 frame of {width} x {height} pixels")
    buf = data[10:]
    if part0 > len(buf):
        raise ValueError(f"{path}: truncated WebP lossy data: partition 0 ends past the chunk")
    br = _Bool(buf[:part0])
    get = br.bit
    get(128)  # colour space
    get(128)  # clamping type (libwebp always clamps)
    # segment header
    use_segment = get(128)
    update_map, absolute = 0, 1
    quantizer, strength = [0] * 4, [0] * 4
    seg_probs = [255, 255, 255]
    if use_segment:
        update_map = get(128)
        if get(128):
            absolute = get(128)
            quantizer = [br.signed(7) if get(128) else 0 for _ in range(4)]
            strength = [br.signed(6) if get(128) else 0 for _ in range(4)]
        if update_map:
            seg_probs = [br.value_bits(8) if get(128) else 255 for _ in range(3)]
    # filter header
    simple = get(128)
    level = br.value_bits(6)
    sharpness = br.value_bits(3)
    ref_delta, mode_delta = [0] * 4, [0] * 4
    use_delta = get(128)
    if use_delta and get(128):
        for deltas in (ref_delta, mode_delta):
            for i in range(4):
                if get(128):
                    deltas[i] = br.signed(6)
    filter_type = 0 if level == 0 else 1 if simple else 2
    # token partitions
    last = (1 << br.value_bits(2)) - 1
    rest = buf[part0:]
    if len(rest) < 3 * last:
        raise ValueError(f"{path}: truncated WebP lossy data: no partition sizes")
    parts, start, left = [], 3 * last, len(rest) - 3 * last
    for p in range(last):
        size = min(rest[3 * p] | (rest[3 * p + 1] << 8) | (rest[3 * p + 2] << 16), left)
        parts.append(_Bool(rest[start:start + size]))
        start += size
        left -= size
    if start >= len(rest):
        raise ValueError(f"{path}: truncated WebP lossy data: the last token partition is "
                         f"empty")
    parts.append(_Bool(rest[start:]))
    # quantisers
    base_q = br.value_bits(7)
    dy1_dc, dy2_dc, dy2_ac, duv_dc, duv_ac = (br.signed(4) if get(128) else 0 for _ in range(5))

    def clip(v, m):
        return 0 if v < 0 else m if v > m else v

    dq = []
    for s in range(4):
        q = (quantizer[s] + (0 if absolute else base_q)) if use_segment else base_q
        y2ac = (_AC_TABLE[clip(q + dy2_ac, 127)] * 101581) >> 16
        dq.append(((_DC_TABLE[clip(q + dy1_dc, 127)], _AC_TABLE[clip(q, 127)]),
                   (_DC_TABLE[clip(q + dy2_dc, 127)] * 2, max(8, y2ac)),
                   (_DC_TABLE[clip(q + duv_dc, 117)], _AC_TABLE[clip(q + duv_ac, 127)])))
    get(128)  # refresh entropy probabilities: ignored for a key frame
    probs = [br.value_bits(8) if get(u) else p0 for u, p0 in zip(_COEF_UPDATE_PROBS, _COEF_PROBS)]
    # prob[type][coefficient position 0..16][context] -> 11 probabilities
    prob = [[[probs[((t * 8 + _BANDS[n]) * 3 + c) * 11:((t * 8 + _BANDS[n]) * 3 + c) * 11 + 11]
              for c in range(3)] for n in range(17)] for t in range(4)]
    use_skip = get(128)
    skip_p = br.value_bits(8) if use_skip else 0
    # filter strengths per segment and 4x4-ness
    fstrength = []
    for s in range(4):
        base_level = (strength[s] + (0 if absolute else level)) if use_segment else level
        row = []
        for i4 in (0, 1):
            lv = base_level
            if use_delta:
                lv += ref_delta[0] + (mode_delta[0] if i4 else 0)
            lv = clip(lv, 63)
            if lv > 0:
                il = lv
                if sharpness > 0:
                    il >>= 2 if sharpness > 4 else 1
                    il = min(il, 9 - sharpness)
                il = max(il, 1)
                row.append((2 * lv + il, il, 2 if lv >= 40 else 1 if lv >= 15 else 0))
            else:
                row.append((0, 0, 0))
        fstrength.append(row)

    mbw, mbh = (width + 15) >> 4, (height + 15) >> 4
    nmb = mbw * mbh
    coefs = [0] * (nmb * 384)
    y2 = {}
    modes = []  # per macroblock: (is 4x4, y modes (1 or 16), uv mode)
    finfo = [[None] * mbw for _ in range(mbh)]
    intra_t = [_DC] * (4 * mbw)
    nz_t = [[0] * 9 for _ in range(mbw)]  # 4 Y, 2 U, 2 V, Y2
    for my in range(mbh):
        intra_l = [_DC] * 4
        nz_l = [0] * 9
        tbr = parts[my & last]
        tbit = tbr.bit
        for mx in range(mbw):
            # ---- modes (partition 0)
            segment = 0
            if update_map:
                segment = get(seg_probs[1]) if not get(seg_probs[0]) else 2 + get(seg_probs[2])
            skip = get(skip_p) if use_skip else 0
            is4 = not get(145)
            if not is4:
                ymode = (_TM if get(128) else _HE) if get(156) else (_VE if get(163) else _DC)
                ymodes = [ymode]
                intra_t[4 * mx:4 * mx + 4] = [ymode] * 4
                intra_l = [ymode] * 4
            else:
                ymodes = [0] * 16
                for y in range(4):
                    m = intra_l[y]
                    for x in range(4):
                        p = _BMODE_PROBS[(intra_t[4 * mx + x] * 10 + m) * 9:
                                         (intra_t[4 * mx + x] * 10 + m) * 9 + 9]
                        if not get(p[0]):
                            m = _DC
                        elif not get(p[1]):
                            m = _TM
                        elif not get(p[2]):
                            m = _VE
                        elif not get(p[3]):
                            m = _HE if not get(p[4]) else (_RD if not get(p[5]) else _VR)
                        else:
                            m = (_LD if not get(p[6]) else
                                 (_VL if not get(p[7]) else (_HD if not get(p[8]) else _HU)))
                        intra_t[4 * mx + x] = m
                        ymodes[4 * y + x] = m
                    intra_l[y] = m
            uvmode = _DC if not get(142) else _VE if not get(114) else _TM if get(183) else _HE
            modes.append((is4, ymodes, uvmode))
            if br.eof:
                raise ValueError(f"{path}: truncated WebP lossy data: partition 0 ends early")
            # ---- tokens
            top = nz_t[mx]
            base = (my * mbw + mx) * 384
            q_y, q_y2, q_uv = dq[segment]
            nonzero = False
            if skip:
                top[:8] = [0] * 8
                nz_l[:8] = [0] * 8
                if not is4:
                    top[8] = nz_l[8] = 0
            else:
                if not is4:
                    dc = [0] * 16
                    nz = _coeffs(tbit, prob[1], top[8] + nz_l[8], q_y2, 0, dc, 0)
                    top[8] = nz_l[8] = int(nz > 0)
                    y2[my * mbw + mx] = dc
                    dcs = _iwht(np.asarray(dc)).reshape(-1).tolist()
                    for k in range(16):
                        coefs[base + 16 * k] = dcs[k]
                    first, ac = 1, prob[0]
                else:
                    first, ac = 0, prob[3]
                for y in range(4):
                    lflag = nz_l[y]
                    for x in range(4):
                        b = base + 16 * (4 * y + x)
                        nz = _coeffs(tbit, ac, lflag + top[x], q_y, first, coefs, b)
                        lflag = int(nz > first)
                        top[x] = lflag
                        if nz > 1 or coefs[b]:
                            nonzero = True
                    nz_l[y] = lflag
                for ch in (4, 6):
                    for y in range(2):
                        lflag = nz_l[ch + y]
                        for x in range(2):
                            b = base + 16 * (16 + 2 * (ch - 4) + 2 * y + x)
                            nz = _coeffs(tbit, prob[2], lflag + top[ch + x], q_uv, 0, coefs, b)
                            lflag = int(nz > 0)
                            top[ch + x] = lflag
                            if nz > 1 or coefs[b]:
                                nonzero = True
                        nz_l[ch + y] = lflag
            if tbr.eof:
                raise ValueError(f"{path}: truncated WebP lossy data: a token partition ends "
                                 f"early")
            if filter_type:
                limit, ilevel, hev_t = fstrength[segment][int(is4)]
                finfo[my][mx] = (limit, ilevel, hev_t, is4 or nonzero)
    residual = _idct(np.asarray(coefs, np.int64).reshape(-1, 16)).reshape(nmb, 24, 4, 4)
    planes = _reconstruct(residual, modes, mbw, mbh)
    if filter_type:
        _loop_filter(planes, mbw, mbh, finfo, filter_type == 1)
    yp, up, vp = planes
    cw, ch_ = (width + 1) >> 1, (height + 1) >> 1
    return yp[:height, :width], up[:ch_, :cw], vp[:ch_, :cw]


def _reconstruct(residual: np.ndarray, modes, mbw: int, mbh: int):
    """Intra prediction plus residual, macroblock by macroblock, into the
    unfiltered Y, U and V planes (int64, macroblock-aligned)."""
    yp = np.zeros((16 * mbh, 16 * mbw), np.int64)
    up = np.zeros((8 * mbh, 8 * mbw), np.int64)
    vp = np.zeros((8 * mbh, 8 * mbw), np.int64)
    for my in range(mbh):
        for mx in range(mbw):
            i = my * mbw + mx
            is4, ymodes, uvmode = modes[i]
            res = residual[i]
            y0, x0 = 16 * my, 16 * mx
            if my > 0:
                top = yp[y0 - 1, x0:x0 + 16]
                corner = int(yp[y0 - 1, x0 - 1]) if mx > 0 else 129
                if mx < mbw - 1:
                    top_right = yp[y0 - 1, x0 + 16:x0 + 20].tolist()
                else:
                    top_right = [int(yp[y0 - 1, x0 + 15])] * 4
            else:
                top, corner, top_right = np.full(16, 127, np.int64), 127, [127] * 4
            left = yp[y0:y0 + 16, x0 - 1] if mx > 0 else np.full(16, 129, np.int64)
            if not is4:
                pred = _pred_block(ymodes[0], top, left, corner, 16, my > 0, mx > 0)
                blocks = res[:16].reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
                yp[y0:y0 + 16, x0:x0 + 16] = np.clip(pred + blocks, 0, 255)
            else:
                # a 17 x 21 work area: row 0 the pixels above (from column 0,
                # above-left), column 0 the pixels to the left
                ws = [[0] * 21 for _ in range(17)]
                ws[0] = [corner] + top.tolist() + top_right
                for r in range(16):
                    ws[r + 1][0] = int(left[r])
                for r in (4, 8, 12):  # the above-right pixels of the right column
                    ws[r][17:21] = top_right
                rs = res[:16].tolist()
                for n in range(16):
                    by, bx = n >> 2, n & 3
                    r0, c0 = 4 * by, 4 * bx
                    t = ws[r0][c0:c0 + 9]
                    lft = [ws[r0 + 1 + k][c0] for k in range(4)]
                    pr = _pred4(ymodes[n], t, lft)
                    rb = rs[n]
                    for r in range(4):
                        row = ws[r0 + 1 + r]
                        pv, rv = pr[r], rb[r]
                        for c in range(4):
                            v = pv[c] + rv[c]
                            row[c0 + 1 + c] = 0 if v < 0 else 255 if v > 255 else v
                yp[y0:y0 + 16, x0:x0 + 16] = np.asarray(ws)[1:17, 1:17]
            cy0, cx0 = 8 * my, 8 * mx
            for plane, k in ((up, 16), (vp, 20)):
                ctop = plane[cy0 - 1, cx0:cx0 + 8] if my > 0 else np.full(8, 127, np.int64)
                cleft = plane[cy0:cy0 + 8, cx0 - 1] if mx > 0 else np.full(8, 129, np.int64)
                ccorner = (int(plane[cy0 - 1, cx0 - 1]) if mx > 0 else 129) if my > 0 else 127
                pred = _pred_block(uvmode, ctop, cleft, ccorner, 8, my > 0, mx > 0)
                blocks = res[k:k + 4].reshape(2, 2, 4, 4).transpose(0, 2, 1, 3).reshape(8, 8)
                plane[cy0:cy0 + 8, cx0:cx0 + 8] = np.clip(pred + blocks, 0, 255)
    return yp, up, vp
