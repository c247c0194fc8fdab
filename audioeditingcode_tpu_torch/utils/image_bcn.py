"""Block-compressed texture decoding (BC1-BC7, DXT1/3/5) for the DDS, FTEX
and BLP readers, numpy only, bit-equal to PIL 12.1.

Two decoders of PIL's are copied here, and they differ:

- ``decode`` is PIL's C ``bcn`` decoder (DDS and FTEX), vectorised over
  the blocks. Its rules, as probing PIL shows them:

  - BC1 colours expand 5-6-5 bits by replicating their top bits
    (r << 3 | r >> 2); the third and fourth colours are (2 c0 + c1) / 3
    and (c0 + 2 c1) / 3, truncated, where c0 > c1 as 16-bit words, else
    (c0 + c1) / 2 and transparent black. BC2 and BC3 always take the
    four-colour rule.
  - BC2 alpha: a 4-bit nibble per pixel, low nibble first, times 17.
    BC3, BC4 and BC5 interpolate two 8-bit ends with 3-bit indices:
    (k a0 + (7 - k) a1) / 7 where a0 > a1, else fifths with 0 and 255.
    BC5 fills red and green (blue 0); its signed kind (BC5S) adds 128 to
    each signed end and gives blue 128.
  - BC6H: the 14 modes of D3D's table (their bit layouts below),
    endpoint deltas, sign extension, PIL's unquantisation, the 3- or
    4-bit weights, the lerp ``(e0 (64 - w) + e1 w) >> 6``, then the
    half float of ``v * 31 / 64`` (unsigned) or ``|v| * 31 / 32`` with
    the sign (signed), clamped to [0, 1] and truncated to 8 bits
    (x 255 in float32). Mode bits past the 14 modes give black.
  - BC7: the 8 modes, 2- and 3-subset partitions, anchors, p-bits, the
    rotation and the index selector; a block whose first byte is 0 is
    opaque black. The partition and anchor tables are PIL's, read off
    its decoder by probing.
- ``decode_blp_dxt`` is PIL's Python DXT1/3/5 decoder of
  ``BlpImagePlugin``: the same rules, but 5-6-5 colours shifted without
  replicating their top bits (r << 3).

Blocks are 4 x 4 pixels, in rows of ceil(width / 4), cropped to the
image; ``decode`` returns (H, W, 4) uint8 RGBA (BC4: (H, W, 1) L).
"""

from __future__ import annotations

import numpy as np

# BC7 modes: subsets, partition bits, rotation bits, index-selector bits,
# colour bits, alpha bits, p-bit per endpoint, p-bit per subset, index bits,
# second index bits
_BC7_MODES = ((3, 4, 0, 0, 4, 0, 1, 0, 3, 0), (2, 6, 0, 0, 6, 0, 0, 1, 3, 0),
              (3, 6, 0, 0, 5, 0, 0, 0, 2, 0), (2, 6, 0, 0, 7, 0, 1, 0, 2, 0),
              (1, 0, 2, 1, 5, 6, 0, 0, 2, 3), (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
              (1, 0, 0, 0, 7, 7, 1, 0, 4, 0), (2, 6, 0, 0, 5, 5, 1, 0, 2, 0))
# subset of each pixel: 1 bit (two subsets) or 2 bits (three) per pixel
_P2 = (0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80, 0xc800, 0xffec, 0xfe80,
       0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000, 0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310,
       0x3100, 0x8cce, 0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c, 0xaaaa,
       0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a, 0x73ce, 0x13c8, 0x324c, 0x3bdc,
       0x6996, 0xc33c, 0x9966, 0x0660, 0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6,
       0x639c, 0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22)
_P3 = (0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050, 0x5555a0a0,
       0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090, 0x94949494, 0xa4a4a4a4,
       0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054, 0xa5a5a500, 0x55a0a0a0, 0xa8a85454,
       0x6a6a4040, 0xa4a45000, 0x1a1a0500, 0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400,
       0xa08585a0, 0xaa821414, 0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050,
       0x24242424, 0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
       0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600, 0xaa444444,
       0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580, 0xaa141414, 0x96960000,
       0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000, 0x40804080, 0xa9a8a9a8, 0xaaaaaa44,
       0x2a4a5254)
# the anchor pixel of the second subset (two subsets), and of the second and
# third (three subsets); pixel 0 anchors the first
_A2 = (15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 2, 8, 2, 2, 8, 8, 15,
       2, 8, 2, 2, 8, 8, 2, 2, 15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6, 6, 2, 6, 8,
       15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15)
_A3 = ((3, 15), (3, 8), (8, 15), (3, 15), (8, 15), (3, 15), (3, 15), (8, 15), (8, 15), (8, 15),
       (6, 15), (6, 15), (6, 15), (5, 15), (3, 15), (3, 8), (3, 15), (3, 8), (8, 15), (3, 15),
       (3, 15), (3, 8), (6, 15), (8, 10), (3, 5), (8, 15), (6, 8), (6, 10), (8, 15), (5, 15),
       (10, 15), (8, 15), (8, 15), (3, 15), (3, 15), (5, 10), (6, 10), (8, 10), (8, 9), (10, 15),
       (6, 15), (3, 15), (8, 15), (5, 15), (3, 15), (6, 15), (6, 15), (8, 15), (3, 15), (3, 15),
       (5, 15), (5, 15), (5, 15), (8, 15), (5, 15), (10, 15), (5, 15), (10, 15), (8, 15),
       (13, 15), (3, 15), (12, 15), (3, 15), (3, 8))
_WEIGHTS = {2: np.array([0, 21, 43, 64]), 3: np.array([0, 9, 18, 27, 37, 46, 55, 64]),
            4: np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64])}

# BC6H modes, in the order of the mode bits' values: subsets, transformed
# (deltas), partition bits, endpoint bits, delta bits of red, green, blue
_BC6_MODES = ((2, 1, 5, 10, 5, 5, 5), (2, 1, 5, 7, 6, 6, 6), (2, 1, 5, 11, 5, 4, 4),
              (2, 1, 5, 11, 4, 5, 4), (2, 1, 5, 11, 4, 4, 5), (2, 1, 5, 9, 5, 5, 5),
              (2, 1, 5, 8, 6, 5, 5), (2, 1, 5, 8, 5, 6, 5), (2, 1, 5, 8, 5, 5, 6),
              (2, 0, 5, 6, 6, 6, 6), (1, 0, 0, 10, 10, 10, 10), (1, 1, 0, 11, 9, 9, 9),
              (1, 1, 0, 12, 8, 8, 8), (1, 1, 0, 16, 4, 4, 4))
# the endpoint bits of each mode in stream order, after its mode bits: w, x,
# y, z are the endpoints, "a-b" bits a up to b, "a:b" bits a down to b
_BC6_LAYOUTS = (
    "gy4 by4 bz4 rw0-9 gw0-9 bw0-9 rx0-4 gz4 gy0-3 gx0-4 bz0 gz0-3 bx0-4 bz1 by0-3 ry0-4 bz2 "
    "rz0-4 bz3",
    "gy5 gz4 gz5 rw0-6 bz0 bz1 by4 gw0-6 by5 bz2 gy4 bw0-6 bz3 bz5 bz4 rx0-5 gy0-3 gx0-5 gz0-3 "
    "bx0-5 by0-3 ry0-5 rz0-5",
    "rw0-9 gw0-9 bw0-9 rx0-4 rw10 gy0-3 gx0-3 gw10 bz0 gz0-3 bx0-3 bw10 bz1 by0-3 ry0-4 bz2 "
    "rz0-4 bz3",
    "rw0-9 gw0-9 bw0-9 rx0-3 rw10 gz4 gy0-3 gx0-4 gw10 gz0-3 bx0-3 bw10 bz1 by0-3 ry0-3 bz0 "
    "bz2 rz0-3 gy4 bz3",
    "rw0-9 gw0-9 bw0-9 rx0-3 rw10 by4 gy0-3 gx0-3 gw10 bz0 gz0-3 bx0-4 bw10 by0-3 ry0-3 bz1 "
    "bz2 rz0-3 bz4 bz3",
    "rw0-8 by4 gw0-8 gy4 bw0-8 bz4 rx0-4 gz4 gy0-3 gx0-4 bz0 gz0-3 bx0-4 bz1 by0-3 ry0-4 bz2 "
    "rz0-4 bz3",
    "rw0-7 gz4 by4 gw0-7 bz2 gy4 bw0-7 bz3 bz4 rx0-5 gy0-3 gx0-4 bz0 gz0-3 bx0-4 bz1 by0-3 "
    "ry0-5 rz0-5",
    "rw0-7 bz0 by4 gw0-7 gy5 gy4 bw0-7 gz5 bz4 rx0-4 gz4 gy0-3 gx0-5 gz0-3 bx0-4 bz1 by0-3 "
    "ry0-4 bz2 rz0-4 bz3",
    "rw0-7 bz1 by4 gw0-7 by5 gy4 bw0-7 bz5 bz4 rx0-4 gz4 gy0-3 gx0-4 bz0 gz0-3 bx0-5 by0-3 "
    "ry0-4 bz2 rz0-4 bz3",
    "rw0-5 gz4 bz0 bz1 by4 gw0-5 gy5 by5 bz2 gy4 bw0-5 gz5 bz3 bz5 bz4 rx0-5 gy0-3 gx0-5 gz0-3 "
    "bx0-5 by0-3 ry0-5 rz0-5",
    "rw0-9 gw0-9 bw0-9 rx0-9 gx0-9 bx0-9",
    "rw0-9 gw0-9 bw0-9 rx0-8 rw10 gx0-8 gw10 bx0-8 bw10",
    "rw0-9 gw0-9 bw0-9 rx0-7 rw11:10 gx0-7 gw11:10 bx0-7 bw11:10",
    "rw0-9 gw0-9 bw0-9 rx0-3 rw15:10 gx0-3 gw15:10 bx0-3 bw15:10")


def _bc6_packing(layout: str):
    """(endpoint word, bit) of each endpoint bit in stream order; the words
    are r, g, b of w, then of x, y and z."""
    out = []
    for field in layout.split():
        word = "wxyz".index(field[1]) * 3 + "rgb".index(field[0])
        spec = field[2:]
        if "-" in spec:
            lo, hi = map(int, spec.split("-"))
            bits = range(lo, hi + 1)
        elif ":" in spec:
            hi, lo = map(int, spec.split(":"))
            bits = range(hi, lo - 1, -1)
        else:
            bits = [int(spec)]
        out += [(word, b) for b in bits]
    return out


_BC6_PACKINGS = [_bc6_packing(layout) for layout in _BC6_LAYOUTS]


def _bits(blocks: np.ndarray) -> np.ndarray:
    """(n, 8 * bytes) bits of each block, least significant first."""
    return np.unpackbits(blocks, axis=1, bitorder="little").astype(np.int64)


def _field(bits: np.ndarray, start, width) -> np.ndarray:
    """The little-endian field of ``width`` bits at bit ``start`` of each
    block (start and width broadcast against the blocks, (n,) or (n, k))."""
    start, width = np.asarray(start), np.asarray(width)
    top = int(width.max()) if width.size else 0
    if top == 0:
        return np.zeros(np.broadcast_shapes(start.shape, width.shape, bits.shape[:1]), np.int64)
    j = np.arange(top)
    pos = np.minimum(start[..., None] + j, bits.shape[1] - 1)
    n = bits.shape[0]
    rows = np.arange(n).reshape((n,) + (1,) * (pos.ndim - 1))
    picked = bits[rows, pos] if pos.ndim > 1 else bits[:, pos]
    keep = j < width[..., None]
    return (picked * keep << j).sum(-1)


# ------------------------------------------------------------ BC1 to BC5
def _565(c: np.ndarray, replicate: bool) -> np.ndarray:
    r, g, b = (c >> 11) & 31, (c >> 5) & 63, c & 31
    if replicate:
        return np.stack([r << 3 | r >> 2, g << 2 | g >> 4, b << 3 | b >> 2], -1)
    return np.stack([r << 3, g << 2, b << 3], -1)


def _colours(blocks: np.ndarray, four: bool, replicate: bool = True) -> np.ndarray:
    """BC1 colour blocks (n, 8) -> (n, 16, 4) RGBA; ``four``: always the
    four-colour rule (BC2, BC3)."""
    w = blocks.astype(np.int64)
    c0, c1 = w[:, 0] | w[:, 1] << 8, w[:, 2] | w[:, 3] << 8
    lut = w[:, 4] | w[:, 5] << 8 | w[:, 6] << 16 | w[:, 7] << 24
    e0, e1 = _565(c0, replicate), _565(c1, replicate)
    p = np.full((len(w), 4, 4), 255, np.int64)
    p[:, 0, :3], p[:, 1, :3] = e0, e1
    gt = (c0 > c1) | four
    p[:, 2, :3] = np.where(gt[:, None], (2 * e0 + e1) // 3, (e0 + e1) // 2)
    p[:, 3, :3] = np.where(gt[:, None], (e0 + 2 * e1) // 3, 0)
    p[:, 3, 3] = np.where(gt, 255, 0)
    code = lut[:, None] >> (2 * np.arange(16)) & 3
    return np.take_along_axis(p, code[:, :, None], axis=1)


def _alpha_block(blocks: np.ndarray, signed: bool = False) -> np.ndarray:
    """BC3-style alpha blocks (n, 8) -> (n, 16) values 0-255."""
    w = blocks.astype(np.int64)
    a0, a1 = w[:, 0], w[:, 1]
    if signed:
        a0, a1 = (a0 ^ 128), (a1 ^ 128)  # int8 + 128
    lut = sum(w[:, 2 + k] << (8 * k) for k in range(6))
    k = np.arange(1, 7)
    seven = ((7 - k) * a0[:, None] + k * a1[:, None]) // 7
    five = ((5 - k[:4]) * a0[:, None] + k[:4] * a1[:, None]) // 5
    five = np.concatenate([five, np.zeros((len(w), 1), np.int64),
                           np.full((len(w), 1), 255, np.int64)], 1)
    table = np.concatenate([a0[:, None], a1[:, None], np.where((a0 > a1)[:, None], seven, five)],
                           1)
    code = lut[:, None] >> (3 * np.arange(16)) & 7
    return np.take_along_axis(table, code, axis=1)


def _bc2_alpha(blocks: np.ndarray) -> np.ndarray:
    w = blocks.astype(np.int64)
    nib = np.stack([w & 15, w >> 4], -1).reshape(len(w), 16)
    return nib * 17


# ------------------------------------------------------------------ BC7
def _bc7(blocks: np.ndarray) -> np.ndarray:
    out = np.zeros((len(blocks), 16, 4), np.int64)
    out[:, :, 3] = 255  # first byte 0: opaque black
    first = blocks[:, 0].astype(np.int64)
    mode = np.where(first == 0, -1, np.log2(np.maximum(first & -first, 1)).astype(np.int64))
    for m, (ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2) in enumerate(_BC7_MODES):
        sel = np.nonzero(mode == m)[0]
        if not len(sel):
            continue
        bits = _bits(blocks[sel])
        n = len(sel)
        pos = m + 1
        part = _field(bits, pos, pb)
        rot = _field(bits, pos + pb, rb)
        isel = _field(bits, pos + pb + rb, isb)
        pos += pb + rb + isb
        numep = 2 * ns
        ends = np.empty((n, numep, 4), np.int64)
        for ch in range(3):
            ends[:, :, ch] = _field(bits, pos + cb * np.arange(numep)[None], np.full(numep, cb))
            pos += cb * numep
        if ab:
            ends[:, :, 3] = _field(bits, pos + ab * np.arange(numep)[None], np.full(numep, ab))
            pos += ab * numep
        else:
            ends[:, :, 3] = 255
        cbits, abits = cb, ab
        if epb or spb:
            cbits += 1
            abits += 1 if ab else 0
            count = numep if epb else ns
            p = _field(bits, pos + np.arange(count)[None], np.ones(count, np.int64))
            pos += count
            if spb:
                p = np.repeat(p, 2, axis=1)
            ends[:, :, :3] = ends[:, :, :3] << 1 | p[:, :, None]
            if ab:
                ends[:, :, 3] = ends[:, :, 3] << 1 | p
        ends[:, :, :3] = _expand(ends[:, :, :3], cbits)
        if ab:
            ends[:, :, 3] = _expand(ends[:, :, 3], abits)
        # subsets and index widths of each pixel, per partition
        pix = np.arange(16)
        if ns == 2:
            subset = (np.array(_P2)[part][:, None] >> pix) & 1
            anchor = (pix == 0) | (pix == np.array(_A2)[part][:, None])
        elif ns == 3:
            subset = (np.array(_P3)[part][:, None] >> (2 * pix)) & 3
            a3 = np.array(_A3)[part]
            anchor = (pix == 0) | (pix == a3[:, :1]) | (pix == a3[:, 1:])
        else:
            subset = np.zeros((n, 16), np.int64)
            anchor = np.broadcast_to(pix == 0, (n, 16))
        width = ib - anchor
        start = pos + np.cumsum(width, axis=1) - width
        i0 = _field(bits, start, width)
        cw = _WEIGHTS[ib][i0]
        if ab and ib2:
            width2 = np.broadcast_to(ib2 - (pix == 0), (n, 16))
            start2 = pos + 16 * ib - ns + np.cumsum(width2, axis=1) - width2
            aw = _WEIGHTS[ib2][_field(bits, start2, width2)]
            s_rgb = np.where(isel[:, None] == 1, aw, cw)
            s_a = np.where(isel[:, None] == 1, cw, aw)
        else:
            s_rgb = s_a = cw
        e0 = np.take_along_axis(ends, (2 * subset)[:, :, None], axis=1)
        e1 = np.take_along_axis(ends, (2 * subset + 1)[:, :, None], axis=1)
        col = np.empty((n, 16, 4), np.int64)
        col[:, :, :3] = ((64 - s_rgb)[:, :, None] * e0[:, :, :3] + s_rgb[:, :, None] * e1[:, :, :3]
                         + 32) >> 6
        col[:, :, 3] = ((64 - s_a) * e0[:, :, 3] + s_a * e1[:, :, 3] + 32) >> 6
        col &= 255
        for r in (1, 2, 3):
            hit = rot == r
            col[hit, :, r - 1], col[hit, :, 3] = col[hit, :, 3], col[hit, :, r - 1].copy()
        out[sel] = col
    return out


def _expand(v: np.ndarray, bits: int) -> np.ndarray:
    v = (v << (8 - bits)) & 255
    return v | v >> bits


# ----------------------------------------------------------------- BC6H
def _bc6(blocks: np.ndarray, signed: bool) -> np.ndarray:
    out = np.zeros((len(blocks), 16, 4), np.int64)
    low = blocks[:, 0].astype(np.int64) & 31
    mode = np.where((low & 3) < 2, low & 3, np.where((low & 3) == 2, 2 + (low >> 2),
                                                     10 + (low >> 2)))
    for m, (ns, tr, pb, epb, rb, gb, bbits) in enumerate(_BC6_MODES):
        sel = np.nonzero(mode == m)[0]
        if not len(sel):
            continue
        bits = _bits(blocks[sel])
        n = len(sel)
        pos = 2 if m < 2 else 5
        eps = np.zeros((n, 12), np.int64)
        for i, (word, b) in enumerate(_BC6_PACKINGS[m]):
            eps[:, word] |= bits[:, pos + i] << b
        pos += len(_BC6_PACKINGS[m])
        part = _field(bits, pos, pb)
        pos += pb
        numep = 12 if ns == 2 else 6
        if signed:
            eps[:, :3] = _sign_extend(eps[:, :3], epb)
        delta = np.array([rb, gb, bbits] * 3)[:numep - 3]
        if signed or tr:
            eps[:, 3:numep] = _sign_extend(eps[:, 3:numep], delta)
        if tr:  # PIL does not sign-extend the sums, even where signed
            eps[:, 3:numep] = (eps[:, 3:numep] + np.tile(eps[:, :3], (1, numep // 3 - 1))) & (
                (1 << epb) - 1)
        uq = _unquantize(eps[:, :numep], epb, signed)
        pix = np.arange(16)
        ib = 3 if ns == 2 else 4
        if ns == 2:
            subset = (np.array(_P2)[part][:, None] >> pix) & 1
            anchor = (pix == 0) | (pix == np.array(_A2)[part][:, None])
        else:
            subset = np.zeros((n, 16), np.int64)
            anchor = np.broadcast_to(pix == 0, (n, 16))
        width = ib - anchor
        start = pos + np.cumsum(width, axis=1) - width
        w = _WEIGHTS[ib][_field(bits, start, width)]
        e0 = np.take_along_axis(uq.reshape(n, -1, 3), (2 * subset)[:, :, None], axis=1)
        e1 = np.take_along_axis(uq.reshape(n, -1, 3), (2 * subset + 1)[:, :, None], axis=1)
        v = (e0 * (64 - w)[:, :, None] + e1 * w[:, :, None]) >> 6
        if signed:
            half = np.where(v < 0, 0x8000 | (-v * 31) // 32, v * 31 // 32)
        else:
            half = v * 31 // 64
        f = half.astype(np.uint16).view(np.float16).astype(np.float32)
        out[sel, :, :3] = np.where(f < 0, 0, np.where(f > 1, 255, (f * np.float32(255)).astype(
            np.int64)))
    return out


def _sign_extend(v: np.ndarray, bits) -> np.ndarray:
    bits = np.asarray(bits)
    v = np.where((v >> (bits - 1)) & 1 == 1, v | (-1 << bits), v)
    return (v + 32768) % 65536 - 32768


def _unquantize(v: np.ndarray, prec: int, signed: bool) -> np.ndarray:
    if not signed:
        v = v & 0xFFFF
        if prec >= 15:
            return v
        out = ((v << 15) + 0x4000) >> (prec - 1)
        return np.where(v == 0, 0, np.where(v == (1 << prec) - 1, 0xFFFF, out))
    v = (v + 32768) % 65536 - 32768  # as int16
    if prec >= 16:
        return v
    x = np.abs(v)
    x = np.where(x == 0, 0, np.where(x >= (1 << (prec - 1)) - 1, 0x7FFF,
                                     ((x << 15) + 0x4000) >> (prec - 1)))
    return np.where(v < 0, -x, x)


# ------------------------------------------------------------- the image
BLOCK_BYTES = {1: 8, 2: 16, 3: 16, 4: 8, 5: 16, 6: 16, 7: 16}


def decode(data: bytes, width: int, height: int, n: int, pixel_format: str,
           path: str) -> np.ndarray:
    """PIL's ``bcn`` decoder of BCn (``n`` 1-7) blocks at the start of
    ``data``: (H, W, 4) RGBA, or (H, W, 1) for BC4. ``pixel_format`` "BC5S"
    and "BC6HS" are the signed kinds. Data that ends before the last block
    raises, as PIL raises "image file is truncated"."""
    size = BLOCK_BYTES[n]
    bw, bh = (width + 3) // 4, (height + 3) // 4
    if len(data) < bw * bh * size:
        raise ValueError(f"{path}: truncated BC{n} data: {bw * bh} blocks of {size} bytes need "
                         f"{bw * bh * size}, the file holds {len(data)} (PIL fails on it: "
                         f"image file is truncated)")
    blocks = np.frombuffer(data, np.uint8, bw * bh * size).reshape(-1, size)
    if n == 1:
        px = _colours(blocks, False)
    elif n in (2, 3):
        px = _colours(blocks[:, 8:], True)
        px[:, :, 3] = _bc2_alpha(blocks[:, :8]) if n == 2 else _alpha_block(blocks[:, :8])
    elif n == 4:
        px = _alpha_block(blocks)[:, :, None]
    elif n == 5:
        signed = pixel_format == "BC5S"
        px = np.zeros((len(blocks), 16, 4), np.int64)
        px[:, :, 0] = _alpha_block(blocks[:, :8], signed)
        px[:, :, 1] = _alpha_block(blocks[:, 8:], signed)
        px[:, :, 2] = 128 if signed else 0
    elif n == 6:
        px = _bc6(blocks, pixel_format == "BC6HS")
    else:
        px = _bc7(blocks)
    return _tile(px, bw, bh, width, height)


def _tile(px: np.ndarray, bw: int, bh: int, width: int, height: int) -> np.ndarray:
    c = px.shape[-1]
    img = px.reshape(bh, bw, 4, 4, c).transpose(0, 2, 1, 3, 4).reshape(bh * 4, bw * 4, c)
    return np.ascontiguousarray(img[:height, :width]).astype(np.uint8)


def decode_blp_dxt(data: bytes, width: int, height: int, alpha_encoding: int) -> np.ndarray:
    """PIL's Python DXT decoders of ``BlpImagePlugin`` over ceil(H / 4) rows
    of ceil(W / 4) blocks: (4 ceil(H / 4), 4 ceil(W / 4), 4) RGBA, the
    blocks' pixels uncropped (PIL takes the rows as they come; the caller
    cuts them). ``alpha_encoding`` 0 (DXT1), 1 (DXT3) or 7 (DXT5)."""
    size = 8 if alpha_encoding == 0 else 16
    bw, bh = (width + 3) // 4, (height + 3) // 4
    blocks = np.frombuffer(data, np.uint8, bw * bh * size).reshape(-1, size)
    if alpha_encoding == 0:
        px = _colours(blocks, False, replicate=False)
    else:
        px = _colours(blocks[:, 8:], True, replicate=False)
        px[:, :, 3] = (_bc2_alpha(blocks[:, :8]) if alpha_encoding == 1
                       else _alpha_block(blocks[:, :8]))
    return _tile(px, bw, bh, 4 * bw, 4 * bh)
