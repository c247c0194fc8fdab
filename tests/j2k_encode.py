"""A small JPEG 2000 encoder for the tests: the files PIL's writer cannot
make (image and tile origins, subsampled components, precisions other
than 8 and 16, signed samples, the code-block style bits, RGN, ``pclr``
palettes, more than four components).

It writes one quality layer in LRCP order with one precinct per
resolution: the reversible 5/3 transform (vertical then horizontal at
each level, so that OpenJPEG's inverse undoes it), no quantisation, an MQ
coder (ISO 15444-1 Annex C) and the three coding passes with every pass
kept. Each code-block style is honoured: BYPASS codes the significance and
refinement passes raw from the fifth bit-plane on, TERMALL and BYPASS end
segments, RESET resets the contexts after each MQ pass, VSC hides the
stripe below, SEGSYM writes 1010 after each cleanup pass. RGN shifts the
LL band's coefficients up by the ROI shift. The header fields are the
caller's. PIL decodes what it writes; the tests hold the port to PIL's
decode, not to the encoder's input.

``encode(planes, ...)`` returns a raw codestream; ``jp2(codestream, ...)``
wraps it in JP2 boxes; ``repack(data, ...)`` writes a codestream's packets
again (packed headers, SOP/EPH, other orders, POC).
"""

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from audioeditingcode_tpu_torch.utils import image_j2k_t1 as t1
from audioeditingcode_tpu_torch.utils.image_jpeg2000 import _resolutions, _Tccp

_QE, _NMPS, _NLPS, _SWITCH = t1._QE, t1._NMPS, t1._NLPS, t1._SWITCH


class MQEncoder:
    """Annex C's encoder: INITENC, CODEMPS/CODELPS, RENORME, BYTEOUT,
    FLUSH."""

    def __init__(self, states: List[List[int]]):
        self.states = states  # [state, mps] per context, kept across segments
        self.start()

    def start(self) -> None:
        self.a, self.c, self.ct = 0x8000, 0, 12
        self.out = bytearray([0])  # the byte before the segment, dropped at the end

    def _byteout(self) -> None:
        out = self.out
        if out[-1] == 0xFF:
            out.append(self.c >> 20)
            self.c &= 0xFFFFF
            self.ct = 7
        elif self.c < 0x8000000:
            out.append(self.c >> 19)
            self.c &= 0x7FFFF
            self.ct = 8
        else:
            out[-1] += 1
            if out[-1] == 0xFF:
                self.c &= 0x7FFFFFF
                out.append(self.c >> 20)
                self.c &= 0xFFFFF
                self.ct = 7
            else:
                out.append((self.c >> 19) & 0xFF)  # the carry went into the byte before
                self.c &= 0x7FFFF
                self.ct = 8

    def _renorm(self) -> None:
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def encode(self, d: int, k: int) -> None:
        st = self.states[k]
        q = _QE[st[0]]
        self.a -= q
        if d == st[1]:
            if not self.a & 0x8000:
                if self.a < q:
                    self.a = q
                else:
                    self.c += q
                st[0] = _NMPS[st[0]]
                self._renorm()
            else:
                self.c += q
        else:
            if self.a < q:
                self.c += q
            else:
                self.a = q
            if _SWITCH[st[0]]:
                st[1] ^= 1
            st[0] = _NLPS[st[0]]
            self._renorm()

    def flush(self) -> bytes:
        temp = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= temp:
            self.c -= 0x8000
        self.c <<= self.ct
        self._byteout()
        self.c <<= self.ct
        self._byteout()
        out = self.out
        if out[-1] == 0xFF:
            out.pop()
        seg = bytes(out[1:])
        self.start()
        return seg


class RawEncoder:
    """Raw (bypass) bits, 7 to a byte after 0xFF."""

    def __init__(self):
        self.out, self.byte, self.n, self.room = bytearray(), 0, 0, 8

    def encode(self, bit: int, k: int = 0) -> None:
        self.byte = (self.byte << 1) | bit
        self.n += 1
        if self.n == self.room:
            self.out.append(self.byte)
            self.room = 7 if self.byte == 0xFF else 8
            self.byte = self.n = 0

    def flush(self) -> bytes:
        if self.n:
            self.out.append(self.byte << (self.room - self.n))
        seg = bytes(self.out)
        self.__init__()
        return seg


def _reset_states() -> List[List[int]]:
    states = [[0, 0] for _ in range(19)]
    states[0][0], states[17][0], states[18][0] = 4, 3, 46
    return states


def encode_block(coef: np.ndarray, orient: int, planes: int, style: int,
                 roishift: int = 0) -> Tuple[list, int]:
    """One code-block's coefficients (h, w int) coded over ``planes``
    bit-planes: [(segment bytes, passes)], number of passes."""
    h, w = coef.shape
    mag, neg = np.abs(coef), coef < 0
    sig = np.zeros((h + 2, w + 2), bool)
    sgn = np.zeros((h + 2, w + 2), bool)
    refined = np.zeros((h, w), bool)
    visited = np.zeros((h, w), bool)
    vsc = bool(style & t1.VSC)
    states = _reset_states()
    mq, raw = MQEncoder(states), RawEncoder()
    segs: List[Tuple[bytes, int]] = []
    order = [(y, x) for y0 in range(0, h, 4) for x in range(w) for y in range(y0, min(y0 + 4, h))]

    def nbits(y, x):
        """The decoder's neighbour bits for (y, x) (VSC: a stripe's last
        row does not see the row below)."""
        def s(dy, dx):
            if vsc and dy == 1 and y % 4 == 3:
                return False
            return bool(sig[y + 1 + dy, x + 1 + dx])

        def g(dy, dx):
            return s(dy, dx) and bool(sgn[y + 1 + dy, x + 1 + dx])
        nb = (s(0, -1) * t1._W | s(0, 1) * t1._E | s(-1, 0) * t1._N | s(1, 0) * t1._S
              | s(-1, -1) * t1._NW | s(-1, 1) * t1._NE | s(1, -1) * t1._SW | s(1, 1) * t1._SE)
        nb |= (g(0, -1) * t1._WNEG | g(0, 1) * t1._ENEG | g(-1, 0) * t1._NNEG
               | g(1, 0) * t1._SNEG)
        return int(nb)

    def significant(y, x, coder, lazy):
        nb = nbits(y, x)
        if lazy:
            coder.encode(int(neg[y, x]))
        else:
            coder.encode(int(neg[y, x]) ^ t1._SXOR[nb], t1._SCX[nb])
        sig[y + 1, x + 1] = True
        sgn[y + 1, x + 1] = neg[y, x]

    npasses = seg_passes = 0
    coder = mq
    for bp in range(planes - 1, -1, -1):
        for pass_type in ((2,) if bp == planes - 1 else (0, 1, 2)):
            lazy = bool(style & t1.LAZY) and pass_type < 2 and bp + 1 <= planes - roishift - 4
            coder = raw if lazy else mq
            if pass_type == 0:
                for y, x in order:
                    if sig[y + 1, x + 1] or not nbits(y, x) & 0xFF:
                        continue
                    bit = int(mag[y, x] >> bp & 1)
                    if lazy:
                        coder.encode(bit)
                    else:
                        coder.encode(bit, t1._ZC[orient][nbits(y, x)])
                    if bit:
                        significant(y, x, coder, lazy)
                    visited[y, x] = True
            elif pass_type == 1:
                for y, x in order:
                    if not sig[y + 1, x + 1] or visited[y, x]:
                        continue
                    bit = int(mag[y, x] >> bp & 1)
                    if lazy:
                        coder.encode(bit)
                    else:
                        coder.encode(bit, 16 if refined[y, x] else
                                     (15 if nbits(y, x) & 0xFF else 14))
                    refined[y, x] = True
            else:
                full = h // 4 * 4
                for y0 in range(0, h, 4):
                    for x in range(w):
                        rows = list(range(y0, min(y0 + 4, h)))
                        first = 0
                        if y0 < full and all(not sig[y + 1, x + 1] and not visited[y, x]
                                             and not nbits(y, x) & 0xFF for y in rows):
                            bits = [int(mag[y, x] >> bp & 1) for y in rows]
                            if not any(bits):
                                mq.encode(0, 17)
                                continue
                            mq.encode(1, 17)
                            first = bits.index(1)
                            mq.encode(first >> 1, 18)
                            mq.encode(first & 1, 18)
                            significant(rows[first], x, mq, False)
                            first += 1
                        for y in rows[first:]:
                            if sig[y + 1, x + 1] or visited[y, x]:
                                continue
                            bit = int(mag[y, x] >> bp & 1)
                            mq.encode(bit, t1._ZC[orient][nbits(y, x)])
                            if bit:
                                significant(y, x, mq, False)
                if style & t1.SEGSYM:
                    for b in (1, 0, 1, 0):
                        mq.encode(b, 18)
                visited[:] = False
            npasses += 1
            seg_passes += 1
            if style & t1.RESET and not lazy:
                states[:] = _reset_states()
            # where the decoder ends a segment: each pass (TERMALL); with
            # BYPASS after 10 passes, then after 2 and 1 in turn
            end = bool(style & t1.TERMALL) or (
                bool(style & t1.LAZY) and (npasses == 10 or (npasses > 10 and pass_type >= 1)))
            if end:
                segs.append((coder.flush(), seg_passes))
                seg_passes = 0
    if seg_passes:
        segs.append((coder.flush(), seg_passes))
    return segs, npasses


def _fdwt53_lines(x: np.ndarray, start: int) -> np.ndarray:
    """Forward 5/3 of lines (rows of ``x``) whose first sample sits at
    absolute ``start``: lows (even positions) then highs."""
    n = x.shape[1]
    if n == 1:
        return x * 2 if start % 2 else x.copy()
    x = x.copy()
    idx = np.arange(n)
    ab = start + idx
    def at(i):
        i = np.where(i < 0, -i, i)
        return np.where(i >= n, 2 * (n - 1) - i, i)
    odd, even = idx[ab % 2 == 1], idx[ab % 2 == 0]
    x[:, odd] -= (x[:, at(odd - 1)] + x[:, at(odd + 1)]) >> 1
    x[:, even] += (x[:, at(even - 1)] + x[:, at(even + 1)] + 2) >> 2
    return np.concatenate([x[:, even], x[:, odd]], 1)


def fdwt53(tile: np.ndarray, res: list) -> np.ndarray:
    """The forward transform of a tile-component, resolution by resolution
    from the finest, laid out as OpenJPEG lays its bands."""
    x = tile.astype(np.int64).copy()
    for r in range(len(res) - 1, 0, -1):
        x0, y0, x1, y1 = res[r]
        w, h = x1 - x0, y1 - y0
        if w and h:
            x[:h, :w] = _fdwt53_lines(x[:h, :w].T, y0).T
            x[:h, :w] = _fdwt53_lines(x[:h, :w], x0)
    return x


class _Bits:
    """Packet header bits, a 0 bit stuffed after 0xFF."""

    def __init__(self):
        self.out, self.buf, self.ct = bytearray(), 0, 8

    def put(self, bit: int) -> None:
        if self.ct == 0:
            self.out.append(self.buf & 0xFF)
            self.ct = 7 if self.buf & 0xFF == 0xFF else 8
            self.buf = 0
        self.ct -= 1
        self.buf |= bit << self.ct

    def bits(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.put(v >> i & 1)

    def flush(self) -> bytes:
        self.out.append(self.buf & 0xFF)
        if self.buf & 0xFF == 0xFF:
            self.out.append(0)
        return bytes(self.out)


class _TagTree:
    def __init__(self, w: int, h: int, values: Sequence[int]):
        sizes = [(w, h)]
        while sizes[-1][0] * sizes[-1][1] > 1:
            sizes.append(((sizes[-1][0] + 1) // 2, (sizes[-1][1] + 1) // 2))
        self.levels = [np.full((lh, lw), 1 << 30, np.int64) for lw, lh in sizes]
        self.levels[0][:] = np.asarray(values, np.int64).reshape(h, w)
        for i in range(1, len(sizes)):
            prev = self.levels[i - 1]
            for y in range(prev.shape[0]):
                for x in range(prev.shape[1]):
                    cur = self.levels[i]
                    cur[y // 2, x // 2] = min(cur[y // 2, x // 2], prev[y, x])
        self.low = [np.zeros_like(v) for v in self.levels]
        self.known = [np.zeros(v.shape, bool) for v in self.levels]

    def encode(self, bits: _Bits, leaf: int, threshold: int) -> None:
        w = self.levels[0].shape[1]
        y, x = divmod(leaf, w)
        path = []
        for lev in range(len(self.levels)):
            path.append((lev, y, x))
            y, x = y // 2, x // 2
        low = 0
        for lev, y, x in reversed(path):
            low = max(low, self.low[lev][y, x])
            while low < threshold:
                if low >= self.levels[lev][y, x]:
                    if not self.known[lev][y, x]:
                        bits.put(1)
                        self.known[lev][y, x] = True
                    break
                bits.put(0)
                low += 1
            self.low[lev][y, x] = low


def _passes_code(bits: _Bits, n: int) -> None:
    if n == 1:
        bits.put(0)
    elif n == 2:
        bits.bits(0b10, 2)
    elif n <= 5:
        bits.bits(0b1100 | (n - 3), 4)
    elif n <= 36:
        bits.bits(0b1111 << 5 | (n - 6), 9)
    else:
        bits.bits(0b111111111 << 7 | (n - 37), 16)


def encode(planes: Sequence[np.ndarray], prec: int = 8, sgnd: bool = False,
           origin: Tuple[int, int] = (0, 0), tile: Optional[Tuple[int, int]] = None,
           tile_origin: Tuple[int, int] = (0, 0), sub: Optional[Sequence[Tuple[int, int]]] = None,
           levels: int = 2, cblk: Tuple[int, int] = (4, 4), style: int = 0,
           roishift: Optional[Sequence[int]] = None, mct: bool = False,
           guard: int = 2) -> bytes:
    """A raw codestream of the components ``planes`` (each the component's
    samples on its own grid, unsigned unless ``sgnd``). ``origin`` is
    (XOsiz, YOsiz), ``tile`` (XTsiz, YTsiz) with ``tile_origin``, ``sub`` the
    (XRsiz, YRsiz) of each component, ``cblk`` the code-block exponents
    (xcb, ycb)."""
    nc = len(planes)
    sub = list(sub or [(1, 1)] * nc)
    roishift = list(roishift or [0] * nc)
    x0, y0 = origin
    h0, w0 = planes[0].shape
    x1, y1 = x0 + w0 * sub[0][0], y0 + h0 * sub[0][1]
    tdx, tdy = tile or (x1, y1)
    tx0, ty0 = tile_origin
    out = bytearray(b"\xff\x4f")
    siz = struct.pack(">HIIIIIIIIH", 0, x1, y1, x0, y0, tdx, tdy, tx0, ty0, nc)
    for c in range(nc):
        siz += bytes([(prec - 1) | (0x80 if sgnd else 0), sub[c][0], sub[c][1]])
    out += b"\xff\x51" + struct.pack(">H", 2 + len(siz)) + siz
    cod = bytes([0, 0]) + struct.pack(">H", 1) + bytes([int(mct), levels, cblk[0] - 2,
                                                            cblk[1] - 2, style, 1])
    out += b"\xff\x52" + struct.pack(">H", 2 + len(cod)) + cod
    gains = [0] + [1, 1, 2] * levels
    expn = [prec + g + int(mct) for g in gains]
    qcd = bytes([guard << 5]) + bytes(e << 3 for e in expn)
    out += b"\xff\x5c" + struct.pack(">H", 2 + len(qcd)) + qcd
    for c, s in enumerate(roishift):
        if s:
            out += b"\xff\x5e" + struct.pack(">HBBB", 5, c, 0, s)
    tccp = _Tccp()
    tccp.numres, tccp.cblkw, tccp.cblkh, tccp.cblksty, tccp.qmfbid = levels + 1, cblk[0], \
        cblk[1], style, 1
    tccp.numgbits = guard
    tccp.steps = [(e, 0) for e in expn] + [(0, 0)] * (97 - len(expn))
    tw, th = -(-(x1 - tx0) // tdx), -(-(y1 - ty0) // tdy)
    shift = 0 if sgnd else 1 << (prec - 1)
    for t in range(tw * th):
        p, q = t % tw, t // tw
        tile_r = (max(tx0 + p * tdx, x0), max(ty0 + q * tdy, y0),
                  min(tx0 + (p + 1) * tdx, x1), min(ty0 + (q + 1) * tdy, y1))
        comps, geo = [], []
        for c in range(nc):
            dx, dy = sub[c]
            tc = (-(-tile_r[0] // dx), -(-tile_r[1] // dy), -(-tile_r[2] // dx),
                  -(-tile_r[3] // dy))
            cx0, cy0 = -(-x0 // dx), -(-y0 // dy)
            v = planes[c][tc[1] - cy0:tc[3] - cy0, tc[0] - cx0:tc[2] - cx0].astype(np.int64)
            comps.append(v - shift)
            geo.append((tc, _resolutions(tc, tccp, {"prec": prec})))
        if mct:
            r, g, b = comps[:3]
            comps[0], comps[1], comps[2] = (r + 2 * g + b) >> 2, b - g, r - g
        body = bytearray()
        for r in range(levels + 1):
            for c in range(nc):
                tc, res = geo[c]
                if not res[r].pw * res[r].ph:
                    continue
                coef = fdwt53(comps[c], [(rr.x0, rr.y0, rr.x1, rr.y1) for rr in res])
                body += _packet(coef, res, r, style, roishift[c])
        sot = struct.pack(">HIBB", t, 14 + len(body), 0, 1)
        out += b"\xff\x90" + struct.pack(">H", 10) + sot + b"\xff\x93" + body
    out += b"\xff\xd9"
    return bytes(out)


def _packet(coef, res, r, style, roishift) -> bytes:
    """The one-layer packet of resolution r (its only precinct)."""
    rr = res[r]
    bits = _Bits()
    blocks = []
    for band in rr.bands:
        if band.empty():
            continue
        prc = band.precincts[0] if band.precincts else None
        if prc is None:
            continue
        xoff = res[r - 1].x1 - res[r - 1].x0 if band.bandno & 1 else 0
        yoff = res[r - 1].y1 - res[r - 1].y0 if band.bandno & 2 else 0
        infos = []
        for cb in prc["cblks"]:
            x, y = cb.x0 - band.x0 + xoff, cb.y0 - band.y0 + yoff
            v = coef[y:y + cb.y1 - cb.y0, x:x + cb.x1 - cb.x0]
            if roishift and band.bandno == 0:
                v = v * (1 << roishift)
            top = int(np.abs(v).max(initial=0)).bit_length()
            mb = band.numbps
            if top > mb + roishift:
                raise ValueError("coefficients past the band's bit-planes")
            zbp = mb - max(top - roishift, 0)
            planes = roishift + mb - zbp
            if top and planes:
                segs, n = encode_block(v, band.bandno, planes, style, roishift)
            else:
                segs, n = [], 0
            infos.append((zbp, segs, n))
        blocks.append((prc, infos))
    if not any(n for _, infos in blocks for _, _, n in infos):
        bits.put(0)
        data = b""
    else:
        bits.put(1)
        data = bytearray()
        for prc, infos in blocks:
            cw, ch = prc["cw"], prc["ch"]
            incl = _TagTree(cw, ch, [0 if n else 1 for _, _, n in infos])
            imsb = _TagTree(cw, ch, [z for z, _, _ in infos])
            for k, (zbp, segs, n) in enumerate(infos):
                incl.encode(bits, k, 1)
                if not n:
                    continue
                imsb.encode(bits, k, zbp + 1)
                _passes_code(bits, n)
                lblock = 3
                need = max(len(s).bit_length() - (p.bit_length() - 1) for s, p in segs)
                inc = max(0, need - lblock)
                for _ in range(inc):
                    bits.put(1)
                bits.put(0)
                lblock += inc
                for s, p in segs:
                    bits.bits(len(s), lblock + p.bit_length() - 1)
                    data += s
    return bits.flush() + bytes(data)


def jp2(codestream: bytes, nc: int, height: int, width: int, bpc: int, enumcs: int = 16,
        pclr: Optional[Tuple[Sequence[Tuple[int, ...]], int]] = None,
        colr: Optional[bytes] = b"") -> bytes:
    """JP2 boxes around a codestream: signature, ftyp, jp2h (ihdr, colr
    with ``enumcs`` or the body ``colr`` (None: no colr box), and a
    ``pclr`` of (entries, bits) with its ``cmap``), jp2c."""
    def box(t, b):
        return struct.pack(">I", 8 + len(b)) + t + b
    ihdr = box(b"ihdr", struct.pack(">IIHBBBB", height, width, nc, bpc, 7, 0, 0))
    if colr == b"":
        colr = struct.pack(">BBBI", 1, 0, 0, enumcs)
    colr = box(b"colr", colr) if colr is not None else b""
    extra = b""
    if pclr is not None:
        entries, depth = pclr
        npc = len(entries[0])
        body = struct.pack(">HB", len(entries), npc) + bytes([depth - 1] * npc)
        for e in entries:
            body += bytes(e)
        extra = box(b"pclr", body) + box(b"cmap", b"".join(
            struct.pack(">HBB", 0, 1, i) for i in range(npc)))
    return (b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a" + box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + box(b"jp2h", ihdr + colr + extra) + box(b"jp2c", codestream))


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, 2 + len(body)) + body


def repack(data: bytes, ppm: bool = False, ppt: bool = False, sop: bool = False,
           eph: bool = False, progression: Optional[int] = None,
           poc: Optional[Sequence[Tuple[int, int, int, int, int, int]]] = None) -> bytes:
    """A raw codestream (one tile-part a tile, headers not packed) written
    again with its packets unchanged: their headers moved into PPM or PPT
    markers, SOP before each packet and EPH after each header, the packets
    in another progression order (COD's) or under a POC of (RSpoc, CSpoc,
    LYEpoc, REpoc, CEpoc, Ppoc) entries. The packet header bits do not
    change (each precinct keeps its layers in order), so PIL's decode must
    not either."""
    from audioeditingcode_tpu_torch.utils import image_jpeg2000 as j2k

    tiles = {t: (d, {key: (d[h0:h1], d[b0:b1]) for key, (h0, h1), (b0, b1) in pk})
             for t, d, pk in j2k.packets(data)}
    first_sot = data.index(b"\xff\x90", data.index(b"\xff\x52"))
    main, pos = bytearray(data[:2]), 2
    while pos < first_sot:
        marker, length = struct.unpack(">HH", data[pos:pos + 4])
        seg = bytearray(data[pos:pos + 2 + length])
        if marker == 0xFF52:
            seg[4] |= (2 if sop else 0) | (4 if eph else 0)
            if progression is not None:
                seg[5] = progression
        main += seg
        pos += 2 + length
    if poc:
        room = ">BBHBBB" if j2k._Codestream(data, 0, len(data)).ncomp <= 256 else ">BHHBHB"
        main += _segment(0xFF5F, b"".join(struct.pack(room, *e) for e in poc))
    cs = j2k._Codestream(bytes(main) + data[first_sot:], 0, len(main) + len(data) - first_sot)
    order = {}
    for t in tiles:
        tcp, tile = cs.tiles[t], j2k._tile_rect(cs, t)
        res = []
        for c, comp in enumerate(cs.comps):
            tc = (-(-tile[0] // comp["dx"]), -(-tile[1] // comp["dy"]),
                  -(-tile[2] // comp["dx"]), -(-tile[3] // comp["dy"]))
            res.append(j2k._resolutions(tc, tcp.tccps[c], comp))
        order[t] = list(j2k._packets(cs, tcp, tile, cs.comps, res))
    end = b"\xff\x92" if eph else b""
    if ppm:
        packed = b"".join(struct.pack(">I", sum(len(tiles[t][1][k][0]) + len(end)
                                                for k in order[t]))
                          + b"".join(tiles[t][1][k][0] + end for k in order[t])
                          for t in sorted(tiles))
        for z, i in enumerate(range(0, len(packed), 60000)):
            main += _segment(0xFF60, bytes([z]) + packed[i:i + 60000])
    out = bytearray(main)
    nsop = 0
    for t in sorted(tiles):
        body, head = bytearray(), bytearray()
        for k in order[t]:
            hdr, payload = tiles[t][1][k]
            if sop:
                body += b"\xff\x91\x00\x04" + struct.pack(">H", nsop & 0xFFFF)
                nsop += 1
            if ppm or ppt:
                head += hdr + end
            else:
                body += hdr + end
            body += payload
        markers = b""
        if ppt:
            markers = b"".join(_segment(0xFF61, bytes([z]) + bytes(head[i:i + 60000]))
                               for z, i in enumerate(range(0, len(head), 60000)))
        sot = _segment(0xFF90, struct.pack(">HIBB", t, 14 + len(markers) + len(body), 0, 1))
        out += sot + markers + b"\xff\x93" + body
    return bytes(out + b"\xff\xd9")
