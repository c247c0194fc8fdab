"""Lossless (SOF3) and arithmetic-coded (SOF9, SOF10) JPEG in the port's
JPEG path (utils/image_io.py, image_jpeg_lossless.py, image_jpeg_arith.py)
against PIL 12.1's ``np.array(Image.open(p).convert("RGB"))``, bit for bit.

PIL writes neither, so this file carries small encoders of its own:

- ``lossless_jpeg``, after T.81 Annex H: predictors 1-7, the point
  transform, one or three components, interleaved or one scan a component,
  chroma subsampling, restart intervals of whole MCU rows. Shown to be real:
  with point transform 0 and RGB components (an Adobe APP14 marker with
  transform 0) PIL decodes each file to its source exactly.
- ``arith_jpeg``, after T.81 Annexes D and F/G (the QM coder as libjpeg's
  ``jcarith.c`` runs it): a float DCT, libjpeg's quality-scaled tables,
  sequential (SOF9) or progressive (SOF10: DC first and refinement, AC
  spectral bands and refinement), 4:4:4, 4:2:2 or 4:2:0, restart intervals,
  a DAC segment. Shown to be real: PIL decodes each file to within the
  error of its quantization tables of the source, a PSNR of at least 28 dB
  and within 1.5 dB of PIL's own baseline JPEG of the same quality (29.0 to
  41.8 dB on the cases here, 0.05 to 1.2 dB under PIL's).

Arithmetic-coded lossless JPEG (SOF11), which libjpeg-turbo does not
decode, raises in both. Last, libjpeg's block smoothing of progressive
files cut after each scan (utils/image_jpeg_smooth.py).
"""

import struct

import numpy as np
import pytest
from PIL import Image

from audioeditingcode_tpu_torch.utils import image_io as tio
from test_torch_image_codecs import _both_raise, _check
from test_torch_image_formats import _pattern, _pil, _scans


def _natural_order():
    """Zigzag position -> row-major index of the 8x8 block."""
    order = sorted(((r + c, r if (r + c) % 2 else c, r * 8 + c) for r in range(8)
                    for c in range(8)))
    return [i for _, _, i in order]


NATURAL = _natural_order()


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


ADOBE_RGB = _segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0]))
JFIF = _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


class BitWriter:
    """Huffman-coded bits, most significant first, 0xFF followed by 0x00."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, bits: int):
        self.acc = (self.acc << bits) | (value & ((1 << bits) - 1))
        self.n += bits
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 255
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        out, self.out = bytes(self.out), bytearray()
        return out


# ------------------------------------------------------------ lossless
def _category(d: int) -> int:
    return 16 if d == 32768 else abs(d).bit_length()


def _predict(x, y, col, row, prev, predictor, first, initial):
    """The prediction of sample ``col`` of ``row`` (reduced values)."""
    if first:
        return initial if col == 0 else row[col - 1]
    if col == 0:
        return prev[0]
    ra, rb, rc = row[col - 1], prev[col], prev[col - 1]
    return {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor]


def _diffs(plane, predictor, pt, rows_per_restart, precision=8):
    """Each sample's difference, modulo 2^16 and in -32767..32768."""
    x = (np.asarray(plane, np.int64) >> pt).tolist()
    out = np.zeros((len(x), len(x[0])), np.int64)
    initial = 1 << (precision - pt - 1)
    for y, row in enumerate(x):
        for c in range(len(row)):
            p = _predict(None, y, c, row, x[y - 1] if y else None, predictor,
                         y % rows_per_restart == 0, initial)
            d = (row[c] - p) % 65536
            out[y, c] = d - 65536 if d > 32768 else d
    return out


def lossless_jpeg(planes, sampling, predictor=1, pt=0, restart_rows=0, app=b"",
                  interleaved=True, ids=None, sof=0xC3, precision=8):
    """A lossless JPEG of component planes at their own sizes, with one DC
    Huffman table of 17 five-bit codes."""
    n = len(planes)
    ids = ids or list(range(1, n + 1))
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    height, width = planes[0].shape  # the first component at full size
    sof_body = struct.pack(">BHHB", precision, height, width, n) + b"".join(
        bytes([ids[i], (h << 4) | v, 0]) for i, (h, v) in enumerate(sampling))
    dht = bytes([0x00]) + bytes([0, 0, 0, 0, 17] + [0] * 11) + bytes(range(17))
    out = b"\xff\xd8" + app + _segment(sof, sof_body) + _segment(0xC4, dht)
    scans = [list(range(n))] if interleaved else [[i] for i in range(n)]
    for members in scans:
        if len(members) > 1:
            mcux, mcuy = -(-width // hmax), -(-height // vmax)
            layout = [(c, yy, xx) for c in members for yy in range(sampling[c][1])
                      for xx in range(sampling[c][0])]
        else:
            c = members[0]
            mcuy, mcux = planes[c].shape
            layout = [(c, 0, 0)]
        restart = restart_rows * mcux
        diffs = {}
        for c in members:
            v = sampling[c][1] if len(members) > 1 else 1
            diffs[c] = _diffs(planes[c], predictor, pt, restart_rows * v if restart else 10 ** 9,
                              precision)
        body = (_segment(0xDD, struct.pack(">H", restart)) if restart else b"") + _segment(
            0xDA, bytes([len(members)]) + b"".join(bytes([ids[c], 0]) for c in members)
            + bytes([predictor, 0, pt]))
        w = BitWriter()
        data, rst = b"", 0
        for r in range(mcuy):
            if restart and r and r % restart_rows == 0:
                data += w.flush() + bytes([0xFF, 0xD0 + rst % 8])
                rst += 1
            for m in range(mcux):
                for c, yy, xx in layout:
                    h, v = sampling[c] if len(members) > 1 else (1, 1)
                    y, x = r * v + yy, m * h + xx
                    d = diffs[c]
                    val = int(d[y, x]) if y < d.shape[0] and x < d.shape[1] else 0
                    s = _category(val)
                    w.put(s, 5)
                    if 0 < s < 16:
                        w.put(val if val > 0 else val - 1, s)
        out += body + data + w.flush()
    return out + b"\xff\xd9"


def _write(tmp_path, name, data):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_rgb_is_the_source_and_matches_pil(tmp_path, predictor):
    """Adobe transform 0 (RGB), point transform 0: PIL gives back the source;
    then point transforms and restart intervals, bit-equal to PIL."""
    img = _pattern(21, 34, noise=0.3, seed=predictor)
    planes = [img[:, :, i] for i in range(3)]
    path = _write(tmp_path, "a.jpg", lossless_jpeg(planes, [(1, 1)] * 3, predictor,
                                                   app=ADOBE_RGB))
    np.testing.assert_array_equal(_pil(path), img)
    _check(path)
    for pt, rows in ((1, 0), (3, 2), (0, 1), (7, 0)):
        _check(_write(tmp_path, "b.jpg", lossless_jpeg(planes, [(1, 1)] * 3, predictor, pt, rows,
                                                       app=ADOBE_RGB)))


def test_lossless_components_sampling_and_colour(tmp_path):
    """Greyscale; three components without a marker (libjpeg-turbo takes
    them as RGB in lossless mode, whatever their ids) or under an Adobe
    transform 0; 2x2 and 2x1 subsampling (replicated, not fancy); one scan
    a component; four components (CMYK). Under JFIF (YCbCr) or an Adobe
    transform 2 (YCCK) PIL fails and the port raises."""
    img = _pattern(19, 27, noise=0.3)
    checked = 0
    grey = img[:, :, 0]
    for p in (1, 4, 7):
        _check(_write(tmp_path, "g.jpg", lossless_jpeg([grey], [(1, 1)], p, restart_rows=3)))
        checked += 1
    y, cb, cr = (np.asarray(Image.fromarray(img).convert("YCbCr"))[:, :, i] for i in range(3))
    for sampling in ([(1, 1)] * 3, [(2, 2), (1, 1), (1, 1)], [(2, 1), (1, 1), (1, 1)]):
        h, v = sampling[0]
        planes = [y, cb[::v, ::h], cr[::v, ::h]]
        for interleaved in (True, False):
            for app in (ADOBE_RGB, b""):
                _check(_write(tmp_path, "c.jpg", lossless_jpeg(planes, sampling, 6, 1, app=app,
                                                               interleaved=interleaved)))
                checked += 1
            _both_raise(_write(tmp_path, "j.jpg", lossless_jpeg(planes, sampling, 6, 1,
                                                                app=JFIF,
                                                                interleaved=interleaved)))
    for ids in ([82, 71, 66], [7, 8, 9]):
        _check(_write(tmp_path, "r.jpg", lossless_jpeg([img[:, :, i] for i in range(3)],
                                                       [(1, 1)] * 3, 5, ids=ids)))
        checked += 1
    cmyk = [img[:, :, 0], img[:, :, 1], img[:, :, 2], img[:, :, 0] // 2]
    for app in (b"", ADOBE_RGB):  # CMYK, which PIL inverts as CMYK;I
        _check(_write(tmp_path, "k.jpg", lossless_jpeg(cmyk, [(1, 1)] * 4, 2, app=app)))
        checked += 1
    _both_raise(_write(tmp_path, "y.jpg", lossless_jpeg(cmyk, [(1, 1)] * 4, 2,
                                                        app=ADOBE_RGB[:-1] + b"\x02")))
    assert checked == 19


def test_lossless_refusals(tmp_path):
    """A restart interval that is not a whole number of MCU rows, SOF11
    (arithmetic lossless) and a truncated file: PIL fails, the port raises."""
    img = _pattern(12, 20, noise=0.3)
    data = lossless_jpeg([img[:, :, 0]], [(1, 1)], 1, restart_rows=1)
    bad = data.replace(b"\xff\xdd\x00\x04\x00\x14", b"\xff\xdd\x00\x04\x00\x07")
    assert bad != data
    _both_raise(_write(tmp_path, "a.jpg", bad))
    _both_raise(_write(tmp_path, "b.jpg", lossless_jpeg([img[:, :, 0]], [(1, 1)], 1,
                                                        sof=0xCB)))
    _both_raise(_write(tmp_path, "c.jpg", data[:len(data) // 2]))


# ---------------------------------------------------------- arithmetic
_LUMA = [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57,
         69, 56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64,
         81, 104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]
_CHROMA = [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99,
           99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32


def _quant(base, quality):
    """libjpeg's jpeg_quality_scaling of a row-major table."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((np.asarray(base) * scale + 50) // 100, 1, 255)


_C = np.array([[np.sqrt((1 if u == 0 else 2) / 8) * np.cos((2 * x + 1) * u * np.pi / 16)
                for x in range(8)] for u in range(8)])


class ArithEncoder:
    """``arith_encode`` and ``finish_pass`` of libjpeg's jcarith.c (the QM
    coder, T.81 Annex D), with its 0xFF stacking and carry handling."""

    def __init__(self):
        from audioeditingcode_tpu_torch.utils.image_jpeg_arith import ARITAB
        self.tab = ARITAB
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, b):
        self.out.append(b)

    def _flush_pending(self, byte):
        if self.zc:
            self.out += bytes(self.zc)
            self.zc = 0
        self._emit(byte)

    def encode(self, st, i, val):
        sv = st[i]
        qe = self.tab[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._flush_pending(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._flush_pending(self.buffer)
                    if self.sc:
                        if self.zc:
                            self.out += bytes(self.zc)
                            self.zc = 0
                        self.out += b"\xff\x00" * self.sc
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_pending(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_pending(self.buffer)
            if self.sc:
                if self.zc:
                    self.out += bytes(self.zc)
                    self.zc = 0
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            if self.zc:
                self.out += bytes(self.zc)
                self.zc = 0
            b = (self.c >> 19) & 0xFF
            self._emit(b)
            if b == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                b = (self.c >> 11) & 0xFF
                self._emit(b)
                if b == 0xFF:
                    self._emit(0)
        out, self.out = bytes(self.out), bytearray()
        self.reset()
        return out


def _encode_magnitude(enc, st, i, v, x):
    """Figures F.8 and F.9 (AC: a second decision at ``i``, then bins from
    ``x``) for v >= 1."""
    m = 0
    v -= 1
    if v:
        enc.encode(st, i, 1)
        m = 1
        v2 = v >> 1
        if v2:
            enc.encode(st, i, 1)
            m <<= 1
            i = x
            v2 >>= 1
            while v2:
                enc.encode(st, i, 1)
                m <<= 1
                i += 1
                v2 >>= 1
    enc.encode(st, i, 0)
    i += 14
    m >>= 1
    while m:
        enc.encode(st, i, 1 if m & v else 0)
        m >>= 1


class _ScanState:
    def __init__(self, ncomp):
        self.dc = {}
        self.ac = {}
        self.fixed = [113]
        self.last = [0] * ncomp
        self.ctx = [0] * ncomp

    def dc_stats(self, t):
        return self.dc.setdefault(t, [0] * 64)

    def ac_stats(self, t):
        return self.ac.setdefault(t, [0] * 256)


def _encode_dc(enc, state, ci, value, lu):
    st = state.dc_stats(0 if ci == 0 else 1)
    s0 = state.ctx[ci]
    v = value - state.last[ci]
    if v == 0:
        enc.encode(st, s0, 0)
        state.ctx[ci] = 0
        return
    state.last[ci] = value
    enc.encode(st, s0, 1)
    sign = int(v < 0)
    v = abs(v)
    enc.encode(st, s0 + 1, sign)
    i = s0 + 2 + sign
    state.ctx[ci] = 4 + 4 * sign
    m = 0
    v -= 1
    if v:
        enc.encode(st, i, 1)
        m = 1
        v2 = v
        i = 20
        v2 >>= 1
        while v2:
            enc.encode(st, i, 1)
            m <<= 1
            i += 1
            v2 >>= 1
    enc.encode(st, i, 0)
    if m < (1 << lu[0]) >> 1:
        state.ctx[ci] = 0
    elif m > (1 << lu[1]) >> 1:
        state.ctx[ci] += 8
    i += 14
    m >>= 1
    while m:
        enc.encode(st, i, 1 if m & v else 0)
        m >>= 1


def _encode_ac(enc, state, ci, block, ss, se, al, kx):
    """Figure F.5 / G.9 over zigzag band ss..se of ``block`` (values >> al)."""
    st = state.ac_stats(0 if ci == 0 else 1)
    vals = [(abs(int(block[k])) >> al) * (1 if block[k] >= 0 else -1) for k in range(64)]
    ke = se
    while ke >= ss and vals[ke] == 0:
        ke -= 1
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        enc.encode(st, i, 0)
        while vals[k] == 0:
            enc.encode(st, i + 1, 0)
            i += 3
            k += 1
        enc.encode(st, i + 1, 1)
        v = vals[k]
        enc.encode(state.fixed, 0, int(v < 0))
        _encode_magnitude(enc, st, i + 2, abs(v), 189 if k <= kx else 217)
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def _encode_ac_refine(enc, state, ci, block, ss, se, ah, al):
    """Figure G.10: correction bits and new coefficients at bit ``al``."""
    st = state.ac_stats(0 if ci == 0 else 1)
    mag = [abs(int(block[k])) for k in range(64)]
    ke = se
    while ke >= ss and (mag[ke] >> al) == 0:
        ke -= 1
    kex = ke
    while kex > 0 and (mag[kex] >> ah) == 0:
        kex -= 1
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        if k > kex:
            enc.encode(st, i, 0)
        while True:
            v = mag[k] >> al
            if v:
                if v >> 1:
                    enc.encode(st, i + 2, v & 1)
                else:
                    enc.encode(st, i + 1, 1)
                    enc.encode(state.fixed, 0, int(block[k] < 0))
                break
            enc.encode(st, i + 1, 0)
            i += 3
            k += 1
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def _coefficients(img, sampling, quality):
    """Quantized zigzag blocks of each component in its padded MCU grid:
    {ci: (rows, cols, 64)}, and the quantization tables."""
    h, w = img.shape[:2]
    if img.ndim == 2:
        planes, sampling = [img.astype(np.float64)], [(1, 1)]
    else:
        ycc = np.asarray(Image.fromarray(img).convert("YCbCr"), np.float64)
        planes = [ycc[:, :, i] for i in range(3)]
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    q = [_quant(_LUMA, quality), _quant(_CHROMA, quality)]
    out = {}
    for ci, (p, (sh, sv)) in enumerate(zip(planes, sampling)):
        p = np.pad(p, ((0, mcuy * 8 * vmax - h), (0, mcux * 8 * hmax - w)), mode="edge")
        p = p.reshape(p.shape[0] // (vmax // sv), vmax // sv, p.shape[1] // (hmax // sh),
                      hmax // sh).mean(axis=(1, 3)) - 128
        blocks = p.reshape(mcuy * sv, 8, mcux * sh, 8).transpose(0, 2, 1, 3)
        f = np.einsum("ux,rcxy,vy->rcuv", _C, blocks, _C).reshape(mcuy * sv, mcux * sh, 64)
        qt = q[min(ci, 1)]
        out[ci] = np.round(f / qt)[:, :, NATURAL].astype(np.int64)
    return out, q, sampling, (mcux, mcuy)


def arith_jpeg(img, sampling=((1, 1), (1, 1), (1, 1)), quality=90, progressive=False,
               restart=0, dac=None):
    """An arithmetic-coded JPEG (JFIF) of ``img`` (greyscale or RGB)."""
    blocks, q, sampling, (mcux, mcuy) = _coefficients(img, list(sampling), quality)
    n = len(sampling)
    h, w = img.shape[:2]
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    dqt = b"".join(bytes([t]) + bytes(np.asarray(q[t]).astype(np.uint8)[NATURAL].tolist())
                   for t in range(min(n, 2)))
    sof = struct.pack(">BHHB", 8, h, w, n) + b"".join(
        bytes([i + 1, (sh << 4) | sv, min(i, 1)]) for i, (sh, sv) in enumerate(sampling))
    cond = dac or {}
    out = b"\xff\xd8" + JFIF + _segment(0xDB, dqt) + _segment(0xCA if progressive else 0xC9,
                                                                    sof)
    if dac:
        out += _segment(0xCC, b"".join(bytes([(tc << 4) | tb, (v[1] << 4) | v[0] if tc == 0
                                              else v]) for (tc, tb), v in dac.items()))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    if progressive:
        scans = [(list(range(n)), 0, 0, 0, 1)]
        scans += [([c], 1, 5, 0, 1) for c in range(n)] + [([c], 6, 63, 0, 1) for c in range(n)]
        scans += [(list(range(n)), 0, 0, 1, 0)]
        scans += [([c], 1, 63, 1, 0) for c in range(n)]
    else:
        scans = [(list(range(n)), 0, 63, 0, 0)]
    for members, ss, se, ah, al in scans:
        header = bytes([len(members)]) + b"".join(
            bytes([c + 1, (min(c, 1) << 4) | min(c, 1)]) for c in members) + bytes(
            [ss, se, (ah << 4) | al])
        out += _segment(0xDA, header)
        if len(members) > 1:
            units = [[(c, (my * sampling[c][1] + yy, mx * sampling[c][0] + xx))
                      for c in members for yy in range(sampling[c][1])
                      for xx in range(sampling[c][0])]
                     for my in range(mcuy) for mx in range(mcux)]
        else:
            c = members[0]
            bw = -(-(-(-w * sampling[c][0] // hmax)) // 8)
            bh = -(-(-(-h * sampling[c][1] // vmax)) // 8)
            units = [[(c, (by, bx))] for by in range(bh) for bx in range(bw)]
        enc = ArithEncoder()
        state = _ScanState(n)
        data, rst = b"", 0
        for u, unit in enumerate(units):
            if restart and u and u % restart == 0:
                data += enc.finish() + bytes([0xFF, 0xD0 + rst % 8])
                rst += 1
                state = _ScanState(n)
            for c, (by, bx) in unit:
                b = blocks[c][by, bx]
                t = min(c, 1)
                if ss == 0 and ah == 0:
                    dc = int(b[0])
                    _encode_dc(enc, state, c, dc >> al if progressive else dc,
                               cond.get((0, t), (0, 1)))
                    if not progressive:
                        _encode_ac(enc, state, c, b, 1, 63, 0, cond.get((1, t), 5))
                elif ss == 0:
                    enc.encode(state.fixed, 0, (int(b[0]) >> al) & 1)
                elif ah == 0:
                    _encode_ac(enc, state, c, b, ss, se, al, cond.get((1, t), 5))
                else:
                    _encode_ac_refine(enc, state, c, b, ss, se, ah, al)
        out += data + enc.finish()
    return out + b"\xff\xd9"


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255 ** 2 / mse)


ARITH_CASES = {
    "seq_444": dict(), "seq_420_restart": dict(sampling=((2, 2), (1, 1), (1, 1)), restart=3),
    "seq_422_dac": dict(sampling=((2, 1), (1, 1), (1, 1)), dac={(0, 0): (2, 5), (0, 1): (0, 0),
                                                                (1, 0): 12, (1, 1): 1}),
    "prog_444": dict(progressive=True), "prog_420_restart": dict(
        sampling=((2, 2), (1, 1), (1, 1)), progressive=True, restart=2),
    "seq_q30": dict(quality=30), "prog_q98": dict(quality=98, progressive=True),
}


@pytest.mark.parametrize("case", sorted(ARITH_CASES))
def test_arithmetic_jpeg_is_real_and_matches_pil(tmp_path, case):
    """PIL decodes the encoder's file near its source: a PSNR of at least
    28 dB, and within 1.5 dB of PIL's own baseline JPEG of the same quality
    and subsampling (their quantization's error); the port gives PIL's
    pixels."""
    img = _pattern(37, 53, noise=0.05, seed=len(case))
    kw = ARITH_CASES[case]
    path = _write(tmp_path, "a.jpg", arith_jpeg(img, **kw))
    got = _pil(path)
    ref = str(tmp_path / "ref.jpg")
    Image.fromarray(img).save(ref, quality=kw.get("quality", 90), subsampling={
        (1, 1): 0, (2, 1): 1, (2, 2): 2}[kw.get("sampling", ((1, 1),))[0]])
    assert _psnr(got, img) >= max(28.0, _psnr(_pil(ref), img) - 1.5), _psnr(got, img)
    _check(path)


def test_arithmetic_greyscale_and_truncated(tmp_path):
    img = _pattern(29, 41, noise=0.05)[:, :, 1]
    for progressive in (False, True):
        data = arith_jpeg(img, sampling=((1, 1),), progressive=progressive, restart=4)
        path = _write(tmp_path, "g.jpg", data)
        _check(path)
        _both_raise(_write(tmp_path, "t.jpg", data[:len(data) * 2 // 3]))


# -------------------------------------------------------- block smoothing
SMOOTH_CASES = [((64, 96), "RGB", 0), ((37, 53), "RGB", 2), ((24, 9), "RGB", 2), ((40, 40), "RGB", 2),
                ((41, 41), "RGB", 1), ((16, 16), "RGB", 2), ((23, 100), "L", 0), ((17, 31), "CMYK", 0)]


@pytest.mark.parametrize("size,mode,sub", SMOOTH_CASES,
                         ids=[f"{h}x{w}-{m}-{s}" for (h, w), m, s in SMOOTH_CASES])
def test_progressive_block_smoothing(tmp_path, size, mode, sub):
    """A progressive JPEG cut after each of its scans and closed with EOI:
    libjpeg smooths the blocks whose first AC coefficients lack bits, from
    the DCs around them (DC only: the DC too), and the port gives PIL's
    pixels; the sizes put the 4:2:0 luma's last iMCU row at one block row,
    where libjpeg picks the rows above and below by its own count."""
    h, w = size
    img = Image.fromarray(_pattern(h, w, noise=0.15, seed=h * w)).convert(mode)
    path = str(tmp_path / "p.jpg")
    checked = 0
    for quality in (20, 85):
        img.save(path, quality=quality, progressive=True, subsampling=sub,
                 restart_marker_blocks=3)
        data = open(path, "rb").read()
        scans = _scans(data)
        for cut in scans[1:]:
            _check(_write(tmp_path, "c.jpg", data[:cut] + b"\xff\xd9"))
            checked += 1
    assert checked == 2 * (len(scans) - 1)
