"""JPEG 2000's inverse wavelet and component transforms for
``image_jpeg2000``, in numpy, as OpenJPEG 2.5.4 computes them
(``dwt.c``, ``mct.c``).

- 5/3 (reversible): integer lifting with symmetric extension, the rows of
  a resolution first, then its columns. Each line's parity (which samples
  are low-pass) comes from the resolution's origin (x0 or y0 odd: the first
  sample is high-pass). A line of one high-pass sample is halved (C's
  truncating division), as OpenJPEG does.
- 9/7 (irreversible): float32 lifting with OpenJPEG's constants and order:
  the low-pass samples times K, the high-pass ones times OpenJPEG's 2/K
  (1.625732422), then the four steps (delta, gamma, beta, alpha, each
  negated), each step x += (left + right) * c as separate float32
  operations (no FMA, nothing in float64), with the neighbour mirrored at
  a line's ends. A line of one sample is left as it is.
- The component transforms: RCT in integers (g = y - ((u + v) >> 2)),
  ICT in float32 with ``mct.c``'s constants and order.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

_F = np.float32
_K, _TWO_INVK = _F(1.230174105), _F(1.625732422)
_ALPHA, _BETA, _GAMMA, _DELTA = _F(-1.586134342), _F(-0.052980118), _F(0.882911075), \
    _F(0.443506852)


def _idwt53_lines(x: np.ndarray, sn: int, dn: int, cas: int) -> np.ndarray:
    """Lines (rows of ``x``: sn low-pass then dn high-pass samples, int64)
    interleaved and lifted back (``opj_dwt_decode_1_``)."""
    n = sn + dn
    out = np.empty_like(x)
    lo, hi = x[:, :sn], x[:, sn:]
    if cas == 0:
        if not (dn > 0 or sn > 1):
            return x.copy()
        s, d = lo.copy(), hi
        i = np.arange(sn)
        dl, dr = d[:, np.clip(i - 1, 0, dn - 1)], d[:, np.clip(i, 0, dn - 1)]
        s -= (dl + dr + 2) >> 2
        j = np.arange(dn)
        d = d + ((s[:, np.clip(j, 0, sn - 1)] + s[:, np.clip(j + 1, 0, sn - 1)]) >> 1)
        out[:, 0::2], out[:, 1::2] = s, d
        return out
    if sn == 0 and dn == 1:
        return np.where(x < 0, -((-x) // 2), x // 2)
    s, d = hi, lo.copy()  # high-pass on the even positions, low-pass on the odd
    i = np.arange(sn)
    d -= (s[:, np.clip(i, 0, dn - 1)] + s[:, np.clip(i + 1, 0, dn - 1)] + 2) >> 2
    j = np.arange(dn)
    s = s + ((d[:, np.clip(j, 0, sn - 1)] + d[:, np.clip(j - 1, 0, sn - 1)]) >> 1)
    out[:, 0::2], out[:, 1:n:2] = s, d
    return out


def _lift(x: np.ndarray, pos: int, count: int, c: np.float32) -> None:
    """x[:, pos + 2i] += (left + right) * c for i < count, the neighbours
    at pos + 2i -+ 1, a missing one mirrored (``opj_v8dwt_decode_step2``)."""
    if count <= 0:
        return
    n = x.shape[1]
    t = pos + 2 * np.arange(count)
    left, right = t - 1, t + 1
    left = np.where(left < 0, right, left)
    right = np.where(right >= n, left, right)
    x[:, t] = x[:, t] + (x[:, left] + x[:, right]) * c


def _idwt97_lines(x: np.ndarray, sn: int, dn: int, cas: int) -> np.ndarray:
    """The 9/7 counterpart of ``_idwt53_lines`` on float32 lines
    (``opj_v8dwt_decode``)."""
    n = sn + dn
    out = np.empty_like(x)
    a, b = cas, 1 - cas
    out[:, a:n:2], out[:, b:n:2] = x[:, :sn], x[:, sn:]
    if (cas == 0 and not (dn > 0 or sn > 1)) or (cas == 1 and not (sn > 0 or dn > 1)):
        return out
    out[:, a:n:2] *= _K
    out[:, b:n:2] *= _TWO_INVK
    _lift(out, a, sn, -_DELTA)
    _lift(out, b, dn, -_GAMMA)
    _lift(out, a, sn, -_BETA)
    _lift(out, b, dn, -_ALPHA)
    return out


def inverse_dwt(tile: np.ndarray, res: List[Tuple[int, int, int, int]],
                reversible: bool) -> np.ndarray:
    """A tile-component's coefficients (int64 for 5/3, float32 for 9/7;
    each resolution's bands laid out as OpenJPEG lays them) transformed back
    level by level, ``res`` being the resolutions' (x0, y0, x1, y1)."""
    lines = _idwt53_lines if reversible else _idwt97_lines
    x = tile.copy()
    rw, rh = res[0][2] - res[0][0], res[0][3] - res[0][1]
    for x0, y0, x1, y1 in res[1:]:
        snw, snh = rw, rh
        rw, rh = x1 - x0, y1 - y0
        if rw and rh:
            x[:rh, :rw] = lines(x[:rh, :rw], snw, rw - snw, x0 % 2)
            x[:rh, :rw] = lines(x[:rh, :rw].T, snh, rh - snh, y0 % 2).T
    return x


def inverse_rct(y: np.ndarray, u: np.ndarray, v: np.ndarray):
    """``opj_mct_decode`` in its int32 arithmetic, which wraps."""
    def w(x):
        return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)

    g = w(y - (w(u + v) >> 2))
    return w(v + g), g, w(u + g)


def inverse_ict(y: np.ndarray, u: np.ndarray, v: np.ndarray):
    r = y + v * _F(1.402)
    g = (y - u * _F(0.34413)) - v * _F(0.71414)
    b = y + u * _F(1.772)
    return r, g, b
