"""CIELab -> RGB as PIL 12.1's ``convert("RGB")`` gives it from mode LAB,
numpy only.

PIL converts LAB through LittleCMS (2.17): a transform from
``cmsCreateLab2Profile(NULL)`` (D50) to ``cmsCreate_sRGBProfile()`` with
the perceptual intent, 8-bit Lab in, 8-bit RGB out, on the LAB bytes with
a* and b* taken as offset by 128 (a TIFF's signed a* and b* bytes, as PIL
stores them, XOR 128). LittleCMS optimizes that transform into a 33 x 33 x
33 16-bit CLUT sampled from the unoptimized pipeline and interpolates it
tetrahedrally. This module rebuilds both:

- the nodes, as ``cmsPipelineEval16`` computes them on the pipeline that
  ``PreOptimize`` leaves (Lab -> XYZ, the inverse of sRGB's D50-adapted
  colorant matrix times 1 + 32767/32768, the analytic inverse of sRGB's
  parametric curve), with float32 between the stages and LittleCMS's
  rounding to 16 bits (``_cmsQuickSaturateWord``); black-point
  compensation, which LittleCMS forces for the v4 sRGB profile, leaves an
  empty layer there, since both black points are (0, 0, 0);
- ``TetrahedralInterp16`` on the 8-bit input widened to 16 bits (x * 257)
  and the output narrowed back as ``FROM_16_TO_8``.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np

_D50 = (0.9642, 1.0, 0.8249)
_BRADFORD = [[0.8951, 0.2664, -0.1614], [-0.7502, 1.7135, 0.0367], [0.0389, -0.0685, 1.0296]]
_MAX_XYZ = 1.0 + 32767.0 / 32768.0  # MAX_ENCODEABLE_XYZ
_GRID = 33
# sRGB's parametric curve (type 4): gamma, a, b, c, d
_SRGB = (2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045)


def _inv3(a: List[List[float]]) -> List[List[float]]:
    """``_cmsMAT3inverse``, in its order of operations."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return [[c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
             (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det],
            [c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
             (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det],
            [c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det,
             (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det]]


def _mul(a, b):
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j] for j in range(3)]
            for i in range(3)]


def _apply(a, v):
    return [a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2] for i in range(3)]


def _srgb_to_xyz() -> List[List[float]]:
    """sRGB's colorant matrix as ``cmsCreate_sRGBProfile`` builds it
    (``_cmsBuildRGB2XYZtransferMatrix``, Bradford-adapted from D65 to D50)."""
    xn, yn = 0.3127, 0.3290
    (xr, yr), (xg, yg), (xb, yb) = (0.64, 0.33), (0.30, 0.60), (0.15, 0.06)
    coef = _apply(_inv3([[xr, xg, xb], [yr, yg, yb], [1 - xr - yr, 1 - xg - yg, 1 - xb - yb]]),
                  [xn / yn, 1.0, (1.0 - xn - yn) / yn])
    m = [[coef[0] * xr, coef[1] * xg, coef[2] * xb], [coef[0] * yr, coef[1] * yg, coef[2] * yb],
         [coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg), coef[2] * (1.0 - xb - yb)]]
    src = [(xn / yn) * 1.0, 1.0, ((1 - xn - yn) / yn) * 1.0]
    s, d = _apply(_BRADFORD, src), _apply(_BRADFORD, list(_D50))
    cone = [[d[0] / s[0], 0.0, 0.0], [0.0, d[1] / s[1], 0.0], [0.0, 0.0, d[2] / s[2]]]
    return _mul(_mul(_inv3(_BRADFORD), _mul(cone, _BRADFORD)), m)


def _saturate_word(d: np.ndarray) -> np.ndarray:
    """``_cmsQuickSaturateWord``: d + 0.5, clamped, floored through the
    16.16 fixed point of ``_cmsQuickFloor`` (rounded to nearest even)."""
    d = d + 0.5
    fixed = np.round((d - 32767.0) * 65536.0)
    floor = (np.floor_divide(fixed, 65536) + 32767).astype(np.int64) & 0xFFFF
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 65535, floor))


@functools.lru_cache(maxsize=1)
def _nodes() -> np.ndarray:
    """The (33, 33, 33, 3) int64 CLUT LittleCMS samples (``XFormSampler16``
    at ``_cmsQuantizeVal`` inputs)."""
    f32 = np.float32
    q = np.floor(np.arange(_GRID) * 65535.0 / (_GRID - 1) + 0.5)
    grid = np.stack(np.meshgrid(q, q, q, indexing="ij"), -1).reshape(-1, 3)
    v = (grid.astype(f32) / f32(65535.0)).astype(np.float64)
    lab_l, lab_a, lab_b = v[:, 0] * 100.0, v[:, 1] * 255.0 - 128.0, v[:, 2] * 255.0 - 128.0
    fy = (lab_l + 16.0) / 116.0

    def f_1(t):
        return np.where(t <= 24.0 / 116.0, (108.0 / 841.0) * (t - (16.0 / 116.0)), t * t * t)

    xyz = [f_1(fy + 0.002 * lab_a) * _D50[0], f_1(fy) * _D50[1], f_1(fy - 0.005 * lab_b) * _D50[2]]
    xyz = [(c / _MAX_XYZ).astype(f32).astype(np.float64) for c in xyz]
    inv = np.array(_inv3(_srgb_to_xyz())) * _MAX_XYZ
    out = []
    g, a, b, c, d = _SRGB
    disc = (a * d + b) ** g
    for i in range(3):
        t = 0.0
        for j in range(3):
            t = t + xyz[j] * inv[i, j]
        r = t.astype(f32).astype(np.float64)
        val = np.where(r >= disc, (np.power(np.maximum(r, 0.0), 1.0 / g) - b) / a, r / c)
        out.append(_saturate_word(val.astype(f32).astype(np.float64) * 65535.0))
    return np.stack(out, -1).reshape(_GRID, _GRID, _GRID, 3)


def _tetrahedral(inp: np.ndarray, table: np.ndarray) -> np.ndarray:
    """LittleCMS's ``TetrahedralInterp16``: (N, 3) 16-bit inputs -> (N, 3)."""
    fixed = [inp[:, i] * (_GRID - 1) for i in range(3)]
    fixed = [f + (f + 0x7FFF) // 0xFFFF for f in fixed]
    lo = [f >> 16 for f in fixed]
    hi = [np.where(inp[:, i] == 0xFFFF, lo[i], lo[i] + 1) for i in range(3)]
    rx, ry, rz = ((f & 0xFFFF)[:, None] for f in fixed)
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    c0 = table[x0, y0, z0]
    sx, sy, sz = rx[:, 0], ry[:, 0], rz[:, 0]
    # each tetrahedron: its mask and the nodes c1, c2, c3 whose differences
    # weigh rx, ry, rz
    cases = [
        ((sx >= sy) & (sy >= sz), (x1, y0, z0), (x1, y1, z0), (x1, y1, z1), "x"),
        ((sx >= sy) & (sy < sz) & (sz >= sx), (x1, y0, z1), (x1, y1, z1), (x0, y0, z1), "z"),
        ((sx >= sy) & (sy < sz) & (sz < sx), (x1, y0, z0), (x1, y1, z1), (x1, y0, z1), "xz"),
        ((sx < sy) & (sx >= sz), (x1, y1, z0), (x0, y1, z0), (x1, y1, z1), "y"),
        ((sx < sy) & (sx < sz) & (sy >= sz), (x1, y1, z1), (x0, y1, z0), (x0, y1, z1), "yz"),
        ((sx < sy) & (sx < sz) & (sy < sz), (x1, y1, z1), (x0, y1, z1), (x0, y0, z1), "zy"),
    ]
    out = np.zeros_like(c0)
    for mask, n1, n2, n3, order in cases:
        c1, c2, c3 = table[n1], table[n2], table[n3]
        if order == "x":
            d1, d2, d3 = c1 - c0, c2 - c1, c3 - c2
        elif order == "z":
            d1, d2, d3 = c1 - c3, c2 - c1, c3 - c0
        elif order == "xz":
            d1, d2, d3 = c1 - c0, c2 - c3, c3 - c1
        elif order == "y":
            d1, d2, d3 = c1 - c2, c2 - c0, c3 - c1
        elif order == "yz":
            d1, d2, d3 = c1 - c3, c2 - c0, c3 - c2
        else:
            d1, d2, d3 = c1 - c2, c2 - c3, c3 - c0
        rest = d1 * rx + d2 * ry + d3 * rz + 0x8001
        v = c0 + ((rest + (rest >> 16)) >> 16)
        out[mask] = v[mask]
    return out


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 LAB as PIL stores it -> (H, W, 3) uint8 RGB."""
    h, w, _ = lab.shape
    v = lab.reshape(-1, 3).astype(np.int64)
    v[:, 1:] ^= 128
    out16 = _tetrahedral(v * 257, _nodes())
    return ((out16 * 65281 + 8388608) >> 24).astype(np.uint8).reshape(h, w, 3)
