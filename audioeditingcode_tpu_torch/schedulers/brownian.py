"""Brownian-tree noise for the Stable Audio sampling loops.

The port's own copy of ``audioeditingcode_tpu/schedulers/brownian.py``, a
pure-numpy module: for a seed and a sigma grid it gives bit for bit the
JAX package's draws.

The upstream sampler draws its generation-mode variance noise from
torchsde's ``BrownianTreeNoiseSampler``: the per-step noise is the
normalized increment of ONE underlying Brownian path over the sigma
interval, ``(W(s_{i+1}) - W(s_i)) / sqrt(|ds|)``. Marginally each
increment is i.i.d. N(0, I); what makes the tree a tree is *path
consistency*: for a fixed seed, runs with different step counts (or
queried at any sigma grid) sample the same underlying path, so a 50-step
and a 100-step run of the same generation stay comparable.

Everything runs on the host in numpy once per run; the loops take the
stacked noise as an argument. ``W(t)`` is evaluated by a canonical
fixed-depth dyadic bridge descent with one counter-based RNG stream per
tree node: the value of ``W(t)`` depends only on (seed, t), never on the
other query points, which gives exact additivity ``W(c)-W(a) =
[W(c)-W(b)] + [W(b)-W(a)]`` and cross-step-count consistency by
construction.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = ["BrownianPath", "brownian_noise_for_sigmas"]


def _node_normal(seed: int, depth: int, idx: int, shape: Tuple[int, ...]):
    """The standard-normal draw owned by one dyadic tree node.

    Keyed by (seed, depth, idx) through SeedSequence spawn keys, so every
    node's draw is reproducible in isolation (no sampling order effects).
    """
    ss = np.random.SeedSequence(entropy=int(seed) & (2 ** 63 - 1),
                                spawn_key=(int(depth), int(idx)))
    return np.random.default_rng(ss).standard_normal(shape).astype(np.float32)


class BrownianPath:
    """W(t) on [t0, t1] with W(t0) = 0, evaluated at arbitrary t.

    Midpoints are filled level-by-level with the Brownian-bridge law
    ``W(m) | W(a), W(b) ~ N((W(a)+W(b))/2, (b-a)/4)``; below ``depth``
    levels the path is linearly interpolated (the leaf is (t1-t0)/2^depth
    wide — with the default depth 30 and sigma_max 500 that is ~5e-7, far
    below any solver's sigma step).
    """

    def __init__(self, seed: int, shape: Sequence[int], t0: float, t1: float,
                 depth: int = 30):
        if not t1 > t0:
            raise ValueError(f"need t1 > t0, got [{t0}, {t1}]")
        self.seed = int(seed)
        self.shape = tuple(shape)
        self.t0, self.t1 = float(t0), float(t1)
        self.depth = int(depth)
        self._w1 = np.sqrt(self.t1 - self.t0) * _node_normal(
            self.seed, 0, 0, self.shape)

    def __call__(self, t: float) -> np.ndarray:
        t = min(max(float(t), self.t0), self.t1)
        a, b = self.t0, self.t1
        wa, wb = np.zeros(self.shape, np.float32), self._w1
        idx = 0
        for d in range(1, self.depth + 1):
            m = 0.5 * (a + b)
            wm = 0.5 * (wa + wb) + np.sqrt(0.25 * (b - a)) * _node_normal(
                self.seed, d, idx, self.shape)
            if t <= m:
                b, wb = m, wm
                idx = 2 * idx
            else:
                a, wa = m, wm
                idx = 2 * idx + 1
        if b == a:  # degenerate only if depth made the leaf collapse in fp
            return wa
        frac = (t - a) / (b - a)
        return wa + (wb - wa) * np.float32(frac)


def brownian_noise_for_sigmas(
    seed: int,
    sigmas: Sequence[float],
    shape: Sequence[int],
    depth: int = 30,
) -> np.ndarray:
    """Stacked per-step variance noise for a sigma schedule.

    ``sigmas`` is the solver's decreasing schedule INCLUDING the final
    entry (length S+1, reference step i consumes the interval
    (sigmas[i], sigmas[i+1])).  Returns float32 ``(S,) + shape`` with row
    ``i = (W(sigmas[i+1]) - W(sigmas[i])) / sqrt(|sigmas[i+1]-sigmas[i]|)``
    — exactly the k-diffusion/torchsde normalization the reference's
    sampler applies (reference models.py:1310-1312).  Zero-width intervals
    (e.g. a clamped final sigma) get zero noise; the solver masks the last
    step's noise anyway (step_zero_noise).
    """
    sig = np.asarray(sigmas, dtype=np.float64)
    if sig.ndim != 1 or sig.size < 2:
        raise ValueError(f"sigmas must be 1-D with >=2 entries, got {sig.shape}")
    hi = float(sig.max())
    if hi <= 0:
        raise ValueError("sigma schedule has no positive entries")
    path = BrownianPath(seed, shape, t0=0.0, t1=hi, depth=depth)
    w = [path(s) for s in sig]
    out = np.zeros((sig.size - 1,) + tuple(shape), np.float32)
    for i in range(sig.size - 1):
        dt = abs(float(sig[i + 1]) - float(sig[i]))
        if dt > 0:
            out[i] = (w[i + 1] - w[i]) / np.float32(np.sqrt(dt))
    return out
