"""LPAPS — LPIPS-for-audio perceptual distance (a copy of
``audioeditingcode_tpu/evals/lpaps.py``: numpy on the host, over the stage
features that the extractor computes on the card).

Reproduces the reference metric exactly (reference: evals/lpaps.py:25-78):

  dist(a, b) = sum over stages s of
      spatial_average( sum_channels( (normalize(f_s(a)) - normalize(f_s(b)))^2 ) )

with ``normalize_tensor(x) = x / sqrt(sum_c x^2)`` (evals/lpaps.py:10-12) and
``spatial_average`` the mean over all non-channel feature axes
(evals/lpaps.py:15-16). The feature network is pluggable (features.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .windows import windowed_score


def _normalize(feat: np.ndarray, channel_axis: int, eps: float = 1e-10) -> np.ndarray:
    norm = np.sqrt(np.sum(feat ** 2, axis=channel_axis, keepdims=True))
    return feat / (norm + eps)


def lpaps_distance(
    stages_a: Sequence[np.ndarray],
    stages_b: Sequence[np.ndarray],
    channel_axis: int = -1,
) -> float:
    """Stage-feature distance (reference: evals/lpaps.py:60-78)."""
    total = 0.0
    for fa, fb in zip(stages_a, stages_b):
        d = (_normalize(fa, channel_axis) - _normalize(fb, channel_axis)) ** 2
        d = np.sum(d, axis=channel_axis)  # sum over channels
        total += float(np.mean(d))  # spatial average (+ batch mean)
    return total


class LPAPS:
    """Callable metric bound to a feature extractor.

    ``model(aud1, aud2, sr1, sr2)`` like the reference's module call
    (evals/lpaps.py:44-78); use :meth:`windowed` for the 10 s / 10%-overlap
    protocol (evals/utils.py:36-84)."""

    def __init__(self, extractor, channel_axis: int = -1):
        self.extractor = extractor
        self.channel_axis = channel_axis

    def __call__(self, aud1: np.ndarray, aud2: np.ndarray, sr1: int, sr2: int) -> float:
        sa = self.extractor.stages(aud1, sr1)
        sb = self.extractor.stages(aud2, sr2)
        return lpaps_distance(sa, sb, self.channel_axis)

    def windowed(
        self,
        aud1: np.ndarray,
        aud2: np.ndarray,
        sr1: int,
        sr2: int,
        window_size_s: Optional[float] = None,
        overlap: float = 0.1,
        method: str = "mean",
    ) -> float:
        return windowed_score(
            lambda w1, w2: self(w1, w2, sr1, sr2),
            [np.atleast_2d(aud1), np.atleast_2d(aud2)], [sr1, sr2],
            window_size_s, overlap, method,
        )
