"""Windowed scoring utilities (a copy of ``audioeditingcode_tpu/evals/windows.py``).

Reproduces the reference's 10 s / 10 %-overlap windowing semantics
(reference: evals/utils.py:36-116 compute_*_with_windows,
evals/fadtk_utils.py:11-23 split_to_overlapping_windows).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

_METHODS = {
    "mean": np.mean,
    "median": np.median,
    "max": np.max,
    "min": np.min,
}


def split_to_overlapping_windows(
    aud: np.ndarray, sr: int, window_size_s: float = 10.0, overlap: float = 0.1
) -> List[np.ndarray]:
    """Split (..., T) audio into 10 s windows with 10% overlap
    (reference: evals/fadtk_utils.py:11-23 — same start-stride convention)."""
    win = int(sr * window_size_s)
    stride = int(win * (1 - overlap))
    return [aud[..., i: i + win] for i in range(0, aud.shape[-1], stride)]


def combine(scores: Sequence[float], method: str = "mean") -> float:
    if method not in _METHODS:
        raise ValueError(f"Unknown method: {method}")
    return float(_METHODS[method](scores))


def windowed_score(
    score_fn: Callable[..., float],
    auds: Sequence[np.ndarray],
    srs: Sequence[int],
    window_size_s: Optional[float] = None,
    overlap: float = 0.1,
    method: str = "mean",
) -> float:
    """Apply ``score_fn(window_1, ..., window_n)`` over aligned windows of one
    or more audios and combine (reference: evals/utils.py:36-116 — the zip of
    per-audio window ranges, so windows stay aligned even across sample
    rates)."""
    ws = window_size_s if window_size_s is not None else 10.0
    wins = [split_to_overlapping_windows(a, sr, ws, overlap)
            for a, sr in zip(auds, srs)]
    n = min(len(w) for w in wins)
    scores = [float(score_fn(*[w[i] for w in wins])) for i in range(n)]
    return combine(scores, method)
