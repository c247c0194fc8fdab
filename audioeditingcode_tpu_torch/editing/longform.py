"""Long-form editing: chunk -> window-batched edit -> overlap-add crossfade.

Counterpart of ``audioeditingcode_tpu/editing/longform.py`` (numpy, as
there): split a long recording into overlapping windows, run the same text
edit on every window in one batched loop (``editing/batched.py``), and
stitch the decoded waveforms with a linear crossfade.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def window_starts(n_frames: int, win: int, hop: int) -> List[int]:
    """Start offsets covering [0, n_frames) with the final window pulled
    back to end exactly at n_frames (full coverage, no short tail)."""
    if n_frames <= win:
        return [0]
    starts = list(range(0, n_frames - win + 1, hop))
    if starts[-1] + win < n_frames:
        starts.append(n_frames - win)
    return starts


def split_windows(mel: np.ndarray, win: int, hop: int) -> Tuple[np.ndarray, List[int]]:
    """(1, 1, T, M) full mel -> ((N, 1, win, M) windows, start offsets).
    T < win is right-padded with zeros."""
    T = mel.shape[2]
    if T < win:
        mel = np.pad(mel, ((0, 0), (0, 0), (0, win - T), (0, 0)))
        T = win
    starts = window_starts(T, win, hop)
    wins = np.concatenate([mel[:, :, s: s + win] for s in starts], axis=0)
    return wins, starts


def overlap_add(
    wavs: np.ndarray,  # (N, C, Tw) decoded window waveforms
    starts_samples: List[int],
    total_samples: int,
) -> np.ndarray:
    """Linear-crossfade overlap-add: where consecutive windows overlap, the
    earlier one fades out and the later one fades in; the weights sum to 1
    inside every overlap."""
    N, C, Tw = wavs.shape
    out = np.zeros((C, total_samples), np.float32)
    weight = np.zeros((1, total_samples), np.float32)
    for i, s in enumerate(starts_samples):
        w = np.ones((1, Tw), np.float32)
        if i > 0:
            ov = starts_samples[i - 1] + Tw - s
            if ov > 0:
                w[:, :ov] = np.linspace(0.0, 1.0, ov, dtype=np.float32)
        if i < N - 1:
            ov = s + Tw - starts_samples[i + 1]
            if ov > 0:
                w[:, -ov:] = np.linspace(1.0, 0.0, ov, dtype=np.float32)
        end = min(s + Tw, total_samples)
        out[:, s:end] += (wavs[i] * w)[:, : end - s]
        weight[:, s:end] += w[:, : end - s]
    return out / np.maximum(weight, 1e-8)
