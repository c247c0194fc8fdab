"""The mel front end of the mel families, copied from the port's audio
loader: normalise, pad to the loader's length, renormalise, then the log-mel
transform of ``ops/stft.py``."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .ops.stft import mel_spectrogram  # noqa: F401  (the front end's transform)


def normalize_wav(waveform: np.ndarray) -> np.ndarray:
    """Center, peak-normalize, scale to 0.5 amplitude."""
    waveform = waveform - np.mean(waveform)
    waveform = waveform / (np.max(np.abs(waveform)) + 1e-8)
    return (waveform * 0.5).astype(np.float32)


def pad_wav(waveform: np.ndarray, segment_length: Optional[int]) -> np.ndarray:
    """Trim/zero-pad a (1, L) waveform to segment_length."""
    waveform_length = waveform.shape[-1]
    if segment_length is None or waveform_length == segment_length:
        return waveform
    if waveform_length > segment_length:
        return waveform[..., :segment_length]
    out = np.zeros((1, segment_length), dtype=np.float32)
    out[:, :waveform_length] = waveform
    return out


def pad_spec(fbank: np.ndarray, target_length: int) -> np.ndarray:
    """Pad/trim (T, n_mels) along time; drop the last mel bin if odd."""
    n_frames = fbank.shape[0]
    p = target_length - n_frames
    if p > 0:
        fbank = np.pad(fbank, ((0, p), (0, 0)))
    elif p < 0:
        fbank = fbank[:target_length]
    if fbank.shape[-1] % 2 != 0:
        fbank = fbank[..., :-1]
    return fbank
