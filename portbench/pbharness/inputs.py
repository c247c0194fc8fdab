"""The cell's clips, made from the seed: the synthetic clip of the port's
smoke script (two tones and a little noise; stereo adds a third tone,
louder on the right), with each clip's tones drawn from the seed so that
every clip of a batch differs, as 16-bit PCM would hold it. Every seed
gives the same sizes; only the values move."""

from __future__ import annotations

import numpy as np
import torch

from . import seeds


def clip(seed: int, index: int, seconds: float, sr: int, channels: int) -> np.ndarray:
    """(channels, samples) float32 in [-1, 1], quantised to 16 bits."""
    rng = np.random.default_rng(seeds.subseed(seed, "clip", index))
    f0, f1, f2 = rng.uniform(200.0, 500.0), rng.uniform(900.0, 1600.0), rng.uniform(450.0, 700.0)
    t = np.arange(int(sr * seconds)) / sr
    wave = 0.4 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(2 * np.pi * f1 * t)
    wave += 0.02 * rng.standard_normal(t.shape)
    if channels == 2:
        wave = np.stack([wave, wave + 0.2 * np.sin(2 * np.pi * f2 * t)]) / 1.2
    else:
        wave = wave[None]
    return (np.round(wave * 32767).astype(np.int16).astype(np.float32) / 32768.0)


def waveform_batch(seed: int, n: int, seconds: float, sr: int, channels: int,
                   device) -> torch.Tensor:
    """(n, channels, samples): each clip with its mean removed and its peak
    at 0.5, as the port's loader hands a clip to Stable Audio."""
    out = []
    for i in range(n):
        w = clip(seed, i, seconds, sr, channels)
        w = w - w.mean()
        out.append(w / (np.abs(w).max() + 1e-8) * 0.5)
    return torch.as_tensor(np.stack(out).astype(np.float32), device=device)


def mel_batch(seed: int, n: int, seconds: float, mel_config, device, frontend) -> torch.Tensor:
    """(n, 1, frames, n_mels): each mono clip through the mel front end of
    the mel families (``frontend``: the port's or the reference's audio
    module), at the loader's 102.4 frames a second."""
    frames = int(seconds * 102.4)
    mels = []
    for i in range(n):
        w = clip(seed, i, seconds, mel_config.sampling_rate, 1)[0]
        w = frontend.normalize_wav(w)[None]
        w = frontend.pad_wav(w, frames * mel_config.hop_length)
        w = (0.5 * w / np.max(np.abs(w))).astype(np.float32)
        w = np.clip(w, -1.0, 1.0)
        with torch.no_grad():
            log_mel, _, _ = frontend.mel_spectrogram(torch.as_tensor(w, device=device),
                                                     mel_config)
        fbank = frontend.pad_spec(log_mel[0].T.cpu().numpy(), frames)
        mels.append(fbank[None])
    return torch.as_tensor(np.stack(mels).astype(np.float32), device=device)
