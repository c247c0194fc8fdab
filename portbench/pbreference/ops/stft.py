"""STFT / mel-spectrogram frontend as framed matmuls, and its inverse.

Counterpart of ``audioeditingcode_tpu/ops/stft.py`` (no kernel there: XLA
fuses the framed matmuls). Parity targets: periodic Hann window, reflect
padding by n_fft//2, librosa slaney mel filterbank, log(clamp(x, 1e-5)).
``stft_transform`` (magnitude and phase), ``inverse_stft`` (weighted
overlap-add with window-sum-square compensation) and ``griffin_lim``
(phase recovery, its initial phase an argument or drawn from a
``torch.Generator``) synthesise a waveform without a vocoder.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window == scipy.signal.get_window('hann', N, fftbins=True)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float64)


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, (n_mels, n_fft//2+1)
    (librosa.filters.mel with htk=False, norm='slaney')."""
    fftfreqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_min, mel_max = _hz_to_mel_slaney(np.array([fmin, fmax]))
    mels = np.linspace(mel_min, mel_max, n_mels + 2)
    mel_f = _mel_to_hz_slaney(mels)

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights = weights * enorm[:, None]
    return weights.astype(np.float64)


def _window(config: "MelConfig") -> np.ndarray:
    """The periodic Hann window, centre-padded to n_fft (float64)."""
    window = hann_window(config.win_length)
    n_fft = config.filter_length
    if config.win_length < n_fft:
        p = (n_fft - config.win_length) // 2
        window = np.pad(window, (p, n_fft - config.win_length - p))
    return window


def dynamic_range_compression(x: torch.Tensor, clip_val: float = 1e-5, C: float = 1.0):
    """log-clamp compression."""
    return torch.log(torch.clamp(x, min=clip_val) * C)


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """STFT/mel parameters."""

    filter_length: int = 1024
    hop_length: int = 160
    win_length: int = 1024
    n_mel_channels: int = 64
    sampling_rate: int = 16000
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0

    def bases(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(cos_basis, sin_basis, mel_basis) as float32 numpy arrays: the
        windowed real/imag DFT rows and the mel filterbank."""
        n_fft = self.filter_length
        cutoff = n_fft // 2 + 1
        n = np.arange(n_fft, dtype=np.float64)
        k = np.arange(cutoff, dtype=np.float64)[:, None]
        ang = 2.0 * np.pi * k * n[None, :] / n_fft
        window = _window(self)
        cos_b = (np.cos(ang) * window[None, :]).astype(np.float32)
        sin_b = (-np.sin(ang) * window[None, :]).astype(np.float32)
        mel_b = mel_filterbank(
            self.sampling_rate, n_fft, self.n_mel_channels, self.mel_fmin, self.mel_fmax
        ).astype(np.float32)
        return cos_b, sin_b, mel_b


def _stft(wave: torch.Tensor, config: MelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(real, imag) of the STFT of waveforms (B, L), each (B, n_fft//2+1,
    T): reflect pad by n_fft//2, hop-strided frames, windowed DFT as two
    matmuls."""
    cos_b, sin_b, _ = config.bases()
    cos_t = torch.as_tensor(cos_b, device=wave.device)
    sin_t = torch.as_tensor(sin_b, device=wave.device)
    pad = config.filter_length // 2
    x = torch.nn.functional.pad(wave[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, config.filter_length, config.hop_length)  # (B, T, n_fft)
    return (torch.matmul(frames, cos_t.T).transpose(1, 2),
            torch.matmul(frames, sin_t.T).transpose(1, 2))


def stft_magnitude(wave: torch.Tensor, config: MelConfig) -> torch.Tensor:
    """|STFT| of waveforms (B, L) -> (B, n_fft//2+1, T)."""
    real, imag = _stft(wave, config)
    return torch.sqrt(real ** 2 + imag ** 2)


def stft_transform(wave: torch.Tensor, config: MelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(magnitude, phase) of waveforms (B, L), each (B, n_fft//2+1, T)."""
    real, imag = _stft(wave, config)
    return torch.sqrt(real ** 2 + imag ** 2), torch.atan2(imag, real)


def inverse_stft(magnitude: torch.Tensor, phase: torch.Tensor,
                 config: MelConfig) -> torch.Tensor:
    """ISTFT of (B, n_fft//2+1, T) magnitude and phase by weighted
    overlap-add, divided by the window's overlapped sum of squares; (B, L)
    with the reflect padding trimmed."""
    n_fft, hop = config.filter_length, config.hop_length
    window = torch.as_tensor(_window(config), dtype=torch.float32, device=magnitude.device)
    spec = torch.polar(magnitude.float(), phase.float()).transpose(1, 2)  # (B, T, C)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window
    B, T = frames.shape[0], frames.shape[1]
    out_len = (T - 1) * hop + n_fft
    idx = (torch.arange(T, device=frames.device)[:, None] * hop
           + torch.arange(n_fft, device=frames.device)[None, :]).reshape(-1)
    sig = frames.new_zeros((B, out_len)).index_add_(1, idx, frames.reshape(B, -1))
    wss = frames.new_zeros(out_len).index_add_(0, idx, (window ** 2).repeat(T))
    sig = sig / torch.clamp(wss, min=1e-8)[None, :]
    return sig[:, n_fft // 2: -(n_fft // 2)]


def griffin_lim(magnitudes: torch.Tensor, config: MelConfig, n_iters: int = 30,
                phase: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Phase recovery by alternating projection from (B, n_fft//2+1, T)
    magnitudes: ``phase`` is the initial phase, or it is drawn uniform in
    [-pi, pi) from ``generator``."""
    if phase is None:
        phase = (torch.rand(magnitudes.shape, generator=generator, device=magnitudes.device)
                 * 2.0 - 1.0) * math.pi
    signal = inverse_stft(magnitudes, phase, config)
    for _ in range(n_iters):
        _, ang = stft_transform(signal, config)
        signal = inverse_stft(magnitudes, ang[..., : magnitudes.shape[-1]], config)
    return signal


def mel_spectrogram(wave: torch.Tensor, config: MelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """TacotronSTFT.mel_spectrogram: wave (B, L) in [-1, 1] ->
    (log_mel (B, n_mels, T), log_magnitudes (B, n_freq, T), energy (B, T))."""
    _, _, mel_b = config.bases()
    mag = stft_magnitude(wave, config)
    mel = torch.matmul(torch.as_tensor(mel_b, device=wave.device), mag)
    log_mel = dynamic_range_compression(mel)
    log_mag = dynamic_range_compression(mag)
    energy = torch.linalg.norm(mag, dim=1)
    return log_mel, log_mag, energy
