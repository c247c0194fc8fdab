"""Audio IO: WAV read/write, resampling, mel-frontend loading.

Counterpart of ``audioeditingcode_tpu/utils/audio_io.py``: host-side numpy
and scipy, with the mel transform from :mod:`..ops.stft`.
"""

from __future__ import annotations

import wave as wave_mod
from typing import Optional, Tuple, Union

import numpy as np
import torch
from scipy.io import wavfile
from scipy.signal import resample_poly

from ..ops.stft import MelConfig, mel_spectrogram


def get_duration(path: str) -> float:
    """Duration in seconds from the WAV header."""
    with wave_mod.open(path, "rb") as f:
        return f.getnframes() / f.getframerate()


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 waveform (channels, samples), sample_rate)."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 1:
        data = data[None, :]
    else:
        data = data.T  # (channels, samples)
    return data, int(sr)


def write_wav(path: str, waveform: np.ndarray, sample_rate: int) -> None:
    """Write float waveform (channels, samples) or (samples,) as 16-bit PCM WAV."""
    w = np.asarray(waveform, dtype=np.float32)
    if w.ndim == 2:
        w = w.T  # scipy expects (samples, channels)
    w = np.clip(w, -1.0, 1.0)
    wavfile.write(path, sample_rate, (w * 32767.0).astype(np.int16))


def resample(waveform: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase resampling along the last axis."""
    if orig_sr == new_sr:
        return waveform
    g = np.gcd(int(orig_sr), int(new_sr))
    return resample_poly(waveform, new_sr // g, orig_sr // g, axis=-1).astype(np.float32)


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


def read_wav_file(filename: str, segment_length: Optional[int]) -> np.ndarray:
    """Load -> resample 16 kHz -> normalize -> pad -> renormalize (the
    double 0.5-peak normalize)."""
    waveform, sr = read_wav(filename)
    waveform = resample(waveform, sr, 16000)
    waveform = waveform[0, ...]
    waveform = normalize_wav(waveform)
    waveform = waveform[None, ...]
    waveform = pad_wav(waveform, segment_length)
    waveform = waveform / np.max(np.abs(waveform))
    return (0.5 * waveform).astype(np.float32)


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


def wav_to_fbank(
    filename: str,
    target_length: int = 1024,
    config: Optional[MelConfig] = None,
    device: Union[str, torch.device] = "cpu",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """wav file -> (fbank (T, n_mels), log_magnitudes (T, n_freq), waveform (1, L))."""
    config = config or MelConfig()
    waveform = read_wav_file(filename, target_length * config.hop_length)
    wav = np.clip(waveform, -1.0, 1.0)

    with torch.no_grad():
        log_mel, log_mag, _ = mel_spectrogram(torch.as_tensor(wav, device=device), config)
    fbank = log_mel[0].T.cpu().numpy()  # (T, n_mels)
    log_magnitudes = log_mag[0].T.cpu().numpy()  # (T, n_freq)

    fbank = pad_spec(fbank, target_length)
    log_magnitudes = pad_spec(log_magnitudes, target_length)
    return fbank, log_magnitudes, waveform


def load_audio(
    audio_path: str,
    config: Optional[MelConfig] = None,
    left: int = 0,
    right: int = 0,
    stft: bool = True,
    model_sr: Optional[int] = None,
    device: Union[str, torch.device] = "cpu",
) -> Tuple[np.ndarray, int, float]:
    """Load audio for editing. Returns (x, sample_rate, duration):

    stft=True  (the mel families): x is a (1, 1, T, n_mels) mel "image".
    stft=False (Stable Audio): x is the (channels, L) waveform at
               ``model_sr``, with its mean removed and peak-normalized to 0.5.
    """
    if not stft:
        waveform, sr = read_wav(audio_path)
        if model_sr is not None and sr != model_sr:
            waveform = resample(waveform, sr, model_sr)
            sr = model_sr
        waveform = waveform - waveform.mean()
        waveform = waveform / (np.abs(waveform).max() + 1e-8) * 0.5
        return waveform.astype(np.float32), sr, waveform.shape[-1] / sr
    config = config or MelConfig()
    duration = get_duration(audio_path)
    target_length = int(duration * 102.4)
    mel, _, _ = wav_to_fbank(audio_path, target_length=target_length,
                             config=config, device=device)
    mel = mel[None, ...]  # (1, T, n_mels)
    c, h, w = mel.shape
    left = min(left, w - 1)
    right = min(right, w - left - 1)
    mel = mel[:, :, left : w - right]
    return mel[None, ...].astype(np.float32), model_sr or 16000, duration
