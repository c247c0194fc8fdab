"""CLAP's input side without transformers: the feature extractor and the
processor that pairs it with the tokenizer.

The JAX eval tower calls transformers' ``ClapProcessor``
(``audioeditingcode_tpu/evals/features.py``); the card's machine has no
transformers, so the port keeps its own copy of what that call computes:

- ``ClapFeatureExtractor``: a mono waveform at the extractor's rate, padded
  (``repeatpad``, ``repeat`` or ``pad``) or cut to ``max_length_s``, then
  the power spectrogram (periodic Hann window, reflect-centred frames, an
  FFT in float64 stored as complex64) through the slaney mel filter bank
  and to decibels, as transformers' ``_np_extract_fbank_features`` with
  ``truncation="rand_trunc"``. A clip longer than ``max_length_s`` is cut
  at an offset drawn from an explicit ``numpy.random.Generator`` (where
  transformers reads numpy's global state). ``truncation="fusion"`` would
  give four mel channels, which the audio tower does not take: it raises.
- ``ClapProcessor``: ``preprocessor_config.json`` and ``tokenizer.json``
  of a checkpoint directory; ``text(...)`` pads to the longest prompt, as
  ``processor(text=..., padding=True)`` does.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from ..ops.stft import hann_window, mel_filterbank
from .tokenizers import Tokenizer


class ClapFeatureExtractor:
    """transformers' ClapFeatureExtractor for one mono clip, on the
    ``rand_trunc`` path."""

    def __init__(self, feature_size: int = 64, sampling_rate: int = 48000,
                 hop_length: int = 480, max_length_s: int = 10, fft_window_size: int = 1024,
                 frequency_min: float = 0, frequency_max: float = 14000,
                 truncation: str = "fusion", padding: str = "repeatpad", **_):
        self.feature_size, self.sampling_rate = feature_size, sampling_rate
        self.hop_length, self.fft_window_size = hop_length, fft_window_size
        self.max_length_s = max_length_s
        self.nb_max_samples = max_length_s * sampling_rate
        self.truncation, self.padding = truncation, padding
        # the slaney filter bank (librosa's, which transformers reproduces)
        self.mel_filters_slaney = mel_filterbank(sampling_rate, fft_window_size, feature_size,
                                                 frequency_min, frequency_max).T
        self.window = hann_window(fft_window_size)

    @classmethod
    def from_dir(cls, d: str) -> "ClapFeatureExtractor":
        path = os.path.join(d, "preprocessor_config.json")
        if not os.path.exists(path):
            raise FileNotFoundError(f"missing CLAP feature extractor config: {path}")
        with open(path) as f:
            return cls(**json.load(f))

    def log_mel(self, waveform: np.ndarray) -> np.ndarray:
        """(frames, feature_size) float32 dB power mel of a 1-D waveform."""
        n = self.fft_window_size
        x = np.pad(waveform, (n // 2, n // 2), mode="reflect").astype(np.float64)
        frames = np.lib.stride_tricks.sliding_window_view(x, n)[:: self.hop_length]
        spec = np.fft.rfft(frames * self.window, axis=-1).astype(np.complex64)
        power = np.abs(spec, dtype=np.float64) ** 2.0
        mel = np.maximum(1e-10, self.mel_filters_slaney.T @ power.T)
        db = 10.0 * (np.log10(np.clip(mel, 1e-10, None)) - np.log10(1.0))
        return np.asarray(db, np.float32).T

    def __call__(self, waveform: np.ndarray, sampling_rate: Optional[int] = None,
                 truncation: Optional[str] = None, padding: Optional[str] = None,
                 rng: Optional[np.random.Generator] = None) -> Tuple[np.ndarray, bool]:
        """(input_features (1, 1, frames, feature_size) float32, is_longer)
        of one mono clip. ``truncation`` and ``padding`` default to the
        config's; ``rng`` draws the offset of a clip longer than
        ``max_length_s``."""
        truncation = truncation if truncation is not None else self.truncation
        padding = padding or self.padding
        if truncation == "fusion":
            raise ValueError("CLAP truncation='fusion' gives four mel channels, which the "
                             "audio tower does not take (feature fusion is not ported): "
                             "pass truncation='rand_trunc'")
        if truncation != "rand_trunc":
            raise NotImplementedError(f"data_truncating {truncation} not implemented")
        if sampling_rate is not None and sampling_rate != self.sampling_rate:
            raise ValueError(f"the CLAP feature extractor takes {self.sampling_rate} Hz, "
                             f"got {sampling_rate}")
        waveform = np.asarray(waveform)
        if waveform.ndim != 1:
            raise ValueError(f"the CLAP feature extractor takes one mono clip, got shape "
                             f"{waveform.shape}")
        max_length = self.nb_max_samples
        longer = waveform.shape[0] > max_length
        if longer:
            if rng is None:
                raise ValueError("a clip longer than max_length_s needs rng for its "
                                 "random crop")
            idx = int(rng.integers(0, waveform.shape[0] - max_length + 1))
            waveform = waveform[idx: idx + max_length]
        elif waveform.shape[0] < max_length:
            if padding == "repeat":
                n_repeat = int(max_length / len(waveform))
                waveform = np.tile(waveform, n_repeat + 1)[:max_length]
            elif padding == "repeatpad":
                waveform = np.tile(waveform, int(max_length / len(waveform)))
            elif padding != "pad":
                raise ValueError(f"unknown CLAP padding {padding!r}")
            waveform = np.pad(waveform, (0, max_length - waveform.shape[0]))
        return self.log_mel(waveform)[None, None], longer


class ClapProcessor:
    """The feature extractor and the tokenizer of a CLAP checkpoint
    directory."""

    def __init__(self, feature_extractor: ClapFeatureExtractor, tokenizer: Tokenizer):
        self.feature_extractor, self.tokenizer = feature_extractor, tokenizer

    @classmethod
    def from_dir(cls, d: str) -> "ClapProcessor":
        if not os.path.exists(os.path.join(d, "tokenizer.json")):
            raise ValueError(f"{d}: the port's tokenizer reads tokenizer.json, which this "
                             f"checkpoint lacks (vocab.json + merges.txt alone are not read)")
        return cls(ClapFeatureExtractor.from_dir(d), Tokenizer.from_dir(d))

    def text(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """(input_ids, attention_mask) padded to the longest text."""
        return self.tokenizer(list(texts), padding=True)
