"""Pluggable audio/text feature extractors for the eval tower.

Counterpart of ``audioeditingcode_tpu/evals/features.py``. The metrics are
bound to an extractor protocol, so they are network-agnostic:

  stages(aud, sr)  -> list of (1, C_i, H_i, W_i) stage features (LPAPS)
  embed_audio(...) -> (D,) L2-normalised audio embedding (CLAP consistency, FAD)
  embed_text(...)  -> (N, D) L2-normalised text embeddings (CLAP consistency)

- ``ClapExtractor``, the counterpart of the JAX ``FlaxClapExtractor``: the
  port's CLAP towers (``models/clap_audio.py``) on a device, from a
  checkpoint directory in the layout ``ClapModel.from_pretrained`` reads,
  with the port's copy of the processor (``models/clap_processor.py``).
- ``TransformersClapExtractor``: the oracle, transformers' ClapModel on the
  CPU (imported when it is built; it raises an ImportError that names
  transformers where that package is missing).
- ``MelStageExtractor``: the weight-free, deterministic stand-in with the
  same interface, on the port's ``ops/stft.py`` mel spectrogram.

Both CLAP extractors feed the audio tower one mel channel:
``truncation="rand_trunc"``, as the JAX tower's tests drive it, with the
random crop of a clip longer than 10 s drawn from a generator seeded by
``seed``.
"""

from __future__ import annotations

import hashlib
import os
import warnings
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..ops.stft import MelConfig, mel_spectrogram
from ..utils.audio_io import resample

# The reference pins LPAPS and CLAP consistency to LAION-CLAP HTSAT-base with
# the music_speech_epoch_15_esc_89.25.pt checkpoint (reference
# evals/lpaps.py:27-29, evals/pretrained_networks.py:12-30); its
# transformers port is laion/larger_clap_music_and_speech.
LPAPS_CLAP_MUSIC_SPEECH = "laion/larger_clap_music_and_speech"
# fadtk's 'clap-laion-music' model: laion_clap HTSAT-base with the
# music_audioset_epoch_15_esc_90.14.pt checkpoint, whose transformers port
# is laion/larger_clap_music (reference evals/fadtk_utils.py:33-59).
FAD_CLAP_MUSIC = "laion/larger_clap_music"

# A checkpoint id such as "laion/larger_clap_music" names the directory
# checkpoints/laion/larger_clap_music/ at the root of the repository
CHECKPOINT_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "checkpoints")


def checkpoint_dir(model_name_or_path: str) -> str:
    """The directory of a CLAP checkpoint: the path itself, or for an id
    the directory of that name under ``CHECKPOINT_ROOT``."""
    if os.path.isdir(model_name_or_path):
        return model_name_or_path
    d = os.path.join(CHECKPOINT_ROOT, *model_name_or_path.split("/"))
    if not os.path.isdir(d):
        raise FileNotFoundError(f"no CLAP checkpoint {model_name_or_path!r}: neither a "
                                f"directory nor {d}")
    return d


class MelStageExtractor:
    """Weight-free extractor: log-mel pyramid stages and pooled-stats
    embeddings. Deterministic, no checkpoints needed: it stands in for CLAP
    wherever the metric machinery is under test. NOT a perceptual model."""

    sample_rate = 48000
    embed_dim = 64
    # every input is padded or cut to a fixed 10 s window before it is
    # featurised, as CLAP's processor does; FADScorer warns when configured
    # with a longer window
    input_window_s = 10.0

    def __init__(self, n_mels: int = 64):
        self.config = MelConfig(
            filter_length=1024, hop_length=480, win_length=1024,
            n_mel_channels=n_mels, sampling_rate=self.sample_rate,
            mel_fmin=0.0, mel_fmax=24000.0,
        )

    def _mel(self, aud: np.ndarray, sr: int) -> np.ndarray:
        aud = np.atleast_2d(np.asarray(aud, np.float32))
        if aud.shape[0] > 1:
            aud = aud.mean(axis=0, keepdims=True)
        aud = resample(aud, sr, self.sample_rate)
        n = int(self.input_window_s * self.sample_rate)
        if aud.shape[-1] < n:
            aud = np.pad(aud, ((0, 0), (0, n - aud.shape[-1])))
        else:
            aud = aud[..., :n]
        with torch.no_grad():
            log_mel, _, _ = mel_spectrogram(torch.from_numpy(np.ascontiguousarray(aud)),
                                            self.config)
        return log_mel.numpy()  # (1, n_mels, T)

    def stages(self, aud: np.ndarray, sr: int) -> List[np.ndarray]:
        m = self._mel(aud, sr)[:, None]  # (1, 1, n_mels, T)
        stages = []
        for _ in range(4):
            stages.append(m)
            if m.shape[-1] >= 2 and m.shape[-2] >= 2:
                m = m[..., : m.shape[-2] // 2 * 2, : m.shape[-1] // 2 * 2]
                m = 0.25 * (m[..., ::2, ::2] + m[..., 1::2, ::2]
                            + m[..., ::2, 1::2] + m[..., 1::2, 1::2])
        return stages

    def embed_audio(self, aud: np.ndarray, sr: int) -> np.ndarray:
        m = self._mel(aud, sr)[0]  # (n_mels, T)
        feats = np.concatenate([m.mean(axis=1), m.std(axis=1) + 1e-6])[: self.embed_dim * 2]
        v = feats[: self.embed_dim] / (np.linalg.norm(feats[: self.embed_dim]) + 1e-8)
        return v.astype(np.float32)

    def embed_text(self, texts: Sequence[str]) -> np.ndarray:
        out = []
        for t in texts:
            seed = int.from_bytes(hashlib.sha256(t.encode()).digest()[:4], "little")
            v = np.random.default_rng(seed).standard_normal(self.embed_dim)
            out.append(v / np.linalg.norm(v))
        return np.stack(out).astype(np.float32)


def _mono_48k(aud: np.ndarray, sr: int, sample_rate: int) -> np.ndarray:
    """Mono downmix, then resampling to the model rate (the reference's
    convert_audio, evals/meta_clap_consistency.py:64-69)."""
    aud = np.atleast_2d(np.asarray(aud, np.float32))
    if aud.shape[0] > 1:
        aud = aud.mean(axis=0, keepdims=True)
    return resample(aud, sr, sample_rate)[0]


def _unit(v: np.ndarray) -> np.ndarray:
    return (v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-8)).astype(np.float32)


class ClapExtractor:
    """CLAP on the port: the audio tower and the text tower of
    ``models/clap_audio.py`` on ``device``, from a checkpoint directory (or
    an id under ``CHECKPOINT_ROOT``). Same protocol and outputs as the
    oracle."""

    sample_rate = 48000
    input_window_s = 10.0  # the processor pads or cuts every input to 10 s

    def __init__(self, model_name_or_path: str = LPAPS_CLAP_MUSIC_SPEECH,
                 device: Union[str, torch.device] = "cuda", seed: int = 0):
        from ..models.clap_audio import load_clap
        from ..models.clap_processor import ClapProcessor

        d = checkpoint_dir(model_name_or_path)
        self._init_components(load_clap(d), ClapProcessor.from_dir(d), device, seed)

    @classmethod
    def from_components(cls, model, processor, device: Union[str, torch.device] = "cpu",
                        seed: int = 0) -> "ClapExtractor":
        self = cls.__new__(cls)
        self._init_components(model, processor, device, seed)
        return self

    def _init_components(self, model, processor, device, seed: int) -> None:
        self.device = torch.device(device)
        self.model = model.float().to(self.device).eval().requires_grad_(False)
        self.processor = processor
        self.embed_dim = model.audio_cfg.projection_dim
        self.rng = np.random.default_rng(seed)

    def features(self, aud: np.ndarray, sr: int) -> torch.Tensor:
        """The processor's (1, 1, frames, mel bins) input features on the
        device."""
        feats, _ = self.processor.feature_extractor(
            _mono_48k(aud, sr, self.sample_rate), self.sample_rate,
            truncation="rand_trunc", rng=self.rng)
        return torch.from_numpy(feats).to(self.device)

    @torch.no_grad()
    def stages(self, aud: np.ndarray, sr: int) -> List[np.ndarray]:
        stages, _ = self.model.audio_forward(self.features(aud, sr))
        return [s.float().cpu().numpy() for s in stages[-4:]]

    @torch.no_grad()
    def embed_audio(self, aud: np.ndarray, sr: int) -> np.ndarray:
        v = self.model.get_audio_features(self.features(aud, sr))[0]
        return _unit(v.float().cpu().numpy())

    @torch.no_grad()
    def embed_text(self, texts: Sequence[str]) -> np.ndarray:
        ids, mask = self.processor.text(list(texts))
        emb = self.model.get_text_features(torch.from_numpy(ids).to(self.device),
                                           torch.from_numpy(mask).to(self.device))
        return _unit(emb.float().cpu().numpy())


class TransformersClapExtractor:
    """The oracle: transformers' ClapModel on the CPU, from a local path or
    a cached id; stage features for LPAPS from the audio tower's hidden
    states, projected embeddings for consistency and FAD."""

    sample_rate = 48000
    input_window_s = 10.0

    def __init__(self, model_name_or_path: str = LPAPS_CLAP_MUSIC_SPEECH,
                 local_files_only: bool = True, seed: int = 0):
        try:
            from transformers import AutoProcessor, ClapModel
        except ImportError as e:
            raise ImportError("--clap_backend torch needs the transformers package, "
                              "which is not installed") from e
        model = ClapModel.from_pretrained(model_name_or_path, local_files_only=local_files_only)
        processor = AutoProcessor.from_pretrained(model_name_or_path,
                                                  local_files_only=local_files_only)
        self._init_components(model, processor, seed)

    @classmethod
    def from_components(cls, model, processor, seed: int = 0) -> "TransformersClapExtractor":
        self = cls.__new__(cls)
        self._init_components(model, processor, seed)
        return self

    def _init_components(self, model, processor, seed: int) -> None:
        self.model = model.eval()
        self.processor = processor
        self.embed_dim = self.model.config.projection_dim
        self.seed = seed

    def _prep(self, aud: np.ndarray, sr: int):
        # transformers draws a long clip's crop from numpy's global state
        np.random.seed(self.seed)
        return self.processor(audios=_mono_48k(aud, sr, self.sample_rate),
                              sampling_rate=self.sample_rate, return_tensors="pt",
                              truncation="rand_trunc")

    def stages(self, aud: np.ndarray, sr: int) -> List[np.ndarray]:
        inputs = self._prep(aud, sr)
        with torch.no_grad():
            out = self.model.audio_model(inputs["input_features"], output_hidden_states=True)
        return [h.numpy() for h in out.hidden_states[-4:]]

    def embed_audio(self, aud: np.ndarray, sr: int) -> np.ndarray:
        with torch.no_grad():
            emb = self.model.get_audio_features(input_features=self._prep(aud, sr)["input_features"])
        return _unit(emb[0].numpy())

    def embed_text(self, texts: Sequence[str]) -> np.ndarray:
        with torch.no_grad():
            toks = self.processor(text=list(texts), return_tensors="pt", padding=True)
            emb = self.model.get_text_features(input_ids=toks["input_ids"],
                                               attention_mask=toks["attention_mask"])
        return _unit(emb.numpy())


def default_extractor(model_name_or_path: Optional[str] = None, backend: str = "jax",
                      allow_mel_fallback: bool = False,
                      device: Union[str, torch.device] = "cuda"):
    """CLAP extractor bound to the reference LPAPS/consistency protocol
    (``LPAPS_CLAP_MUSIC_SPEECH`` by default). ``backend="jax"`` selects the
    port's own towers on ``device`` (the counterpart of the JAX tower),
    ``"torch"`` the transformers oracle. A checkpoint that cannot be loaded
    is a HARD ERROR unless ``allow_mel_fallback=True`` knowingly opts in to
    the weight-free, NON-perceptual ``MelStageExtractor``."""
    target = model_name_or_path or LPAPS_CLAP_MUSIC_SPEECH
    try:
        if backend == "jax":
            return ClapExtractor(target, device=device)
        return TransformersClapExtractor(target)
    except ImportError:
        raise
    except Exception as e:  # missing weights
        if not allow_mel_fallback:
            raise RuntimeError(
                f"CLAP checkpoint '{target}' is unavailable ({e}). Scores "
                "need the reference protocol checkpoint "
                f"({LPAPS_CLAP_MUSIC_SPEECH}); pass allow_mel_fallback=True "
                "(CLI: --allow_mel_fallback) to knowingly use the "
                "weight-free, non-perceptual MelStageExtractor instead."
            ) from e
        warnings.warn(
            f"[evals] CLAP unavailable ({e}); using MelStageExtractor — "
            "scores are NOT protocol-comparable (non-perceptual features)")
    return MelStageExtractor()


def fad_extractor(model_name_or_path: Optional[str] = None, backend: str = "jax",
                  allow_mel_fallback: bool = False,
                  device: Union[str, torch.device] = "cuda"):
    """FAD-protocol extractor: the laion-CLAP music checkpoint (fadtk
    'clap-laion-music') by default, with ``default_extractor``'s contract."""
    return default_extractor(model_name_or_path or FAD_CLAP_MUSIC, backend,
                             allow_mel_fallback=allow_mel_fallback, device=device)
