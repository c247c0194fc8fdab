"""Frechet Audio Distance with windowed embedding caching (a copy of
``audioeditingcode_tpu/evals/fad.py`` on the port's wav reader).

The reference shells out to microsoft/fadtk with a windowed-splitting +
embedding-cache harness (reference: evals/fadtk_utils.py:11-59 and
evals/UnsupEval.ipynb cells 7-12, fadtk 'clap-laion-music' model). Here the
whole pipeline is self-contained: split generations into 10 s / 10%-overlap
chunks, embed with the pluggable extractor, cache per-file embeddings as
.npy next to the audio (fadtk's convention), and compute the classic FAD

    FAD = |mu_a - mu_b|^2 + Tr(S_a + S_b - 2 (S_a S_b)^{1/2})

with the matrix square root via eigendecomposition (symmetric PSD path).

Protocol compatibility: with the default FAD extractor
(features.fad_extractor -> laion/larger_clap_music, the transformers port of
fadtk's 'clap-laion-music' laion_clap music checkpoint), the pipeline is the
reference's — 48 kHz mono, 10 s windows with a 10%-overlap integer-second
stride (fadtk_utils.py:17 ``int(10*(1-overlap))*sr``), L2-normalized 512-d
projected audio embeddings, per-file embedding caches — so scores are
comparable with the paper's UnsupEval numbers.
"""

from __future__ import annotations

import os

import numpy as np

from .windows import split_to_overlapping_windows


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Matrix square root of a (near-)PSD symmetric matrix."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2.0)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(emb_a: np.ndarray, emb_b: np.ndarray, eps: float = 1e-6) -> float:
    """FAD between two embedding sets, rows = samples."""
    mu_a, mu_b = emb_a.mean(axis=0), emb_b.mean(axis=0)
    cov_a = np.cov(emb_a, rowvar=False) + eps * np.eye(emb_a.shape[1])
    cov_b = np.cov(emb_b, rowvar=False) + eps * np.eye(emb_b.shape[1])
    covmean = _sqrtm_psd(_sqrtm_psd(cov_a) @ cov_b @ _sqrtm_psd(cov_a))
    diff = mu_a - mu_b
    return float(diff @ diff + np.trace(cov_a) + np.trace(cov_b) - 2.0 * np.trace(covmean))


class FADScorer:
    def __init__(self, extractor, window_size_s: float = 10.0, overlap: float = 0.1):
        self.extractor = extractor
        self.window_size_s = window_size_s
        self.overlap = overlap
        ext_win = getattr(extractor, "input_window_s", None)
        if ext_win and window_size_s > ext_win:
            import warnings

            warnings.warn(
                f"FAD window_size_s={window_size_s} exceeds the extractor's "
                f"fixed {ext_win}s input window (CLAP-processor semantics): "
                f"embeddings only see the first {ext_win}s of each window. "
                f"The reference protocol uses 10 s windows.",
                stacklevel=2,
            )

    def embed_file(self, path: str, use_cache: bool = True) -> np.ndarray:
        """Windowed embeddings for one audio file, cached as <path>.emb.npy
        (reference cache layout: evals/fadtk_utils.py:33-59)."""
        cache = path + ".emb.npy"
        if use_cache and os.path.exists(cache):
            return np.load(cache)
        from ..utils.audio_io import read_wav

        aud, sr = read_wav(path)
        chunks = split_to_overlapping_windows(aud, sr, self.window_size_s, self.overlap)
        min_len = int(sr * min(1.0, self.window_size_s))
        embs = [self.extractor.embed_audio(c, sr) for c in chunks
                if c.shape[-1] >= min_len]
        if not embs:
            embs = [self.extractor.embed_audio(aud, sr)]
        out = np.stack(embs)
        if use_cache:
            np.save(cache, out)
        return out

    def embed_dir(self, dir_path: str, use_cache: bool = True) -> np.ndarray:
        files = sorted(
            os.path.join(dir_path, f) for f in os.listdir(dir_path)
            if f.endswith((".wav", ".flac"))
        )
        if not files:
            raise FileNotFoundError(f"no audio files in {dir_path}")
        return np.concatenate([self.embed_file(f, use_cache) for f in files], axis=0)

    def score_dirs(self, gen_dir: str, ref_dir: str, use_cache: bool = True) -> float:
        """FAD of a generation directory against a reference directory
        (UnsupEval protocol: FAD-to-originals and FAD-to-FMA-pop)."""
        return frechet_distance(
            self.embed_dir(gen_dir, use_cache), self.embed_dir(ref_dir, use_cache)
        )
