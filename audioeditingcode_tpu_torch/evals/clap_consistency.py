"""CLAP text-consistency metric (a copy of
``audioeditingcode_tpu/evals/clap_consistency.py``).

Reproduces the audiocraft-derived torchmetrics.Metric semantics the
reference uses (reference: evals/meta_clap_consistency.py:89-139): per
update, cosine similarity between the audio embedding and the text
embedding, accumulated as a weighted mean; ``compute`` returns the mean,
``reset`` clears state. Input audio is converted to 48 kHz mono inside the
extractor (convert_audio, evals/meta_clap_consistency.py:64-69).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .windows import windowed_score


class CLAPTextConsistencyMetric:
    def __init__(self, extractor):
        self.extractor = extractor
        self.reset()

    def reset(self) -> None:
        self._sum = 0.0
        self._weight = 0.0

    def update(self, audio: np.ndarray, texts: Sequence[str], sr: int) -> None:
        audio = np.atleast_2d(np.asarray(audio))
        a = self.extractor.embed_audio(audio, sr)
        t = self.extractor.embed_text(list(texts))
        sim = float(np.mean(t @ a))
        self._sum += sim
        self._weight += 1.0

    def compute(self) -> float:
        if self._weight == 0:
            raise RuntimeError("compute() called before update()")
        return self._sum / self._weight

    def windowed(
        self,
        aud: np.ndarray,
        sr: int,
        prompt: str,
        window_size_s: Optional[float] = None,
        overlap: float = 0.1,
        method: str = "mean",
    ) -> float:
        """10 s / 10%-overlap protocol (reference: evals/utils.py:87-116)."""

        def score(w):
            self.reset()
            self.update(w, [prompt], sr)
            return self.compute()

        return windowed_score(score, [np.atleast_2d(aud)], [sr],
                              window_size_s, overlap, method)
