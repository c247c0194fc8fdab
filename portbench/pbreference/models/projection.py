"""Stable Audio conditioning projections: text projection + duration embeds.

Counterpart of ``audioeditingcode_tpu/models/projection.py``, with the names
of diffusers' ``StableAudioProjectionModel`` that
``tools/convert_checkpoint.py::convert_projection_sa`` reads
(``text_projection.0``/``.2``,
``start_number_conditioner.time_positional_embedding.0.weights`` and
``.1``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ProjectionConfig:
    text_encoder_dim: int = 768
    conditioning_dim: int = 768
    min_value: float = 0.0
    max_value: float = 512.0
    internal_dim: int = 256  # Fourier feature dim of the number embedder


class PositionalEmbedding(nn.Module):
    """t -> [t, sin(2 pi t w), cos(2 pi t w)], in float32."""

    fourier_features = True  # random init: N(0, 1), as the Flax param
    float32_params = ("weights",)  # kept float32 in every model dtype

    def __init__(self, dim: int):
        super().__init__()
        self.weights = nn.Parameter(torch.empty(dim // 2))

    def forward(self, times: torch.Tensor) -> torch.Tensor:  # (B,) -> (B, dim + 1)
        t = times.float()[:, None]
        freqs = t * self.weights.float()[None, :] * 2.0 * math.pi
        return torch.cat([t, torch.sin(freqs), torch.cos(freqs)], dim=-1)


class NumberConditioner(nn.Module):
    """clamp -> normalize -> Fourier features -> Linear."""

    def __init__(self, cfg: ProjectionConfig):
        super().__init__()
        self.cfg = cfg
        self.time_positional_embedding = nn.Sequential(
            PositionalEmbedding(cfg.internal_dim),
            nn.Linear(cfg.internal_dim + 1, cfg.conditioning_dim))

    def forward(self, floats: torch.Tensor) -> torch.Tensor:  # (B,) -> (B, 1, D)
        c = self.cfg
        x = torch.clamp(floats.float(), c.min_value, c.max_value)
        x = (x - c.min_value) / (c.max_value - c.min_value)
        pos, linear = self.time_positional_embedding
        return linear(pos(x).to(linear.weight.dtype))[:, None, :]


class StableAudioProjectionModel(nn.Module):
    """text_projection + start/end number conditioners."""

    def __init__(self, cfg: ProjectionConfig):
        super().__init__()
        self.text_projection = nn.Sequential(
            nn.Linear(cfg.text_encoder_dim, cfg.conditioning_dim, bias=False),
            nn.SiLU(),
            nn.Linear(cfg.conditioning_dim, cfg.conditioning_dim, bias=False))
        self.start_number_conditioner = NumberConditioner(cfg)
        self.end_number_conditioner = NumberConditioner(cfg)

    def forward(self, text_hidden_states: torch.Tensor) -> torch.Tensor:
        return self.project_text(text_hidden_states)

    def project_text(self, text_hidden_states: torch.Tensor) -> torch.Tensor:
        dtype = self.text_projection[0].weight.dtype
        return self.text_projection(text_hidden_states.to(dtype))

    def encode_duration(self, seconds_start: torch.Tensor,
                        seconds_end: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B,), (B,) -> ((B, 1, D), (B, 1, D)) duration hidden states."""
        return (self.start_number_conditioner(seconds_start),
                self.end_number_conditioner(seconds_end))
