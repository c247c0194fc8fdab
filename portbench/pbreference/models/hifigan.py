"""HiFi-GAN vocoder — mel spectrogram -> 16 kHz waveform.

Counterpart of ``audioeditingcode_tpu/models/hifigan.py``. The JAX module
emulates torch's ConvTranspose1d with an lhs-dilated convolution; here it is
``nn.ConvTranspose1d`` itself (out_len = (L-1)*stride - 2*padding + kernel).
The public layout is the JAX one: mel (B, T, n_mels) in, (B, T*hop) out.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn
from torch.nn import functional as F

LRELU_SLOPE = 0.1


@dataclasses.dataclass(frozen=True)
class HifiGanConfig:
    model_in_dim: int = 64
    upsample_initial_channel: int = 1024
    upsample_rates: Tuple[int, ...] = (5, 4, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 8, 4, 4)
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    sampling_rate: int = 16000
    normalize_before: bool = False


def _conv1d(c_in: int, c_out: int, kernel: int, dilation: int = 1) -> nn.Conv1d:
    return nn.Conv1d(c_in, c_out, kernel, dilation=dilation,
                     padding=(kernel * dilation - dilation) // 2)


class ResBlock(nn.Module):
    """Multi-dilation residual block."""

    def __init__(self, channels: int, kernel: int, dilations: Tuple[int, ...]):
        super().__init__()
        self.convs1 = nn.ModuleList(_conv1d(channels, channels, kernel, d) for d in dilations)
        self.convs2 = nn.ModuleList(_conv1d(channels, channels, kernel) for _ in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            h = c1(F.leaky_relu(x, LRELU_SLOPE))
            x = x + c2(F.leaky_relu(h, LRELU_SLOPE))
        return x


class HifiGanGenerator(nn.Module):
    """mel (B, T, n_mels) -> waveform (B, T * prod(upsample_rates))."""

    def __init__(self, config: HifiGanConfig):
        super().__init__()
        cfg = self.config = config
        if cfg.normalize_before:
            self.mean = nn.Parameter(torch.zeros(cfg.model_in_dim))
            self.scale = nn.Parameter(torch.ones(cfg.model_in_dim))
        ch = cfg.upsample_initial_channel
        self.conv_pre = _conv1d(cfg.model_in_dim, ch, 7)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            out = cfg.upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(nn.ConvTranspose1d(ch, out, k, stride=u, padding=(k - u) // 2))
            ch = out
            for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                self.resblocks.append(ResBlock(ch, rk, tuple(rd)))
        self.conv_post = _conv1d(ch, 1, 7)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = mel
        if self.config.normalize_before:
            x = (x - self.mean) / self.scale
        x = self.conv_pre(x.transpose(1, 2))
        n = len(self.config.resblock_kernel_sizes)
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            xs = None
            for j in range(n):
                r = self.resblocks[i * n + j](x)
                xs = r if xs is None else xs + r
            x = xs / n
        x = self.conv_post(F.leaky_relu(x, 0.01))  # torch's default slope
        return torch.tanh(x)[:, 0, :]
