"""Resnet and up/down-sampling blocks (diffusers-compatible, NCHW).

Counterpart of ``audioeditingcode_tpu/models/resnet.py``. The JAX modules
run NHWC and infer input widths; these take them as arguments. GroupNorm
epsilons follow the JAX modules, not torch's defaults.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F


class ResnetBlock2D(nn.Module):
    """GroupNorm-SiLU-Conv x2 with a time-embedding bias."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = None, norm_num_groups: int = 32,
                 eps: float = 1e-5):
        super().__init__()
        self.norm1 = nn.GroupNorm(norm_num_groups, in_channels, eps=eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        if temb_channels is not None:
            self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = nn.GroupNorm(norm_num_groups, out_channels, eps=eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv with padding 1 (the UNet's downsampler)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest x2, cropped to ``output_size`` when given, then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor, output_size: Optional[Sequence[int]] = None) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        if output_size is not None:
            x = x[:, :, : output_size[0], : output_size[1]]
        return self.conv(x)


class AttnBlock2D(nn.Module):
    """Single-head spatial self-attention of the VAE mid blocks. It stays
    plain tensor code (the JAX package has no kernel for it)."""

    def __init__(self, channels: int, norm_num_groups: int = 32):
        super().__init__()
        self.group_norm = nn.GroupNorm(norm_num_groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.group_norm(x).flatten(2).transpose(1, 2)  # (b, h*w, c)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        attn = torch.softmax(torch.matmul(q, k.transpose(1, 2)) * (c ** -0.5), dim=-1)
        y = self.to_out[0](torch.matmul(attn, v))
        return x + y.transpose(1, 2).reshape(b, c, h, w)
