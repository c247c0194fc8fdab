"""Oobleck VAE (Stable Audio's stereo waveform autoencoder).

Counterpart of ``audioeditingcode_tpu/models/oobleck.py``, with diffusers'
``AutoencoderOobleck`` names (``encoder.block.0.res_unit1.snake1.alpha``,
``decoder.block.0.conv_t1``), which ``tools/convert_checkpoint.py::
convert_oobleck`` reads. The modules run in torch's (B, C, W) convolution
layout (the Flax modules run (B, W, C)); Snake params are (1, C, 1), as
diffusers stores them.

Geometry (stable-audio-open-1.0 vae/config.json): encoder strides
(2, 4, 4, 8, 8) with channel multiples (1, 2, 4, 8, 16), three dilated
residual units (1, 3, 9) per block, padding ceil(stride / 2); the decoder
mirrors it with ``ConvTranspose1d(padding=ceil(stride / 2))``, which equals
Flax's VALID transpose followed by the crop. The decoder's last conv has no
bias.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple, Union

import torch
from torch import nn
from torch.nn import functional as F


@dataclasses.dataclass(frozen=True)
class OobleckConfig:
    encoder_hidden_size: int = 128
    downsampling_ratios: Tuple[int, ...] = (2, 4, 4, 8, 8)
    channel_multiples: Tuple[int, ...] = (1, 2, 4, 8, 16)
    decoder_channels: int = 128
    decoder_input_channels: int = 64  # latent channels
    audio_channels: int = 2
    sampling_rate: int = 44100

    @property
    def hop_length(self) -> int:
        return math.prod(self.downsampling_ratios)


class Snake1d(nn.Module):
    """x + (1 / (beta + eps)) * sin(alpha x)^2 with per-channel log-scale
    params alpha, beta of shape (1, C, 1). The params stay float32 and the
    activation computes in float32, cast back to x's dtype, as in Flax."""

    float32_params = ("alpha", "beta")

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(1, channels, 1))
        self.beta = nn.Parameter(torch.zeros(1, channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = torch.exp(self.alpha.float()), torch.exp(self.beta.float())
        return (x + (1.0 / (b + 1e-9)) * torch.sin(a * x) ** 2).to(x.dtype)


class ResidualUnit(nn.Module):
    """snake -> dilated conv k=7 -> snake -> conv k=1, residual add."""

    def __init__(self, channels: int, dilation: int = 1):
        super().__init__()
        pad = ((7 - 1) * dilation) // 2
        self.snake1 = Snake1d(channels)
        self.conv1 = nn.Conv1d(channels, channels, 7, dilation=dilation, padding=pad)
        self.snake2 = Snake1d(channels)
        self.conv2 = nn.Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(self.snake2(self.conv1(self.snake1(x))))


class EncoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int):
        super().__init__()
        self.res_unit1 = ResidualUnit(in_channels, 1)
        self.res_unit2 = ResidualUnit(in_channels, 3)
        self.res_unit3 = ResidualUnit(in_channels, 9)
        self.snake1 = Snake1d(in_channels)
        self.conv1 = nn.Conv1d(in_channels, out_channels, 2 * stride, stride=stride,
                               padding=math.ceil(stride / 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.res_unit3(self.res_unit2(self.res_unit1(x)))
        return self.conv1(self.snake1(x))


class DecoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int):
        super().__init__()
        self.snake1 = Snake1d(in_channels)
        self.conv_t1 = nn.ConvTranspose1d(in_channels, out_channels, 2 * stride,
                                          stride=stride, padding=math.ceil(stride / 2))
        self.res_unit1 = ResidualUnit(out_channels, 1)
        self.res_unit2 = ResidualUnit(out_channels, 3)
        self.res_unit3 = ResidualUnit(out_channels, 9)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_t1(self.snake1(x))
        return self.res_unit3(self.res_unit2(self.res_unit1(x)))


class OobleckEncoder(nn.Module):
    def __init__(self, cfg: OobleckConfig):
        super().__init__()
        c = cfg.encoder_hidden_size
        self.conv1 = nn.Conv1d(cfg.audio_channels, c, 7, padding=3)
        blocks, mult = [], 1
        for i, stride in enumerate(cfg.downsampling_ratios):
            out_mult = cfg.channel_multiples[i]
            blocks.append(EncoderBlock(c * mult, c * out_mult, stride))
            mult = out_mult
        self.block = nn.ModuleList(blocks)
        self.snake1 = Snake1d(c * mult)
        # 2x latent channels: (mean, scale)
        self.conv2 = nn.Conv1d(c * mult, 2 * cfg.decoder_input_channels, 3, padding=1)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:  # (B, audio_channels, W)
        x = self.conv1(audio)
        for block in self.block:
            x = block(x)
        return self.conv2(self.snake1(x))


class OobleckDecoder(nn.Module):
    def __init__(self, cfg: OobleckConfig):
        super().__init__()
        c = cfg.decoder_channels
        mults = cfg.channel_multiples
        self.conv1 = nn.Conv1d(cfg.decoder_input_channels, c * mults[-1], 7, padding=3)
        strides = cfg.downsampling_ratios[::-1]
        rev_mults = (1,) + tuple(mults)
        self.block = nn.ModuleList(
            DecoderBlock(c * rev_mults[len(strides) - i], c * rev_mults[len(strides) - i - 1], s)
            for i, s in enumerate(strides))
        self.snake1 = Snake1d(c)
        self.conv2 = nn.Conv1d(c, cfg.audio_channels, 7, padding=3, bias=False)

    def forward(self, z: torch.Tensor) -> torch.Tensor:  # (B, latent_channels, L)
        x = self.conv1(z)
        for block in self.block:
            x = block(x)
        return self.conv2(self.snake1(x))


class AutoencoderOobleck(nn.Module):
    """encode: waveform (B, 2, W) -> (mean, std); decode: latent -> waveform."""

    def __init__(self, cfg: OobleckConfig):
        super().__init__()
        self.config = cfg
        self.encoder = OobleckEncoder(cfg)
        self.decoder = OobleckDecoder(cfg)

    def encode(self, audio: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, scale = self.encoder(audio).chunk(2, dim=1)
        # OobleckDiagonalGaussianDistribution: std = softplus(scale) + 1e-4
        return mean, F.softplus(scale) + 1e-4

    def encode_sample(self, audio: torch.Tensor,
                      noise: Union[torch.Tensor, torch.Generator]) -> torch.Tensor:
        """A latent sample mean + std * noise; ``noise`` has the latent's
        (B, C, L) shape, or is a generator to draw it from."""
        mean, std = self.encode(audio)
        if isinstance(noise, torch.Generator):
            noise = torch.randn(mean.shape, generator=noise, device=mean.device,
                                dtype=mean.dtype)
        return mean + std * noise.to(mean.dtype)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)
