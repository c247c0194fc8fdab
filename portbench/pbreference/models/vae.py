"""AutoencoderKL and VQModel (NCHW) — the latent autoencoders of the mel
"images" and of the image models.

Counterpart of ``audioeditingcode_tpu/models/vae.py``. AutoencoderKL:
``encode`` gives the posterior mode times ``scaling_factor``, ``decode``
divides by it first. VQModel (CelebA-HQ): ``encode`` gives the continuous
pre-quantization latent, the space the edits run in; ``decode`` snaps it
to the nearest codebook row first. GroupNorm and resnet epsilons are 1e-6
throughout.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn
from torch.nn import functional as F

from .resnet import AttnBlock2D, ResnetBlock2D


@dataclasses.dataclass(frozen=True)
class AutoencoderKLConfig:
    in_channels: int = 1
    out_channels: int = 1
    latent_channels: int = 8
    block_out_channels: Tuple[int, ...] = (128, 256, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    mid_block_add_attention: bool = True
    scaling_factor: float = 1.0
    double_z: bool = True  # KL: (mean, logvar); VQ: one latent
    num_vq_embeddings: int = 0  # > 0 for the VQ variant (CelebA-HQ: 8192)

    @property
    def downscale_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


class _Conv(nn.Module):
    """Holds one conv under the name ``conv`` (diffusers' samplers)."""

    def __init__(self, conv: nn.Conv2d):
        super().__init__()
        self.conv = conv


class _Block(nn.Module):
    def __init__(self, resnets, attentions=None, downsample=None, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([_Conv(downsample)])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([_Conv(upsample)])


def _mid_block(cfg: AutoencoderKLConfig, ch: int) -> _Block:
    g = cfg.norm_num_groups
    attns = [AttnBlock2D(ch, g)] if cfg.mid_block_add_attention else None
    return _Block([ResnetBlock2D(ch, ch, None, g, eps=1e-6),
                   ResnetBlock2D(ch, ch, None, g, eps=1e-6)], attns)


def _run_mid(block: _Block, x: torch.Tensor) -> torch.Tensor:
    x = block.resnets[0](x)
    if hasattr(block, "attentions"):
        x = block.attentions[0](x)
    return block.resnets[1](x)


class Encoder(nn.Module):
    def __init__(self, cfg: AutoencoderKLConfig):
        super().__init__()
        g = cfg.norm_num_groups
        ch = cfg.block_out_channels[0]
        self.conv_in = nn.Conv2d(cfg.in_channels, ch, 3, padding=1)
        self.down_blocks = nn.ModuleList()
        for i, out_ch in enumerate(cfg.block_out_channels):
            resnets = []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(ch, out_ch, None, g, eps=1e-6))
                ch = out_ch
            down = (nn.Conv2d(out_ch, out_ch, 3, stride=2)
                    if i < len(cfg.block_out_channels) - 1 else None)
            self.down_blocks.append(_Block(resnets, downsample=down))
        self.mid_block = _mid_block(cfg, ch)
        self.conv_norm_out = nn.GroupNorm(g, ch, eps=1e-6)
        out_ch = (2 if cfg.double_z else 1) * cfg.latent_channels
        self.conv_out = nn.Conv2d(ch, out_ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            for resnet in block.resnets:
                x = resnet(x)
            if hasattr(block, "downsamplers"):
                # diffusers' VAE downsampler: pad (0, 1, 0, 1), stride-2 conv
                x = block.downsamplers[0].conv(F.pad(x, (0, 1, 0, 1)))
        x = _run_mid(self.mid_block, x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: AutoencoderKLConfig):
        super().__init__()
        g = cfg.norm_num_groups
        rev = tuple(reversed(cfg.block_out_channels))
        ch = rev[0]
        self.conv_in = nn.Conv2d(cfg.latent_channels, ch, 3, padding=1)
        self.mid_block = _mid_block(cfg, ch)
        self.up_blocks = nn.ModuleList()
        for i, out_ch in enumerate(rev):
            resnets = []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(ch, out_ch, None, g, eps=1e-6))
                ch = out_ch
            up = nn.Conv2d(out_ch, out_ch, 3, padding=1) if i < len(rev) - 1 else None
            self.up_blocks.append(_Block(resnets, upsample=up))
        self.conv_norm_out = nn.GroupNorm(g, ch, eps=1e-6)
        self.conv_out = nn.Conv2d(ch, cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = _run_mid(self.mid_block, self.conv_in(z))
        for block in self.up_blocks:
            for resnet in block.resnets:
                x = resnet(x)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0].conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    """KL-VAE with encode-to-mode / decode entry points (NCHW)."""

    def __init__(self, config: AutoencoderKLConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        moments = self.quant_conv(self.encoder(x))
        mean = moments[:, : self.config.latent_channels]
        return mean * self.config.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z / self.config.scaling_factor))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))


class VQModel(nn.Module):
    """VQ-VAE (diffusers' VQModel), the CelebA-HQ LDM autoencoder. The
    codebook stays float32 in every dtype, as the Flax param does."""

    float32_params = ("codebook",)

    def __init__(self, config: AutoencoderKLConfig):
        super().__init__()
        if config.double_z or config.num_vq_embeddings <= 0:
            raise ValueError("VQModel takes double_z=False and num_vq_embeddings > 0")
        self.config = config
        C = config.latent_channels
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(C, C, 1)
        self.post_quant_conv = nn.Conv2d(C, C, 1)
        self.codebook = nn.Parameter(torch.empty(config.num_vq_embeddings, C))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.quant_conv(self.encoder(x))

    def quantize(self, z: torch.Tensor) -> torch.Tensor:
        """The nearest codebook row of each latent pixel, by the expanded
        distance |z|^2 - 2 z.C + |C|^2 in float32, then argmin."""
        flat = z.permute(0, 2, 3, 1).reshape(-1, z.shape[1]).float()
        cb = self.codebook.float()
        d = (flat.square().sum(dim=1, keepdim=True) - 2.0 * flat @ cb.T
             + cb.square().sum(dim=1)[None, :])
        q = cb[d.argmin(dim=1)]
        return q.reshape(z.shape[0], z.shape[2], z.shape[3], -1).permute(0, 3, 1, 2).to(z.dtype)

    def decode(self, z: torch.Tensor, force_not_quantize: bool = False) -> torch.Tensor:
        if not force_not_quantize:
            z = self.quantize(z)
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))
