"""Conditional 2-D UNet (NCHW) — the latent-diffusion denoiser of the mel
families.

Counterpart of ``audioeditingcode_tpu/models/unet2d.py``. One module
covers:

- AudioLDM: FiLM conditioning through a ``simple_projection`` class
  embedding (added or concatenated to the time embedding), and attn2 as
  self-attention when no encoder states are given;
- AudioLDM2: two conditioning streams, one full ``Transformer2DModel`` per
  stream at each attention position, ``attentions.{2j}`` on
  ``encoder_hidden_states`` and ``attentions.{2j+1}`` on
  ``encoder_hidden_states_1``, run in turn (diffusers'
  AudioLDM2UNet2DConditionModel layout);
- TANGO: one cross-attention stream, with linear ``proj_in``/``proj_out``.

Parameter names are diffusers' dotted names
(``down_blocks.0.attentions.1.transformer_blocks.0.attn1.to_q.weight``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import torch
from torch import nn
from torch.nn import functional as F

from .attention import Transformer2DModel, mask_to_bias
from .embeddings import TimestepEmbedding, get_timestep_embedding
from .resnet import Downsample2D, ResnetBlock2D, Upsample2D


@dataclasses.dataclass(frozen=True)
class UNet2DConditionConfig:
    sample_size: Optional[int] = None
    in_channels: int = 8
    out_channels: int = 8
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    block_out_channels: Tuple[int, ...] = (128, 256, 384, 640)
    layers_per_block: int = 2
    transformer_layers_per_block: int = 1
    norm_num_groups: int = 32
    cross_attention_dim: Optional[int] = None
    num_attention_heads: Union[int, Tuple[int, ...]] = 8
    use_linear_projection: bool = False
    mid_block_type: Optional[str] = "UNetMidBlock2DCrossAttn"
    class_embed_type: Optional[str] = None  # None | 'simple_projection'
    projection_class_embeddings_input_dim: Optional[int] = None
    class_embeddings_concat: bool = False
    double_cross_attention: bool = False  # AudioLDM2 dual streams
    cross_attention_dim_1: Optional[int] = None
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    center_input_sample: bool = False

    def heads_for_block(self, i: int) -> int:
        if isinstance(self.num_attention_heads, int):
            return self.num_attention_heads
        return self.num_attention_heads[i]


class _Block(nn.Module):
    """Container giving diffusers' block names: resnets.j, attentions.j,
    downsamplers.0 / upsamplers.0."""

    def __init__(self, resnets, attentions=None, downsample=None, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([downsample])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])


class UNet2DConditionModel(nn.Module):
    def __init__(self, config: UNet2DConditionConfig):
        super().__init__()
        cfg = self.config = config
        if cfg.class_embed_type not in (None, "simple_projection"):
            raise NotImplementedError(cfg.class_embed_type)
        ch0 = cfg.block_out_channels[0]
        groups = cfg.norm_num_groups
        self.time_embedding = TimestepEmbedding(ch0, ch0 * 4)
        temb_ch = ch0 * 4
        if cfg.class_embed_type == "simple_projection":
            self.class_embedding = nn.Linear(cfg.projection_class_embeddings_input_dim, ch0 * 4)
            if cfg.class_embeddings_concat:
                temb_ch = ch0 * 8
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)

        def transformer(ch, i, cross_dim):
            heads = cfg.heads_for_block(i)
            return Transformer2DModel(
                ch, heads, ch // heads, depth=cfg.transformer_layers_per_block,
                cross_attention_dim=cross_dim,
                use_linear_projection=cfg.use_linear_projection,
                norm_num_groups=groups)

        def attn(ch, i):
            """The transformers of one attention position: one, or one per
            stream for the dual-stream UNet."""
            if not cfg.double_cross_attention:
                return [transformer(ch, i, cfg.cross_attention_dim)]
            return [transformer(ch, i, cfg.cross_attention_dim),
                    transformer(ch, i, cfg.cross_attention_dim_1)]

        n_levels = len(cfg.block_out_channels)
        skip_ch: List[int] = [ch0]  # channels of the skip connections, in order
        ch = ch0
        self.down_blocks = nn.ModuleList()
        for i, block_type in enumerate(cfg.down_block_types):
            out_ch = cfg.block_out_channels[i]
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(ch, out_ch, temb_ch, groups))
                ch = out_ch
                if block_type == "CrossAttnDownBlock2D":
                    attns += attn(out_ch, i)
                skip_ch.append(ch)
            down = None
            if i < len(cfg.down_block_types) - 1:
                down = Downsample2D(out_ch)
                skip_ch.append(ch)
            self.down_blocks.append(_Block(resnets, attns, downsample=down))

        if cfg.mid_block_type is not None:
            mid_ch = cfg.block_out_channels[-1]
            self.mid_block = _Block(
                [ResnetBlock2D(ch, mid_ch, temb_ch, groups),
                 ResnetBlock2D(mid_ch, mid_ch, temb_ch, groups)],
                attn(mid_ch, n_levels - 1))
            ch = mid_ch

        self.up_blocks = nn.ModuleList()
        for i, block_type in enumerate(cfg.up_block_types):
            rev_i = n_levels - 1 - i
            out_ch = cfg.block_out_channels[rev_i]
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(ch + skip_ch.pop(), out_ch, temb_ch, groups))
                ch = out_ch
                if block_type == "CrossAttnUpBlock2D":
                    attns += attn(out_ch, rev_i)
            up = Upsample2D(out_ch) if i < len(cfg.up_block_types) - 1 else None
            self.up_blocks.append(_Block(resnets, attns, upsample=up))

        self.conv_norm_out = nn.GroupNorm(groups, ch, eps=1e-5)
        self.conv_out = nn.Conv2d(ch, cfg.out_channels, 3, padding=1)

    def forward(
        self,
        sample: torch.Tensor,  # (B, C_in, H, W)
        timesteps: torch.Tensor,  # (B,) or scalar
        encoder_hidden_states: Optional[torch.Tensor] = None,  # (B, K, D)
        class_labels: Optional[torch.Tensor] = None,
        encoder_attention_mask: Optional[torch.Tensor] = None,  # (B, K) keep-mask
        encoder_hidden_states_1: Optional[torch.Tensor] = None,  # (B, K1, D1) 2nd stream
        encoder_attention_mask_1: Optional[torch.Tensor] = None,  # (B, K1)
    ) -> torch.Tensor:
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        ctx_bias = mask_to_bias(encoder_attention_mask, dtype)
        ctx1_bias = mask_to_bias(encoder_attention_mask_1, dtype)
        # the text streams in the module dtype, as the Flax modules cast them
        if encoder_hidden_states is not None:
            encoder_hidden_states = encoder_hidden_states.to(dtype)
        if encoder_hidden_states_1 is not None:
            encoder_hidden_states_1 = encoder_hidden_states_1.to(dtype)
        if cfg.center_input_sample:
            sample = 2.0 * sample - 1.0

        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps[None].expand(sample.shape[0])
        t_emb = get_timestep_embedding(
            timesteps, cfg.block_out_channels[0],
            flip_sin_to_cos=cfg.flip_sin_to_cos,
            downscale_freq_shift=cfg.freq_shift).to(dtype)
        emb = self.time_embedding(t_emb)
        if cfg.class_embed_type == "simple_projection":
            if class_labels is None:
                raise ValueError("class_labels required for simple_projection embedding")
            class_emb = self.class_embedding(class_labels.to(dtype))
            emb = (torch.cat([emb, class_emb], dim=-1) if cfg.class_embeddings_concat
                   else emb + class_emb)

        def attend(block, j, x):
            if not cfg.double_cross_attention:
                return block.attentions[j](x, encoder_hidden_states, ctx_bias)
            x = block.attentions[2 * j](x, encoder_hidden_states, ctx_bias)
            return block.attentions[2 * j + 1](x, encoder_hidden_states_1, ctx1_bias)

        sample = self.conv_in(sample)
        skips = [sample]
        for block in self.down_blocks:
            for j, resnet in enumerate(block.resnets):
                sample = resnet(sample, emb)
                if hasattr(block, "attentions"):
                    sample = attend(block, j, sample)
                skips.append(sample)
            if hasattr(block, "downsamplers"):
                sample = block.downsamplers[0](sample)
                skips.append(sample)

        if cfg.mid_block_type is not None:
            sample = self.mid_block.resnets[0](sample, emb)
            sample = attend(self.mid_block, 0, sample)
            sample = self.mid_block.resnets[1](sample, emb)

        for block in self.up_blocks:
            for j, resnet in enumerate(block.resnets):
                sample = resnet(torch.cat([sample, skips.pop()], dim=1), emb)
                if hasattr(block, "attentions"):
                    sample = attend(block, j, sample)
            if hasattr(block, "upsamplers"):
                # nearest x2, cropped to the matching skip's size
                sample = block.upsamplers[0](sample, output_size=skips[-1].shape[2:4])

        sample = F.silu(self.conv_norm_out(sample))
        return self.conv_out(sample)
