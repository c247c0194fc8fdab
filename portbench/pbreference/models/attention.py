"""Attention and transformer blocks of the diffusion UNet (diffusers naming).

Counterpart of ``audioeditingcode_tpu/models/attention.py``. Every attention
goes through :func:`..ops.flash_attention.fused_attention`, which sends the
long unmasked self-attention to the CUDA kernel; cross-attention to a text
stream (AudioLDM2's two streams, TANGO's T5 tokens), with the stream's key
mask as an additive bias, takes the plain path, as in the JAX dispatcher.
LayerNorm and GroupNorm use eps = 1e-6 as the Flax modules do (torch's
default is 1e-5).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.flash_attention import fused_attention


def mask_to_bias(mask: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    """(B, K) 0/1 keep-mask -> additive (B, 1, 1, K) bias of 0 / -1e4."""
    if mask is None:
        return None
    bias = (1.0 - mask.to(dtype)) * -10000.0
    return bias[:, None, None, :]


class Attention(nn.Module):
    """Multi-head attention with separate q and kv sources."""

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 cross_attention_dim: Optional[int] = None, out_bias: bool = True):
        super().__init__()
        inner = heads * head_dim
        kv_dim = query_dim if cross_attention_dim is None else cross_attention_dim
        self.heads, self.head_dim = heads, head_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(kv_dim, inner, bias=False)
        self.to_v = nn.Linear(kv_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim, bias=out_bias)])

    def forward(self, hidden_states: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                attention_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = hidden_states if context is None else context
        b, ql, _ = hidden_states.shape
        kl = ctx.shape[1]
        q = self.to_q(hidden_states).reshape(b, ql, self.heads, self.head_dim)
        k = self.to_k(ctx).reshape(b, kl, self.heads, self.head_dim)
        v = self.to_v(ctx).reshape(b, kl, self.heads, self.head_dim)
        out = fused_attention(q, k, v, bias=attention_bias)
        return self.to_out[0](out.reshape(b, ql, self.heads * self.head_dim))


class _GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact (erf) GELU


class GEGLUFeedForward(nn.Module):
    """GEGLU feed-forward: ``net.0.proj`` -> h * gelu(gate) -> ``net.2``."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([_GEGLU(dim, inner), nn.Identity(), nn.Linear(inner, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.net:
            x = layer(x)
        return x


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn (self-attn without context) -> GEGLU FF,
    each pre-LayerNorm."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 cross_attention_dim: Optional[int] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn1 = Attention(dim, heads, head_dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.attn2 = Attention(dim, heads, head_dim, cross_attention_dim=cross_attention_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                context_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        # without context attn2 is self-attention, as diffusers does with
        # encoder_hidden_states=None (AudioLDM's FiLM-only conditioning)
        x = x + self.attn2(self.norm2(x), context=context,
                           attention_bias=context_bias if context is not None else None)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    """GroupNorm -> proj_in -> blocks -> proj_out + residual over an NCHW map."""

    def __init__(self, in_channels: int, heads: int, head_dim: int, depth: int = 1,
                 cross_attention_dim: Optional[int] = None,
                 use_linear_projection: bool = False, norm_num_groups: int = 32):
        super().__init__()
        inner = heads * head_dim
        self.use_linear_projection = use_linear_projection
        self.norm = nn.GroupNorm(norm_num_groups, in_channels, eps=1e-6)
        if use_linear_projection:
            self.proj_in = nn.Linear(in_channels, inner)
            self.proj_out = nn.Linear(inner, in_channels)
        else:
            self.proj_in = nn.Conv2d(in_channels, inner, 1)
            self.proj_out = nn.Conv2d(inner, in_channels, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, heads, head_dim, cross_attention_dim)
            for _ in range(depth))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                context_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, c, h, w = x.shape
        residual = x
        x = self.norm(x)
        # tokens in (h, w) row-major order, the order of the JAX NHWC reshape
        if self.use_linear_projection:
            x = self.proj_in(x.permute(0, 2, 3, 1).reshape(b, h * w, c))
        else:
            x = self.proj_in(x)
            x = x.permute(0, 2, 3, 1).reshape(b, h * w, x.shape[1])
        for block in self.transformer_blocks:
            x = block(x, context, context_bias)
        if self.use_linear_projection:
            x = self.proj_out(x).reshape(b, h, w, c).permute(0, 3, 1, 2)
        else:
            x = self.proj_out(x.reshape(b, h, w, -1).permute(0, 3, 1, 2))
        return x + residual
