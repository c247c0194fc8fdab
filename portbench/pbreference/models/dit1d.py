"""Stable Audio DiT (1-D diffusion transformer), (B, L, C) layout.

Counterpart of ``audioeditingcode_tpu/models/dit1d.py``. Module and
parameter names follow diffusers' ``StableAudioDiTModel``
(``transformer_blocks.0.attn1.to_out.0``, ``ff.net.0.proj``,
``timestep_proj.0``/``.2``, ``preprocess_conv`` as a ``Conv1d(k=1)``), the
names ``tools/convert_checkpoint.py::convert_dit`` reads.

- Self-attention (attn1) is grouped-query (24 query / 12 kv heads at full
  width) with a partial rotary embedding, through
  :func:`..ops.flash_attention.fused_attention` (kernel B1, or B2 with the
  rotary inside it); attn2 is cross-attention over the text + duration
  stream and takes the plain path.
- The SwiGLU feed-forward goes through :func:`..ops.swiglu.fused_swiglu`
  (kernel B3) with ``ff.net.0.proj``'s weight and bias, value half then
  gate half, with no copy.
- Under ``sp_mesh_scope`` with an sp axis (``--sp``), the token axis is
  split by hand, as GSPMD splits it in JAX: after the global token is
  prepended, the sequence is padded to a multiple of 8 sp and each rank
  keeps its block of rows (and of the rotary tables) through every block;
  self-attention gathers K/V over the sp group and masks the padded keys;
  cross-attention reads the whole (replicated) text stream. The rows are
  gathered before ``proj_out``, and the pad and the global token dropped.
- LayerNorm eps is 1e-6, as the Flax modules have it. The Fourier feature
  weights stay float32 in every model dtype, as the Flax params do; the
  rest runs in the model dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..ops.flash_attention import fused_attention, sp_mesh
from ..ops.swiglu import fused_swiglu
from ..parallel.mesh import seq_sharding


@dataclasses.dataclass(frozen=True)
class DiT1DConfig:
    """The stable-audio-open-1.0 transformer/config.json."""

    sample_size: int = 1024
    in_channels: int = 64
    out_channels: int = 64
    num_layers: int = 24
    attention_head_dim: int = 64
    num_attention_heads: int = 24
    num_key_value_attention_heads: int = 12
    cross_attention_dim: int = 768
    cross_attention_input_dim: int = 768
    global_states_input_dim: int = 1536
    time_proj_dim: int = 256

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def rotary_embed_dim(self) -> int:
        # rotary on the first half of each head's features
        return self.attention_head_dim // 2


def rotary_tables(dim: int, seq_len: int, theta: float = 10000.0,
                  device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of get_1d_rotary_pos_embed(use_real=True,
    repeat_interleave_real=False): each (seq_len, dim) float32, the dim/2
    frequencies tiled twice (rotate-half); computed in float64 numpy."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64)[: dim // 2] / dim))
    angles = np.outer(np.arange(seq_len, dtype=np.float64), freqs)
    cos = np.concatenate([np.cos(angles), np.cos(angles)], axis=-1)
    sin = np.concatenate([np.sin(angles), np.sin(angles)], axis=-1)
    return (torch.as_tensor(cos.astype(np.float32), device=device),
            torch.as_tensor(sin.astype(np.float32), device=device))


class GaussianFourierProjection(nn.Module):
    """Fixed random Fourier features of the continuous timestep,
    [cos, sin] (flip_sin_to_cos=True, log=False)."""

    fourier_features = True  # random init: N(0, 1), as the Flax param
    float32_params = ("weight",)  # kept float32 in every model dtype

    def __init__(self, embedding_size: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(embedding_size))

    def forward(self, t: torch.Tensor) -> torch.Tensor:  # (B,) -> (B, 2 * size) f32
        proj = 2.0 * math.pi * t.float()[:, None] * self.weight.float()[None, :]
        return torch.cat([torch.cos(proj), torch.sin(proj)], dim=-1)


def _mlp_proj(in_dim: int, out_dim: int, bias: bool) -> nn.Sequential:
    """Linear -> SiLU -> Linear (diffusers' ``*_proj.0`` / ``.2``)."""
    return nn.Sequential(nn.Linear(in_dim, out_dim, bias=bias), nn.SiLU(),
                         nn.Linear(out_dim, out_dim, bias=bias))


class GQAttention(nn.Module):
    """Grouped-query attention with an optional partial rotary embedding."""

    def __init__(self, dim: int, heads: int, kv_heads: int, head_dim: int,
                 cross_dim: Optional[int] = None):
        super().__init__()
        kv_in = dim if cross_dim is None else cross_dim
        self.heads, self.kv_heads, self.head_dim = heads, kv_heads, head_dim
        self.to_q = nn.Linear(dim, heads * head_dim, bias=False)
        self.to_k = nn.Linear(kv_in, kv_heads * head_dim, bias=False)
        self.to_v = nn.Linear(kv_in, kv_heads * head_dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(heads * head_dim, dim, bias=False)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                context_bias: Optional[torch.Tensor] = None,
                rotary: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                kv_len: Optional[int] = None) -> torch.Tensor:
        B, S, _ = x.shape
        ctx = x if context is None else context
        K = ctx.shape[1]
        # (B, S, H, D) end to end, the fused_attention contract; the kv
        # heads pass unexpanded (the kernels index them per query head)
        q = self.to_q(x).reshape(B, S, self.heads, self.head_dim)
        k = self.to_k(ctx).reshape(B, K, self.kv_heads, self.head_dim)
        v = self.to_v(ctx).reshape(B, K, self.kv_heads, self.head_dim)
        bias = None if context_bias is None else context_bias[:, None, None, :].float()
        out = fused_attention(q, k, v, bias=bias, rotary=rotary, kv_len=kv_len)
        return self.to_out[0](out.reshape(B, S, self.heads * self.head_dim))


class _SwiGLUProj(nn.Module):
    """``ff.net.0.proj``: a Linear(E, 2N) whose product, bias and
    ``h * silu(gate)`` run as one op (kernel B3 on the card). Its bias stays
    float32, as the Flax param reaches the kernel uncast."""

    float32_params = ("proj.bias",)

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_swiglu(x, self.proj.weight, self.proj.bias)

    def tp_shard(self, axis) -> None:
        """Tensor-parallel split (``parallel.mesh.shard_module_params``): the
        (2N, E) weight holds value rows, then gate rows. Rank r keeps value
        rows and gate rows [r N/tp, (r + 1) N/tp), so its (2N/tp, E) weight
        is again value rows then gate rows and kernel B3 gives its (M, N/tp)
        slice of the output, all-gathered on the last axis."""
        lin = self.proj
        N = lin.weight.shape[0] // 2
        n = N // axis.size
        if N % axis.size:
            raise ValueError(f"tp {axis.size} does not divide the SwiGLU width {N}")
        if lin.weight.shape[1] % 128 == 0 and N % 128 == 0 and n % 128:
            raise ValueError(f"tp {axis.size}: the SwiGLU shard width {n} breaks the "
                             f"kernels' 128-column tiles (TMA alignment); use a tp that "
                             f"keeps N / tp a multiple of 128")
        rows = torch.cat([torch.arange(axis.index * n, (axis.index + 1) * n),
                          torch.arange(N + axis.index * n, N + (axis.index + 1) * n)])
        rows = rows.to(lin.weight.device)
        lin.weight = nn.Parameter(lin.weight.detach()[rows].contiguous(), requires_grad=False)
        lin.bias = nn.Parameter(lin.bias.detach()[rows].contiguous(), requires_grad=False)
        self.register_forward_hook(lambda module, inputs, out: axis.gather(out, dim=out.dim() - 1))


class SwiGLUFeedForward(nn.Module):
    """FeedForward(activation_fn='swiglu'): net.0 (fused SwiGLU) -> net.2."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([_SwiGLUProj(dim, inner), nn.Identity(),
                                  nn.Linear(inner, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.net:
            x = layer(x)
        return x


class DiTBlock(nn.Module):
    """Pre-LN self-attention (rotary) -> cross-attention -> SwiGLU FF."""

    def __init__(self, cfg: DiT1DConfig):
        super().__init__()
        E = cfg.inner_dim
        heads, kv, hd = (cfg.num_attention_heads, cfg.num_key_value_attention_heads,
                         cfg.attention_head_dim)
        self.norm1 = nn.LayerNorm(E, eps=1e-6)
        self.attn1 = GQAttention(E, heads, kv, hd)
        self.norm2 = nn.LayerNorm(E, eps=1e-6)
        self.attn2 = GQAttention(E, heads, kv, hd, cross_dim=cfg.cross_attention_dim)
        self.norm3 = nn.LayerNorm(E, eps=1e-6)
        self.ff = SwiGLUFeedForward(E)

    def forward(self, x, context, context_bias, rotary, kv_len=None):
        x = x + self.attn1(self.norm1(x), rotary=rotary, kv_len=kv_len)
        x = x + self.attn2(self.norm2(x), context=context, context_bias=context_bias)
        return x + self.ff(self.norm3(x))


def _sp_rows(x: torch.Tensor, rotary: Tuple[torch.Tensor, torch.Tensor], axis):
    """This rank's block of the (B, S0, E) tokens, padded to a multiple of
    8 sp (the pad's rows are zeros, its rotary rows zeros), and the rotary
    rows of the same positions."""
    S0 = x.shape[1]
    S = -(-S0 // (8 * axis.size)) * (8 * axis.size)
    n = S // axis.size
    lo = axis.index * n
    x = F.pad(x, (0, 0, 0, S - S0))[:, lo: lo + n]
    cos, sin = (F.pad(t[:S0], (0, 0, 0, S - S0))[lo: lo + n] for t in rotary)
    return x, (cos, sin)


class StableAudioDiT(nn.Module):
    """Latent (B, L, C) + t + text/duration conditioning -> v-prediction."""

    # read as F.linear weights in forward: tensor parallelism keeps them whole
    tp_replicate = ("preprocess_conv", "postprocess_conv")

    def __init__(self, cfg: DiT1DConfig):
        super().__init__()
        self.config = cfg
        E, C = cfg.inner_dim, cfg.in_channels
        self.time_proj = GaussianFourierProjection(cfg.time_proj_dim // 2)
        self.timestep_proj = _mlp_proj(cfg.time_proj_dim, E, bias=True)
        self.global_proj = _mlp_proj(cfg.global_states_input_dim, E, bias=False)
        self.cross_attention_proj = _mlp_proj(cfg.cross_attention_input_dim,
                                              cfg.cross_attention_dim, bias=False)
        self.preprocess_conv = nn.Conv1d(C, C, 1, bias=False)
        self.proj_in = nn.Linear(C, E, bias=False)
        self.transformer_blocks = nn.ModuleList(DiTBlock(cfg) for _ in range(cfg.num_layers))
        self.proj_out = nn.Linear(E, cfg.out_channels, bias=False)
        self.postprocess_conv = nn.Conv1d(cfg.out_channels, cfg.out_channels, 1, bias=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.proj_in.weight.dtype

    def forward(
        self,
        sample: torch.Tensor,  # (B, L, C_in)
        timestep: torch.Tensor,  # (B,) continuous t in (0, 1)
        encoder_hidden_states: torch.Tensor,  # (B, K, cross_in) text + duration
        global_hidden_states: torch.Tensor,  # (B, 1, global_in) duration token
        rotary: Tuple[torch.Tensor, torch.Tensor],  # cos/sin (L+1, rot)
        encoder_attention_bias: Optional[torch.Tensor] = None,  # (B, K) additive
    ) -> torch.Tensor:
        dtype = self.dtype
        t_emb = self.timestep_proj(self.time_proj(timestep).to(dtype))
        g = self.global_proj(global_hidden_states.to(dtype)) + t_emb[:, None, :]
        ctx = self.cross_attention_proj(encoder_hidden_states.to(dtype))

        # pointwise pre-conv (Conv1d k=1, no bias) on (B, L, C), residual in
        # the promotion of the input and model dtypes, as in Flax
        x = sample + F.linear(sample.to(dtype), self.preprocess_conv.weight[:, :, 0])
        x = self.proj_in(x.to(dtype))
        x = torch.cat([g.to(x.dtype), x], dim=1)  # prepend the global token
        sp = seq_sharding(sp_mesh())
        S0 = x.shape[1]
        if sp is not None:
            x, rotary = _sp_rows(x, rotary, sp)
        for block in self.transformer_blocks:
            x = block(x, ctx, encoder_attention_bias, rotary,
                      kv_len=None if sp is None else S0)
        if sp is not None:
            x = sp.gather(x, S0, dim=1)
        x = self.proj_out(x)[:, 1:]  # drop the global token
        return x + F.linear(x, self.postprocess_conv.weight[:, :, 0])
