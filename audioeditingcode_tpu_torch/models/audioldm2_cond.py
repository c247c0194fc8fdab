"""AudioLDM2's conditioning chain: CLAP + FLAN-T5 -> projection -> GPT-2.

Counterpart of ``audioeditingcode_tpu/models/audioldm2_cond.py``. The CLAP
text embedding (one pooled token) and the FLAN-T5 sequence are projected to
the language model's width, framed by learned SOS/EOS embeddings,
concatenated, and fed to a GPT-2 that generates eight new embedding
vectors (diffusers' ``AudioLDM2Pipeline.generate_language_model``). Those
eight drive the UNet's first cross-attention stream; the raw T5 sequence
drives the second.

Modules carry diffusers' and transformers' parameter names
(``h.N.attn.c_attn``, ``h.N.mlp.c_proj``, ``projection_1``,
``sos_embed_1``, ...), so a checkpoint's ``language_model`` and
``projection_model`` state dicts load strictly, but for the vocabulary
embedding ``wte`` and the causal-mask buffers ``h.N.attn.bias``, which the
embeddings-in model does not use.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from .configs import AudioLDM2ProjectionConfig, GPT2Config
from .text_encoders import TextCond


# ------------------------------------------------------------------ GPT-2
class Conv1D(nn.Module):
    """GPT-2's dense layer: weight (in, out), as transformers stores it."""

    kernel_in_out = True  # the Flax kernel has the same layout (bridge.py)

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_in, n_out))
        self.bias = nn.Parameter(torch.zeros(n_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.addmm(self.bias, x.reshape(-1, x.shape[-1]), self.weight).view(
            x.shape[:-1] + (self.weight.shape[1],))


class GPT2Attention(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.heads = cfg.n_head
        self.c_attn = Conv1D(cfg.n_embd, 3 * cfg.n_embd)
        self.c_proj = Conv1D(cfg.n_embd, cfg.n_embd)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        B, S, E = x.shape
        q, k, v = (t.reshape(B, S, self.heads, -1).transpose(1, 2)
                   for t in self.c_attn(x).split(E, dim=-1))
        scores = q @ k.transpose(-1, -2) / math.sqrt(E // self.heads) + bias
        o = torch.softmax(scores.float(), dim=-1).to(v.dtype) @ v
        return self.c_proj(o.transpose(1, 2).reshape(B, S, E))


class GPT2MLP(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.c_fc = Conv1D(cfg.n_embd, 4 * cfg.n_embd)
        self.c_proj = Conv1D(4 * cfg.n_embd, cfg.n_embd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))


class GPT2Block(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.ln_1 = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon)
        self.attn = GPT2Attention(cfg)
        self.ln_2 = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon)
        self.mlp = GPT2MLP(cfg)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), bias)
        return x + self.mlp(self.ln_2(x))


class GPT2Model(nn.Module):
    """Embeddings-in, hidden-states-out causal GPT-2 (no vocabulary head)."""

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.config = cfg
        self.wpe = nn.Embedding(cfg.n_positions, cfg.n_embd)
        self.h = nn.ModuleList([GPT2Block(cfg) for _ in range(cfg.n_layer)])
        self.ln_f = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon)

    def forward(self, inputs_embeds: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, S, _ = inputs_embeds.shape
        x = inputs_embeds + self.wpe.weight[:S].to(inputs_embeds.dtype)
        dev = x.device
        causal = torch.ones((S, S), dtype=torch.bool, device=dev).tril()
        bias = torch.where(causal, 0.0, -1e9)[None, None]
        if attention_mask is not None:
            bias = bias + torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9)
        for block in self.h:
            x = block(x, bias)
        return self.ln_f(x)


@torch.no_grad()
def generate_language_model(gpt2: GPT2Model, inputs_embeds: torch.Tensor,
                            attention_mask: Optional[torch.Tensor],
                            max_new_tokens: int = 8) -> torch.Tensor:
    """Generate ``max_new_tokens`` embedding vectors, each step appending
    the final hidden state at the last position; (B, max_new_tokens, E)."""
    B, S0, _ = inputs_embeds.shape
    emb = inputs_embeds
    mask = (torch.ones((B, S0), dtype=torch.int32, device=emb.device)
            if attention_mask is None else attention_mask)
    ones = torch.ones((B, 1), dtype=mask.dtype, device=mask.device)
    for _ in range(max_new_tokens):
        nxt = gpt2(emb, mask)[:, -1:]
        emb = torch.cat([emb, nxt], dim=1)
        mask = torch.cat([mask, ones], dim=1)
    return emb[:, S0:]


# ---------------------------------------------------------- projection
def _add_special_tokens(hs: torch.Tensor, mask: Optional[torch.Tensor],
                        sos: torch.Tensor, eos: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SOS in front; EOS at each row's own length + 1; zeros past it."""
    B, S, D = hs.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.int32, device=hs.device)
    sos_tok = sos.to(hs.dtype).expand(B, 1, D)
    eos_tok = eos.to(hs.dtype).expand(B, 1, D)
    hs = torch.cat([sos_tok, hs, eos_tok], dim=1)  # (B, S + 2, D)
    lengths = mask.sum(dim=1)
    pos = torch.arange(S + 2, device=hs.device)[None]
    new_mask = (pos <= (lengths + 1)[:, None]).to(torch.int32)
    is_eos = (pos == (lengths + 1)[:, None])[..., None]
    hs = torch.where(is_eos, eos_tok, hs)
    return hs * new_mask[..., None].to(hs.dtype), new_mask


class AudioLDM2ProjectionModel(nn.Module):
    """Both text streams projected to the language model's width and framed
    by SOS/EOS embeddings (diffusers' AudioLDM2ProjectionModel)."""

    def __init__(self, cfg: AudioLDM2ProjectionConfig):
        super().__init__()
        D = cfg.langauge_model_dim
        self.projection = nn.Linear(cfg.text_encoder_dim, D)
        self.projection_1 = nn.Linear(cfg.text_encoder_1_dim, D)
        self.sos_embed = nn.Parameter(torch.zeros(D))
        self.eos_embed = nn.Parameter(torch.zeros(D))
        self.sos_embed_1 = nn.Parameter(torch.zeros(D))
        self.eos_embed_1 = nn.Parameter(torch.zeros(D))

    def forward(self, hidden_states, hidden_states_1, attention_mask=None,
                attention_mask_1=None) -> Tuple[torch.Tensor, torch.Tensor]:
        hs, mask = _add_special_tokens(self.projection(hidden_states), attention_mask,
                                       self.sos_embed, self.eos_embed)
        hs1, mask1 = _add_special_tokens(self.projection_1(hidden_states_1),
                                         attention_mask_1, self.sos_embed_1, self.eos_embed_1)
        return torch.cat([hs, hs1], dim=1), torch.cat([mask, mask1], dim=1)


# ---------------------------------------------------------- full chain
Features = Callable[[List[str]], Tuple[torch.Tensor, torch.Tensor]]


class AudioLDM2TextEncoder:
    """prompts -> CLAP pooled + T5 sequence -> projection -> GPT-2 generate
    -> TextCond: stream 0 the generated tokens (no mask), stream 1 the raw
    T5 sequence with its mask. ``clap_text_features`` and ``t5_features``
    map prompts to (embeddings, mask)."""

    def __init__(self, clap_text_features: Features, t5_features: Features,
                 projection: AudioLDM2ProjectionModel, gpt2: GPT2Model,
                 max_new_tokens: int = 8):
        self.clap_text_features = clap_text_features
        self.t5_features = t5_features
        self.projection = projection
        self.gpt2 = gpt2
        self.max_new_tokens = max_new_tokens

    @torch.no_grad()
    def __call__(self, prompts: List[str], negative: bool = False) -> TextCond:
        prompts = list(prompts)
        clap_emb, _ = self.clap_text_features(prompts)
        clap_emb = clap_emb[:, None, :]  # the pooled vector as one token
        clap_mask = torch.ones((len(prompts), 1), dtype=torch.int32, device=clap_emb.device)
        t5_emb, t5_mask = self.t5_features(prompts)
        proj_hs, proj_mask = self.projection(clap_emb, t5_emb, clap_mask, t5_mask)
        generated = generate_language_model(self.gpt2, proj_hs, proj_mask,
                                            max_new_tokens=self.max_new_tokens)
        return TextCond(hidden_states=generated, attention_mask=None,
                        hidden_states_1=t5_emb, attention_mask_1=t5_mask.int())
