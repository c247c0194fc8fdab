"""Prompt conditioning: the ``TextCond`` bundle, the weight-free encoder
and the text towers of a converted checkpoint.

Counterpart of ``audioeditingcode_tpu/models/text_encoders.py`` and of the
encoders the JAX registry builds from a ``weights_dir``. The
``NullTextEncoder`` derives the same sha256-seeded numpy embeddings as the
JAX one, so a prompt gives bit-identical conditioning in both packages.
The towers are transformers' models, rewritten in plain PyTorch under
transformers' parameter names so that the Flax files of ``t5/`` and
``clap_text/`` load by name:

- ``T5EncoderModel``: FLAN-T5's encoder (RMS norms in float32, unscaled
  scores, bidirectional relative position buckets held by layer 0 and
  shared by all layers; ``feed_forward_proj`` from config.json);
- ``RobertaModel``: CLAP's text tower with its pooler, tanh(dense(h[:, 0]));
- ``CLIPTextModel``: Stable Diffusion's CLIP text tower (pre-LN layers,
  quick_gelu, a causal mask combined with the padding mask, the final
  layer norm);

and the encoders built on them: ``ClapFilmEncoder`` (AudioLDM's FiLM
vector), ``T5TextEncoder`` (TANGO), ``T5ProjectedEncoder`` (Stable Audio)
and ``ClipTextEncoder`` (Stable Diffusion). The towers always run in
float32, as transformers' Flax models do.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import time
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from . import flax_msgpack
from .bridge import flax_to_torch_state_dict, torch_to_flax_tree
from .tokenizers import Tokenizer

_FIELDS = ("hidden_states", "class_labels", "attention_mask",
           "hidden_states_1", "attention_mask_1")


@dataclasses.dataclass(frozen=True)
class TextCond:
    """Conditioning for one batch of prompts."""

    hidden_states: Optional[torch.Tensor] = None  # (P, K, D) cross-attn stream
    class_labels: Optional[torch.Tensor] = None  # (P, D) FiLM stream (AudioLDM)
    attention_mask: Optional[torch.Tensor] = None  # (P, K)
    hidden_states_1: Optional[torch.Tensor] = None  # (P, K1, D1) 2nd stream
    attention_mask_1: Optional[torch.Tensor] = None  # (P, K1)

    @property
    def batch(self) -> int:
        for f in (self.hidden_states, self.class_labels, self.hidden_states_1):
            if f is not None:
                return f.shape[0]
        return 1


def concat_conds(a: TextCond, b: TextCond) -> TextCond:
    """Batch-concat two bundles for the fused CFG call. Token streams of
    different lengths are right-padded with zero embeddings and a zero mask."""
    fields = {}
    for hs_name, mask_name in (("hidden_states", "attention_mask"),
                               ("hidden_states_1", "attention_mask_1")):
        hss = [getattr(c, hs_name) for c in (a, b)]
        masks = [getattr(c, mask_name) for c in (a, b)]
        if all(h is None for h in hss):
            fields[hs_name] = fields[mask_name] = None
            continue
        if any(h is None for h in hss):
            raise ValueError(f"inconsistent TextCond field {hs_name}")
        K = max(h.shape[1] for h in hss)
        need_mask = any(m is not None for m in masks) or any(h.shape[1] != K for h in hss)
        out_h, out_m = [], []
        for h, m in zip(hss, masks):
            if m is None and need_mask:
                m = torch.ones(h.shape[:2], dtype=torch.int32, device=h.device)
            if h.shape[1] != K:
                h = torch.nn.functional.pad(h, (0, 0, 0, K - h.shape[1]))
                m = torch.nn.functional.pad(m, (0, K - m.shape[1]))
            out_h.append(h)
            out_m.append(m)
        fields[hs_name] = torch.cat(out_h, dim=0)
        fields[mask_name] = torch.cat(out_m, dim=0) if need_mask else None
    cls = [c.class_labels for c in (a, b)]
    if all(v is None for v in cls):
        fields["class_labels"] = None
    elif any(v is None for v in cls):
        raise ValueError("inconsistent TextCond field class_labels")
    else:
        fields["class_labels"] = torch.cat(cls, dim=0)
    return TextCond(**fields)


def repeat_cond(c: TextCond, n: int) -> TextCond:
    """Repeat a batch-1 bundle n times."""
    if c.batch == n:
        return c
    if c.batch != 1:
        raise ValueError(f"cannot repeat batch {c.batch} to {n}")
    return TextCond(**{f: None if getattr(c, f) is None
                       else getattr(c, f).repeat_interleave(n, dim=0) for f in _FIELDS})


class NullTextEncoder:
    """Deterministic weight-free prompt embeddings: seeded from a sha256 of
    the prompt; the empty prompt gives zeros."""

    def __init__(self, hidden_dim: Optional[int] = None, seq_len: int = 8,
                 class_dim: Optional[int] = None, hidden_dim_1: Optional[int] = None,
                 seq_len_1: int = 8, device: Union[str, torch.device] = "cpu"):
        self.hidden_dim = hidden_dim
        self.seq_len = seq_len
        self.class_dim = class_dim
        self.hidden_dim_1 = hidden_dim_1
        self.seq_len_1 = seq_len_1
        self.device = device

    def _emb(self, prompt: str, shape) -> np.ndarray:
        if prompt == "":
            return np.zeros(shape, dtype=np.float32)
        seed = int.from_bytes(hashlib.sha256(prompt.encode()).digest()[:4], "little")
        rng = np.random.default_rng(seed)
        e = rng.standard_normal(shape).astype(np.float32)
        return e / np.linalg.norm(e, axis=-1, keepdims=True)

    def _stack(self, prompts: List[str], shape) -> torch.Tensor:
        return torch.as_tensor(np.stack([self._emb(p, shape) for p in prompts]),
                               device=self.device)

    def _mask(self, n: int, k: int) -> torch.Tensor:
        return torch.ones((n, k), dtype=torch.int32, device=self.device)

    def __call__(self, prompts: List[str], negative: bool = False) -> TextCond:
        hs = cls = hs1 = mask = mask1 = None
        if self.hidden_dim is not None:
            hs = self._stack(prompts, (self.seq_len, self.hidden_dim))
            mask = self._mask(len(prompts), self.seq_len)
        if self.class_dim is not None:
            cls = self._stack(prompts, (self.class_dim,))
        if self.hidden_dim_1 is not None:
            hs1 = self._stack(prompts, (self.seq_len_1, self.hidden_dim_1))
            mask1 = self._mask(len(prompts), self.seq_len_1)
        return TextCond(hidden_states=hs, class_labels=cls, attention_mask=mask,
                        hidden_states_1=hs1, attention_mask_1=mask1)


# ------------------------------------------------------------------ towers
def _act(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """transformers' Flax ACT2FN entries the text towers use."""
    acts = {"relu": F.relu, "gelu": F.gelu,
            "gelu_new": lambda x: F.gelu(x, approximate="tanh"), "silu": F.silu,
            "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x)}
    if name not in acts:
        raise NotImplementedError(f"activation {name!r} is not implemented in the port")
    return acts[name]


def _mask_bias(mask: torch.Tensor) -> torch.Tensor:
    """(B, K) mask -> (B, 1, 1, K) additive bias, finfo.min where masked
    (transformers' Flax attention)."""
    return torch.where(mask[:, None, None, :] > 0, 0.0, torch.finfo(torch.float32).min)


class T5LayerNorm(nn.Module):
    """T5's RMS norm, in float32, with no bias and no mean subtraction."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().pow(2).mean(dim=-1, keepdim=True)
        return self.weight * (x / torch.sqrt(var + self.eps))


class T5Attention(nn.Module):
    def __init__(self, cfg: dict, has_bias: bool):
        super().__init__()
        d, inner = cfg["d_model"], cfg["num_heads"] * cfg["d_kv"]
        self.heads = cfg["num_heads"]
        self.q = nn.Linear(d, inner, bias=False)
        self.k = nn.Linear(d, inner, bias=False)
        self.v = nn.Linear(d, inner, bias=False)
        self.o = nn.Linear(inner, d, bias=False)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(
                cfg["relative_attention_num_buckets"], self.heads)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        B, S, _ = x.shape
        q, k, v = (m(x).view(B, S, self.heads, -1).transpose(1, 2)
                   for m in (self.q, self.k, self.v))
        scores = q @ k.transpose(-1, -2) + bias  # T5 does not scale by 1/sqrt(d)
        o = torch.softmax(scores, dim=-1) @ v
        return self.o(o.transpose(1, 2).reshape(B, S, -1))


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: dict, has_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_bias)
        self.layer_norm = T5LayerNorm(cfg["d_model"], cfg["layer_norm_epsilon"])

    def forward(self, x, bias):
        return x + self.SelfAttention(self.layer_norm(x), bias)


class T5DenseActDense(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.wi = nn.Linear(cfg["d_model"], cfg["d_ff"], bias=False)
        self.wo = nn.Linear(cfg["d_ff"], cfg["d_model"], bias=False)
        self.act = _act(cfg["dense_act_fn"])

    def forward(self, x):
        return self.wo(self.act(self.wi(x)))


class T5DenseGatedActDense(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.wi_0 = nn.Linear(cfg["d_model"], cfg["d_ff"], bias=False)
        self.wi_1 = nn.Linear(cfg["d_model"], cfg["d_ff"], bias=False)
        self.wo = nn.Linear(cfg["d_ff"], cfg["d_model"], bias=False)
        self.act = _act(cfg["dense_act_fn"])

    def forward(self, x):
        return self.wo(self.act(self.wi_0(x)) * self.wi_1(x))


class T5LayerFF(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.DenseReluDense = (T5DenseGatedActDense if cfg["is_gated_act"]
                               else T5DenseActDense)(cfg)
        self.layer_norm = T5LayerNorm(cfg["d_model"], cfg["layer_norm_epsilon"])

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x))


class T5Block(nn.Module):
    def __init__(self, cfg: dict, has_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(cfg, has_bias), T5LayerFF(cfg)])

    def forward(self, x, bias):
        return self.layer[1](self.layer[0](x, bias))


class T5Stack(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.block = nn.ModuleList([T5Block(cfg, i == 0) for i in range(cfg["num_layers"])])
        self.final_layer_norm = T5LayerNorm(cfg["d_model"], cfg["layer_norm_epsilon"])


def t5_config(raw: dict) -> dict:
    """The fields of a T5 config.json the encoder uses, with transformers'
    derivation of the activation from ``feed_forward_proj``."""
    cfg = {k: raw[k] for k in ("d_model", "d_kv", "d_ff", "num_layers", "num_heads",
                               "vocab_size")}
    cfg["relative_attention_num_buckets"] = raw.get("relative_attention_num_buckets", 32)
    cfg["relative_attention_max_distance"] = raw.get("relative_attention_max_distance", 128)
    cfg["layer_norm_epsilon"] = raw.get("layer_norm_epsilon", 1e-6)
    proj = raw.get("feed_forward_proj", "relu")
    parts = proj.split("-")
    if len(parts) > 2 or (len(parts) == 2 and parts[0] != "gated"):
        raise ValueError(f"feed_forward_proj {proj!r} is not a T5 activation")
    cfg["is_gated_act"] = len(parts) == 2
    act = parts[-1]
    cfg["dense_act_fn"] = "gelu_new" if proj == "gated-gelu" else act
    cfg["model_type"] = "t5"
    return cfg


def relative_position_buckets(q_len: int, k_len: int, num_buckets: int,
                              max_distance: int) -> torch.Tensor:
    """T5's bidirectional buckets of memory - query positions, (q, k) int64,
    computed in float32 on the host as the Flax model computes them."""
    rel = torch.arange(k_len)[None, :] - torch.arange(q_len)[:, None]
    num_buckets //= 2
    buckets = (rel > 0).long() * num_buckets
    rel = rel.abs()
    max_exact = num_buckets // 2
    large = max_exact + (torch.log(rel.float() / max_exact)
                         / torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32))
                         * (num_buckets - max_exact))
    large = torch.clamp(large, max=num_buckets - 1)
    return (buckets + torch.where(rel < max_exact, rel.float(), large)).long()


class T5EncoderModel(nn.Module):
    """transformers' T5EncoderModel (no decoder), last hidden state out."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.config = cfg
        self.shared = nn.Embedding(cfg["vocab_size"], cfg["d_model"])
        self.encoder = T5Stack(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        S = input_ids.shape[1]
        cfg = self.config
        buckets = relative_position_buckets(S, S, cfg["relative_attention_num_buckets"],
                                            cfg["relative_attention_max_distance"])
        attn0 = self.encoder.block[0].layer[0].SelfAttention
        bias = attn0.relative_attention_bias(buckets.to(input_ids.device))
        bias = bias.permute(2, 0, 1)[None] + _mask_bias(attention_mask)
        h = self.shared(input_ids)
        for block in self.encoder.block:
            h = block(h, bias)
        return self.encoder.final_layer_norm(h)


class RobertaEmbeddings(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        H = cfg["hidden_size"]
        self.word_embeddings = nn.Embedding(cfg["vocab_size"], H)
        self.position_embeddings = nn.Embedding(cfg["max_position_embeddings"], H)
        self.token_type_embeddings = nn.Embedding(cfg["type_vocab_size"], H)
        self.LayerNorm = nn.LayerNorm(H, eps=cfg["layer_norm_eps"])
        self.pad = cfg["pad_token_id"]

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        # transformers' create_position_ids_from_input_ids
        mask = (input_ids != self.pad).long()
        pos = torch.cumsum(mask, dim=1) * mask + self.pad
        h = (self.word_embeddings(input_ids)
             + self.token_type_embeddings(torch.zeros_like(input_ids))
             + self.position_embeddings(pos))
        return self.LayerNorm(h)


class RobertaSelfAttention(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        H = cfg["hidden_size"]
        self.heads = cfg["num_attention_heads"]
        self.query = nn.Linear(H, H)
        self.key = nn.Linear(H, H)
        self.value = nn.Linear(H, H)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        B, S, H = x.shape
        q, k, v = (m(x).view(B, S, self.heads, -1).transpose(1, 2)
                   for m in (self.query, self.key, self.value))
        q = q / math.sqrt(q.shape[-1])
        o = torch.softmax(q @ k.transpose(-1, -2) + bias, dim=-1) @ v
        return o.transpose(1, 2).reshape(B, S, H)


class RobertaDenseNorm(nn.Module):
    """dense, then LayerNorm of the residual sum (the attention output and
    the layer output)."""

    def __init__(self, cfg: dict, d_in: int):
        super().__init__()
        self.dense = nn.Linear(d_in, cfg["hidden_size"])
        self.LayerNorm = nn.LayerNorm(cfg["hidden_size"], eps=cfg["layer_norm_eps"])

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.dense(x) + residual)


class RobertaAttention(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.self = RobertaSelfAttention(cfg)
        self.output = RobertaDenseNorm(cfg, cfg["hidden_size"])

    def forward(self, x, bias):
        return self.output(self.self(x, bias), x)


class RobertaIntermediate(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.dense = nn.Linear(cfg["hidden_size"], cfg["intermediate_size"])
        self.act = _act(cfg["hidden_act"])

    def forward(self, x):
        return self.act(self.dense(x))


class RobertaLayer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.attention = RobertaAttention(cfg)
        self.intermediate = RobertaIntermediate(cfg)
        self.output = RobertaDenseNorm(cfg, cfg["intermediate_size"])

    def forward(self, x, bias):
        a = self.attention(x, bias)
        return self.output(self.intermediate(a), a)


class RobertaEncoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.layer = nn.ModuleList([RobertaLayer(cfg) for _ in range(cfg["num_hidden_layers"])])


class RobertaPooler(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.dense = nn.Linear(cfg["hidden_size"], cfg["hidden_size"])


def roberta_config(raw: dict) -> dict:
    cfg = {k: raw[k] for k in ("vocab_size", "hidden_size", "num_hidden_layers",
                               "num_attention_heads", "intermediate_size",
                               "max_position_embeddings")}
    cfg["type_vocab_size"] = raw.get("type_vocab_size", 1)
    cfg["layer_norm_eps"] = raw.get("layer_norm_eps", 1e-12)
    cfg["pad_token_id"] = raw.get("pad_token_id", 1)
    cfg["hidden_act"] = raw.get("hidden_act", "gelu")
    if raw.get("position_embedding_type", "absolute") != "absolute":
        raise NotImplementedError(
            f"position_embedding_type {raw['position_embedding_type']!r} is not ported")
    cfg["model_type"] = "roberta"
    return cfg


class RobertaModel(nn.Module):
    """transformers' RobertaModel: (last hidden state, pooler output)."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.config = cfg
        self.embeddings = RobertaEmbeddings(cfg)
        self.encoder = RobertaEncoder(cfg)
        self.pooler = RobertaPooler(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        bias = _mask_bias(attention_mask)
        h = self.embeddings(input_ids)
        for layer in self.encoder.layer:
            h = layer(h, bias)
        return h, torch.tanh(self.pooler.dense(h[:, 0]))


class CLIPAttention(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        H = cfg["hidden_size"]
        self.heads = cfg["num_attention_heads"]
        self.q_proj = nn.Linear(H, H)
        self.k_proj = nn.Linear(H, H)
        self.v_proj = nn.Linear(H, H)
        self.out_proj = nn.Linear(H, H)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        B, S, H = x.shape
        q, k, v = (m(x).view(B, S, self.heads, -1).transpose(1, 2)
                   for m in (self.q_proj, self.k_proj, self.v_proj))
        q = q / math.sqrt(q.shape[-1])
        o = torch.softmax(q @ k.transpose(-1, -2) + bias, dim=-1) @ v
        return self.out_proj(o.transpose(1, 2).reshape(B, S, H))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.fc1 = nn.Linear(cfg["hidden_size"], cfg["intermediate_size"])
        self.fc2 = nn.Linear(cfg["intermediate_size"], cfg["hidden_size"])
        self.act = _act(cfg["hidden_act"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    """Pre-LN: x + attn(ln1(x)), then x + mlp(ln2(x))."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = nn.LayerNorm(cfg["hidden_size"], eps=cfg["layer_norm_eps"])
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg["hidden_size"], eps=cfg["layer_norm_eps"])

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), bias)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg)
                                     for _ in range(cfg["num_hidden_layers"])])


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg["vocab_size"], cfg["hidden_size"])
        self.position_embedding = nn.Embedding(cfg["max_position_embeddings"],
                                               cfg["hidden_size"])


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg["hidden_size"], eps=cfg["layer_norm_eps"])


def clip_config(raw: dict) -> dict:
    cfg = {k: raw[k] for k in ("vocab_size", "hidden_size", "intermediate_size",
                               "num_hidden_layers", "num_attention_heads",
                               "max_position_embeddings")}
    cfg["hidden_act"] = raw.get("hidden_act", "quick_gelu")
    cfg["layer_norm_eps"] = raw.get("layer_norm_eps", 1e-5)
    cfg["model_type"] = "clip_text_model"
    return cfg


class CLIPTextModel(nn.Module):
    """transformers' CLIPTextModel: the last hidden state, with the causal
    mask and the padding mask of ``attention_mask`` combined, as
    FlaxCLIPTextModel combines them when it is given the mask."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.config = cfg
        self.text_model = CLIPTextTransformer(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        tm = self.text_model
        S = input_ids.shape[1]
        pos = torch.arange(S, device=input_ids.device)
        h = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding(pos)
        causal = torch.ones((S, S), dtype=torch.bool, device=h.device).tril()
        keep = causal[None, None] & (attention_mask[:, None, None, :] > 0)
        bias = torch.where(keep, 0.0, torch.finfo(torch.float32).min)
        for layer in tm.encoder.layers:
            h = layer(h, bias)
        return tm.final_layer_norm(h)


_TOWERS = {"t5": (T5EncoderModel, t5_config), "roberta": (RobertaModel, roberta_config),
           "clip_text_model": (CLIPTextModel, clip_config)}


def load_text_tower(d: str, device: Union[str, torch.device] = "cpu") -> nn.Module:
    """A transformers-Flax directory (config.json + flax_model.msgpack, or
    its ``.index.json`` shards) as a float32 T5 encoder, RoBERTa or CLIP
    text model."""
    with open(os.path.join(d, "config.json")) as f:
        raw = json.load(f)
    kind = raw.get("model_type")
    if kind not in _TOWERS:
        raise NotImplementedError(f"{d}: text tower model_type {kind!r} is not ported")
    cls, make_cfg = _TOWERS[kind]
    t0 = time.perf_counter()
    index = os.path.join(d, "flax_model.msgpack.index.json")
    if os.path.exists(index):
        with open(index) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        paths = [os.path.join(d, s) for s in shards]
        flat = {}
        for path in paths:
            flat.update(flax_msgpack.flatten(flax_msgpack.read_file(path)))
    else:
        path = os.path.join(d, "flax_model.msgpack")
        if not os.path.exists(path):
            raise FileNotFoundError(f"missing text tower weights: {path}")
        paths = [path]
        flat = flax_msgpack.flatten(flax_msgpack.read_file(path))
    with torch.device("meta"):
        model = cls(make_cfg(raw))
    try:
        sd = flax_to_torch_state_dict(flat, model, nesting="transformers")
    except (KeyError, ValueError) as e:
        raise ValueError(f"{d}: the Flax weights do not match a {kind} model: {e}") from e
    model.load_state_dict(sd, assign=True)
    flax_msgpack.LOAD_SECONDS[d] = (sum(os.path.getsize(p) for p in paths),
                                    time.perf_counter() - t0)
    return model.to(device).eval().requires_grad_(False)


def save_text_tower(model: nn.Module, d: str, raw_config: dict) -> None:
    """Write ``model`` as transformers' Flax ``save_pretrained`` does:
    config.json and flax_model.msgpack (no ``params`` root)."""
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(raw_config, f, indent=2)
    flax_msgpack.write_file(torch_to_flax_tree(model, nesting="transformers", root=""),
                            os.path.join(d, "flax_model.msgpack"))


# ----------------------------------------------------------------- encoders
def _ids(tok: Tokenizer, prompts: List[str], device, **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    ids, mask = tok(prompts, **kw)
    return (torch.as_tensor(ids, device=device),
            torch.as_tensor(mask, device=device))


def clap_text_features(roberta: RobertaModel, tok: Tokenizer, proj: dict,
                       prompts: List[str]) -> Tuple[torch.Tensor, torch.Tensor]:
    """CLAP's get_text_features: the MLP projection of the pooler output,
    L2-normalized, (B, D); and the token mask."""
    dev = roberta.pooler.dense.weight.device
    ids, mask = _ids(tok, prompts, dev, padding="max_length",
                     max_length=tok.model_max_length)
    _, pooled = roberta(ids, mask)
    h = torch.relu(pooled @ proj["w1"].T + proj["b1"])
    emb = h @ proj["w2"].T + proj["b2"]
    return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True), mask.int()


def load_clap_projection(d: str, device) -> dict:
    with np.load(os.path.join(d, "text_projection.npz")) as z:
        return {k: torch.as_tensor(z[k], dtype=torch.float32, device=device)
                for k in ("w1", "b1", "w2", "b2")}


class ClapFilmEncoder:
    """AudioLDM's CLAP FiLM vector: class_labels = the L2-normalized CLAP
    text embedding (the JAX registry's ``_try_clap_film``)."""

    def __init__(self, roberta: RobertaModel, tok: Tokenizer, proj: dict):
        self.roberta, self.tok, self.proj = roberta, tok, proj

    @torch.no_grad()
    def __call__(self, prompts: List[str], negative: bool = False) -> TextCond:
        emb, _ = clap_text_features(self.roberta, self.tok, self.proj, list(prompts))
        return TextCond(class_labels=emb)


class T5TextEncoder:
    """The FLAN-T5 sequence, padded to ``max_length`` (TANGO)."""

    def __init__(self, t5: T5EncoderModel, tok: Tokenizer, max_length: int = 512):
        self.t5, self.tok, self.max_length = t5, tok, max_length

    @torch.no_grad()
    def __call__(self, prompts: List[str], negative: bool = False) -> TextCond:
        ids, mask = _ids(self.tok, list(prompts), self.t5.shared.weight.device,
                         padding="max_length", max_length=self.max_length)
        return TextCond(hidden_states=self.t5(ids, mask), attention_mask=mask.int())


class T5ProjectedEncoder:
    """Stable Audio: the T5 sequence through the projection model's text
    projection; a negative prompt's padding is zeroed before projecting
    (the JAX registry's ``_try_t5_projected``)."""

    def __init__(self, base: T5TextEncoder, projection: nn.Module):
        self.base, self.projection = base, projection

    @torch.no_grad()
    def __call__(self, prompts: List[str], negative: bool = False) -> TextCond:
        cond = self.base(prompts, negative=negative)
        hs = cond.hidden_states
        if negative:
            hs = hs * cond.attention_mask[..., None].to(hs.dtype)
        hs = self.projection.project_text(hs)
        return TextCond(hidden_states=hs, attention_mask=cond.attention_mask)


class ClipTextEncoder:
    """Stable Diffusion's CLIP conditioning: the last hidden state of the
    prompts padded to the tokenizer's ``model_max_length`` (77), with no
    mask on the stream (the JAX registry's ``_try_clip_encoder``)."""

    def __init__(self, clip: CLIPTextModel, tok: Tokenizer):
        self.clip, self.tok = clip, tok

    @torch.no_grad()
    def __call__(self, prompts: List[str], negative: bool = False) -> TextCond:
        dev = self.clip.text_model.final_layer_norm.weight.device
        ids, mask = _ids(self.tok, list(prompts), dev, padding="max_length",
                         max_length=self.tok.model_max_length)
        return TextCond(hidden_states=self.clip(ids, mask))
