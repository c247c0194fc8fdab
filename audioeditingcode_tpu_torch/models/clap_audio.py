"""CLAP for the eval tower: the HTSAT audio tower, the CLAP model around it
and its text tower, as PyTorch modules.

Counterpart of ``audioeditingcode_tpu/models/clap_audio.py`` (the audio
tower) and ``audioeditingcode_tpu/models/clap_text.py`` (the text tower).
The modules carry transformers' ``ClapModel`` parameter and buffer names,
so that the state dict of a checkpoint in the layout ``ClapModel.
from_pretrained`` reads (``models/hf_checkpoint.py``) loads strictly:

- ``ClapAudioEncoder``: eval-mode BatchNorm over the mel bins, the mel
  image (``reshape_mel2img``, bicubic align-corners resampling as the
  matrix ``cubic_resize_matrix``), the patch embedding, Swin stages
  (window attention with the relative-position bias and the
  shifted-window mask, patch merging) and the frequency-grouped pooling;
- ``ClapProjectionLayer``: linear, ReLU, linear;
- ``ClapModel``: the audio tower and the port's ``RobertaModel``
  (``models/text_encoders.py``) as the text tower, each with its
  projection; ``get_audio_features`` and ``get_text_features`` as
  transformers computes them.

The tower's attention runs over 64-token Swin windows and the text
tower's over at most 77 tokens: both stay below the attention kernel's
1024-token threshold in both packages, so they take plain PyTorch ops.
GELU is the exact (erf) one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .text_encoders import RobertaModel, roberta_config


@dataclasses.dataclass(frozen=True)
class ClapAudioConfig:
    spec_size: int = 256
    patch_size: int = 4
    patch_stride: int = 4
    num_mel_bins: int = 64
    window_size: int = 8
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_attention_heads: Tuple[int, ...] = (4, 8, 16, 32)
    patch_embeds_hidden_size: int = 96
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-5
    projection_dim: int = 512

    @property
    def freq_ratio(self) -> int:
        return self.spec_size // self.num_mel_bins

    @property
    def num_features(self) -> int:
        return int(self.patch_embeds_hidden_size * 2 ** (len(self.depths) - 1))


def audio_config(raw: dict) -> ClapAudioConfig:
    """The tower's config from a transformers ``audio_config`` dict; what the
    port does not implement (feature fusion, other activations, no qkv
    bias) raises."""
    if raw.get("enable_fusion"):
        raise NotImplementedError("CLAP audio feature fusion (enable_fusion) is not ported")
    for key, want in (("hidden_act", "gelu"), ("projection_hidden_act", "relu"),
                      ("qkv_bias", True), ("patch_embed_input_channels", 1),
                      ("flatten_patch_embeds", True), ("enable_patch_layer_norm", True)):
        if raw.get(key, want) != want:
            raise NotImplementedError(f"CLAP audio {key}={raw[key]!r} is not ported")
    stride = raw.get("patch_stride", 4)
    if isinstance(stride, (list, tuple)):
        if len(set(stride)) != 1:
            raise NotImplementedError(f"CLAP audio patch_stride {stride} is not ported")
        stride = stride[0]
    defaults = ClapAudioConfig()
    return ClapAudioConfig(
        spec_size=raw.get("spec_size", defaults.spec_size),
        patch_size=raw.get("patch_size", defaults.patch_size),
        patch_stride=stride,
        num_mel_bins=raw.get("num_mel_bins", defaults.num_mel_bins),
        window_size=raw.get("window_size", defaults.window_size),
        depths=tuple(raw.get("depths", defaults.depths)),
        num_attention_heads=tuple(raw.get("num_attention_heads", defaults.num_attention_heads)),
        patch_embeds_hidden_size=raw.get("patch_embeds_hidden_size",
                                         defaults.patch_embeds_hidden_size),
        mlp_ratio=raw.get("mlp_ratio", defaults.mlp_ratio),
        layer_norm_eps=raw.get("layer_norm_eps", defaults.layer_norm_eps),
        projection_dim=raw.get("projection_dim", defaults.projection_dim),
    )


# ----------------------------------------------------------------- helpers

def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """torch's bicubic convolution kernel (Keys, A = -0.75)."""
    x = np.abs(x)
    return np.where(
        x <= 1, (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1,
        np.where(x < 2, a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a, 0.0),
    )


def cubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) matrix of torch's 1-D bicubic interpolation with
    align_corners=True and replicated borders (reshape_mel2img's time
    axis)."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    scale = (n_in - 1) / (n_out - 1)
    W = np.zeros((n_out, n_in), np.float32)
    for o in range(n_out):
        src = o * scale
        i0 = int(np.floor(src))
        for tap in range(-1, 3):
            i = i0 + tap
            W[o, min(max(i, 0), n_in - 1)] += _cubic_kernel(np.asarray(src - i))
    return W


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * H/ws * W/ws, ws*ws, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def _window_reverse(w: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    C = w.shape[-1]
    x = w.reshape(-1, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, H, W, C)


def relative_position_index(ws: int) -> torch.Tensor:
    """(ws*ws, ws*ws) index into the relative-position bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return torch.from_numpy(rel.sum(-1).astype(np.int64))


def shift_attn_mask(H: int, W: int, ws: int, shift: int) -> torch.Tensor:
    """(num_windows, ws*ws, ws*ws) additive mask of shifted windows
    (transformers' ClapAudioLayer.get_attn_mask)."""
    img = torch.zeros((1, H, W, 1))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    mw = _window_partition(img, ws)[..., 0]  # (nW, ws*ws)
    m = mw[:, None, :] - mw[:, :, None]
    return torch.where(m != 0, -100.0, 0.0)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, transformers' ACT2FN['gelu']."""
    return F.gelu(x)


# ----------------------------------------------------------------- modules

class ClapAudioSelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int, ws: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, heads))
        self.register_buffer("relative_position_index", relative_position_index(ws))


class ClapAudioSelfOutput(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dense = nn.Linear(dim, dim)


class ClapAudioAttention(nn.Module):
    def __init__(self, dim: int, heads: int, ws: int):
        super().__init__()
        self.self = ClapAudioSelfAttention(dim, heads, ws)
        self.output = ClapAudioSelfOutput(dim)


class _Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)


class ClapAudioLayer(nn.Module):
    """One Swin block (transformers' ClapAudioLayer)."""

    def __init__(self, cfg: ClapAudioConfig, dim: int, heads: int, shift: int):
        super().__init__()
        self.cfg, self.heads, self.shift = cfg, heads, shift
        eps = cfg.layer_norm_eps
        self.layernorm_before = nn.LayerNorm(dim, eps=eps)
        self.attention = ClapAudioAttention(dim, heads, cfg.window_size)
        self.layernorm_after = nn.LayerNorm(dim, eps=eps)
        self.intermediate = _Dense(dim, int(cfg.mlp_ratio * dim))
        self.output = _Dense(int(cfg.mlp_ratio * dim), dim)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        ws, shift = self.cfg.window_size, self.shift
        if min(H, W) <= ws:  # transformers' set_shift_and_window_size
            ws, shift = min(H, W), 0
        B, L, C = x.shape
        att = self.attention.self
        h = self.layernorm_before(x).reshape(B, H, W, C)
        if shift > 0:
            h = torch.roll(h, (-shift, -shift), dims=(1, 2))
        win = _window_partition(h, ws)  # (B * nW, ws*ws, C)
        hd = C // self.heads
        q, k, v = (m(win).reshape(-1, ws * ws, self.heads, hd).transpose(1, 2)
                   for m in (att.query, att.key, att.value))
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        idx = (att.relative_position_index if ws == self.cfg.window_size
               else relative_position_index(ws).to(x.device))
        bias = att.relative_position_bias_table[idx.reshape(-1)]
        scores = scores + bias.reshape(ws * ws, ws * ws, self.heads).permute(2, 0, 1)[None]
        if shift > 0:
            mask = shift_attn_mask(H, W, ws, shift).to(x.device)  # (nW, L, L)
            nW = mask.shape[0]
            scores = scores.reshape(B, nW, self.heads, ws * ws, ws * ws) + mask[None, :, None]
            scores = scores.reshape(-1, self.heads, ws * ws, ws * ws)
        ctx = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(-1, ws * ws, C)
        h = _window_reverse(self.attention.output.dense(ctx), ws, H, W)
        if shift > 0:
            h = torch.roll(h, (shift, shift), dims=(1, 2))
        x = x + h.reshape(B, L, C)
        h = self.output.dense(gelu(self.intermediate.dense(self.layernorm_after(x))))
        return x + h


class ClapAudioPatchMerging(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim, eps=eps)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, _, C = x.shape
        x = x.reshape(B, H, W, C)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1).reshape(B, -1, 4 * C)
        return self.reduction(self.norm(x))


class ClapAudioStage(nn.Module):
    def __init__(self, cfg: ClapAudioConfig, i: int):
        super().__init__()
        dim = cfg.patch_embeds_hidden_size * 2 ** i
        self.blocks = nn.ModuleList([
            ClapAudioLayer(cfg, dim, cfg.num_attention_heads[i],
                           0 if b % 2 == 0 else cfg.window_size // 2)
            for b in range(cfg.depths[i])])
        self.downsample = (ClapAudioPatchMerging(dim, cfg.layer_norm_eps)
                           if i < len(cfg.depths) - 1 else None)


class ClapAudioPatchEmbed(nn.Module):
    def __init__(self, cfg: ClapAudioConfig):
        super().__init__()
        E = cfg.patch_embeds_hidden_size
        self.proj = nn.Conv2d(1, E, cfg.patch_size, stride=cfg.patch_stride,
                              padding=(cfg.patch_size - cfg.patch_stride) // 2)
        self.norm = nn.LayerNorm(E, eps=cfg.layer_norm_eps)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.norm(self.proj(img).flatten(2).transpose(1, 2))


def reshape_mel2img(feats: torch.Tensor, cfg: ClapAudioConfig) -> torch.Tensor:
    """(B, 1, T, M) normalized mel -> (B, 1, S, S) Swin image (transformers'
    ClapAudioEncoder.reshape_mel2img, the bicubic resampling as a matrix)."""
    B, C, T, M = feats.shape
    fr = cfg.freq_ratio
    spec_w, spec_h = cfg.spec_size * fr, cfg.spec_size // fr
    if T > spec_w or M > spec_h:
        raise ValueError("input longer than the swin input size")
    if T < spec_w:
        Wm = torch.from_numpy(cubic_resize_matrix(T, spec_w)).to(feats)
        feats = torch.einsum("ot,bctm->bcom", Wm, feats)
    if M < spec_h:
        Wm = torch.from_numpy(cubic_resize_matrix(M, spec_h)).to(feats)
        feats = torch.einsum("om,bctm->bcto", Wm, feats)
    B, C, T, M = feats.shape
    x = feats.reshape(B, C * fr, T // fr, M).permute(0, 1, 3, 2)
    return x.reshape(B, C, M * fr, T // fr)


class ClapAudioEncoder(nn.Module):
    def __init__(self, cfg: ClapAudioConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = ClapAudioPatchEmbed(cfg)
        self.layers = nn.ModuleList([ClapAudioStage(cfg, i) for i in range(len(cfg.depths))])
        self.batch_norm = nn.BatchNorm2d(cfg.num_mel_bins)
        self.norm = nn.LayerNorm(cfg.num_features, eps=cfg.layer_norm_eps)

    def forward(self, input_features: torch.Tensor
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """(B, 1, T, num_mel_bins) processor features -> (the hidden states
        [(B, C_i, H_i, W_i)]: the patch embedding's, then each stage's after
        its downsampling, as transformers' ``output.hidden_states``; the
        pooled output)."""
        cfg = self.cfg
        if input_features.shape[1] != 1:
            raise ValueError(f"the CLAP audio tower takes one mel channel, got "
                             f"{input_features.shape[1]} (feature fusion is not ported)")
        # BatchNorm2d over the mel-bin axis, in eval mode
        f = self.batch_norm(input_features.transpose(1, 3)).transpose(1, 3)
        img = reshape_mel2img(f, cfg)
        x = self.patch_embed(img)
        B = x.shape[0]
        H = W = cfg.spec_size // cfg.patch_stride
        stages = [x.reshape(B, H, W, -1).permute(0, 3, 1, 2)]
        for stage in self.layers:
            for block in stage.blocks:
                x = block(x, H, W)
            if stage.downsample is not None:
                x = stage.downsample(x, H, W)
                H, W = H // 2, W // 2
            stages.append(x.reshape(B, H, W, -1).permute(0, 3, 1, 2))
        # final norm, then the frequency-grouped average pool
        x = self.norm(x)
        C = x.shape[-1]
        fs = cfg.spec_size // (2 ** (len(cfg.depths) - 1)) // cfg.patch_stride
        cfb = fs // cfg.freq_ratio
        x = x.transpose(1, 2).reshape(B, C, fs // cfb, cfb, fs)
        pooled = x.permute(0, 1, 3, 2, 4).reshape(B, C, -1).mean(-1)
        return stages, pooled


class ClapAudioModel(nn.Module):
    def __init__(self, cfg: ClapAudioConfig):
        super().__init__()
        self.audio_encoder = ClapAudioEncoder(cfg)


class ClapProjectionLayer(nn.Module):
    """linear, ReLU, linear (transformers' ClapProjectionLayer)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.linear1 = nn.Linear(d_in, d_out)
        self.linear2 = nn.Linear(d_out, d_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(F.relu(self.linear1(x)))


# transformers' ClapTextConfig defaults (RoBERTa-base) for keys a config.json omits
_TEXT_DEFAULTS = {"vocab_size": 50265, "hidden_size": 768, "num_hidden_layers": 12,
                  "num_attention_heads": 12, "intermediate_size": 3072,
                  "max_position_embeddings": 514}


class ClapModel(nn.Module):
    """transformers' ClapModel (without feature fusion), from its config.json
    dict: ``text_model``, ``text_projection``, ``audio_model``,
    ``audio_projection`` and the two logit scales."""

    def __init__(self, config: dict):
        super().__init__()
        self.config = config
        tcfg = {**_TEXT_DEFAULTS, **config["text_config"]}
        self.audio_cfg = audio_config(config["audio_config"])
        text = roberta_config(tcfg)
        self.text_model = RobertaModel(text)
        # transformers' ClapTextEmbeddings keeps these two index buffers
        n = text["max_position_embeddings"]
        emb = self.text_model.embeddings
        emb.register_buffer("position_ids", torch.arange(n)[None])
        emb.register_buffer("token_type_ids", torch.zeros((1, n), dtype=torch.int64))
        proj = config.get("projection_dim", self.audio_cfg.projection_dim)
        self.text_projection = ClapProjectionLayer(text["hidden_size"],
                                                   tcfg.get("projection_dim", proj))
        self.audio_model = ClapAudioModel(self.audio_cfg)
        self.audio_projection = ClapProjectionLayer(self.audio_cfg.num_features,
                                                    self.audio_cfg.projection_dim)
        self.logit_scale_a = nn.Parameter(torch.tensor(0.0))
        self.logit_scale_t = nn.Parameter(torch.tensor(0.0))

    def audio_forward(self, input_features: torch.Tensor):
        """(the audio tower's hidden states, its pooled output)."""
        return self.audio_model.audio_encoder(input_features)

    def get_audio_features(self, input_features: torch.Tensor) -> torch.Tensor:
        """The projected pooled audio output (not normalized, as transformers
        returns it)."""
        return self.audio_projection(self.audio_forward(input_features)[1])

    def get_text_features(self, input_ids: torch.Tensor, attention_mask: torch.Tensor
                          ) -> torch.Tensor:
        """The projected pooler output of the text tower (not normalized)."""
        return self.text_projection(self.text_model(input_ids, attention_mask)[1])


# what a checkpoint saved by another transformers version, or the JAX
# package's param trees, may leave out: index buffers the model derives
# itself, and the logit scales, which the eval tower does not use
_OPTIONAL_KEYS = ("position_ids", "token_type_ids", "relative_position_index",
                  "num_batches_tracked", "logit_scale_a", "logit_scale_t")


def load_clap_weights(model: ClapModel, state_dict, where: str = "the state dict") -> ClapModel:
    """Load ``state_dict`` into ``model`` by name: every parameter but the
    logit scales must be there, and nothing may be left over."""
    result = model.load_state_dict(state_dict, strict=False)
    missing = [k for k in result.missing_keys if not k.endswith(_OPTIONAL_KEYS)]
    if missing or result.unexpected_keys:
        raise ValueError(f"{where}: the weights do not match a CLAP model: missing "
                         f"{missing[:5]}, unexpected {result.unexpected_keys[:5]}")
    return model.float().eval().requires_grad_(False)


def load_clap(d: str) -> ClapModel:
    """The CLAP checkpoint directory ``d`` (``config.json`` and
    ``model.safetensors`` or ``pytorch_model.bin``) as a float32 ClapModel
    on the CPU in eval mode."""
    from .hf_checkpoint import read_config, read_state_dict

    return load_clap_weights(ClapModel(read_config(d)), read_state_dict(d), d)
