"""diffusers and transformers checkpoints -> the ``weights_dir`` layout.

Counterpart of ``audioeditingcode_tpu/models/convert.py`` and of the
per-part converters of ``tools/convert_checkpoint.py``, with no JAX and no
flax. Each part's state dict is mapped onto the port module that reads it
(built on the ``meta`` device, so nothing is allocated but the source
tensors), and the filled module is written by ``registry.save_params`` or
``text_encoders.save_text_tower``: the files the JAX package's tool writes,
leaf for leaf and bit for bit (``bridge.torch_to_flax_tree`` is the inverse
of the layout rules of the JAX converter). Every tensor keeps the dtype it
has in the checkpoint, as in the JAX tool.

The port's modules carry diffusers' and transformers' parameter names, so
most keys map as they are. ``RENAMES`` holds the rest, per part:

- ``vocoder``: transformers' ``upsampler.N`` is the port's ``ups.N``;
- ``vqvae``: ``quantize.embedding.weight`` is the VQ ``codebook``;
- ``gpt2`` (the ``language_model`` subfolder): GPT-2 under a
  ``transformer.`` prefix loses it;
- ``clap_text``: CLAP's RoBERTa body under ``text_model.`` loses it;
- ``unet``, ``vae``, ``vqvae``: diffusers' deprecated attention names
  (``query``, ``key``, ``value``, ``proj_attn``) are ``to_q``, ``to_k``,
  ``to_v``, ``to_out.0``, as diffusers renames them at load.

and ``DROPS`` the source tensors no port module holds, each with its
reason. Weight-norm pairs are folded first (``fold_weight_norm``: the HiFi-GAN
vocoder and the Oobleck VAE).

Accounting is strict both ways, unlike the JAX tool's ``strict=False`` on
the UNet, VAE, VQ-VAE, DiT and Oobleck (where a missing tensor keeps the
Flax init's random value): every parameter of the port module must be
filled, every source tensor must be used or dropped by name, and a wrong
shape raises. Each error names the key and the file it came from.
"""

from __future__ import annotations

import os
import re
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from . import hf_checkpoint

# (pattern, replacement) applied in order to every source key of a part
_DEPRECATED_ATTENTION = (
    (r"(attentions\.\d+\.)query\.", r"\1to_q."),
    (r"(attentions\.\d+\.)key\.", r"\1to_k."),
    (r"(attentions\.\d+\.)value\.", r"\1to_v."),
    (r"(attentions\.\d+\.)proj_attn\.", r"\1to_out.0."),
)
RENAMES: Dict[str, Tuple[Tuple[str, str], ...]] = {
    "unet": _DEPRECATED_ATTENTION,
    "vae": _DEPRECATED_ATTENTION,
    "vqvae": _DEPRECATED_ATTENTION + ((r"^quantize\.embedding\.weight$", "codebook"),),
    "vocoder": ((r"^upsampler\.", "ups."),),
    "gpt2": ((r"^transformer\.", ""),),
    "clap_text": ((r"^text_model\.", ""),),
}
# source keys (full-match patterns) that no port module holds, per part
DROPS: Dict[str, Tuple[str, ...]] = {
    # GPT-2: the vocabulary embedding (the embeddings-in language model
    # never looks a token up) and the causal-mask buffers older
    # transformers saved
    "gpt2": (r"wte\.weight", r"h\.\d+\.attn\.(bias|masked_bias)"),
    # SpeechT5HifiGan's input statistics, used only when normalize_before
    # (dropped for the AudioLDM configs, which run it False)
    "vocoder": (r"mean", r"scale"),
    # T5's encoder embedding is the shared one (tied)
    "t5": (r"encoder\.embed_tokens\.weight",),
    # CLIP's position index buffer (persistent in older transformers)
    "clip": (r"text_model\.embeddings\.position_ids",),
    # CLAP's index buffers (persistent in transformers' ClapTextEmbeddings);
    # of a full ClapModel, the audio tower, its projection and the logit
    # scales; the text projection goes to text_projection.npz
    "clap_text": (r"text_model\.embeddings\.(position_ids|token_type_ids)",
                  r"audio_model\..*", r"audio_projection\..*", r"logit_scale_[at]",
                  r"text_projection\.linear[12]\.(weight|bias)"),
}


# the parts whose convs are weight-normed at rest
FOLDED = ("vocoder", "oobleck")


class ConversionError(ValueError):
    """A checkpoint that does not map onto the port module of its part."""


# ------------------------------------------------------------- weight norm
def fold_weight_norm(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fold torch weight-norm parametrizations into plain weights, in both
    layouts: ``<mod>.weight_g`` + ``<mod>.weight_v``, and
    ``<mod>.parametrizations.weight.original0`` (g) + ``original1`` (v).
    weight = g * v / max(||v||, 1e-12), the norm over every axis but 0.

    Computed in numpy with the JAX converter's expression, so that the bits
    match its files (torch sums in another order than numpy's pairwise
    sum). A bfloat16 pair, which numpy cannot hold, is folded in float32
    and rounded back."""
    out: Dict[str, torch.Tensor] = {}
    pairs: Dict[str, Dict[str, torch.Tensor]] = {}
    suffixes = (("weight_g", "g"), ("weight_v", "v"),
                ("parametrizations.weight.original0", "g"),
                ("parametrizations.weight.original1", "v"))
    for k, v in state_dict.items():
        for suffix, role in suffixes:
            if k.endswith(suffix):
                pairs.setdefault(k[: -len(suffix)].rstrip("."), {})[role] = v
                break
        else:
            out[k] = v
    for base, gv in pairs.items():
        if "g" not in gv or "v" not in gv:
            raise ConversionError(f"incomplete weight-norm pair at {base!r}")
        dtype = gv["v"].dtype
        g, v = (t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
                for t in (gv["g"], gv["v"]))
        norm = np.sqrt(np.sum(v ** 2, axis=tuple(range(1, v.ndim)), keepdims=True))
        w = torch.from_numpy(np.ascontiguousarray(g * v / np.maximum(norm, 1e-12)))
        out[(base + ".weight") if base else "weight"] = w.to(dtype)
    return out


# ----------------------------------------------------------------- mapping
def _rename(key: str, rules: Iterable[Tuple[str, str]]) -> str:
    for pattern, repl in rules:
        key = re.sub(pattern, repl, key)
    return key


def flat_key(key: str) -> Tuple[str, str]:
    """The JAX converter's normalized name of a state-dict key
    (``models/convert.py::normalize_torch_key`` there): the module path with
    each index joined to the name before it by ``_``, ``upsampler`` read as
    ``ups``, and the leaf. ``down_blocks.0.resnets.1.conv1.weight`` and
    ``down_blocks_0_resnets_1.conv1.weight`` are both
    ``('down_blocks_0_resnets_1_conv1', 'weight')``."""
    parts = key.split(".")
    merged: list = []
    for p in parts[:-1]:
        p = "ups" if p == "upsampler" else p
        if p.isdigit() and merged:
            merged[-1] += "_" + p
        else:
            merged.append(p)
    return "_".join(merged), parts[-1]


def map_state_dict(module: nn.Module, sd: Dict[str, torch.Tensor], part: str,
                   files: Optional[Dict[str, str]] = None, where: str = "",
                   renames: Sequence[Tuple[str, str]] = (),
                   drops: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """``sd`` renamed onto ``module``'s state-dict keys, with strict
    accounting: a key of the module that no source tensor fills, a source
    tensor that is neither used nor in ``drops``, and a shape that differs
    each raise a ``ConversionError`` naming the key and its file. A source
    key that is not the module's after the renames takes the one module key
    of its ``flat_key`` that no other tensor fills, as the JAX converter
    matches names (so a checkpoint named after the JAX package's Flax
    modules, ``down_blocks_0_attentions_0.norm.bias``, maps too)."""
    files = files or {}
    mapped: Dict[str, torch.Tensor] = {}
    origin: Dict[str, str] = {}
    left = []
    for key, t in sd.items():
        if any(re.fullmatch(p, key) for p in drops):
            continue
        new = _rename(key, renames)
        if new in mapped:
            raise ConversionError(f"{part}: {key!r} and {origin[new]!r} both map to {new!r} "
                                  f"({files.get(key, where)})")
        mapped[new], origin[new] = t, key
    want = module.state_dict()
    flat = {}  # the JAX converter's name rule: normalized path and leaf -> module keys
    for k in want:
        flat.setdefault(flat_key(k), []).append(k)
    for new in list(mapped):
        if new in want:
            continue
        same = [k for k in flat.get(flat_key(new), []) if k not in mapped]
        if len(same) == 1:
            mapped[same[0]], origin[same[0]] = mapped.pop(new), origin.pop(new)
        else:
            left.append(origin[new])
    if left:
        raise ConversionError(
            f"{part}: {len(left)} checkpoint tensor(s) with no parameter in the port's "
            f"{type(module).__name__}: {left[:5]} (first in {files.get(left[0], where)})")
    missing = [k for k in want if k not in mapped]
    if missing:
        raise ConversionError(
            f"{part}: {len(missing)} parameter(s) of the port's {type(module).__name__} "
            f"not in the checkpoint {where}: {missing[:5]}")
    for k, ref in want.items():
        if tuple(mapped[k].shape) != tuple(ref.shape):
            src = origin[k]
            raise ConversionError(
                f"{part}: {src!r} has shape {tuple(mapped[k].shape)}, the port's {k!r} "
                f"takes {tuple(ref.shape)} ({files.get(src, where)})")
    return mapped


def fill(factory: Callable[[], nn.Module], sd: Dict[str, torch.Tensor], part: str,
         files: Optional[Dict[str, str]] = None, where: str = "",
         drops: Optional[Sequence[str]] = None) -> nn.Module:
    """The module of ``factory``, built on ``meta``, holding the tensors of
    ``sd`` (no copy: ``load_state_dict(assign=True)`` keeps each source
    tensor and its dtype), after the part's fold, renames and drops
    (``DROPS[part]`` unless ``drops`` is given)."""
    with torch.device("meta"):
        module = factory()
    if part in FOLDED:
        sd = fold_weight_norm(sd)
    drops = DROPS.get(part, ()) if drops is None else drops
    mapped = map_state_dict(module, sd, part, files, where, RENAMES.get(part, ()), drops)
    module.load_state_dict(mapped, strict=True, assign=True)
    return module


def read_part(src: str, subfolder: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, str], str]:
    """(state dict, key -> file, directory) of ``<src>/<subfolder>``."""
    d = os.path.join(src, subfolder)
    if not os.path.isdir(d):
        raise FileNotFoundError(f"missing checkpoint subfolder: {d}")
    files: Dict[str, str] = {}
    return hf_checkpoint.read_state_dict(d, files), files, d


# ------------------------------------------------------------------ parts
# part -> (checkpoint subfolder, file in weights_dir)
PARTS = {"unet": ("unet", "unet.msgpack"), "vae": ("vae", "vae.msgpack"),
         "vqvae": ("vqvae", "vae.msgpack"), "vocoder": ("vocoder", "vocoder.msgpack"),
         "gpt2": ("language_model", "gpt2.msgpack"),
         "projection_lm": ("projection_model", "projection_lm.msgpack"),
         "dit": ("transformer", "dit.msgpack"), "oobleck": ("vae", "oobleck.msgpack"),
         "projection": ("projection_model", "projection.msgpack")}
# text tower -> (model subfolder, tokenizer subfolder, directory in weights_dir)
TOWERS = {"t5": ("text_encoder", "tokenizer", "t5"),
          "t5_2": ("text_encoder_2", "tokenizer_2", "t5"),
          "clap_text": ("text_encoder", "tokenizer", "clap_text"),
          "clip": ("text_encoder", "tokenizer", "clip")}


def model_parts(spec) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(parts, text towers) of a model spec, in the JAX tool's order."""
    if spec.family == "stable-audio":
        return ("dit", "oobleck", "projection"), ("t5",)
    parts = ["unet", "vqvae" if spec.family == "celebahq" else "vae"]
    if spec.vocoder is not None:
        parts.append("vocoder")
    towers: Tuple[str, ...] = ()
    if spec.family == "audioldm2":
        parts += ["gpt2", "projection_lm"]
        towers = ("t5_2", "clap_text")
    elif spec.family == "audioldm":
        towers = ("clap_text",)
    elif spec.text_encoder == "t5":
        towers = ("t5",)
    elif spec.text_encoder == "clip":
        towers = ("clip",)
    return tuple(parts), towers


def part_factory(spec, part: str) -> Callable[[], nn.Module]:
    """The port module of ``part`` for ``spec``."""
    from .audioldm2_cond import AudioLDM2ProjectionModel, GPT2Model
    from .configs import AudioLDM2ProjectionConfig, GPT2Config
    from .dit1d import StableAudioDiT
    from .hifigan import HifiGanGenerator
    from .oobleck import AutoencoderOobleck
    from .projection import StableAudioProjectionModel
    from .unet2d import UNet2DConditionModel
    from .vae import AutoencoderKL, VQModel

    return {"unet": lambda: UNet2DConditionModel(spec.unet),
            "vae": lambda: AutoencoderKL(spec.vae),
            "vqvae": lambda: VQModel(spec.vae),
            "vocoder": lambda: HifiGanGenerator(spec.vocoder),
            "gpt2": lambda: GPT2Model(spec.gpt2 or GPT2Config()),
            "projection_lm": lambda: AudioLDM2ProjectionModel(spec.projection_lm
                                                              or AudioLDM2ProjectionConfig()),
            "dit": lambda: StableAudioDiT(spec.dit),
            "oobleck": lambda: AutoencoderOobleck(spec.oobleck),
            "projection": lambda: StableAudioProjectionModel(spec.projection)}[part]


def convert_part(spec, part: str, sd: Dict[str, torch.Tensor],
                 files: Optional[Dict[str, str]] = None, where: str = "") -> nn.Module:
    """The port module of ``part`` holding the checkpoint state dict ``sd``."""
    drops = None
    if part == "vocoder" and spec.vocoder.normalize_before:
        drops = ()  # the module holds mean and scale
    return fill(part_factory(spec, part), sd, part, files, where, drops)


# ------------------------------------------------------------ text towers
# transformers' ClapTextConfig defaults, for the keys a config.json omits
CLAP_TEXT_DEFAULTS = {"vocab_size": 50265, "hidden_size": 768, "num_hidden_layers": 12,
                      "num_attention_heads": 12, "intermediate_size": 3072,
                      "hidden_act": "gelu", "max_position_embeddings": 514,
                      "type_vocab_size": 1, "layer_norm_eps": 1e-12, "pad_token_id": 1}
_CLAP_PROJECTION = (("w1", "linear1.weight"), ("b1", "linear1.bias"),
                    ("w2", "linear2.weight"), ("b2", "linear2.bias"))


def roberta_config_of_clap(raw: dict) -> dict:
    """The RoBERTa config.json of a CLAP text tower (``raw``: a
    ``clap_text_model`` config, or a ``clap`` one with its ``text_config``),
    with the fields the JAX tool gives its RobertaConfig."""
    if raw.get("model_type") == "clap":
        raw = raw.get("text_config") or {}
    elif raw.get("model_type") not in (None, "clap_text_model"):
        raise ConversionError(f"CLAP text encoder config has model_type "
                              f"{raw.get('model_type')!r}, not clap or clap_text_model")
    tc = {**CLAP_TEXT_DEFAULTS, **raw}
    return {"model_type": "roberta", "architectures": ["RobertaModel"],
            **{k: tc[k] for k in CLAP_TEXT_DEFAULTS}}


def convert_text_tower(tower: str, src_dir: str, out_dir: str,
                       files: Optional[Dict[str, str]] = None) -> nn.Module:
    """The text model of checkpoint directory ``src_dir`` written to
    ``out_dir`` as transformers' Flax ``save_pretrained`` writes it
    (``save_text_tower``): T5's encoder (``t5``), CLAP's RoBERTa with its
    projection in ``text_projection.npz`` (``clap_text``), CLIP's text
    model (``clip``). Returns the filled model; ``files``, where given,
    gets each source key's file."""
    from .text_encoders import (
        CLIPTextModel,
        RobertaModel,
        T5EncoderModel,
        clip_config,
        roberta_config,
        save_text_tower,
        t5_config,
    )

    raw = hf_checkpoint.read_config(src_dir)
    files = {} if files is None else files
    sd = hf_checkpoint.read_state_dict(src_dir, files)
    part = "t5" if tower.startswith("t5") else tower
    kind = raw.get("model_type")
    if part == "t5":
        if kind != "t5":
            raise ConversionError(f"{src_dir}: model_type {kind!r} is not a T5 encoder")
        if "shared.weight" not in sd and "encoder.embed_tokens.weight" in sd:
            sd["shared.weight"] = sd.pop("encoder.embed_tokens.weight")  # tied
        model = fill(lambda: T5EncoderModel(t5_config(raw)), sd, part, files, src_dir)
        save_text_tower(model, out_dir, raw)
        return model
    if part == "clip":
        if kind != "clip_text_model":
            raise ConversionError(f"{src_dir}: model_type {kind!r} is not a CLIP text model")
        model = fill(lambda: CLIPTextModel(clip_config(raw)), sd, part, files, src_dir)
        save_text_tower(model, out_dir, raw)
        return model
    # CLAP: the JAX tool takes the tower through a float32 torch model
    cfg = roberta_config_of_clap(raw)
    sd = {k: v.float() for k, v in sd.items()}
    proj = {}
    for name, key in _CLAP_PROJECTION:
        key = "text_projection." + key
        if key not in sd:
            raise ConversionError(f"{src_dir}: no {key!r}: not a CLAP text encoder with "
                                  f"its projection")
        proj[name] = sd[key].numpy()
    model = fill(lambda: RobertaModel(roberta_config(cfg)), sd, part, files, src_dir)
    save_text_tower(model, out_dir, cfg)
    np.savez(os.path.join(out_dir, "text_projection.npz"), **proj)
    return model
