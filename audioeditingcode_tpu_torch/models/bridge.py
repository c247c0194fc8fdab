"""Carry Flax params over to the port's modules, and back.

The input of :func:`flax_to_torch_state_dict` is a flat ``{flax_path:
array}`` dict (``flatten_dict`` of a param tree, or :func:`flax_msgpack.flatten`
of a converted file); the output is a ``state_dict`` for a port module.
:func:`torch_to_flax_tree` is its inverse: it writes a module's weights in
the Flax nesting, so that the JAX package can read them.

Two nestings are met. The JAX package's own modules (``nesting="jax"``)
name a level by the torch path down to it with ``_`` between the parts:
``down_blocks.0.attentions.1.transformer_blocks.0.ff.net.0.proj.weight``
is ``(down_blocks_0_attentions_1, transformer_blocks_0, ff, net_0_proj,
kernel)``. A torch module opens a level unless it is a ``ModuleList``, a
``Sequential`` other than ``_SCOPED_SEQUENTIALS``, or a class of
``_FLAT_CLASSES``, which only add their name to the levels below them.
transformers' Flax models (``nesting="transformers"``: the ``t5/`` and
``clap_text/`` directories) make every part a level. Names are matched on
both sides joined by ``_``, so the reader does not depend on the nesting.

Leaf names follow the module that owns the param: a dense or conv kernel
is ``kernel``, a LayerNorm/GroupNorm weight ``scale``, an embedding table
``embedding`` (in the JAX nesting a bare leaf named after the module, as
GPT-2's ``wpe``), anything else keeps its torch name. Tensors are re-laid
out by the inverse of the rank rules of
``audioeditingcode_tpu/models/convert.py``:

  Dense kernel   (in, out)          -> Linear weight (out, in)
                                       (GPT-2's Conv1D keeps (in, out))
  Dense kernel   (in, out)          -> Conv1d(k=1) weight (out, in, 1)
                                       (the DiT's pre/post convs)
  Conv kernel    (kh, kw, in, out)  -> Conv2d weight (out, in, kh, kw)
  Conv1d kernel  (k, in, out)       -> Conv1d weight (out, in, k)
  ConvTranspose(transpose_kernel=True) kernel (k, out, in)
                                    -> ConvTranspose1d (in, out, k), no flip
                                       (Oobleck's conv_t1: the same transpose)
  HiFi-GAN ups_  (k, in, out), taps flipped -> ConvTranspose1d (in, out, k)
  norm scale                        -> weight
  Snake alpha/beta (1, 1, C)        -> (1, C, 1)
  Fourier weight / weights, embeddings -> as they are
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from .flax_msgpack import unflatten

# Flax levels that differ from the torch path: diffusers' Sequential
# projections of the DiT are linear_1 / linear_2 in Flax, and GPT-2's
# attention and MLP are no levels of their own
_LEVEL_RENAMES = (
    (re.compile(r"^(timestep_proj|global_proj|cross_attention_proj)/0$"), r"\1/linear_1"),
    (re.compile(r"^(timestep_proj|global_proj|cross_attention_proj)/2$"), r"\1/linear_2"),
    (re.compile(r"^(h_\d+)/attn_(c_attn|c_proj)$"), r"\1/\2"),
    (re.compile(r"^(h_\d+)/mlp_c_fc$"), r"\1/c_fc"),
)
# modules whose kernels emulate torch's ConvTranspose1d (flipped taps)
_TRANSPOSE_CONV_MARKERS = ("ups_",)
# port classes that open no level of their own in the JAX nesting
_FLAT_CLASSES = frozenset({"_Block", "_GEGLU", "_SwiGLUProj", "_Conv",
                           "GPT2Attention", "GPT2MLP"})
# Sequentials that are a level of their own in the JAX nesting
_SCOPED_SEQUENTIALS = frozenset({"timestep_proj", "global_proj", "cross_attention_proj",
                                 "text_projection"})
# Conv1d(k=1) modules that are Dense layers in Flax
_DENSE_CONV1D = frozenset({"preprocess_conv", "postprocess_conv"})
_KERNEL_OWNERS = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d)


def _is_flat(mod: nn.Module, name: str) -> bool:
    if isinstance(mod, nn.Sequential):
        return name not in _SCOPED_SEQUENTIALS
    return isinstance(mod, nn.ModuleList) or type(mod).__name__ in _FLAT_CLASSES


def flax_location(module: nn.Module, key: str, nesting: str = "jax"
                  ) -> Tuple[Tuple[str, ...], str, nn.Module]:
    """(Flax levels, Flax leaf name, owning torch module) of a state_dict key."""
    parts = key.split(".")
    owner = module.get_submodule(".".join(parts[:-1])) if len(parts) > 1 else module
    leaf = parts[-1]
    if nesting == "transformers":
        levels = list(parts[:-1])
    elif nesting == "jax":
        levels, pending, cur = [], [], module
        for p in parts[:-1]:
            cur = cur[int(p)] if p.isdigit() else getattr(cur, p)
            pending.append(p)
            if not _is_flat(cur, p):
                levels.append("_".join(pending))
                pending = []
        if pending:
            levels.append("_".join(pending))
        path = "/".join(levels)
        for pattern, repl in _LEVEL_RENAMES:
            path = pattern.sub(repl, path)
        levels = path.split("/") if path else []
        if isinstance(owner, nn.Embedding):  # a bare param named after its module
            return tuple(levels[:-1]), levels[-1], owner
    else:
        raise ValueError(f"unknown nesting {nesting!r}")
    if leaf == "weight":
        if isinstance(owner, _KERNEL_OWNERS) or getattr(owner, "kernel_in_out", False):
            leaf = "kernel"
        elif isinstance(owner, (nn.LayerNorm, nn.GroupNorm)):
            leaf = "scale"
        elif isinstance(owner, nn.Embedding):
            leaf = "embedding"
    return tuple(levels), leaf, owner


def _is_transpose_conv(levels: Tuple[str, ...]) -> bool:
    return any(m in "_".join(levels) for m in _TRANSPOSE_CONV_MARKERS)


def _is_dense_conv1d(owner: nn.Module, levels: Tuple[str, ...]) -> bool:
    return isinstance(owner, nn.Conv1d) and bool(levels) and levels[-1] in _DENSE_CONV1D


def flax_to_torch_tensor(a: np.ndarray, transpose_conv: bool) -> np.ndarray:
    """Re-lay a Flax kernel out in torch order (see the module docstring)."""
    if a.ndim == 2:
        return a.T
    if a.ndim == 3:
        if transpose_conv:
            return a.transpose(1, 2, 0)[:, :, ::-1]
        return a.transpose(2, 1, 0)
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    return a


def torch_to_flax_tensor(t: torch.Tensor, transpose_conv: bool) -> torch.Tensor:
    """The inverse of :func:`flax_to_torch_tensor`."""
    if t.dim() == 2:
        return t.t()
    if t.dim() == 3:
        if transpose_conv:
            return t.flip(2).permute(2, 0, 1)
        return t.permute(2, 1, 0)
    if t.dim() == 4:
        return t.permute(2, 3, 1, 0)
    return t


def _flax_index(flat: Mapping[tuple, Any]) -> Dict[str, Dict[str, np.ndarray]]:
    """normalized module path -> {flax leaf name: array}, 'params' root
    dropped; bfloat16 leaves widened to float32 (exactly)."""
    index: Dict[str, Dict[str, np.ndarray]] = {}
    for path, val in flat.items():
        if path and path[0] == "params":
            path = path[1:]
        if isinstance(val, torch.Tensor):
            val = val.float().numpy()
        index.setdefault("_".join(path[:-1]), {})[path[-1]] = np.asarray(val)
    return index


def flax_to_torch_state_dict(flat: Mapping[tuple, Any], module: nn.Module,
                             nesting: str = "jax") -> Dict[str, torch.Tensor]:
    """The state_dict for ``module`` from Flax params. Every entry of the
    module's state_dict must be found, with the shape the module expects,
    and every Flax leaf must be used."""
    index = _flax_index(flat)
    used = set()
    out: Dict[str, torch.Tensor] = {}
    for key, ref in module.state_dict().items():
        levels, name, owner = flax_location(module, key, nesting)
        norm = "_".join(levels)
        entry = index.get(norm)
        if entry is None:
            raise KeyError(f"no Flax params for {key} (module path {norm!r})")
        if name not in entry:
            raise KeyError(f"no Flax leaf {name!r} for {key} (has {sorted(entry)})")
        a = entry[name]
        if name == "kernel" and getattr(owner, "kernel_in_out", False):
            pass  # GPT-2's Conv1D: (in, out) on both sides
        elif name == "kernel" and a.ndim == 2 and ref.dim() == 3:
            a = a.T[:, :, None]  # Dense kernel -> Conv1d(k=1)
        elif name == "kernel":
            a = flax_to_torch_tensor(a, _is_transpose_conv(levels))
        elif name in ("alpha", "beta") and a.ndim == 3:
            a = a.transpose(0, 2, 1)  # Snake (1, 1, C) -> (1, C, 1)
        if tuple(a.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch for {key}: {a.shape} vs {tuple(ref.shape)}")
        out[key] = torch.from_numpy(np.array(a, order="C")).to(ref.dtype)
        used.add((norm, name))
    unused = [f"{n}/{leaf}" for n, e in index.items() for leaf in e if (n, leaf) not in used]
    if unused:
        raise KeyError(f"Flax params with no torch target: {unused[:10]}")
    return out


def torch_to_flax_tree(module: nn.Module, nesting: str = "jax",
                       root: str = "params") -> dict:
    """``module``'s weights as a nested Flax param dict (numpy leaves;
    bfloat16 leaves stay torch tensors), under ``root`` unless it is empty
    (transformers' Flax files have no root)."""
    flat = {}
    for key, t in module.state_dict().items():
        levels, name, owner = flax_location(module, key, nesting)
        t = t.detach().cpu()
        if name == "kernel" and getattr(owner, "kernel_in_out", False):
            pass
        elif name == "kernel" and _is_dense_conv1d(owner, levels):
            t = t[:, :, 0].t()
        elif name == "kernel":
            t = torch_to_flax_tensor(t, _is_transpose_conv(levels))
        elif name in ("alpha", "beta") and t.dim() == 3:
            t = t.permute(0, 2, 1)
        t = t.contiguous()
        flat[levels + (name,)] = t if t.dtype == torch.bfloat16 else t.numpy()
    tree = unflatten(flat)
    return {root: tree} if root else tree


def clap_state_dict_from_jax(audio: Mapping[str, Any], text: Mapping[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """The state dict of ``models/clap_audio.py::ClapModel`` from the JAX
    package's CLAP param trees (``params_from_torch_clap`` and
    ``text_params_from_torch_clap``). Their arrays are in torch layouts
    already, under other names. The trees hold no index buffers and no
    logit scales; ``clap_audio.load_clap_weights`` takes the model's own
    for those."""
    sd: Dict[str, torch.Tensor] = {}

    def put(prefix: str, tree: Mapping[str, Any]) -> None:
        for k, v in tree.items():
            sd[f"{prefix}.{k}"] = torch.tensor(np.asarray(v))

    enc = "audio_model.audio_encoder"
    put(f"{enc}.batch_norm", audio["batch_norm"])
    put(f"{enc}.patch_embed.proj", audio["patch_embed"]["proj"])
    put(f"{enc}.patch_embed.norm", audio["patch_embed"]["norm"])
    put(f"{enc}.norm", audio["norm"])
    for i, stage in enumerate(audio["layers"]):
        for j, block in enumerate(stage["blocks"]):
            p = f"{enc}.layers.{i}.blocks.{j}"
            attn = block["attn"]
            for name in ("layernorm_before", "layernorm_after"):
                put(f"{p}.{name}", block[name])
            for name in ("query", "key", "value"):
                put(f"{p}.attention.self.{name}", attn[name])
            put(f"{p}.attention.self", {"relative_position_bias_table":
                                        attn["relative_position_bias_table"]})
            put(f"{p}.attention.output.dense", attn["output"])
            put(f"{p}.intermediate.dense", block["intermediate"])
            put(f"{p}.output.dense", block["output"])
        if "downsample" in stage:
            put(f"{enc}.layers.{i}.downsample.norm", stage["downsample"]["norm"])
            put(f"{enc}.layers.{i}.downsample.reduction", stage["downsample"]["reduction"])
    for name in ("linear1", "linear2"):
        put(f"audio_projection.{name}", audio["projection"][name])
        put(f"text_projection.{name}", text["projection"][name])
    emb = text["embeddings"]
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        put(f"text_model.embeddings.{name}", {"weight": emb[name]})
    put("text_model.embeddings.LayerNorm", emb["LayerNorm"])
    put("text_model.pooler.dense", text["pooler"])
    layer_names = {"query": "attention.self.query", "key": "attention.self.key",
                   "value": "attention.self.value", "attn_out": "attention.output.dense",
                   "attn_ln": "attention.output.LayerNorm", "intermediate": "intermediate.dense",
                   "output": "output.dense", "out_ln": "output.LayerNorm"}
    for i, layer in enumerate(text["layers"]):
        for src, dst in layer_names.items():
            put(f"text_model.encoder.layer.{i}.{dst}", layer[src])
    return sd
