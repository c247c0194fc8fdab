"""Carry the JAX package's Flax params over to the port's modules.

The input is a flat ``{flax_path: np.ndarray}`` dict (``flatten_dict`` of a
param tree); the output is a ``state_dict`` for a port module. Names are
matched as ``audioeditingcode_tpu/models/convert.py`` matches them: a torch
key ``down_blocks.0.resnets.1.conv1.weight`` and a Flax path
``(down_blocks_0_resnets_1, conv1, kernel)`` both normalize to
``down_blocks_0_resnets_1_conv1``. Tensors are re-laid-out by the inverse
of that module's rank rules (the dual-stream UNet's transformers,
``attentions.{2j}`` and ``attentions.{2j+1}``, are named as in Flax, so they
need no rule of their own):

  Dense kernel   (in, out)          -> Linear weight (out, in)
                                       (also the linear proj_in / proj_out
                                       of use_linear_projection transformers)
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
  Fourier weight / weights          -> as they are
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

# torch module names that differ from the Flax ones
_ALIASES = {"upsampler": "ups"}
# normalized torch paths that differ from the Flax ones: diffusers'
# Sequential projections of the DiT are linear_1 / linear_2 in Flax
_PATH_RENAMES = (
    (re.compile(r"^(timestep_proj|global_proj|cross_attention_proj)_0$"), r"\1_linear_1"),
    (re.compile(r"^(timestep_proj|global_proj|cross_attention_proj)_2$"), r"\1_linear_2"),
)
# modules whose kernels emulate torch's ConvTranspose1d (flipped taps)
_TRANSPOSE_CONV_MARKERS = ("ups_",)


def normalize_torch_key(key: str) -> Tuple[str, str]:
    """'down_blocks.0.resnets.1.conv1.weight' -> ('down_blocks_0_resnets_1_conv1', 'weight')."""
    parts = key.split(".")
    leaf = parts[-1]
    merged = []
    for p in parts[:-1]:
        p = _ALIASES.get(p, p)
        if p.isdigit() and merged:
            merged[-1] = merged[-1] + "_" + p
        else:
            merged.append(p)
    path = "_".join(merged)
    for pattern, repl in _PATH_RENAMES:
        path = pattern.sub(repl, path)
    return path, leaf


def _flax_index(flat: Mapping[tuple, np.ndarray]) -> Dict[str, Dict[str, np.ndarray]]:
    """normalized module path -> {flax leaf name: array}, 'params' root dropped."""
    index: Dict[str, Dict[str, np.ndarray]] = {}
    for path, val in flat.items():
        if path and path[0] == "params":
            path = path[1:]
        index.setdefault("_".join(path[:-1]), {})[path[-1]] = np.asarray(val)
    return index


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


def flax_to_torch_state_dict(flat: Mapping[tuple, np.ndarray],
                             module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The state_dict for ``module`` from Flax params. Every entry of the
    module's state_dict must be found, with the shape the module expects,
    and every Flax leaf must be used."""
    index = _flax_index(flat)
    used = set()
    out: Dict[str, torch.Tensor] = {}
    for key, ref in module.state_dict().items():
        norm, leaf = normalize_torch_key(key)
        entry = index.get(norm)
        if entry is None:
            raise KeyError(f"no Flax params for {key} (module path {norm!r})")
        if leaf == "weight":
            name = next((n for n in ("kernel", "scale") if n in entry), "weight")
        else:
            name = leaf
        if name not in entry:
            raise KeyError(f"no Flax leaf {name!r} for {key} (has {sorted(entry)})")
        a = entry[name]
        if name == "kernel" and a.ndim == 2 and ref.dim() == 3:
            a = a.T[:, :, None]  # Dense kernel -> Conv1d(k=1)
        elif name == "kernel":
            a = flax_to_torch_tensor(
                a, any(m in norm for m in _TRANSPOSE_CONV_MARKERS))
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
