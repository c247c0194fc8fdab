"""Seeded weights made on the device in one draw per module.

The rule is the port's seeded init (``random_init_`` of its registry),
which draws leaf by leaf on the host: biases, Snake log-scales and the
vocoder's mean zero; other 1-D params (norm scales, the vocoder's scale)
one; fixed Fourier features N(0, 1); every other weight N(0, 1 / fan_in),
fan-in over every dim but the output one (``ConvTranspose1d`` keeps its
output channels at dim 1). Here the normal draws of a whole module are one
``torch.randn`` on the device, each leaf a 256-byte-aligned slice of it,
scaled in place. The names and shapes come from the reference's modules;
the port's modules load them strictly, so a name or shape that differs
raises.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from . import seeds

_ALIGN = 64  # float32 elements: every leaf starts on 256 bytes (TMA wants 16)


def _leaf_rule(module: nn.Module, name: str, shape) -> tuple:
    """('const', value) or ('randn', scale) for one parameter."""
    leaf = name.rsplit(".", 1)[-1]
    owner = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
    if leaf == "bias" or leaf in ("alpha", "beta"):
        return ("const", 0.0)
    if getattr(owner, "fourier_features", False):
        return ("randn", 1.0)
    if len(shape) == 1:
        return ("const", 0.0 if leaf == "mean" else 1.0)
    n = 1
    for s in shape:
        n *= s
    fan_in = n // (shape[1] if isinstance(owner, nn.ConvTranspose1d) else shape[0])
    return ("randn", fan_in ** -0.5)


@torch.no_grad()
def make_state(module: nn.Module, device, seed: int, name: str) -> Dict[str, torch.Tensor]:
    """float32 weights for ``module`` (built on ``meta``) on ``device``, from
    the run seed and the module's ``name``."""
    rules, total = [], 0
    for pname, p in module.named_parameters():
        rule = _leaf_rule(module, pname, tuple(p.shape))
        off = None
        if rule[0] == "randn":
            off = total
            total += -(-p.numel() // _ALIGN) * _ALIGN
        rules.append((pname, tuple(p.shape), rule, off))
    flat = torch.randn(total, generator=seeds.generator(device, seed, "weights", name),
                       device=device)
    state = {}
    for pname, shape, (kind, val), off in rules:
        if kind == "const":
            state[pname] = torch.full(shape, val, device=device)
        else:
            n = 1
            for s in shape:
                n *= s
            state[pname] = flat[off: off + n].view(shape).mul_(val)
    return state


def rounded_to(state: Dict[str, torch.Tensor], module: nn.Module,
               dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """float32 copies of the values a module in ``dtype`` holds: every leaf
    rounded to ``dtype`` except those its classes keep float32
    (``float32_params``), as the port's ``to_model_dtype_`` keeps them."""
    if dtype == torch.float32:
        return state
    keep = set()
    for mname, m in module.named_modules():
        for p in getattr(m, "float32_params", ()):
            keep.add(f"{mname}.{p}" if mname else p)
    return {k: (v if k in keep else v.to(dtype).float()) for k, v in state.items()}
