"""The reference's arithmetic precision: float32 (the reference itself), or
the emulated precisions of the controls, one step below a configuration's:

- ``tf32``: every product's operands rounded to TF32 (10 mantissa bits, to
  nearest), the control of a float32 configuration (TF32 off);
- ``fp8``: every product's operands rounded to float8 e4m3 with one scale
  per tensor (its largest magnitude to 448), the control of a bfloat16
  configuration.

Rounding happens at the inputs of every Linear and convolution (weights
rounded once by :func:`apply`, activations by a forward pre-hook) and at the
operands of the attention products and the fused SwiGLU
(``ops/flash_attention.py``, ``ops/swiglu.py``). The products themselves
run in float32, as the hardware's accumulate. The emulation runs alike on
the CPU and on the card.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

MODE = "f32"
MODES = ("f32", "tf32", "fp8")
_FP8_MAX = 448.0


def set_mode(mode: str) -> None:
    global MODE
    if mode not in MODES:
        raise ValueError(f"precision {mode!r}: one of {MODES}")
    MODE = mode


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to the nearest TF32 value (ties away from zero)."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor, amax: Optional[float] = None) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale (``amax``: the
    largest magnitude of the whole tensor that x is a block of)."""
    x = x.float()
    top = x.abs().amax() if amax is None else torch.tensor(amax, device=x.device)
    scale = top.clamp_min(1e-30) / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def q(x: torch.Tensor, amax: Optional[float] = None) -> torch.Tensor:
    """x in the current mode's operand precision (float32: unchanged)."""
    if MODE == "f32":
        return x
    return round_tf32(x) if MODE == "tf32" else round_fp8(x, amax)


_PRODUCT_MODULES = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d)


@torch.no_grad()
def apply(module: nn.Module) -> nn.Module:
    """Round the weights of every product layer of ``module`` once and hook
    its inputs, for the current mode; a no-op in float32."""
    if MODE == "f32":
        return module
    for m in module.modules():
        if isinstance(m, _PRODUCT_MODULES):
            m.weight.copy_(q(m.weight))
            m.register_forward_pre_hook(lambda _m, args: (q(args[0]),) + tuple(args[1:]))
    return module
