"""Fused SwiGLU projection with a hand-written CUDA kernel for Hopper.

Counterpart of ``audioeditingcode_tpu/ops/swiglu.py``. The Stable Audio
DiT's feed-forward is ``net.2(h * silu(gate))`` with ``[h | gate] = x W^T +
b``, W the (2N, E) weight of ``ff.net.0.proj`` (torch Linear layout: value
half rows [0, N), gate half rows [N, 2N)).

- ``swiglu_cuda`` (B3), which replaces the Pallas ``swiglu._kernel``: both
  halves in one pass, f32 accumulation and epilogue, one rounding on
  output; the (M, 2N) intermediate never reaches device memory.
  ``swiglu_route`` picks the kernel: bfloat16 goes to the bf16 tensor-core
  kernel (``csrc/swiglu_tc.cu``: TMA, mbarriers, wgmma), float32 to the
  3xTF32 one (``csrc/swiglu.cu``: TMA, operands split once per stage into
  TF32 hi and lo parts, three tf32 wgmma products, held to ``F32_TOL``).
  Each launch adds one to ``swiglu_cuda.launches`` and to its route's entry
  of ``swiglu_cuda.launches_by_route``.
- ``swiglu_reference``: the kernel's plain PyTorch version, with the Pallas
  kernel's rounding (bias added in f32, SiLU in f32, one cast). CPU tensors
  take it; on the card it is only a yardstick.
- ``fused_swiglu``: the dispatcher, with the JAX eligibility rule (E and N
  multiples of 128, at least 512 rows, the ``AEC_FUSED_SWIGLU`` kill
  switch). Eligible calls launch the kernel on a CUDA tensor (no fallback)
  and take the plain version on a CPU tensor; the rest take JAX's
  ``_reference`` expression (bias added in the input dtype).
"""

from __future__ import annotations

import ctypes
import os

import torch
from torch.nn import functional as F

# kernel pays off only when the (M, 2N) intermediate it removes is large
# (the JAX dispatcher's threshold, swiglu.py:42)
_MIN_ROWS_FOR_KERNEL = 512

_FNS = {}

TENSOR_CORE = "tensor_core"
TF32X3 = "tf32x3"

# How far a bfloat16 kernel output may lie from swiglu_reference: two bf16
# ulps (the sums in the tensor cores' order, one rounding of the output),
# 4e-3 near zero. A kernel that skipped one 64-feature slice of E lies
# outside it (tests/test_torch_swiglu.py).
BF16_TOL = {"atol": 4e-3, "rtol": 2.0 ** -6}
# How far a float32 kernel output may lie from swiglu_reference: 1e-5 +
# 1e-5 |ref|. 3xTF32 products summed in fresh accumulators every 32
# features lie well inside it; one TF32 product, or one truncating
# tensor-core sum over all of E, outside it (tests/test_torch_swiglu.py).
F32_TOL = {"atol": 1e-5, "rtol": 1e-5}


def swiglu_route(dtype: torch.dtype) -> str:
    """The kernel a CUDA launch takes: bfloat16 runs on the tensor cores in
    bf16, float32 on the tensor cores in 3xTF32."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the SwiGLU kernels take float32 or bfloat16, got {dtype}")
    return TENSOR_CORE if dtype == torch.bfloat16 else TF32X3


def _kernel_fn(route: str):
    fn = _FNS.get(route)
    if fn is None:
        from .build import load

        if route == TENSOR_CORE:
            fn = load("swiglu_tc").aec_swiglu_tc_fwd
        else:
            fn = load("swiglu").aec_swiglu_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        _FNS[route] = fn
    return fn


def swiglu_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on x (M, E), weight (2N, E), bias (2N,) ->
    (M, N). Raises on what it does not take; never falls back."""
    if not (x.is_cuda and weight.is_cuda and bias.is_cuda):
        raise ValueError("swiglu_cuda takes CUDA tensors")
    if not (x.device == weight.device == bias.device):
        raise ValueError("x, weight and bias must be on one device")
    if x.dtype not in (torch.float32, torch.bfloat16) or weight.dtype != x.dtype:
        raise ValueError(f"swiglu_cuda takes float32 or bfloat16 x and weight of "
                         f"one dtype, got {x.dtype}/{weight.dtype}")
    if x.dim() != 2 or weight.dim() != 2 or weight.shape[1] != x.shape[1]:
        raise ValueError(f"expected x (M, E) and weight (2N, E), got "
                         f"{tuple(x.shape)}, {tuple(weight.shape)}")
    M, E = x.shape
    N = weight.shape[0] // 2
    if weight.shape[0] % 2 or bias.shape != (2 * N,):
        raise ValueError(f"weight rows {weight.shape[0]} and bias {tuple(bias.shape)} "
                         f"must be 2N and (2N,)")
    if E % 16 or N % 64:
        raise ValueError(f"(E, N) = ({E}, {N}): the kernel takes E a multiple of 16 "
                         f"and N a multiple of 64")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("x and weight must be contiguous")
    if x.data_ptr() % 16 or weight.data_ptr() % 16:
        raise ValueError("x and weight must be 16-byte aligned")
    route = swiglu_route(x.dtype)
    bias = bias.float().contiguous()
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel_fn(route)(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                           out.data_ptr(), M, E, N, stream)
    if rc != 0:
        raise RuntimeError(f"swiglu kernel ({route}) launch failed: CUDA error {rc}")
    swiglu_cuda.launches += 1
    swiglu_cuda.launches_by_route[route] += 1
    return out


swiglu_cuda.launches = 0
swiglu_cuda.launches_by_route = {TENSOR_CORE: 0, TF32X3: 0}


def swiglu_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel (and of the Pallas ``_kernel``): products
    summed in f32, bias added in f32, ``a * (g * sigmoid(g))`` in f32, one
    cast to x's dtype."""
    N = weight.shape[0] // 2
    h = torch.matmul(x.float(), weight.float().t())
    a = h[..., :N] + bias[:N].float()
    g = h[..., N:] + bias[N:].float()
    return (a * (g * torch.sigmoid(g))).to(x.dtype)


def _plain_swiglu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """JAX ``_reference``: the projection in x's dtype with the bias cast to
    it, then ``h * silu(gate)``."""
    h, gate = (F.linear(x, weight) + bias.to(x.dtype)).chunk(2, dim=-1)
    return h * F.silu(gate)


def kernel_eligible(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """The JAX dispatcher's rule (swiglu.py:169-175)."""
    e, n2 = x.shape[-1], weight.shape[0]
    return (e % 128 == 0 and n2 % 2 == 0 and (n2 // 2) % 128 == 0
            and x.numel() // max(e, 1) >= _MIN_ROWS_FOR_KERNEL
            and os.environ.get("AEC_FUSED_SWIGLU", "1") == "1")


def fused_swiglu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``(x W[:N]^T + b[:N]) * silu(x W[N:]^T + b[N:])`` for x (..., E),
    weight (2N, E), bias (2N,)."""
    if not kernel_eligible(x, weight):
        return _plain_swiglu(x, weight, bias)
    x2d = x.reshape(-1, x.shape[-1])
    if x.is_cuda:
        out = swiglu_cuda(x2d.contiguous(), weight, bias)
    else:
        out = swiglu_reference(x2d, weight, bias)
    return out.reshape(x.shape[:-1] + (weight.shape[0] // 2,))
