"""Self-attention dispatcher with a hand-written CUDA kernel for Hopper.

Counterpart of ``audioeditingcode_tpu/ops/flash_attention.py``. Layouts are
the JAX package's: q is (B, Sq, H, D), k and v are (B, Skv, H_kv, D).

- ``flash_attention_cuda`` (B1), which replaces the Pallas ``_attn_kernel``.
  It streams K/V tiles through shared memory with an online softmax instead
  of keeping a whole head in fast memory. ``attention_route`` picks the
  kernel: bfloat16 goes to the tensor-core kernel
  (``csrc/flash_attention_tc.cu``: TMA, mbarriers, wgmma), float32 to the
  3xTF32 kernel (``csrc/flash_attention.cu``: each product as three TF32
  ``mma.sync`` products of split operands on the tensor cores, which keeps
  float32 accuracy; K/V tiles by double-buffered ``cp.async``). Both take
  every head dim up to 256, as the Pallas kernel does: the float32 kernel
  zero-fills the features past D in shared memory; the tensor-core kernel's
  TMA loads need rows of whole 16 bytes, so a bfloat16 D that is not a
  multiple of 8 is zero-padded on the device to the next one (a copy of q,
  k and v, counted in ``pad_copies``) and the output sliced back. Each
  launch adds one to ``flash_attention_cuda.launches`` and to its route's
  entry of ``flash_attention_cuda.launches_by_route``.
- ``flash_attention_rotary_cuda`` (B2): B1 with a partial rotate-half
  rotary applied to q and k inside the kernel, which replaces the Pallas
  ``_attn_rotary_kernel``. The routes are B1's: bfloat16 runs the ROT
  variant of the tensor-core kernel, which rotates each K tile in shared
  memory after TMA lands it; float32 the ROT variant of the 3xTF32 kernel,
  which does the same after ``cp.async`` lands it. Its launches count in
  ``flash_attention_rotary_cuda.launches`` and ``.launches_by_route``.
- ``attention_reference`` and ``rotary_attention_reference``: the kernels'
  plain PyTorch versions, with the same roundings (the rotated q/k to the
  input dtype, q*scale back to the input dtype, p to v's dtype before PV).
  CPU tensors take them; on the card they are only yardsticks.
- ``fused_attention``: the dispatcher. Eligible calls go to a kernel on a
  CUDA tensor (no fallback) and to its plain version on a CPU tensor; other
  calls take plain matmul + f32 softmax. A ``rotary`` (cos, sin) pair is
  applied on the host (``_host_rotary``) before B1, or inside B2 with
  ``AEC_ROTARY_IN_KERNEL=1``, as the JAX dispatcher does.
- ``sp_mesh_scope`` and ``_sp_blocked_attention``: sequence-parallel
  self-attention. Under a scope whose mesh has an sp axis, a call that
  passes ``kv_len`` holds this rank's rows of a sequence padded to a
  multiple of 8 sp (``models/dit1d.py`` splits it so): K/V are all-gathered
  over the sp group, the rotary applied on the host first, at the rows'
  global positions, and the local query rows attend to the whole with the
  padded keys masked (B1 with ``kv_len`` on the card).
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import os
from typing import Optional, Tuple

import torch

# the JAX dispatcher's threshold (flash_attention.py:36): below it the
# plain path is used on every device
_MIN_SEQ_FOR_KERNEL = 1024
# the widest head dim of the JAX dispatcher's kernel rule, which both
# kernels and B2 take whole
MAX_KERNEL_HEAD_DIM = 256

_DTYPES = (torch.float32, torch.bfloat16)
_FNS = {}

TENSOR_CORE = "tensor_core"
TF32X3 = "tf32x3"

# How far a bfloat16 kernel output may lie from attention_reference: two
# bf16 ulps (p rounded at the running rather than the final max, the sums
# in another order, one rounding of o), 4e-3 near zero. A kernel that left
# the zero-filled keys of its last tile in the softmax lies outside it
# (tests/test_torch_flash_attention.py).
BF16_TOL = {"atol": 4e-3, "rtol": 2.0 ** -6}
# How far a float32 kernel output may lie from attention_reference: 1e-5 +
# 1e-5 |ref|. Products in 3xTF32 (hi·hi + hi·lo + lo·hi of operands split
# into TF32 parts) lie well inside it, a single TF32 product outside it
# (tests/test_torch_flash_attention.py).
F32_TOL = {"atol": 1e-5, "rtol": 1e-5}


def attention_route(dtype: torch.dtype, rotary: bool = False) -> str:
    """The kernel a CUDA launch of B1, or of B2 with ``rotary``, takes:
    bfloat16 runs on the tensor cores in bf16, float32 on the tensor cores
    in 3xTF32."""
    if dtype not in _DTYPES:
        raise ValueError(f"the attention kernels take float32 or bfloat16, got {dtype}")
    return TENSOR_CORE if dtype == torch.bfloat16 else TF32X3


def _kernel_fn(route: str, rotary: bool = False):
    """The C entry point of B1 on ``route``, or of B2 with ``rotary``
    (built at first use)."""
    fn = _FNS.get((route, rotary))
    if fn is None:
        from .build import load

        tc = "_tc" if route == TENSOR_CORE else ""
        fn = getattr(load("flash_attention" + tc),
                     "aec_flash_attention" + ("_rotary" if rotary else "") + tc + "_fwd")
        # q, k, v, o (+ cos, sin, rot), B, H, H_kv, Sq, kv_len, D
        head = ([ctypes.c_void_p] * 6 + [ctypes.c_int] if rotary else [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        fn.argtypes = (head + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_longlong] * 12
                       + [ctypes.c_void_p])
        _FNS[(route, rotary)] = fn
    return fn


def _check_tma_args(*tensors) -> None:
    """What the tensor-core kernels' TMA loads take: 16-byte aligned bases
    and strides that are multiples of 16 bytes (8 bfloat16)."""
    for x in tensors:
        if x.data_ptr() % 16:
            raise ValueError("the tensor-core attention kernel takes 16-byte aligned "
                             "q, k and v (TMA)")
        if any(st % 8 for st in x.stride()[:3]):
            raise ValueError(f"the tensor-core attention kernel takes strides that are "
                             f"multiples of 8 elements (TMA), got {tuple(x.stride())}")


def _check_kernel_args(q, k, v):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda takes CUDA tensors")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention_cuda takes float32 or bfloat16 "
                         f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected (B, S, H, D) tensors, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    if not 1 <= D <= MAX_KERNEL_HEAD_DIM:
        raise ValueError(f"head dim {D}: the kernels take head dims up to "
                         f"{MAX_KERNEL_HEAD_DIM}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the head dim of q, k and v must be contiguous")


def pad_head_dim(x: torch.Tensor, width: int) -> torch.Tensor:
    """x with its head dim zero-padded to ``width``: the zero features add
    nothing to q k^T and give zero output columns."""
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def _tc_padded(route: str, q, k, v):
    """(q, k, v, D) as the kernel on ``route`` takes them: a tensor-core
    launch at a head dim D that is not a multiple of 8 gets copies of q, k
    and v zero-padded to the next one (TMA takes rows of whole 16 bytes)."""
    D = q.shape[3]
    if route != TENSOR_CORE or D % 8 == 0:
        return q, k, v, D
    width = -(-D // 8) * 8
    return pad_head_dim(q, width), pad_head_dim(k, width), pad_head_dim(v, width), D


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernel on (B, Sq, H, D) x (B, Skv, H_kv, D), D <= 256;
    keys at index >= ``kv_len`` (default Skv) are masked. Raises on what it
    does not take; never falls back."""
    _check_kernel_args(q, k, v)
    B, Sq, H, D = q.shape
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= k.shape[1]:
        raise ValueError(f"kv_len {kv_len} outside 1..{k.shape[1]}")
    route = attention_route(q.dtype)
    q, k, v, D = _tc_padded(route, q, k, v)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    if route == TENSOR_CORE:
        _check_tma_args(q, k, v, o)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel_fn(route)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, H, k.shape[2], Sq, kv_len, q.shape[3], 1.0 / (D ** 0.5),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel ({route}) launch failed: "
                           f"CUDA error {rc}")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_by_route[route] += 1
    if q.shape[3] != D:
        flash_attention_cuda.pad_copies += 1
        o = o[..., :D].contiguous()
    return o


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_route = {TENSOR_CORE: 0, TF32X3: 0}
flash_attention_cuda.pad_copies = 0


def _check_rotary_tables(q, cos, sin) -> Tuple[torch.Tensor, torch.Tensor]:
    rot = cos.shape[-1]
    if cos.shape != sin.shape or cos.dim() != 2:
        raise ValueError(f"cos/sin must be two (S, rot) tables, got "
                         f"{tuple(cos.shape)}, {tuple(sin.shape)}")
    if rot < 2 or rot % 2 or rot > q.shape[3]:
        raise ValueError(f"rotary width {rot}: must be even and at most the head dim "
                         f"{q.shape[3]}")
    if cos.shape[0] < q.shape[1]:
        raise ValueError(f"rotary tables cover {cos.shape[0]} positions, the "
                         f"sequence has {q.shape[1]}")
    if cos.device != q.device or sin.device != q.device:
        raise ValueError("rotary tables must be on the device of q")
    return cos.float().contiguous(), sin.float().contiguous()


def flash_attention_rotary_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Launch the rotary kernel B2 on (B, S, H, D) x (B, S, H_kv, D) square
    self-attention, with (>= S, rot) cos/sin tables, on the route of
    ``attention_route(dtype, rotary=True)``, D <= 256 and any even rotary
    width up to D. Raises on what it does not take; never falls back."""
    _check_kernel_args(q, k, v)
    if q.shape[1] != k.shape[1]:
        raise ValueError(f"in-kernel rotary takes square self-attention, got "
                         f"{q.shape[1]} queries and {k.shape[1]} keys")
    cos, sin = _check_rotary_tables(q, cos, sin)
    B, S, H, _ = q.shape
    route = attention_route(q.dtype, rotary=True)
    q, k, v, D = _tc_padded(route, q, k, v)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    if route == TENSOR_CORE:
        _check_tma_args(q, k, v, o)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel_fn(route, rotary=True)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), cos.shape[-1],
        B, H, k.shape[2], S, S, q.shape[3], 1.0 / (D ** 0.5),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention_rotary kernel ({route}) launch failed: "
                           f"CUDA error {rc}")
    flash_attention_rotary_cuda.launches += 1
    flash_attention_rotary_cuda.launches_by_route[route] += 1
    if q.shape[3] != D:
        flash_attention_rotary_cuda.pad_copies += 1
        o = o[..., :D].contiguous()
    return o


flash_attention_rotary_cuda.launches = 0
flash_attention_rotary_cuda.launches_by_route = {TENSOR_CORE: 0, TF32X3: 0}
flash_attention_rotary_cuda.pad_copies = 0


def _repeat_kv(x: torch.Tensor, heads: int) -> torch.Tensor:
    rep = heads // x.shape[2]
    return x if rep == 1 else x.repeat_interleave(rep, dim=2)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of the kernel (and of the Pallas ``_attn_core``): q is
    scaled in f32 (by ``scale``, default 1/sqrt(D)) and rounded to its
    dtype, scores and softmax are f32, and p is rounded to v's dtype before
    the PV product."""
    B, Sq, H, D = q.shape
    scale = 1.0 / (D ** 0.5) if scale is None else scale
    qs = (q.float() * scale).to(q.dtype).float().transpose(1, 2)  # (B, H, Sq, D)
    kt = _repeat_kv(k, H).float().transpose(1, 2)
    vt = _repeat_kv(v, H).transpose(1, 2)
    s = torch.matmul(qs, kt.transpose(-1, -2))  # (B, H, Sq, Skv) f32
    if kv_len is not None and kv_len < s.shape[-1]:
        s[..., kv_len:] = -1e30
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), vt.float())
    return (o / denom).to(q.dtype).transpose(1, 2)


def _host_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) partial rotate-half rotary on the first rot = cos.shape[-1]
    features, in f32 from (S, rot) tables, rounded back to x's dtype."""
    rot = cos.shape[-1]
    xr = x[..., :rot].float()
    half = rot // 2
    rh = torch.cat([-xr[..., half:], xr[..., :half]], dim=-1)
    out = xr * cos[:, None].float() + rh * sin[:, None].float()
    return torch.cat([out.to(x.dtype), x[..., rot:]], dim=-1)


def rotary_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Plain version of B2 (and of the Pallas ``_attn_rotary_kernel``): the
    host rotary of q and k, then the plain version of B1."""
    S = q.shape[1]
    return attention_reference(_host_rotary(q, cos[:S], sin[:S]),
                               _host_rotary(k, cos[:S], sin[:S]), v)


def _plain_attention(q, k, v, bias=None):
    """The dispatcher's path for calls the kernel does not take (masked or
    cross attention, short sequences): f32 logits scaled after the QK
    product, additive bias, f32 softmax, probabilities in v's dtype — the
    semantics of ``jax.nn.dot_product_attention`` that the JAX dispatcher
    falls back to."""
    H, D = q.shape[2], q.shape[3]
    qt = q.transpose(1, 2)
    kt = _repeat_kv(k, H).transpose(1, 2)
    vt = _repeat_kv(v, H).transpose(1, 2)
    logits = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) * (D ** -0.5)
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, vt).to(q.dtype).transpose(1, 2)


def kernel_eligible(q: torch.Tensor, k: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> bool:
    """The JAX dispatcher's rule (flash_attention.py:481-489) without its
    VMEM clause: that clause bounds the K/V blocks a TPU kernel keeps whole
    in VMEM, and a kernel that streams K/V tiles has no such limit."""
    return bias is None and q.shape[1] == k.shape[1] and _kernel_rule(q.shape[1], q, k)


def _kernel_rule(seq_len: int, q: torch.Tensor, k: torch.Tensor) -> bool:
    """The shape half of ``kernel_eligible``, for a sequence of seq_len
    tokens (all of them, where the sp route holds a rank's rows): long
    enough, D <= 256 and whole query groups per kv head."""
    return (seq_len >= _MIN_SEQ_FOR_KERNEL and q.shape[3] <= MAX_KERNEL_HEAD_DIM
            and q.shape[2] % k.shape[2] == 0)


_SP_MESH_SCOPE = contextvars.ContextVar("aec_sp_mesh", default=None)


@contextlib.contextmanager
def sp_mesh_scope(mesh):
    """Route sequence-parallel self-attention over ``mesh``'s sp axis for
    the duration (the CLIs enter it around their edit; the DiT reads it to
    split its token rows). A mesh of None or one without an sp axis is a
    no-op, so callers wrap unconditionally. An sp axis of size 1 counts: it
    runs the sp route's collectives on one device."""
    tok = _SP_MESH_SCOPE.set(mesh if mesh is not None and "sp" in mesh.shape else None)
    try:
        yield
    finally:
        _SP_MESH_SCOPE.reset(tok)


def sp_mesh():
    """The mesh of the innermost ``sp_mesh_scope`` that has an sp axis, else
    None."""
    return _SP_MESH_SCOPE.get()


def _sp_blocked_attention(q, kf, vf, kv_len: int):
    """Sequence-parallel kernel attention (JAX ``_sp_blocked_attention``):
    q holds this rank's rows of a sequence of ``kv_len`` tokens padded to a
    multiple of 8 sp, kf and vf the K/V all-gathered over the sp group
    (``_sp_attention`` gathers them); the local query rows attend to them
    with keys >= kv_len masked: B1 on the card, its plain version on the
    CPU. Returns the local rows' output."""
    if q.is_cuda:
        return flash_attention_cuda(q, kf, vf, kv_len=kv_len)
    return attention_reference(q, kf, vf, kv_len=kv_len)


def _sp_attention(q, k, v, mesh, kv_len: int, rotary):
    """The sp route of ``fused_attention``: the rotary on the host at the
    rows' global positions (the tables the caller passes are the local
    rows'), K/V all-gathered over the sp group, then the kernel where the
    whole sequence is eligible, or the plain path with the padded keys
    masked."""
    if rotary is not None:
        q, k = _host_rotary(q, *rotary), _host_rotary(k, *rotary)
    axis = mesh.axis("sp")
    kf, vf = axis.gather(k, dim=1), axis.gather(v, dim=1)
    if _kernel_rule(kv_len, q, k):
        return _sp_blocked_attention(q, kf, vf, kv_len)
    bias = torch.zeros(kf.shape[1], dtype=torch.float32, device=q.device)
    bias[kv_len:] = float("-inf")
    return _plain_attention(q, kf, vf, bias)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    rotary: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """(B, Q, H, D) attention, with an optional partial rotary (cos, sin),
    each (Q, rot), applied to q and k. Eligible calls (every head dim up
    to 256) launch a kernel on a CUDA tensor or raise, and take its plain
    version on a CPU tensor; the rest take
    the plain matmul path. The rotary goes inside the kernel (B2) with
    ``AEC_ROTARY_IN_KERNEL=1`` and an even width, and is applied on the
    host before B1 otherwise (the JAX default). ``kv_len`` marks
    self-attention over this rank's rows of an sp-split sequence of
    ``kv_len`` tokens (``sp_mesh_scope``; the sp route above)."""
    if kv_len is not None:
        mesh = sp_mesh()
        if mesh is None:
            raise ValueError("kv_len marks sp-split rows: it needs an sp_mesh_scope")
        return _sp_attention(q, k, v, mesh, kv_len, rotary)
    if kernel_eligible(q, k, bias):
        if (rotary is not None and rotary[0].shape[-1] % 2 == 0
                and os.environ.get("AEC_ROTARY_IN_KERNEL", "0") == "1"):
            if q.is_cuda:
                return flash_attention_rotary_cuda(q, k, v, *rotary)
            return rotary_attention_reference(q, k, v, *rotary)
        if rotary is not None:
            q, k = _host_rotary(q, *rotary), _host_rotary(k, *rotary)
        if q.is_cuda:
            return flash_attention_cuda(q, k, v)
        return attention_reference(q, k, v)
    if rotary is not None:
        q, k = _host_rotary(q, *rotary), _host_rotary(k, *rotary)
    return _plain_attention(q, k, v, bias)
