"""Plain float32 attention in place of the port's kernels B1 and B2, with
the port's dispatch rule kept only to record which calls the port sends to
B1 (``RECORD``: the benchmark's count of B1 launches per forward)."""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .. import precision

_MIN_SEQ_FOR_KERNEL = 1024
MAX_KERNEL_HEAD_DIM = 256

# a list while the benchmark counts launches; each B1-eligible call adds
# (B, Sq, Skv, H, H_kv, D)
RECORD: Optional[List[Tuple[int, ...]]] = None
# the most score elements worked out at once (512 MiB in float32)
BLOCK = 1 << 27


def _repeat_kv(x: torch.Tensor, heads: int) -> torch.Tensor:
    rep = heads // x.shape[2]
    return x if rep == 1 else x.repeat_interleave(rep, dim=2)


def _rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Partial rotate-half rotary on the first cos.shape[-1] features."""
    rot = cos.shape[-1]
    xr = x[..., :rot].float()
    half = rot // 2
    rh = torch.cat([-xr[..., half:], xr[..., :half]], dim=-1)
    out = xr * cos[: x.shape[1], None].float() + rh * sin[: x.shape[1], None].float()
    return torch.cat([out, x[..., rot:].float()], dim=-1)


def kernel_eligible(q: torch.Tensor, k: torch.Tensor, bias=None) -> bool:
    return (bias is None and q.shape[1] == k.shape[1] and q.shape[1] >= _MIN_SEQ_FOR_KERNEL
            and q.shape[3] <= MAX_KERNEL_HEAD_DIM and q.shape[2] % k.shape[2] == 0)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    rotary: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(D) + bias) v over (B, S, H, D) tensors, every
    step in float32; returns q's dtype. Without a bias the scores are
    worked out in blocks of (batch, head) pairs of at most ``BLOCK``
    elements, so that a long sequence's scores fit beside the model."""
    if RECORD is not None and kernel_eligible(q, k, bias):
        RECORD.append((q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3]))
    dtype = q.dtype
    if rotary is not None:
        q, k = _rotary(q, *rotary), _rotary(k, *rotary)
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    qt = precision.q(q.float()).transpose(1, 2)
    kt = precision.q(_repeat_kv(k, H).float()).transpose(1, 2)
    vt = precision.q(_repeat_kv(v, H).float()).transpose(1, 2)
    if bias is not None or B * H * Sq * Skv <= BLOCK:
        logits = torch.matmul(qt, kt.transpose(-1, -2)) * (D ** -0.5)
        if bias is not None:
            logits = logits + bias.float()
        probs = precision.q(torch.softmax(logits, dim=-1))
        return torch.matmul(probs, vt).transpose(1, 2).to(dtype)
    qf, kf, vf = (t.reshape(B * H, t.shape[2], D) for t in (qt, kt, vt))
    step = max(1, BLOCK // (Sq * Skv))
    blocks = [slice(i, i + step) for i in range(0, B * H, step)]

    def probs(sl):
        return torch.softmax(torch.matmul(qf[sl], kf[sl].transpose(-1, -2)) * (D ** -0.5),
                             dim=-1)

    # the controls round the probabilities under one scale for the whole
    # tensor, as without blocks
    amax = max(float(probs(sl).amax()) for sl in blocks) if precision.MODE != "f32" else None
    out = torch.empty((B * H, Sq, D), dtype=torch.float32, device=q.device)
    for sl in blocks:
        out[sl] = torch.matmul(precision.q(probs(sl), amax=amax), vf[sl])
    return out.reshape(B, H, Sq, D).transpose(1, 2).to(dtype)


def sp_mesh():
    return None
