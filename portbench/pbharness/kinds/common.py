"""What the kinds of traffic share: dtypes, the comparison numbers, and the
result of a run before it is printed."""

from __future__ import annotations

import dataclasses
import gc
from typing import Dict, List

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    e2e: Dict[str, float]  # end-to-end metrics of the window
    setup_s: float
    memory_peak_bytes: int
    checks: Dict[str, float]  # the numbers compared, by name
    context: object = None  # readers.Context of a traced run
    notes: List[str] = dataclasses.field(default_factory=list)


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest, over rows, of |a - b| / |b| (Frobenius, b the
    reference); inf where a row is not finite."""
    a = a.detach().float().reshape(a.shape[0], -1)
    b = b.detach().float().reshape(b.shape[0], -1).to(a.device)
    if a.shape != b.shape:
        raise ValueError(f"compared shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    num = torch.linalg.vector_norm(a - b, dim=1)
    den = torch.linalg.vector_norm(b, dim=1).clamp_min(1e-30)
    r = num / den
    if not torch.isfinite(r).all():
        return float("inf")
    return float(r.max())


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def is_probe(step: int, stride: int, t_first: int, t_n: int) -> bool:
    """Whether the window's ``step`` is a host probe of a traced run: every
    ``stride``-th step, none within a step of the traced stretch (steps
    ``t_first`` to ``t_first + t_n - 1``), where the profiler slows the
    host."""
    return step % stride == stride // 2 and not t_first - 1 <= step <= t_first + t_n


def reference_flags(tf32: bool = False) -> None:
    """The reference's float32 products stay float32 (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32

