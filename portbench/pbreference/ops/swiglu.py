"""Plain float32 SwiGLU in place of the port's kernel B3, with the port's
dispatch rule kept only to record which calls the port sends to B3
(``RECORD``: (M, E, N) per eligible call)."""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .. import precision

_MIN_ROWS_FOR_KERNEL = 512
RECORD: Optional[List[Tuple[int, int, int]]] = None


def fused_swiglu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(x W[:N]^T + b[:N]) * silu(x W[N:]^T + b[N:]) in float32, for x
    (..., E), weight (2N, E), bias (2N,); returns x's dtype."""
    e, n2 = x.shape[-1], weight.shape[0]
    M = x.numel() // max(e, 1)
    if (RECORD is not None and e % 128 == 0 and n2 % 2 == 0 and (n2 // 2) % 128 == 0
            and M >= _MIN_ROWS_FOR_KERNEL):
        RECORD.append((M, e, n2 // 2))
    N = n2 // 2
    h = torch.matmul(precision.q(x.float()), precision.q(weight.float()).t())
    a = h[..., :N] + bias[:N].float()
    g = h[..., N:] + bias[N:].float()
    return (a * torch.nn.functional.silu(g)).to(x.dtype)
