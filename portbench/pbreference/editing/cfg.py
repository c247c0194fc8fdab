"""Per-prompt spatial classifier-free-guidance tensors.

Counterpart of ``audioeditingcode_tpu/editing/cfg.py``: the time axis
(axis 2 of the NCHW latent) is cut at ``cutoff_points`` into one segment per
prompt, each scaled by its prompt's CFG strength (zeroed for empty prompts
on the forward pass), then smoothed with a 15x15 sigma-1 gaussian blur.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.filters import gaussian_blur_2d


def build_cfg_tensors(
    latent_shape: Sequence[int],  # (1, C, H, W)
    prompts: List[str],
    cfg_scales: List[float],
    cutoff_points: Optional[List[float]] = None,
    zero_empty_prompts: bool = False,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cpu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (cfg_scales_tensor, masks), each (P, *latent_shape[1:]).

    For P == 1 the cfg tensor is the constant cfg_scales[0] and the mask all
    ones (no blur)."""
    batch = len(prompts)
    inner = tuple(latent_shape[1:])
    if len(cfg_scales) == 1:
        cfg_scales = list(cfg_scales) * batch
    elif len(cfg_scales) < batch:
        raise ValueError("Not enough target CFG scales")

    if batch == 1:
        scale = 0.0 if (zero_empty_prompts and prompts[0] == "") else cfg_scales[0]
        cfg = torch.full((1,) + inner, scale, dtype=dtype, device=device)
        masks = torch.ones((1,) + inner, dtype=dtype, device=device)
        return cfg, masks

    if cutoff_points is None:
        cutoff_points = [i / batch for i in range(1, batch)]
    time_dim = inner[1]
    cuts = [int(x * time_dim) for x in cutoff_points]
    cuts = [0, *cuts, time_dim]

    cfg_np = np.ones((batch,) + inner, dtype=np.float32)
    mask_np = np.ones((batch,) + inner, dtype=np.float32)
    for i, (start, end) in enumerate(zip(cuts[:-1], cuts[1:])):
        cfg_np[i, :, end:] = 0
        cfg_np[i, :, :start] = 0
        mask_np[i, :, end:] = 0
        mask_np[i, :, :start] = 0
        cfg_np[i] *= cfg_scales[i]
        if zero_empty_prompts and prompts[i] == "":
            cfg_np[i] = 0

    cfg = gaussian_blur_2d(torch.as_tensor(cfg_np, device=device).to(dtype), 15, 1.0)
    masks = gaussian_blur_2d(torch.as_tensor(mask_np, device=device).to(dtype), 15, 1.0)
    return cfg, masks
