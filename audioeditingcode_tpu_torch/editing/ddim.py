"""Plain DDIM inversion and eta-0 generation: the ``--mode ddim`` baseline.

Counterpart of ``audioeditingcode_tpu/editing/ddim.py``. Each ``lax.scan``
there is a Python loop over the same step positions here: the inversion
runs k = S-1 down to skip, the generation k = skip up to S-1. The model is
``denoise_fn(xt, k) -> noise_pred``.
"""

from __future__ import annotations

import torch

from ..schedulers.ddim import DiffusionSchedule, ddim_next_step, ddim_step
from .invert import DenoiseFn


@torch.no_grad()
def ddim_inversion_loop(sched: DiffusionSchedule, denoise_fn: DenoiseFn,
                        w0: torch.Tensor, skip: int = 0) -> torch.Tensor:
    """x0 -> x_T by deterministic DDIM inversion over S - skip steps, in
    ascending timesteps."""
    latent = w0
    for k in range(sched.num_inference_steps - 1, skip - 1, -1):
        latent = ddim_next_step(sched, k, denoise_fn(latent, k), latent)
    return latent


@torch.no_grad()
def ddim_generation_loop(sched: DiffusionSchedule, denoise_fn: DenoiseFn,
                         xT: torch.Tensor, skip: int = 0) -> torch.Tensor:
    """x_T -> x0 by eta-0 DDIM sampling from step position skip."""
    xt = xT
    for k in range(skip, sched.num_inference_steps):
        xt, _ = ddim_step(sched, k, denoise_fn(xt, k), xt, eta=0.0)
    return xt
