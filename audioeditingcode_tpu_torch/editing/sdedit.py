"""SDEdit baseline: noise the clean latent to t_start, then denoise it with
the target prompt.

Counterpart of ``audioeditingcode_tpu/editing/sdedit.py``. Each
``lax.scan`` there is a Python loop over the same step positions here
(k = skip up to S-1). The JAX loops draw their start noise and per-step
variance noise from ``jax.random.split(rng)``; these take both as
arguments (the CLI draws them from a ``torch.Generator``, or, for Stable
Audio, the per-step noise from the Brownian path of
``schedulers/brownian.py``).

- ``sdedit_loop`` (DDIM families): x_t = add_noise(w0, noise, t_skip), then
  guided eta-DDIM steps through ``pc_drift.forward_directional``.
- ``sdedit_loop_cosine`` (Stable Audio): x_t = w0 + sigma_skip * noise, then
  guided 2nd-order SDE-DPM-Solver++ steps through the solver's
  ``reverse_step``.
"""

from __future__ import annotations

import torch

from ..schedulers.ddim import DiffusionSchedule, add_noise
from .pc_drift import EpsPairFn, forward_directional
from .solvers import CosineDPMSolver


def _check_noise(w0: torch.Tensor, noise: torch.Tensor, latents: torch.Tensor, runs: int):
    if tuple(noise.shape) != tuple(w0.shape):
        raise ValueError(f"start noise shape {tuple(noise.shape)} != {tuple(w0.shape)}")
    if tuple(latents.shape) != (runs,) + tuple(w0.shape):
        raise ValueError(f"per-step noise shape {tuple(latents.shape)} != "
                         f"{(runs,) + tuple(w0.shape)}")


@torch.no_grad()
def sdedit_loop(
    sched: DiffusionSchedule,
    eps_pair_fn: EpsPairFn,
    w0: torch.Tensor,  # (1, ...) clean latent
    noise: torch.Tensor,  # w0.shape: the start noise
    latents: torch.Tensor,  # (S - skip,) + w0.shape: per-step variance noise
    skip: int,
    cfg_tar: float,
    eta: float = 1.0,
) -> torch.Tensor:
    """Noise w0 to timesteps[skip], then run the guided reverse process."""
    S = sched.num_inference_steps
    _check_noise(w0, noise, latents, S - skip)
    xt = add_noise(sched, w0, noise.to(w0.dtype), sched.timesteps[skip])
    for i, k in enumerate(range(skip, S)):
        xt, _ = forward_directional(sched, eps_pair_fn, xt, k, latents[i], cfg_tar, eta=eta)
    return xt


@torch.no_grad()
def sdedit_loop_cosine(
    solver: CosineDPMSolver,
    eps_pair_fn: EpsPairFn,
    w0: torch.Tensor,
    noise: torch.Tensor,  # w0.shape: the start noise
    latents: torch.Tensor,  # (S - skip,) + w0.shape: per-step variance noise
    skip: int,
    cfg_tar: float,
) -> torch.Tensor:
    """SDEdit on the sigma-space cosine solver (Stable Audio family):
    x_t = w0 + sigma_skip * noise, then guided solver steps."""
    S = solver.num_inference_steps
    _check_noise(w0, noise, latents, S - skip)
    xt = w0 + solver.sched.sigmas[skip] * noise.to(w0.dtype)
    state = solver.init_state(xt)
    for i, k in enumerate(range(skip, S)):
        eps_u, eps_c = eps_pair_fn(xt, xt, k)
        noise_pred = eps_u + cfg_tar * (eps_c - eps_u)
        state, xt = solver.reverse_step(state, k, xt, noise_pred, latents[i].to(w0.dtype))
    return xt
