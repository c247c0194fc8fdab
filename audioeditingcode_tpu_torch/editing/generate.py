"""Generation primitives: text-to-audio, style transfer, masked inpainting.

Counterpart of ``audioeditingcode_tpu/editing/generate.py``. Each
``lax.scan`` there is a Python loop over the same step positions here. The
JAX functions draw their noise from ``jax.random.split(rng)``; these take
every draw as an argument (the CLI draws them from a ``torch.Generator``,
or, for Stable Audio, the solver's per-step noise from the Brownian path
of ``schedulers/brownian.py``):

- ``generation_loop`` / ``text_to_audio_latents``: CFG-guided ancestral
  sampling from a start latent (pure noise for text-to-audio);
- ``style_transfer_latents``: noise the source latent to
  ``transfer_strength * S`` and denoise under the target prompt;
- ``inpaint_latents`` (DDIM families) and ``inpaint_latents_cosine``
  (Stable Audio): after every step the kept region is re-projected to the
  source latent noised to the next noise level, and the result keeps the
  source latent exactly outside the mask.
"""

from __future__ import annotations

import torch

from ..schedulers.ddim import DiffusionSchedule, add_noise, ddim_step
from .invert import DenoiseFn
from .solvers import CosineDPMSolver


def _check(name: str, got: torch.Tensor, want) -> None:
    if tuple(got.shape) != tuple(want):
        raise ValueError(f"{name} shape {tuple(got.shape)} != {tuple(want)}")


@torch.no_grad()
def generation_loop(
    sched: DiffusionSchedule,
    denoise_fn: DenoiseFn,
    xt: torch.Tensor,  # the start latent at timesteps[skip]
    step_noise: torch.Tensor,  # (S - skip,) + xt.shape: per-step variance noise
    eta: float = 1.0,
    skip: int = 0,
) -> torch.Tensor:
    """Ancestral sampling from timesteps[skip] to 0."""
    S = sched.num_inference_steps
    _check("per-step noise", step_noise, (S - skip,) + tuple(xt.shape))
    for i, k in enumerate(range(skip, S)):
        eps = denoise_fn(xt, k)
        xt, _ = ddim_step(sched, k, eps, xt, eta=eta, variance_noise=step_noise[i].to(xt.dtype))
    return xt


def text_to_audio_latents(
    sched: DiffusionSchedule,
    denoise_fn: DenoiseFn,
    noise: torch.Tensor,  # the start latent, N(0, I)
    step_noise: torch.Tensor,  # (S,) + noise.shape
    eta: float = 1.0,
) -> torch.Tensor:
    """Full text-to-audio latent generation from pure noise."""
    return generation_loop(sched, denoise_fn, noise, step_noise, eta=eta)


def transfer_skip(sched: DiffusionSchedule, transfer_strength: float) -> int:
    """The first step position of a style transfer: S - int(strength * S)
    (S, a loop of no step, at strength 0)."""
    S = sched.num_inference_steps
    return S - max(int(transfer_strength * S), 0)


def style_transfer_latents(
    sched: DiffusionSchedule,
    denoise_fn: DenoiseFn,
    w0: torch.Tensor,
    noise: torch.Tensor,  # w0.shape: the forward-noising draw
    step_noise: torch.Tensor,  # (S - skip,) + w0.shape, skip = transfer_skip(...)
    transfer_strength: float,
    eta: float = 1.0,
) -> torch.Tensor:
    """Noise w0 to t = strength * S, then denoise under the target prompt.
    Zero strength returns w0 itself."""
    skip = transfer_skip(sched, transfer_strength)
    if skip == sched.num_inference_steps:  # nothing to transfer
        return w0
    _check("start noise", noise, w0.shape)
    xt = add_noise(sched, w0, noise.to(w0.dtype), sched.timesteps[skip])
    return generation_loop(sched, denoise_fn, xt, step_noise, eta=eta, skip=skip)


@torch.no_grad()
def inpaint_latents(
    sched: DiffusionSchedule,
    denoise_fn: DenoiseFn,
    w0: torch.Tensor,
    mask: torch.Tensor,  # 1 = regenerate, 0 = keep source
    noise: torch.Tensor,  # w0.shape: the start latent, N(0, I)
    keep_noise: torch.Tensor,  # (S,) + w0.shape: the kept region's q-sample noise
    step_noise: torch.Tensor,  # (S,) + w0.shape: per-step variance noise
    eta: float = 1.0,
) -> torch.Tensor:
    """Masked generation: after every step the kept region is replaced by the
    source latent noised to the *next* timestep, max(t - ratio, 0)."""
    S = sched.num_inference_steps
    for name, t, want in (("start noise", noise, w0.shape),
                          ("keep noise", keep_noise, (S,) + tuple(w0.shape)),
                          ("per-step noise", step_noise, (S,) + tuple(w0.shape))):
        _check(name, t, want)
    xt = noise.to(w0.dtype)
    for k in range(S):
        eps = denoise_fn(xt, k)
        xt, _ = ddim_step(sched, k, eps, xt, eta=eta, variance_noise=step_noise[k].to(w0.dtype))
        t_prev = torch.clamp(sched.timesteps[k] - sched.step_ratio, min=0)
        w_known = add_noise(sched, w0, keep_noise[k].to(w0.dtype), t_prev)
        xt = mask * xt + (1.0 - mask) * w_known
    return mask * xt + (1.0 - mask) * w0


@torch.no_grad()
def inpaint_latents_cosine(
    solver: CosineDPMSolver,
    eps_pair_fn,
    w0: torch.Tensor,  # (B, C, L) clean Oobleck latent
    mask: torch.Tensor,  # 1 = regenerate, 0 = keep source
    noise: torch.Tensor,  # w0.shape: the start draw, scaled by sigmas[0]
    keep_noise: torch.Tensor,  # (S,) + w0.shape: the kept region's q-sample noise
    step_noise: torch.Tensor,  # (S,) + w0.shape: solver variance noise
    cfg_tar: float,
) -> torch.Tensor:
    """Masked generation on the sigma-space cosine solver (Stable Audio):
    after every solver step the kept region is re-projected to the source
    latent noised to the NEXT sigma level (0 after the last step). The
    2nd-order history sees the pre-blend model output; the blend runs on
    the sample only."""
    sched = solver.sched
    S = sched.num_inference_steps
    for name, t, want in (("start noise", noise, w0.shape),
                          ("keep noise", keep_noise, (S,) + tuple(w0.shape)),
                          ("per-step noise", step_noise, (S,) + tuple(w0.shape))):
        _check(name, t, want)
    xt = sched.sigmas[0] * noise.to(w0.dtype)
    state = solver.init_state(xt)
    for k in range(S):
        eps_u, eps_c = eps_pair_fn(xt, xt, k)
        noise_pred = eps_u + cfg_tar * (eps_c - eps_u)
        state, xt = solver.reverse_step(state, k, xt, noise_pred, step_noise[k].to(w0.dtype))
        w_known = w0 + sched.sigmas[k + 1] * keep_noise[k].to(w0.dtype)
        xt = mask * xt + (1.0 - mask) * w_known
    return mask * xt + (1.0 - mask) * w0
