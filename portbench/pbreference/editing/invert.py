"""Edit-friendly DDPM inversion: the forward (inversion) and reverse (edit)
passes.

Counterpart of ``audioeditingcode_tpu/editing/invert.py``. Each
``lax.scan`` of the JAX version is a Python loop over timesteps here; one
CFG-batched denoiser forward (UNet or DiT) runs per step. The model is
``denoise_fn(xt, k) -> noise_pred`` with k the step position in the
schedule. Multistep solvers (Stable Audio's cosine DPM) carry their history
through the loop, and the forward pass can return it for the reverse pass's
warm start.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from .solvers import as_solver

DenoiseFn = Callable[[torch.Tensor, int], torch.Tensor]  # (xt, k) -> eps


def make_cfg_denoiser(eps_pair_fn, cfg_tensor: Optional[torch.Tensor]) -> DenoiseFn:
    """Classifier-free guidance: eps_u + sum_p cfg[p] * (eps_c[p] - eps_u)."""
    if cfg_tensor is None:
        def denoise_uncond(xt, k):
            eps_u, _ = eps_pair_fn(xt, None, k)
            return eps_u

        return denoise_uncond

    def denoise(xt, k):
        eps_u, eps_c = eps_pair_fn(xt, xt, k)
        diff = cfg_tensor * (eps_c - eps_u)  # (P, ...)
        return eps_u + torch.sum(diff, dim=0, keepdim=True)

    return denoise


@torch.no_grad()
def inversion_forward_process(
    sched,
    denoise_fn: DenoiseFn,
    x0: torch.Tensor,  # (1, C, H, W)
    noise: Union[torch.Tensor, torch.Generator],
    eta: float = 1.0,
    numerical_fix: bool = True,
    zero_first: bool = True,
    return_extras: bool = False,
):
    """Forward pass: returns (x_fix, zs, xts[, extras]).

    ``noise`` is the (S, *x0.shape) draw for the independent q(x_t | x_0)
    samples, or a generator to draw it from. zs (S, 1, ...) are the noise
    maps (zs[0] zeroed with ``zero_first``); xts (S+1, 1, ...) is the
    trajectory with xts[idx] rewritten to the numerically fixed x_{t-1};
    x_fix is the last carry, the fixed, nearly clean latent (= xts[0]).
    With ``return_extras`` (multistep solvers) extras (S, 1, ...) is the
    per-step solver history in zs-index order; ``extras[T - 1]`` warm-starts
    a reverse pass of T steps.
    """
    solver = as_solver(sched, eta=eta, numerical_fix=numerical_fix)
    S = solver.num_inference_steps
    # xts and zs are allocated once on the device and written in place: step
    # k reads the raw sample xts[idx] before overwriting it with its fixed
    # value, so no second (S+1)-latent buffer is needed
    xts = solver.sample_xts(x0, noise)
    zs = torch.empty((S,) + tuple(x0.shape), dtype=xts.dtype, device=xts.device)
    extras = torch.empty_like(zs) if return_extras and solver.carries_history else None
    xt = xts[S]
    state = solver.init_state(x0)
    for k in range(S):
        idx = S - k - 1
        eps = denoise_fn(xt, k)
        state, z, xtm1_fix, extra = solver.forward_step(state, k, xt, xts[idx], eps)
        zs[idx] = z
        if extras is not None:
            extras[idx] = extra
        xts[idx] = xtm1_fix
        xt = xtm1_fix
    if zero_first:
        zs[0] = 0
    if return_extras:
        return xt, zs, xts, extras
    return xt, zs, xts


@torch.no_grad()
def inversion_reverse_process(
    sched,
    denoise_fn: DenoiseFn,
    xts: torch.Tensor,  # (>= T+1, 1, ...) trajectory from the forward pass
    zs: torch.Tensor,  # (T, 1, ...) noise maps, T = max tstart
    eta: float = 1.0,
    tstart: Optional[torch.Tensor] = None,  # (P,) per-prompt start steps
    fix_alpha: float = 0.1,
    masks: Optional[torch.Tensor] = None,  # (P, ...) smoothed prompt masks
    init_history: Optional[torch.Tensor] = None,  # multistep warm start
) -> torch.Tensor:
    """Reverse (edit) pass from x_{max tstart} with the stored noise maps,
    including the multi-tstart fix: prompts with a smaller tstart are
    blended toward the stored trajectory until their own start step.
    ``init_history`` (``extras[T - 1]`` of the forward pass) warm-starts a
    multistep solver."""
    solver = as_solver(sched, eta=eta)
    T = zs.shape[0]
    S = solver.num_inference_steps
    xt = xts[T]

    multi = tstart is not None and masks is not None and masks.shape[0] > 1
    if multi:
        tstart = torch.as_tensor(tstart, device=xt.device)
        its = torch.arange(T, device=xt.device)[:, None]  # (T, 1)
        apply_fix = ((tstart.max() - tstart)[None, :] > its).to(xt.dtype)
        af = apply_fix * fix_alpha  # (T, P)

    state = solver.init_state(xt, init_history)
    for it in range(T):
        k = S - T + it
        eps = denoise_fn(xt, k)
        state, xt = solver.reverse_step(state, k, xt, eps, zs[T - 1 - it])
        if multi:
            a = af[it].reshape((-1,) + (1,) * (xt.dim() - 1))  # (P, 1, 1, 1)
            blended = masks * (xt * (1.0 - a) + a * xts[T - 1 - it])
            xt = torch.sum(blended, dim=0, keepdim=True)
    return xt
