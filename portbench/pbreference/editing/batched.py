"""Window-batched text edit: N windows (or clips) of one prompt pair in one
denoiser forward per step.

The JAX CLIs run the single-window edit under ``jax.vmap`` over the window
axis (``cli/run_long.py``, ``cli/run_batch.py``). The port's kernels have
no batching rule, and the port's CFG denoiser reads the leading axis as the
prompt axis (``invert.make_cfg_denoiser`` sums the guidance over it, and
the pipelines broadcast the latent to the prompts), so N windows passed to
it as a batch would be read as N prompts and their guidance summed into
one. Here the window axis is folded in explicitly instead:

- one forward per step carries the 2N CFG rows, the N unconditional rows
  first, then the N conditional ones (the pipelines' ``make_eps_pair`` with
  a single prompt and an N-row latent);
- the output is unfolded and the guidance applied per window, with no sum
  over windows;
- each window takes its own slice of the noise, and the solver steps every
  row on its own (the DDIM and cosine-DPM updates are elementwise, and the
  cosine solver's history is per row).

So the result of every window equals its single-window edit.

With a dp axis (``--dp``; the counterpart of JAX ``longform.py::
dp_constraint``) each rank folds its block of the windows into its forwards
(``parallel.mesh.Axis.shard``: blocks of ceil(N / dp), the last padded by
repeating a window) with the same block of every draw, and the edited
latents are all-gathered in window order: each window's edit is the one it
gets on one device.
"""

from __future__ import annotations

from typing import Optional

import torch

from .invert import DenoiseFn, inversion_forward_process, inversion_reverse_process


def make_window_denoiser(eps_pair_fn, cfg_tensor: Optional[torch.Tensor]) -> DenoiseFn:
    """Per-window CFG: eps_u[i] + cfg * (eps_c[i] - eps_u[i]) for each of the
    N rows of xt, from one forward of 2N rows. ``cfg_tensor`` is the (1, ...)
    tensor of one prompt (None: the unconditional stream alone)."""
    if cfg_tensor is None:
        def denoise_uncond(xt, k):
            eps_u, _ = eps_pair_fn(xt, None, k)
            return eps_u

        return denoise_uncond
    if cfg_tensor.shape[0] != 1:
        raise ValueError(f"one prompt per window: the cfg tensor has {cfg_tensor.shape[0]} rows")

    def denoise(xt, k):
        eps_u, eps_c = eps_pair_fn(xt, xt, k)
        if eps_c.shape[0] != xt.shape[0]:
            raise ValueError(f"{eps_c.shape[0]} conditional rows for {xt.shape[0]} windows: "
                             "the window fold takes a single prompt")
        return eps_u + cfg_tensor * (eps_c - eps_u)

    return denoise


@torch.no_grad()
def edit_windows(
    sched,
    fwd_denoise: DenoiseFn,
    rev_denoise: DenoiseFn,
    w0: torch.Tensor,  # (N, ...) clean latents, one row per window
    noise: torch.Tensor,  # (S, N, ...) each window's q(x_t | x_0) draw
    tstart: int,
    eta: float = 1.0,
    numerical_fix: bool = True,
    dp=None,  # parallel.mesh.Axis of the dp ranks, or None
) -> torch.Tensor:
    """The edit-friendly inversion of every window, then its reverse pass
    from ``tstart`` (with the cosine solver's 2nd-order history carried over
    from the forward pass), all N windows in each denoiser call. Returns the
    (N, ...) edited latents. Build the denoisers with
    :func:`make_window_denoiser`. With ``dp``, this rank edits its block of
    the windows and the blocks are gathered (every rank returns all N)."""
    S = noise.shape[0]
    if tuple(noise.shape[1:]) != tuple(w0.shape):
        raise ValueError(f"noise shape {tuple(noise.shape)} != {(S,) + tuple(w0.shape)}")
    N = w0.shape[0]
    if dp is not None:
        w0, noise = dp.shard(w0, 0), dp.shard(noise, 1)
    _, zs, xts, extras = inversion_forward_process(
        sched, fwd_denoise, w0, noise, eta=eta, numerical_fix=numerical_fix,
        return_extras=True)
    out = inversion_reverse_process(
        sched, rev_denoise, xts, zs[:tstart], eta=eta,
        init_history=None if extras is None else extras[tstart - 1])
    return out if dp is None else dp.gather(out, N, dim=0)
