"""Unsupervised editing: posterior principal components by power iteration.

Counterpart of ``audioeditingcode_tpu/editing/pc_drift.py``:

- ``forward_directional``: one guided solver step from xt + a * c_k * v,
  where c_k = d(x_t)/d(x_0) (sqrt(abar_t) for DDIM, 1 for the cosine DPM
  solver).
- ``get_eigenvectors``: subspace power iteration on the denoiser Jacobian
  v -> (x0hat(xt + eps v) - x0hat(xt)) / eps. The n_ev eigenvector batch
  rides the denoiser batch: one CFG-pair forward of batch 2 n_ev per
  iteration. The 50-iteration ``lax.scan`` of the JAX version is a Python
  loop here. With a dp axis (``--dp``) each rank runs the forwards of its
  block of the ev batch, and the shifted x0 predictions are all-gathered
  before the norms and the QR, which every rank then computes alike (JAX
  ``pc_extract.py``'s ``dp_on_ev``).
- ``apply_drift``: shift x0hat along the extracted PCs and redo the step.

The model seam is ``eps_pair_fn(x_uncond_in, x_cond_in, k) -> (eps_u,
eps_c)``, both streams in one denoiser call; the stream choice (BOTH / TEXT /
UNCOND) picks which stream sees the perturbed input. Noise is passed in,
never redrawn: ``get_eigenvectors`` takes its initial draw ``v0``, or draws
it from an explicit generator.
"""

from __future__ import annotations

import enum
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .. import precision
from ..schedulers.ddim import get_sigma
from .solvers import DDIMSolver, as_solver

EpsPairFn = Callable[[torch.Tensor, Optional[torch.Tensor], int],
                     Tuple[torch.Tensor, torch.Tensor]]


class PCStreamChoice(enum.Enum):
    BOTH = 1
    TEXT = 2
    UNCOND = 3


def _pc_sigma2(solver, k: int) -> torch.Tensor:
    """Eigenvalue scale sigma_t^2: DDIM's sqrt(1/abar - 1) squared; the
    cosine DPM solver's marginal noise scale squared (a different unit
    convention, consistent within the family)."""
    if isinstance(solver, DDIMSolver):
        return get_sigma(solver.sched, k) ** 2
    return solver.sched.sigmas[k] ** 2


def forward_directional(
    sched,  # DiffusionSchedule | CosineDPMSchedule | solver
    eps_pair_fn: EpsPairFn,
    xt: torch.Tensor,  # (N, ...)
    k: int,
    latent: torch.Tensor,  # variance noise, (N, ...) or broadcastable
    cfg_tar: float,
    eta: float = 1.0,
    eigvecs=0.0,
    amount: float = 0.0,
    mode: PCStreamChoice = PCStreamChoice.BOTH,
    state=None,  # multistep solver history (None: fresh)
    return_state: bool = False,
):
    """One guided solver step from a (possibly PC-shifted) xt. Returns
    (x_{t-1}, x0_pred)[, state]."""
    solver = as_solver(sched, eta=eta)
    if state is None:
        state = solver.init_state(xt)
    inp = xt + amount * eigvecs * solver.x0_shift_coeff(k)
    x_u = inp if mode in (PCStreamChoice.BOTH, PCStreamChoice.UNCOND) else xt
    x_c = inp if mode in (PCStreamChoice.BOTH, PCStreamChoice.TEXT) else xt
    eps_u, eps_c = eps_pair_fn(x_u, x_c, k)
    noise_pred = eps_u + cfg_tar * (eps_c - eps_u)
    state, prev, x0_pred = solver.directional_step(state, k, inp, noise_pred, latent)
    if return_state:
        return prev, x0_pred, state
    return prev, x0_pred


class EigResult(NamedTuple):
    eigvecs: torch.Tensor  # (n_ev, ...) unit-norm, sorted by eigenvalue desc
    eigvals: torch.Tensor  # (n_ev,)
    in_corrs: torch.Tensor  # (iters-1, n_ev) successive-iterate correlations
    in_norms: torch.Tensor  # (iters, n_ev) ||Ab|| per iteration
    interm_eigvecs: torch.Tensor  # (n_snapshots, n_ev, ...)
    interm_eigvals: torch.Tensor  # (n_snapshots, n_ev)
    snapshot_iters: Tuple[int, ...]


def snapshot_iterations(iters: int) -> Tuple[int, ...]:
    """The iterations whose iterate is kept: i % 10 == 0 and i > 15."""
    return tuple(i for i in range(iters) if i % 10 == 0 and i > 15)


def orthonormalise(ab: torch.Tensor, flat_mask: torch.Tensor, n_ev: int):
    """One iteration's normalisation, QR and sort of the (n_ev, ...) rows
    ``ab``: (unit-norm iterate sorted by |ab| desc, |ab| per row). The
    operands of the norm's and the QR's products pass through the control's
    rounding (``precision.q``; float32: unchanged)."""
    expand = (n_ev,) + (1,) * (ab.dim() - 1)
    dims = tuple(range(1, ab.dim()))
    norm_ab = torch.sqrt(torch.sum((precision.q(ab) * flat_mask) ** 2, dim=dims))  # (n_ev,)
    vecs = ab / norm_ab.reshape(expand) * flat_mask
    if n_ev > 1:
        # QR orthonormalisation across the ev batch; the whole basis is
        # flipped where prod(diag(R)) < 0 (on the device, no host sync)
        q, r = torch.linalg.qr(precision.q(vecs.reshape(n_ev, -1).T), mode="reduced")
        q = torch.where(torch.prod(torch.diagonal(r)) < 0, -q, q)
        q = q / torch.linalg.norm(q, dim=0)
        vecs = q.T.reshape(ab.shape)
        vecs = vecs[torch.argsort(-norm_ab, stable=True)]
    return vecs, norm_ab


@torch.no_grad()
def get_eigenvectors(
    sched,  # DiffusionSchedule | CosineDPMSchedule | solver
    eps_pair_fn: EpsPairFn,
    xt: torch.Tensor,  # (n_ev, ...) already expanded across the ev batch
    latents: torch.Tensor,  # variance noise for the directional step
    mask: torch.Tensor,  # (1, ...) or (n_ev, ...) 0/1 patch mask
    k: int,  # step position
    x0_pred: torch.Tensor,  # (n_ev, ...) unperturbed x0 prediction
    v0: Optional[torch.Tensor] = None,  # (n_ev, ...) standard-normal draw
    generator: Optional[torch.Generator] = None,  # draws v0 when it is None
    mode: PCStreamChoice = PCStreamChoice.BOTH,
    const: float = 1e-3,
    cfg_tar: float = 3.0,
    iters: int = 50,
    eta: float = 1.0,
    n_ev: int = 1,
    state=None,  # incoming multistep history at step k (Stable Audio)
    dp=None,  # parallel.mesh.Axis splitting the ev batch, or None
) -> EigResult:
    """Power iteration for the top n_ev posterior PCs at one timestep; the
    returned eigvecs are unit-norm. With ``dp``, ``eps_pair_fn`` takes this
    rank's block of ``dp.block(n_ev)`` rows."""
    solver = as_solver(sched, eta=eta)
    sigma2 = _pc_sigma2(solver, k)
    flat_mask = mask.bool().to(xt.dtype)
    if v0 is None:
        if generator is None:
            raise ValueError("get_eigenvectors needs the initial draw v0 or a generator")
        v0 = torch.randn(xt.shape, generator=generator, device=xt.device, dtype=xt.dtype)
    elif tuple(v0.shape) != tuple(xt.shape):
        raise ValueError(f"v0 shape {tuple(v0.shape)} != xt shape {tuple(xt.shape)}")
    v0 = v0.to(device=xt.device, dtype=xt.dtype) * flat_mask * const

    snaps = snapshot_iterations(iters)
    scaled, prev = v0, v0 / const  # scaled = unit vectors * const
    corrs, norms, snap_vecs = [], [], []

    def rows(x):
        return x if dp is None or x.shape[0] != n_ev else dp.shard(x)

    xt_rows, latent_rows = rows(xt), rows(latents)
    for i in range(iters):
        _, x0_shift = forward_directional(
            solver, eps_pair_fn, xt_rows, k, latent_rows, cfg_tar, eta=eta,
            eigvecs=rows(scaled), amount=1.0, mode=mode, state=state,
        )
        if dp is not None:
            x0_shift = dp.gather(x0_shift, n_ev)
        ab = x0_shift * flat_mask - x0_pred
        vecs, norm_ab = orthonormalise(ab, flat_mask, n_ev)
        corrs.append(torch.sum(prev.reshape(n_ev, -1) * vecs.reshape(n_ev, -1), dim=-1))
        norms.append(norm_ab)
        if i in snaps:
            snap_vecs.append(vecs)
        scaled, prev = vecs * const, vecs

    norms_t = torch.stack(norms)
    snap_idx = list(snaps)
    return EigResult(
        eigvecs=scaled / const,
        eigvals=norms_t[-1] / const * sigma2,
        in_corrs=torch.stack(corrs)[1:],  # iteration 0 compares with the random draw
        in_norms=norms_t,
        interm_eigvecs=(torch.stack(snap_vecs) if snap_vecs
                        else xt.new_zeros((0,) + tuple(xt.shape))),
        interm_eigvals=norms_t[snap_idx] / const * sigma2,
        snapshot_iters=snaps,
    )


def apply_drift(
    sched,  # DiffusionSchedule | CosineDPMSchedule | solver
    k: int,
    xt_m1: torch.Tensor,  # (B, ...) result of forward_directional
    x0_pred: torch.Tensor,  # (B, ...)
    eigvecs: torch.Tensor,  # (n_sel, ...) PCs to apply
    eigvals: torch.Tensor,  # (n_sel,)
    latent: torch.Tensor,  # the variance noise of the directional step
    eta: float = 1.0,
    amount: float = 1.0,
    use_shifted_x0_for_noisepred: bool = True,
    xt: Optional[torch.Tensor] = None,  # needed by multistep solvers
    state=None,  # incoming multistep history at step k
    return_state: bool = False,
):
    """Shift x0hat by amount * sum_i sqrt(eigval_i) eigvec_i and redo the
    step (DDIM recovers the implied epsilon from (xt_m1, x0_pred); the
    multistep solver reruns its update from the shifted data prediction)."""
    solver = as_solver(sched, eta=eta)
    if state is None:
        state = solver.init_state(x0_pred)
    expand = (eigvals.shape[0],) + (1,) * (eigvecs.dim() - 1)
    shift_by = amount * torch.sum(torch.sqrt(eigvals).reshape(expand) * eigvecs,
                                  dim=0, keepdim=True)
    new_state, out = solver.drift_step(
        state, k, xt, xt_m1, x0_pred, shift_by, latent,
        use_shifted_x0_for_noisepred=use_shifted_x0_for_noisepred,
    )
    if return_state:
        return out, new_state
    return out
