"""Solver seam driven by the editing loops: one interface, two numerics.

Counterpart of ``audioeditingcode_tpu/editing/solvers.py``:
  - ``init_state(like, history)``                 multistep history
  - ``sample_xts(x0, noise)``                     independent q(x_t | x_0) draw
  - ``scale_input(k, xt)``                        what the denoiser consumes
  - ``forward_step(state, k, xt, xtm1, out)``     noise-map recovery (+ fix)
  - ``reverse_step(state, k, xt, out, z)``        custom-noise reverse update

``DDIMSolver`` is stateless. ``CosineDPMSolver`` carries the previous
converted model output, the 2nd-order history of the Stable Audio family.
Both also carry the posterior-PC surface that ``editing/pc_drift.py`` drives:
  - ``x0_shift_coeff(k)``                         d(x_t)/d(x_0) at step k
  - ``directional_step(state, k, inp, out, z)``   step + its x0 prediction
  - ``drift_step(state, k, xt, xt_m1, x0, shift, z)``  the step redone with
    the x0 prediction shifted along the PCs (no model call)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..schedulers.cosine_dpm import (
    CosineDPMSchedule,
    convert_model_output,
    init_solver_state,
    recover_noise,
    sample_xts_from_x0_sigma,
    scale_model_input,
    solver_step,
    solver_step_from_x0,
)
from ..schedulers.ddim import (
    DiffusionSchedule,
    ddim_step,
    get_zs_from_xts,
    reverse_step_with_custom_noise,
    sample_xts_from_x0,
)


@dataclasses.dataclass(frozen=True)
class DDIMSolver:
    """Eta-DDIM numerics for the AudioLDM family; stateless (no history)."""

    sched: DiffusionSchedule
    eta: float = 1.0
    numerical_fix: bool = True
    carries_history: bool = False

    @property
    def num_inference_steps(self) -> int:
        return self.sched.num_inference_steps

    def init_state(self, like: torch.Tensor, history: Optional[torch.Tensor] = None):
        return ()

    def sample_xts(self, x0: torch.Tensor,
                   noise: Union[torch.Tensor, torch.Generator]) -> torch.Tensor:
        return sample_xts_from_x0(self.sched, x0, noise)

    def scale_input(self, k: int, xt: torch.Tensor) -> torch.Tensor:
        return xt

    def forward_step(self, state, k: int, xt, xtm1_raw, model_output):
        z, xtm1_fix = get_zs_from_xts(
            self.sched, k, xt, xtm1_raw, model_output,
            eta=self.eta, numerical_fix=self.numerical_fix,
        )
        return state, z, xtm1_fix, None

    def reverse_step(self, state, k: int, xt, model_output, z):
        xtm1 = reverse_step_with_custom_noise(
            self.sched, k, model_output, xt, variance_noise=z, eta=self.eta
        )
        return state, xtm1

    # ---- posterior-PC surface ----
    def x0_shift_coeff(self, k: int) -> torch.Tensor:
        """d(x_t)/d(x_0) = sqrt(abar_t): maps an x0-space direction into
        x_t-space."""
        return torch.sqrt(self.sched.step_alpha_prod[k])

    def directional_step(self, state, k: int, inp, noise_pred, z):
        """One guided step from a (possibly shifted) input; returns
        (state, x_{t-1}, x0_pred)."""
        prev, x0_pred = ddim_step(self.sched, k, noise_pred, inp, eta=self.eta,
                                  variance_noise=z)
        return state, prev, x0_pred

    def drift_step(self, state, k: int, xt, xt_m1, x0_pred, shift, z,
                   use_shifted_x0_for_noisepred: bool = True):
        """The step redone with x0_pred shifted by ``shift``: the implied
        epsilon is recovered from (xt_m1, x0_pred), and optionally shifted
        too."""
        sched, eta = self.sched, self.eta
        a_prev = sched.step_alpha_prod_prev[k]
        a_t = sched.step_alpha_prod[k]
        std_dev_t = eta * torch.sqrt(sched.step_variance[k])
        if eta > 0:
            xt_m1 = xt_m1 - std_dev_t * z
        pred_dir = xt_m1 - torch.sqrt(a_prev) * x0_pred
        pred_epsilon = pred_dir / torch.sqrt(1.0 - a_prev - std_dev_t ** 2)
        if use_shifted_x0_for_noisepred:
            pred_epsilon = pred_epsilon - torch.sqrt(a_t) / torch.sqrt(1.0 - a_t) * shift
        pred_dir = torch.sqrt(1.0 - a_prev - std_dev_t ** 2) * pred_epsilon
        xt_m1 = torch.sqrt(a_prev) * (x0_pred + shift) + pred_dir
        if eta > 0:
            xt_m1 = xt_m1 + std_dev_t * z
        return state, xt_m1


@dataclasses.dataclass(frozen=True)
class CosineDPMSolver:
    """SDE-DPM-Solver++ (order 2) numerics: the Stable Audio family."""

    sched: CosineDPMSchedule
    numerical_fix: bool = True
    first_order: bool = False  # force order 1 (the reference's --first_order)
    carries_history: bool = True

    @property
    def num_inference_steps(self) -> int:
        return self.sched.num_inference_steps

    @property
    def _sched(self) -> CosineDPMSchedule:
        if not self.first_order:
            return self.sched
        return dataclasses.replace(
            self.sched, step_first_order=np.ones_like(self.sched.step_first_order))

    def init_state(self, like: torch.Tensor, history: Optional[torch.Tensor] = None):
        return init_solver_state(like, history)

    def sample_xts(self, x0: torch.Tensor,
                   noise: Union[torch.Tensor, torch.Generator]) -> torch.Tensor:
        return sample_xts_from_x0_sigma(self.sched, x0, noise)

    def scale_input(self, k: int, xt: torch.Tensor) -> torch.Tensor:
        return scale_model_input(self.sched, k, xt)

    def forward_step(self, state, k: int, xt, xtm1_raw, model_output):
        return recover_noise(self._sched, state, k, xt, xtm1_raw, model_output,
                             numerical_fix=self.numerical_fix)

    def reverse_step(self, state, k: int, xt, model_output, z):
        return solver_step(self._sched, state, k, model_output, xt, z)

    # ---- posterior-PC surface ----
    def x0_shift_coeff(self, k: int) -> torch.Tensor:
        """EDM parameterisation, x_sigma = x0 + sigma * n: d(x_t)/d(x_0) = 1."""
        return torch.ones((), device=self.sched.sigmas.device)

    def directional_step(self, state, k: int, inp, noise_pred, z):
        """One guided solver step from a (possibly shifted) unscaled input;
        returns (state, x_prev, x0_pred), x0_pred the converted data
        prediction."""
        x0_pred = convert_model_output(self._sched, k, inp, noise_pred)
        state, prev = solver_step_from_x0(self._sched, state, k, x0_pred, inp, z)
        return state, prev, x0_pred

    def drift_step(self, state, k: int, xt, xt_m1, x0_pred, shift, z,
                   use_shifted_x0_for_noisepred: bool = True):
        """The solver update redone from the shifted data prediction. The
        solver consumes x0 directly, so DDIM's option of also shifting the
        implied epsilon has no analogue here."""
        del xt_m1, use_shifted_x0_for_noisepred
        return solver_step_from_x0(self._sched, state, k, x0_pred + shift, xt, z)


def as_solver(sched, eta: float = 1.0, numerical_fix: bool = True):
    """Wrap a DDIM or cosine-DPM schedule; a solver instance passes through
    unchanged (its own eta/numerical_fix win, as in the JAX package)."""
    if isinstance(sched, (DDIMSolver, CosineDPMSolver)):
        return sched
    if isinstance(sched, DiffusionSchedule):
        return DDIMSolver(sched, eta=eta, numerical_fix=numerical_fix)
    if isinstance(sched, CosineDPMSchedule):
        return CosineDPMSolver(sched, numerical_fix=numerical_fix)
    raise TypeError(f"not a schedule or solver: {type(sched).__name__}")
