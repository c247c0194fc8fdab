"""Solver seam driven by the editing loops: one interface, two numerics.

Counterpart of ``audioeditingcode_tpu/editing/solvers.py``:
  - ``init_state(like, history)``                 multistep history
  - ``sample_xts(x0, noise)``                     independent q(x_t | x_0) draw
  - ``scale_input(k, xt)``                        what the denoiser consumes
  - ``forward_step(state, k, xt, xtm1, out)``     noise-map recovery (+ fix)
  - ``reverse_step(state, k, xt, out, z)``        custom-noise reverse update

``DDIMSolver`` is stateless. ``CosineDPMSolver`` carries the previous
converted model output, the 2nd-order history of the Stable Audio family.
The posterior-PC surface (``x0_shift_coeff``, ``directional_step``,
``drift_step``) is not ported yet (ROADMAP Queue A item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..schedulers.cosine_dpm import (
    CosineDPMSchedule,
    init_solver_state,
    recover_noise,
    sample_xts_from_x0_sigma,
    scale_model_input,
    solver_step,
)
from ..schedulers.ddim import (
    DiffusionSchedule,
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
