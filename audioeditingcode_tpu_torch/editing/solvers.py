"""Solver seam driven by the editing loops (eta-DDIM only).

Counterpart of ``audioeditingcode_tpu/editing/solvers.py::DDIMSolver``. The
cosine-DPM solver of the Stable Audio family is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

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

    @property
    def num_inference_steps(self) -> int:
        return self.sched.num_inference_steps

    def init_state(self, like: torch.Tensor, history: Optional[torch.Tensor] = None):
        return ()

    def sample_xts(self, x0: torch.Tensor,
                   noise: Union[torch.Tensor, torch.Generator]) -> torch.Tensor:
        return sample_xts_from_x0(self.sched, x0, noise)

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


def as_solver(sched, eta: float = 1.0, numerical_fix: bool = True) -> DDIMSolver:
    """Wrap a DDIM schedule; a solver instance passes through unchanged (its
    own eta/numerical_fix win, as in the JAX package)."""
    if isinstance(sched, DDIMSolver):
        return sched
    if isinstance(sched, DiffusionSchedule):
        return DDIMSolver(sched, eta=eta, numerical_fix=numerical_fix)
    raise TypeError(f"not a DDIM schedule or solver: {type(sched).__name__}")
