"""Cosine DPM-Solver++ (2nd-order SDE) numerics for the Stable Audio family.

Counterpart of ``audioeditingcode_tpu/schedulers/cosine_dpm.py``. The sigma
grid is computed in float64 numpy and rounded to float32 once, as in the JAX
package, so the tables are bit-equal. The step k is a Python int here (the
editing loops are Python loops), so the per-step scalars (h, e^{-h}, the
order and zero-noise flags) are computed on the host in float32 from the
host copy of the table, and only tensor math runs on the device.

Every update computes in float32 whatever the latent's dtype: a bf16 latent
times an f32 sigma is f32 in JAX, while torch would keep it bf16, so inputs
are cast explicitly (``_f32``) and the solver state is created in the
promoted dtype (JAX 18a9e89).

Math (alpha_t == 1; sigma-space):
  x_t = x_0 + sigma_t * n
  c_in = 1 / sqrt(sigma^2 + sd^2), c_skip = sd^2 / (sigma^2 + sd^2),
  c_out = -sigma * sd / sqrt(sigma^2 + sd^2) (v-prediction; epsilon flips it)
  1st order: x_t = (sigma_t/sigma_s) e^{-h} x_s + (1 - e^{-2h}) D0
                   + sigma_t sqrt(1 - e^{-2h}) z,  h = log sigma_s - log sigma_t
  2nd order adds 0.5 (1 - e^{-2h}) (m0 - m1) / r0,  r0 = h_0 / h
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

_F32 = np.float32


@dataclasses.dataclass(frozen=True)
class CosineDPMConfig:
    """HF CosineDPMSolverMultistepScheduler fields (stable-audio-open-1.0's
    scheduler/scheduler_config.json)."""

    sigma_min: float = 0.3
    sigma_max: float = 500.0
    sigma_data: float = 1.0
    sigma_schedule: str = "exponential"  # "exponential" | "karras"
    rho: float = 7.0
    solver_order: int = 2
    prediction_type: str = "v_prediction"  # "v_prediction" | "epsilon"
    lower_order_final: bool = True
    euler_at_final: bool = False
    final_sigmas_type: str = "zero"  # "zero" | "sigma_min"
    num_train_timesteps: int = 1000


@dataclasses.dataclass(frozen=True)
class CosineDPMSchedule:
    """Solver schedule for S steps: ``sigmas`` (S+1,) with the final entry 0
    for final_sigmas_type='zero', ``timesteps[k] = atan(sigmas[k]) * 2/pi``
    (the DiT's continuous time), and per-step static flags."""

    sigmas: torch.Tensor  # (S+1,) float32, on the device
    timesteps: torch.Tensor  # (S,) float32, on the device
    step_first_order: np.ndarray  # (S,) bool: step forced to first order
    step_zero_noise: np.ndarray  # (S,) bool: z forced to 0 (sigma_t == 0)
    sigmas_host: np.ndarray  # (S+1,) float32 copy of ``sigmas`` for the scalars
    sigma_data: float = 1.0
    prediction_type: str = "v_prediction"
    solver_order: int = 2
    num_inference_steps: int = 100


def make_cosine_dpm_schedule(config: CosineDPMConfig, num_inference_steps: int,
                             device: Union[str, torch.device] = "cpu") -> CosineDPMSchedule:
    """set_timesteps equivalent: the sigma grid and the static order flags."""
    S = num_inference_steps
    if config.sigma_schedule == "exponential":
        sigmas = np.exp(np.linspace(np.log(config.sigma_max), np.log(config.sigma_min), S))
    elif config.sigma_schedule == "karras":
        ramp = np.linspace(0.0, 1.0, S)
        rho = config.rho
        min_inv, max_inv = config.sigma_min ** (1 / rho), config.sigma_max ** (1 / rho)
        sigmas = (max_inv + ramp * (min_inv - max_inv)) ** rho
    else:
        raise ValueError(f"unknown sigma schedule: {config.sigma_schedule}")
    timesteps = np.arctan(sigmas) / np.pi * 2.0

    if config.final_sigmas_type == "zero":
        sigma_last = 0.0
    elif config.final_sigmas_type == "sigma_min":
        sigma_last = sigmas[-1]
    else:
        raise ValueError(config.final_sigmas_type)
    sigmas = np.concatenate([sigmas, [sigma_last]])

    k = np.arange(S)
    lower_order_final = (k == S - 1) & (
        config.euler_at_final
        or (config.lower_order_final and S < 15)
        or config.final_sigmas_type == "zero"
    )
    sigmas32 = sigmas.astype(_F32)
    return CosineDPMSchedule(
        sigmas=torch.as_tensor(sigmas32, device=device),
        timesteps=torch.as_tensor(timesteps.astype(_F32), device=device),
        step_first_order=lower_order_final | (config.solver_order == 1),
        step_zero_noise=(k == S - 1) & (config.final_sigmas_type == "zero"),
        sigmas_host=sigmas32,
        sigma_data=config.sigma_data,
        prediction_type=config.prediction_type,
        solver_order=config.solver_order,
        num_inference_steps=S,
    )


def _f32(x: torch.Tensor) -> torch.Tensor:
    """Solver math runs in the promotion of the input with float32."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


# ---------------------------------------------------------------------------
# Preconditioning (EDM c_in / c_skip / c_out)
# ---------------------------------------------------------------------------


def scale_model_input(sched: CosineDPMSchedule, k: int, sample: torch.Tensor) -> torch.Tensor:
    """c_in * sample: what the DiT consumes."""
    sigma = sched.sigmas_host[k]
    return _f32(sample) / float(np.sqrt(sigma ** 2 + _F32(sched.sigma_data ** 2)))


def convert_model_output(sched: CosineDPMSchedule, k: int, sample: torch.Tensor,
                         model_output: torch.Tensor) -> torch.Tensor:
    """Raw DiT output -> denoised x0 prediction; ``sample`` is the unscaled
    latent."""
    sigma = sched.sigmas_host[k]
    sd = _F32(sched.sigma_data)
    c_skip = sd ** 2 / (sigma ** 2 + sd ** 2)
    c_out = sigma * sd / np.sqrt(sigma ** 2 + sd ** 2)
    if sched.prediction_type == "v_prediction":
        c_out = -c_out
    elif sched.prediction_type != "epsilon":
        raise ValueError(sched.prediction_type)
    return float(c_skip) * _f32(sample) + float(c_out) * _f32(model_output)


# ---------------------------------------------------------------------------
# Solver state + updates
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SolverState:
    """Multistep history: the previous step's converted model output m1 and
    whether it is valid."""

    m1: torch.Tensor
    m1_valid: bool


def init_solver_state(like: torch.Tensor, m1: Optional[torch.Tensor] = None) -> SolverState:
    """Fresh state, or warm state from the forward pass's history. The state
    lives in solver space, the promotion of the latent's dtype with float32
    (a bf16 latent gets an f32 state)."""
    dtype = torch.promote_types(like.dtype, torch.float32)
    if m1 is None:
        return SolverState(m1=torch.zeros_like(like, dtype=dtype), m1_valid=False)
    return SolverState(m1=m1.to(dtype), m1_valid=True)


@dataclasses.dataclass(frozen=True)
class _StepScalars:
    zero_t: bool  # sigma_t == 0 (the final step)
    ratio: float  # (sigma_t / sigma_s0) e^{-h}
    one_m: float  # 1 - e^{-2h}
    noise_coef: float  # sigma_t sqrt(|1 - e^{-2h}|)
    r0: float  # h_0 / h (1 where h == 0)


def _scalars(sched: CosineDPMSchedule, k: int) -> _StepScalars:
    """The step's float32 scalars; sigma indices t = k+1, s0 = k, s1 = k-1
    (clamped). At sigma_t == 0, h is infinite: ratio, one_m and noise_coef
    take their limits 0, 1 and 0, as in the JAX package."""
    s = sched.sigmas_host
    sigma_t, sigma_s0, sigma_s1 = s[k + 1], s[k], s[max(k - 1, 0)]
    zero_t = bool(sigma_t <= 0)
    sigma_t_safe = _F32(1.0) if zero_t else sigma_t
    h = np.log(sigma_s0) - np.log(sigma_t_safe)
    one_m = _F32(1.0) - np.exp(_F32(-2.0) * h)
    h0 = np.log(sigma_s1) - np.log(sigma_s0)
    return _StepScalars(
        zero_t=zero_t,
        ratio=0.0 if zero_t else float((sigma_t_safe / sigma_s0) * np.exp(-h)),
        one_m=1.0 if zero_t else float(one_m),
        noise_coef=0.0 if zero_t else float(sigma_t_safe * np.sqrt(np.abs(one_m))),
        r0=1.0 if h == 0 else float(h0 / h),
    )


def _updates(sched: CosineDPMSchedule, k: int, sample, m0, m1, noise,
             use_first: bool) -> torch.Tensor:
    """The first- or second-order update at step k (the JAX package computes
    both and selects; the selected one is computed the same way here)."""
    c = _scalars(sched, k)
    x = c.ratio * _f32(sample) + c.one_m * m0 + c.noise_coef * _f32(noise)
    if use_first:
        return x
    d1 = torch.zeros_like(m0) if c.r0 == 0.0 else (m0 - m1) / c.r0
    return x + (0.5 * c.one_m) * d1


def _use_first(sched: CosineDPMSchedule, state: SolverState, k: int) -> bool:
    return bool(sched.step_first_order[k]) or not state.m1_valid


def solver_step_from_x0(sched: CosineDPMSchedule, state: SolverState, k: int,
                        m0: torch.Tensor, sample: torch.Tensor,
                        noise: torch.Tensor) -> Tuple[SolverState, torch.Tensor]:
    """One SDE-DPM-Solver++ step from an already converted x0 prediction."""
    if sched.step_zero_noise[k]:
        noise = torch.zeros_like(noise)
    prev = _updates(sched, k, sample, m0, state.m1, noise, _use_first(sched, state, k))
    return SolverState(m1=m0, m1_valid=True), prev


def solver_step(sched: CosineDPMSchedule, state: SolverState, k: int,
                model_output: torch.Tensor, sample: torch.Tensor,
                noise: torch.Tensor) -> Tuple[SolverState, torch.Tensor]:
    """One step x_k -> x_{k+1} with external noise (raw model output in)."""
    m0 = convert_model_output(sched, k, sample, model_output)
    return solver_step_from_x0(sched, state, k, m0, sample, noise)


def recover_noise(sched: CosineDPMSchedule, state: SolverState, k: int,
                  xt: torch.Tensor, xtm1: torch.Tensor, model_output: torch.Tensor,
                  numerical_fix: bool = True):
    """Solve the update for the noise z mapping x_k to the target x_{k+1}.

    Returns (state', z, xtm1_fixed, extra), where extra is the previous
    converted output (state.m1), the reverse pass's warm history."""
    m0 = convert_model_output(sched, k, xt, model_output)
    m1 = state.m1
    c = _scalars(sched, k)
    use_first = _use_first(sched, state, k)
    if c.zero_t:
        z = torch.zeros_like(m0)
    else:
        rhs = _f32(xtm1) - c.ratio * _f32(xt) - c.one_m * m0
        if not use_first:
            rhs = rhs - (0.5 * c.one_m) * ((m0 - m1) / (1.0 if c.r0 == 0.0 else c.r0))
        z = rhs / c.noise_coef
    if numerical_fix:
        xtm1 = _updates(sched, k, xt, m0, m1, z, use_first)
    return SolverState(m1=m0, m1_valid=True), z, xtm1, m1


# ---------------------------------------------------------------------------
# Trajectory sampling
# ---------------------------------------------------------------------------


def sample_xts_from_x0_sigma(sched: CosineDPMSchedule, x0: torch.Tensor,
                             noise: Union[torch.Tensor, torch.Generator]) -> torch.Tensor:
    """Independent q(x_t | x_0) samples, x_t = x_0 + sigma_t * n, as one
    (S+1, *x0.shape) float32 tensor: xts[S - k] is the sample at sigmas[k]
    and xts[0] = x0.

    ``noise`` is the (S, *x0.shape) draw, or a generator to draw it from in
    x0's dtype (as the JAX package draws it)."""
    S = sched.num_inference_steps
    if isinstance(noise, torch.Generator):
        noise = torch.randn((S,) + tuple(x0.shape), generator=noise,
                            device=x0.device, dtype=x0.dtype)
    elif tuple(noise.shape) != (S,) + tuple(x0.shape):
        raise ValueError(f"noise shape {tuple(noise.shape)} != {(S,) + tuple(x0.shape)}")
    x0 = _f32(x0)
    expand = (S,) + (1,) * x0.dim()
    scaled = x0[None] + sched.sigmas[:S].reshape(expand) * _f32(noise)
    return torch.cat([x0[None], torch.flip(scaled, dims=(0,))], dim=0)
