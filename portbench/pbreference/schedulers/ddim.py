"""DDIM/DDPM diffusion numerics as functions on torch tensors.

Counterpart of ``audioeditingcode_tpu/schedulers/ddim.py``. The schedule is
computed once in float64 numpy (identical to the JAX package, so the f32
tables are bit-equal) and kept on the device as per-step tables indexed by
the step *position* k (0 = largest timestep).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DDIMConfig:
    """Static scheduler configuration (HF DDIMScheduler config fields)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.0015
    beta_end: float = 0.0195
    beta_schedule: str = "scaled_linear"  # "linear" | "scaled_linear" | "squaredcos_cap_v2"
    prediction_type: str = "epsilon"  # "epsilon" | "v_prediction"
    set_alpha_to_one: bool = False
    steps_offset: int = 1
    timestep_spacing: str = "leading"  # "leading" | "trailing" | "linspace"


def make_betas(config: DDIMConfig) -> np.ndarray:
    """Beta schedule, identical to diffusers' DDIMScheduler constructor."""
    n = config.num_train_timesteps
    if config.beta_schedule == "linear":
        betas = np.linspace(config.beta_start, config.beta_end, n, dtype=np.float64)
    elif config.beta_schedule == "scaled_linear":
        betas = (
            np.linspace(config.beta_start ** 0.5, config.beta_end ** 0.5, n, dtype=np.float64) ** 2
        )
    elif config.beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

        ts = np.arange(n, dtype=np.float64)
        betas = np.minimum(1.0 - alpha_bar((ts + 1) / n) / alpha_bar(ts / n), 0.999)
    else:
        raise ValueError(f"unknown beta schedule: {config.beta_schedule}")
    return betas.astype(np.float64)


def _make_timesteps(config: DDIMConfig, num_inference_steps: int) -> np.ndarray:
    """Inference timestep grid, descending — diffusers DDIMScheduler.set_timesteps."""
    n = config.num_train_timesteps
    s = num_inference_steps
    if s > n:
        raise ValueError(f"num_inference_steps ({s}) > num_train_timesteps ({n})")
    if config.timestep_spacing == "linspace":
        timesteps = np.linspace(0, n - 1, s).round()[::-1].astype(np.int64)
    elif config.timestep_spacing == "leading":
        step_ratio = n // s
        timesteps = (np.arange(0, s) * step_ratio).round()[::-1].astype(np.int64)
        timesteps = timesteps + config.steps_offset
    elif config.timestep_spacing == "trailing":
        step_ratio = n / s
        timesteps = np.round(np.arange(n, 0, -step_ratio)).astype(np.int64) - 1
    else:
        raise ValueError(f"unknown timestep spacing: {config.timestep_spacing}")
    return timesteps


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed schedule; ``step_*`` tables are indexed by step position."""

    alphas_cumprod: torch.Tensor  # (num_train,)
    timesteps: torch.Tensor  # (S,) int64, descending
    step_alpha_prod: torch.Tensor  # (S,)  alpha_bar[timesteps[k]]
    step_alpha_prod_prev: torch.Tensor  # (S,)  alpha_bar[timesteps[k] - ratio] (or final)
    step_variance: torch.Tensor  # (S,)  DDIM variance at step k
    step_sigma: torch.Tensor  # (S,)  sqrt(1/alpha_bar - 1) at timesteps[k]
    num_train_timesteps: int = 1000
    num_inference_steps: int = 50
    prediction_type: str = "epsilon"

    @property
    def step_ratio(self) -> int:
        return self.num_train_timesteps // self.num_inference_steps


def make_schedule(config: DDIMConfig, num_inference_steps: int,
                  dtype: torch.dtype = torch.float32,
                  device: Union[str, torch.device] = "cpu") -> DiffusionSchedule:
    """Build a :class:`DiffusionSchedule` (diffusers set_timesteps equivalent)."""
    betas = make_betas(config)
    alphas_cumprod = np.cumprod(1.0 - betas)
    final_alpha_cumprod = 1.0 if config.set_alpha_to_one else alphas_cumprod[0]
    timesteps = _make_timesteps(config, num_inference_steps)

    ratio = config.num_train_timesteps // num_inference_steps
    prev_timesteps = timesteps - ratio
    alpha_prod = alphas_cumprod[timesteps]
    alpha_prod_prev = np.where(
        prev_timesteps >= 0,
        alphas_cumprod[np.clip(prev_timesteps, 0, None)],
        final_alpha_cumprod,
    )
    beta_prod = 1.0 - alpha_prod
    beta_prod_prev = 1.0 - alpha_prod_prev
    variance = (beta_prod_prev / beta_prod) * (1.0 - alpha_prod / alpha_prod_prev)
    sigma = np.sqrt(1.0 / alpha_prod - 1.0)

    def t(a, dt=dtype):
        # via an f32 numpy cast, as jnp.asarray(f64, dtype=f32) rounds
        return torch.as_tensor(np.asarray(a, np.float32)).to(device=device, dtype=dt)

    return DiffusionSchedule(
        alphas_cumprod=t(alphas_cumprod),
        timesteps=torch.as_tensor(timesteps, dtype=torch.int64, device=device),
        step_alpha_prod=t(alpha_prod),
        step_alpha_prod_prev=t(alpha_prod_prev),
        step_variance=t(variance),
        step_sigma=t(sigma),
        num_train_timesteps=config.num_train_timesteps,
        num_inference_steps=num_inference_steps,
        prediction_type=config.prediction_type,
    )


def pred_original_sample(sched: DiffusionSchedule, k: int, x, model_output):
    """Predicted x0 from a model output at step position k."""
    a = sched.step_alpha_prod[k]
    if sched.prediction_type == "epsilon":
        return (x - torch.sqrt(1.0 - a) * model_output) / torch.sqrt(a)
    elif sched.prediction_type == "v_prediction":
        return torch.sqrt(a) * x - torch.sqrt(1.0 - a) * model_output
    raise ValueError(sched.prediction_type)


def pred_epsilon(sched: DiffusionSchedule, k: int, x, model_output):
    """Noise direction used for the "direction pointing to x_t" term."""
    a = sched.step_alpha_prod[k]
    if sched.prediction_type == "epsilon":
        return model_output
    elif sched.prediction_type == "v_prediction":
        return torch.sqrt(a) * model_output + torch.sqrt(1.0 - a) * x
    raise ValueError(sched.prediction_type)


def get_variance(sched: DiffusionSchedule, k: int):
    """DDIM posterior variance at step position k."""
    return sched.step_variance[k]


def get_sigma(sched: DiffusionSchedule, k: int):
    """sqrt(1/alpha_bar[t_k] - 1), the noise scale at step position k."""
    return sched.step_sigma[k]


def add_noise(sched: DiffusionSchedule, x0, noise, t):
    """q(x_t | x_0) sample at *train* timestep t (diffusers add_noise)."""
    a = sched.alphas_cumprod[t]
    return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise


def sample_xts_from_x0(
    sched: DiffusionSchedule,
    x0: torch.Tensor,
    noise: Union[torch.Tensor, torch.Generator],
) -> torch.Tensor:
    """Independent q(x_t | x_0) samples for every step (edit-friendly
    inversion): returns xts (S+1, *x0.shape) with xts[0] = x0 and
    xts[S - k] the sample at timesteps[k].

    ``noise`` is either the (S, *x0.shape) standard-normal draw itself (tests
    pass the JAX package's draw) or a ``torch.Generator`` to draw it from.
    """
    S = sched.num_inference_steps
    if isinstance(noise, torch.Generator):
        noise = torch.randn((S,) + tuple(x0.shape), generator=noise,
                            device=x0.device, dtype=x0.dtype)
    elif tuple(noise.shape) != (S,) + tuple(x0.shape):
        raise ValueError(f"noise shape {tuple(noise.shape)} != {(S,) + tuple(x0.shape)}")
    a = sched.step_alpha_prod
    expand = (S,) + (1,) * x0.dim()
    scaled = (torch.sqrt(a).reshape(expand) * x0[None]
              + torch.sqrt(1.0 - a).reshape(expand) * noise)
    return torch.cat([x0[None], torch.flip(scaled, dims=(0,))], dim=0)


def get_zs_from_xts(
    sched: DiffusionSchedule,
    k: int,
    xt: torch.Tensor,
    xtm1: torch.Tensor,
    model_output: torch.Tensor,
    eta: float = 1.0,
    numerical_fix: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recover the noise map z that maps x_t to x_{t-1}; returns
    (z, xtm1 re-projected to mu + std*z when ``numerical_fix``)."""
    a_prev = sched.step_alpha_prod_prev[k]
    variance = sched.step_variance[k]

    x0_pred = pred_original_sample(sched, k, xt, model_output)
    eps = pred_epsilon(sched, k, xt, model_output)

    pred_sample_direction = torch.sqrt(1.0 - a_prev - eta * variance) * eps
    mu_xt = torch.sqrt(a_prev) * x0_pred + pred_sample_direction

    std = eta * torch.sqrt(variance)
    z = (xtm1 - mu_xt) / std
    if numerical_fix:
        xtm1 = mu_xt + std * z
    return z, xtm1


def reverse_step_with_custom_noise(
    sched: DiffusionSchedule,
    k: int,
    model_output: torch.Tensor,
    sample: torch.Tensor,
    variance_noise: Optional[torch.Tensor] = None,
    eta: float = 0.0,
) -> torch.Tensor:
    """One DDIM reverse step x_t -> x_{t-1} with externally supplied noise."""
    a_prev = sched.step_alpha_prod_prev[k]
    variance = sched.step_variance[k]

    x0_pred = pred_original_sample(sched, k, sample, model_output)
    eps = pred_epsilon(sched, k, sample, model_output)

    pred_sample_direction = torch.sqrt(1.0 - a_prev - eta * variance) * eps
    prev_sample = torch.sqrt(a_prev) * x0_pred + pred_sample_direction
    if variance_noise is not None:
        prev_sample = prev_sample + eta * torch.sqrt(variance) * variance_noise
    return prev_sample


def ddim_step(
    sched: DiffusionSchedule,
    k: int,
    model_output: torch.Tensor,
    sample: torch.Tensor,
    eta: float = 0.0,
    variance_noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """diffusers DDIMScheduler.step with std_dev_t = eta * sqrt(variance);
    returns (prev_sample, x0_pred)."""
    a_prev = sched.step_alpha_prod_prev[k]
    std_dev_t = eta * torch.sqrt(sched.step_variance[k])

    x0_pred = pred_original_sample(sched, k, sample, model_output)
    eps = pred_epsilon(sched, k, sample, model_output)

    pred_sample_direction = torch.sqrt(1.0 - a_prev - std_dev_t ** 2) * eps
    prev_sample = torch.sqrt(a_prev) * x0_pred + pred_sample_direction
    if variance_noise is not None:
        prev_sample = prev_sample + std_dev_t * variance_noise
    return prev_sample, x0_pred


def ddim_next_step(sched: DiffusionSchedule, k: int, model_output: torch.Tensor,
                   sample: torch.Tensor) -> torch.Tensor:
    """Deterministic DDIM inversion step at position k: the sample at
    timesteps[k] - ratio up to timesteps[k]. It assumes epsilon prediction,
    as the JAX package and its upstream do, whatever the schedule's
    prediction type."""
    # step_alpha_prod_prev already falls back to final_alpha_cumprod for
    # negative previous timesteps (make_schedule)
    a_t = sched.step_alpha_prod_prev[k]
    a_next = sched.step_alpha_prod[k]
    x0_pred = (sample - torch.sqrt(1.0 - a_t) * model_output) / torch.sqrt(a_t)
    return torch.sqrt(a_next) * x0_pred + torch.sqrt(1.0 - a_next) * model_output
