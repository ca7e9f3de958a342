"""DDPM forward process and deterministic DDIM sampling (SD 2.x:
scaled-linear betas 0.00085 -> 0.012 over 1000 steps, epsilon prediction;
DeepFloyd IF: ``squaredcos_cap_v2``, the cosine schedule).
Counterpart of ``dreammat_tpu/models/diffusion/scheduler.py``: the CSD loss
uses ``add_noise``; ControlNet training adds noise and samples its
validation grid with ``ddim_step`` over ``ddim_timesteps``."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dreammat_tpu_torch.utils.hw import resolve_device


@dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # | "squaredcos_cap_v2"


def make_schedule(cfg: SchedulerConfig = SchedulerConfig(), device="cuda"):
    T = cfg.num_train_timesteps
    if cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, T) ** 2
    elif cfg.beta_schedule == "squaredcos_cap_v2":
        # diffusers' betas_for_alpha_bar with the cosine alpha-bar
        abar = lambda s: np.cos((s + 0.008) / 1.008 * np.pi / 2) ** 2
        i = np.arange(T, dtype=np.float64)
        betas = np.minimum(1.0 - abar((i + 1) / T) / abar(i / T), 0.999)
    else:
        raise ValueError(f"unknown beta_schedule {cfg.beta_schedule}")
    alphas_cumprod = np.cumprod(1.0 - betas)
    return {"alphas_cumprod": torch.tensor(alphas_cumprod, dtype=torch.float32,
                                           device=resolve_device(device))}


def _per_sample(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return a.reshape((-1,) + (1,) * (x.ndim - 1))


def add_noise(schedule, samples: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """q(x_t | x_0) = sqrt(a_t) x0 + sqrt(1 - a_t) eps; t [B] int."""
    a = _per_sample(schedule["alphas_cumprod"][t], samples)
    return torch.sqrt(a) * samples + torch.sqrt(1.0 - a) * noise


def pred_x0_from_eps(schedule, x_t: torch.Tensor, eps: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    a = _per_sample(schedule["alphas_cumprod"][t], x_t)
    return (x_t - torch.sqrt(1.0 - a) * eps) / torch.sqrt(a)


def ddim_step(schedule, x_t: torch.Tensor, eps: torch.Tensor, t: torch.Tensor,
              t_prev: torch.Tensor) -> torch.Tensor:
    """One deterministic DDIM step t -> t_prev (eta = 0); t_prev < 0 is the
    final step to x_0 (alpha_prev = 1)."""
    ac = schedule["alphas_cumprod"]
    a_prev = _per_sample(torch.where(t_prev >= 0, ac[torch.clamp(t_prev, min=0)],
                                     torch.ones_like(ac[t])), x_t)
    x0 = pred_x0_from_eps(schedule, x_t, eps, t)
    return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps


def ddim_timesteps(num_train_timesteps: int, num_inference_steps: int) -> np.ndarray:
    """Descending timestep sequence for DDIM sampling."""
    step = num_train_timesteps // num_inference_steps
    return (np.arange(0, num_inference_steps) * step).round()[::-1].astype(np.int64)
