"""DDPM forward-process schedule (SD 2.x: scaled-linear betas 0.00085 ->
0.012 over 1000 steps, epsilon prediction). Counterpart of the parts of
``dreammat_tpu/models/diffusion/scheduler.py`` the CSD loss uses."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012


def make_schedule(cfg: SchedulerConfig = SchedulerConfig(), device="cpu"):
    betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, cfg.num_train_timesteps) ** 2
    alphas_cumprod = np.cumprod(1.0 - betas)
    return {"alphas_cumprod": torch.tensor(alphas_cumprod, dtype=torch.float32, device=device)}


def add_noise(schedule, samples: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """q(x_t | x_0) = sqrt(a_t) x0 + sqrt(1 - a_t) eps; t [B] int."""
    a = schedule["alphas_cumprod"][t]
    shape = (-1,) + (1,) * (samples.ndim - 1)
    return torch.sqrt(a).reshape(shape) * samples + torch.sqrt(1.0 - a).reshape(shape) * noise
