"""The random draws of a train step, by name.

The step draws: the jitter offsets of the smoothness query points
(``jitter_angle`` uniform and ``jitter_eps`` normal, each [P,1]), the VAE
posterior noise (``vae_eps``, normal, latent shape), the timestep
(``t``, uniform [B]) and the latent noise (``noise``, normal, latent
shape). JAX's threefry and torch's Philox give different numbers from one
seed, so a test hands the port the reference's draws through its own object
with the same two methods.
"""

from __future__ import annotations

import torch


class TorchDraws:
    """Draws from one ``torch.Generator`` on ``device``."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.step = 0  # set by the training loop; unused here

    def uniform(self, name: str, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, device=self.device)

    def normal(self, name: str, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=self.device)
