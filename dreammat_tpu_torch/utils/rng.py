"""The random draws of a train step, by name.

The step draws: the jitter offsets of the smoothness query points
(``jitter_angle`` uniform and ``jitter_eps`` normal, each [P,1]), on a
Monte-Carlo step the per-pixel azimuth rotations of the diffuse and the
specular direction sets (``mc_rot_diffuse`` and ``mc_rot_specular``,
uniform [P,1] each, drawn before any direction is formed), the VAE
posterior noise (``vae_eps``, normal, latent shape), the timestep (``t``,
uniform [B]) and the latent noise (``noise``, normal, latent shape). The
fast-path gate draws its gradient weights once (``gate_w``, uniform
[pixels, 3]). A volume system's step draws its stratified samples
(``ray_strat`` [N,S]; ``ray_coarse`` [N,Sc] and ``ray_importance`` [N,S]
with the importance estimator), the material's soft-shading share
(``soft_shading`` ()) and shading mode (``shading_mode`` [2]), the
occupancy refresh's jitter (``occ_jitter`` [G^3,3]), all uniform, and the
VSD guidance's regression timestep (``t2``, integers in [0, T)), noise
(``noise2``, normal) and camera drop (``camera_drop``, uniform [B,1]).
JAX's threefry and torch's Philox give different numbers from one seed,
so a test hands the port the reference's draws through its own object
with the same three methods.
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

    def integers(self, name: str, low: int, high: int, shape) -> torch.Tensor:
        """int64 uniform in [low, high)."""
        return torch.randint(low, high, shape, generator=self.generator, device=self.device)
