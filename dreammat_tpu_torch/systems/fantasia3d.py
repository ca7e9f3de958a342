"""Fantasia3D system: geometry sculpting and texture painting by SDS over a
DMTet mesh.

Counterpart of ``fantasia3d-system`` in ``dreammat_tpu/systems/fantasia3d.py``
on the DreamFusion runtime: a ``tetrahedra-sdf-grid`` geometry, the
``nvdiff-rasterizer`` renderer, ``no-material`` and the solid-colour
background by default.

- Geometry stage (``texture: false``): the rasterizer renders no colour;
  for the first ``latent_steps`` steps ``[comp_normal * 2 - 1, opacity]``
  goes to the guidance as latents (``rgb_as_latents``), then the normal
  image goes through the VAE. The JAX step traces both guidance calls and
  blends them by a 0/1 weight; this one runs the branch the step picks,
  which gives the same loss and gradient. Plus ``normal_consistency`` over
  the soup, weighted by ``lambda_normal_consistency``.
- Texture stage (``texture: true``): SDS on ``comp_rgb``; the geometry is
  fixed (``fix_geometry``: no deformation, no gradient to the SDF).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import torch

import dreammat_tpu_torch
from dreammat_tpu_torch.systems.dreamfusion import DreamFusion, as_image


@dreammat_tpu_torch.register("fantasia3d-system")
class Fantasia3D(DreamFusion):
    @dataclass
    class Config(DreamFusion.Config):
        geometry_type: str = "tetrahedra-sdf-grid"
        renderer_type: str = "nvdiff-rasterizer"
        material_type: str = "no-material"
        background_type: str = "solid-color-background"
        latent_steps: int = 1000
        texture: bool = False
        loss: dict = field(default_factory=lambda: {
            "lambda_sds": 1.0, "lambda_normal_consistency": 10000.0})

    cfg: Config

    def configure(self, device="cuda") -> None:
        super().configure(device)
        if self.cfg.texture:
            self.geometry.cfg.fix_geometry = True

    def train_render_kw(self) -> Dict[str, Any]:
        return {"render_rgb": self.cfg.texture}

    def guidance_input(self, out: Dict[str, torch.Tensor], batch: Dict[str, Any]):
        if self.cfg.texture:
            return as_image(out["comp_rgb"], batch), {}
        if self.global_step < self.cfg.latent_steps:
            lat = torch.cat([out["comp_normal"] * 2.0 - 1.0, out["opacity"]], dim=-1)
            return as_image(lat, batch), {"rgb_as_latents": True}
        return as_image(out["comp_normal"], batch), {}

    def regularizers(self, out: Dict[str, torch.Tensor], step: int, batch=None):
        return (0.0, {}) if self.cfg.texture else self.mesh_regularizers(out, step)
