"""Latent-NeRF system: SDS in Stable Diffusion's latent space over a NeRF volume.

Counterpart of ``latentnerf-system`` in ``dreammat_tpu/systems/latentnerf.py``
on the port's DreamFusion runtime: the field renders 4 latent channels
(``no-material`` with ``n_output_dims`` 4, no activation) and the guidance
takes the rendered image as latents (``rgb_as_latents``: resized to
H // 8, no VAE encode). ``refinement`` renders RGB (3 channels), which the
guidance encodes with the VAE. The background is forced to the render's
channel count. The loss is SDS plus the sparsity, opaque and orient terms
and, with a ``guide_shape`` mesh and ``lambda_shape``, the sketch-shape loss
against the guide baked once on a ``guide_shape_grid_res``^3 lattice on the
device (``ops/shape_loss.py``). Evaluation decodes the latent image through
the VAE at its own size (a 64^2 render decodes to 512^2); without a
guidance it shows clamp(latent[..., :3] / 2 + 1/2).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

import dreammat_tpu_torch
from dreammat_tpu_torch.ops import shape_loss as shape_ops
from dreammat_tpu_torch.systems.dreamfusion import DreamFusion, as_image
from dreammat_tpu_torch.utils.schedule import C


@dreammat_tpu_torch.register("latentnerf-system")
class LatentNeRF(DreamFusion):
    @dataclass
    class Config(DreamFusion.Config):
        material_type: str = "no-material"
        material: dict = field(default_factory=lambda: {
            "n_output_dims": 4, "color_activation": "none"})
        background_type: str = "solid-color-background"
        guide_shape: Optional[str] = None
        guide_shape_grid_res: int = 64
        refinement: bool = False

    cfg: Config

    def configure(self, device="cuda") -> None:
        bg = dict(self.cfg.background or {})
        bg.setdefault("n_output_dims", self.n_render_ch)
        self.cfg.background = bg
        super().configure(device)
        self.shape_grid = None
        if self.cfg.guide_shape is not None:
            from dreammat_tpu_torch.models.mesh import _LOADERS

            ext = os.path.splitext(self.cfg.guide_shape)[1].lower()
            v, f = _LOADERS[ext](self.cfg.guide_shape)[:2]
            self.shape_grid = shape_ops.build_shape_grid(
                v, f, resolution=self.cfg.guide_shape_grid_res, device=self.device)

    @property
    def n_render_ch(self) -> int:
        return 3 if self.cfg.refinement else 4

    def guidance_input(self, out: Dict[str, torch.Tensor], batch: Dict[str, Any]):
        return as_image(out["comp_rgb"], batch), {"rgb_as_latents": not self.cfg.refinement}

    def regularizers(self, out: Dict[str, torch.Tensor], step: int,
                     batch: Optional[Dict[str, Any]] = None):
        """DreamFusion's terms and the sketch-shape loss."""
        loss, metrics = super().regularizers(out, step, batch)
        lam = dict(self.cfg.loss).get("lambda_shape", 0.0)
        if self.shape_grid is not None and lam:
            metrics["loss_shape"] = shape_ops.shape_loss(out["points"], out["density"],
                                                         self.shape_grid)
            loss = loss + C(lam, step) * metrics["loss_shape"]
        return loss, metrics

    @torch.no_grad()
    def eval_out(self, batch: Dict[str, Any], step: int) -> Dict[str, torch.Tensor]:
        out = super().eval_out(batch, step)
        if self.cfg.refinement:
            return out
        if self.guidance is not None:
            lat = out["comp_rgb"].permute(2, 0, 1)[None]
            img = self.guidance.vae.decode(lat).float()[0].permute(1, 2, 0)
            out["comp_rgb"] = torch.clamp(img * 0.5 + 0.5, 0.0, 1.0)
        else:
            out["comp_rgb"] = torch.clamp(out["comp_rgb"][..., :3] * 0.5 + 0.5, 0.0, 1.0)
        return out
