"""TextMesh system: SDS over an implicit SDF rendered by NeuS.

Counterpart of ``textmesh-system`` in ``dreammat_tpu/systems/textmesh.py``
on the port's DreamFusion runtime: an ``implicit-sdf`` geometry, the
``neus-volume-renderer``, the diffuse point-light material and the neural
environment-map background, trained by SDS with the orient, sparsity and
opaque terms and the eikonal loss on the raw SDF gradient,
mean((|sdf_grad| - 1)^2), each weighted by its scheduled ``lambda_*``.
NeuS's learned variance sits in the optimized scene (``SDFScene.var``);
``init_state`` runs the geometry's shape init (``shape_init`` draws) before
the first occupancy refresh. The export is the SDF's level set at
``isosurface_threshold`` (0).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

import dreammat_tpu_torch
from dreammat_tpu_torch.systems.dreamfusion import DreamFusion, VolumeScene
from dreammat_tpu_torch.systems.optimizers import parse_optimizer
from dreammat_tpu_torch.utils.rng import TorchDraws
from dreammat_tpu_torch.utils.schedule import C


class SDFScene(VolumeScene):
    """A ``VolumeScene`` with NeuS's ``LearnedVariance`` as ``var``."""

    def __init__(self, geo: nn.Module, bg: nn.Module, occ: torch.Tensor, var: nn.Module):
        super().__init__(geo, bg, occ)
        self.var = var


@dreammat_tpu_torch.register("textmesh-system")
class TextMesh(DreamFusion):
    @dataclass
    class Config(DreamFusion.Config):
        geometry_type: str = "implicit-sdf"
        renderer_type: str = "neus-volume-renderer"
        loss: dict = field(default_factory=lambda: {
            "lambda_sds": 1.0, "lambda_orient": [0, 10.0, 1000.0, 5000],
            "lambda_sparsity": 1.0, "lambda_opaque": 0.0, "lambda_eikonal": 100.0})

    cfg: Config

    def init_state(self, seed: int = 0) -> None:
        """A fresh scene: the field after its shape init, the background, the
        variance and the grid after its first refresh; its optimizer."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        geo = self.geometry.initialize_shape(self.geometry.init(gen),
                                             TorchDraws(seed + 4, self.device))
        bg = self.background.init(gen)
        occ = self.renderer.update_occ(geo, self.renderer.init_state(),
                                       TorchDraws(seed + 3, self.device))
        self.field = SDFScene(geo, bg, occ, self.renderer.init_variance())
        self.optimizer = parse_optimizer(self.cfg.optimizer, self.field.parameters())
        self.global_step = 0

    def render_batch(self, batch: Dict[str, Any], draws, is_train: bool, **kw):
        return super().render_batch(batch, draws, is_train, var=self.field.var, **kw)

    def regularizers(self, out: Dict[str, torch.Tensor], step: int,
                     batch: Optional[Dict[str, Any]] = None):
        """DreamFusion's terms and the eikonal loss."""
        loss, metrics = super().regularizers(out, step, batch)
        metrics["loss_eikonal"] = torch.mean(
            (torch.linalg.norm(out["sdf_grad"], dim=-1) - 1.0) ** 2)
        loss = loss + C(dict(self.cfg.loss).get("lambda_eikonal", 0.0), step) \
            * metrics["loss_eikonal"]
        return loss, metrics

    def eval_out(self, batch: Dict[str, Any], step: int) -> Dict[str, torch.Tensor]:
        f = self.field
        return self.renderer.render_image(f.geo, f.bg, f.occ, batch["rays_o"], batch["rays_d"],
                                          batch["light_position"], TorchDraws(0, self.device),
                                          step=step, var=f.var)
