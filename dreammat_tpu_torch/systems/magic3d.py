"""Magic3D system: a coarse NeRF stage and a DMTet refinement stage.

Counterpart of ``magic3d-system`` in ``dreammat_tpu/systems/magic3d.py``:

- coarse (``refinement: false``): DreamFusion's step (SDS and the orient,
  sparsity and opaque losses over a NeRF volume) with Magic3D's defaults:
  the point-light material's soft shading, ambient only for 2001 steps;
- refinement (``refinement: true``): an ``implicit-volume`` geometry
  becomes ``tetrahedra-sdf-grid`` and the ``nerf-volume-renderer`` becomes
  ``nvdiff-rasterizer`` (types set otherwise stay); the loss is SDS on
  ``comp_rgb`` plus ``normal_consistency`` of the soup. Like the JAX
  package, the stage starts from the geometry's ``shape_init`` (no
  hand-over from a coarse checkpoint).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import torch

import dreammat_tpu_torch
from dreammat_tpu_torch.systems.dreamfusion import DreamFusion


def switch_to_dmtet(cfg) -> None:
    """The refinement stages' types: DMTet and the rasterizer in place of
    the implicit volume and the volume renderer."""
    if cfg.geometry_type == "implicit-volume":
        cfg.geometry_type = "tetrahedra-sdf-grid"
    if cfg.renderer_type == "nerf-volume-renderer":
        cfg.renderer_type = "nvdiff-rasterizer"


@dreammat_tpu_torch.register("magic3d-system")
class Magic3D(DreamFusion):
    @dataclass
    class Config(DreamFusion.Config):
        refinement: bool = False
        material: dict = field(default_factory=lambda: {
            "ambient_only_steps": 2001, "soft_shading": True})
        loss: dict = field(default_factory=lambda: {
            "lambda_sds": 1.0, "lambda_orient": [0, 10.0, 1000.0, 5000],
            "lambda_sparsity": 1.0, "lambda_opaque": 0.0,
            "lambda_normal_consistency": 1000.0})

    cfg: Config

    def configure(self, device="cuda") -> None:
        if self.cfg.refinement:
            switch_to_dmtet(self.cfg)
        super().configure(device)

    def train_render_kw(self) -> Dict[str, Any]:
        return {"render_rgb": True} if self.cfg.refinement else {}

    def regularizers(self, out: Dict[str, torch.Tensor], step: int, batch=None):
        if self.cfg.refinement:
            return self.mesh_regularizers(out, step)
        return super().regularizers(out, step)
