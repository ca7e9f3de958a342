"""Per-sample materials of the volume systems.

Counterpart of ``dreammat_tpu/models/material_simple.py``:

- ``diffuse-with-point-light-material``: Lambert shading from a point
  light, albedo = activation(features[..., :3]). In training the soft
  shading draws the diffuse share ``d`` (``soft_shading``, uniform ()) and
  sets diffuse = d, ambient = 1 - d; the shading mode comes from two
  uniforms (``shading_mode``, [2]): albedo when u0 > ``diffuse_prob``,
  else textureless when u1 < ``textureless_prob``, else shaded; albedo
  throughout the first ``ambient_only_steps`` steps. The mode is picked
  on the device (``torch.where``), with no sync to the host. In
  evaluation: albedo inside the ambient-only window, shaded after.
- ``no-material``: activation(features[..., :n_output_dims]).

A material is called as ``material(features, positions, shading_normal,
light_positions, viewdirs, draws, step, is_train)`` -> rgb per sample.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

import dreammat_tpu_torch
from dreammat_tpu_torch.utils.base import BaseObject
from dreammat_tpu_torch.utils.hw import resolve_device
from dreammat_tpu_torch.utils.ops import get_activation


@dreammat_tpu_torch.register("diffuse-with-point-light-material")
class DiffuseWithPointLightMaterial(BaseObject):
    @dataclass
    class Config:
        ambient_light_color: Tuple[float, float, float] = (0.1, 0.1, 0.1)
        diffuse_light_color: Tuple[float, float, float] = (0.9, 0.9, 0.9)
        ambient_only_steps: int = 1000
        diffuse_prob: float = 0.75
        textureless_prob: float = 0.5
        albedo_activation: str = "sigmoid"
        soft_shading: bool = False

    cfg: Config
    requires_normal: bool = True

    def configure(self, device="cuda") -> None:
        self.device = resolve_device(device)
        self.ambient = torch.tensor(self.cfg.ambient_light_color, dtype=torch.float32,
                                    device=self.device)
        self.diffuse = torch.tensor(self.cfg.diffuse_light_color, dtype=torch.float32,
                                    device=self.device)

    def _albedo(self, features: torch.Tensor) -> torch.Tensor:
        if self.cfg.albedo_activation not in ("sigmoid", "scale_-11_01", "none"):
            raise ValueError(f"unknown albedo activation {self.cfg.albedo_activation}")
        return get_activation(self.cfg.albedo_activation)(features[..., :3])

    def __call__(self, features, positions, shading_normal, light_positions, viewdirs=None,
                 draws=None, step: int = 0, is_train: bool = False) -> torch.Tensor:
        cfg = self.cfg
        albedo = self._albedo(features)
        if is_train and step < cfg.ambient_only_steps:
            return albedo
        if is_train and cfg.soft_shading and draws is not None:
            diffuse = draws.uniform("soft_shading", ()).to(albedo.device).expand(3)
            ambient = 1.0 - diffuse
        else:
            diffuse, ambient = self.diffuse, self.ambient
        ldir = light_positions - positions
        ldir = ldir / (torch.linalg.norm(ldir, dim=-1, keepdim=True) + 1e-8)
        ndotl = torch.clamp(torch.sum(shading_normal * ldir, dim=-1, keepdim=True), min=0.0)
        textureless = ndotl * diffuse + ambient
        shaded = torch.clamp(albedo, 0.0, 1.0) * textureless
        if not is_train:
            return albedo if step < cfg.ambient_only_steps else shaded
        u = (draws.uniform("shading_mode", (2,)).to(albedo.device) if draws is not None
             else torch.zeros(2, device=albedo.device))
        mode = torch.where(u[0] > cfg.diffuse_prob, 0, torch.where(u[1] < cfg.textureless_prob,
                                                                   1, 2))
        return torch.where(mode == 0, albedo,
                           torch.where(mode == 1, textureless.expand_as(shaded), shaded))

    def export(self, features: torch.Tensor):
        return {"albedo": torch.clamp(self._albedo(features), 0.0, 1.0)}


@dreammat_tpu_torch.register("no-material")
class NoMaterial(BaseObject):
    @dataclass
    class Config:
        n_output_dims: int = 3
        color_activation: str = "sigmoid"

    cfg: Config
    requires_normal: bool = False

    def configure(self, device="cuda") -> None:
        self.device = resolve_device(device)
        if self.cfg.color_activation not in ("sigmoid", "scale_-11_01", "none"):
            raise ValueError(f"unknown color activation {self.cfg.color_activation}")

    def __call__(self, features, positions=None, shading_normal=None, light_positions=None,
                 viewdirs=None, draws=None, step: int = 0, is_train: bool = False):
        return get_activation(self.cfg.color_activation)(features[..., :self.cfg.n_output_dims])

    def export(self, features: torch.Tensor):
        return {"albedo": torch.clamp(self(features), 0.0, 1.0)}
