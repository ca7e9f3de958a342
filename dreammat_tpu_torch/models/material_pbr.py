"""PBR split-sum material for the mesh texture stages.

Counterpart of ``pbr-material`` in ``dreammat_tpu/models/material_pbr.py``:
albedo, metallic and roughness (and an optional tangent-space bump) from
the activated features, shaded against one environment map by the Karis
split sum on the port's ``ops/envmap.py``: the diffuse irradiance and the
roughness^2 specular mips (``build_splitsum``) and the analytic FG LUT
(``compute_fg_lut``), both built once at configure. The map is
``environment_texture`` when the file exists, else the procedural sky and
sun, times ``environment_scale``.

    c = albedo D(n) + (F0 s + b) S(2 (n.v) n - v, roughness^2)
    F0 = 0.04 (1 - metallic) + metallic albedo, (s, b) = LUT(n.v, roughness)

(the diffuse term keeps the full albedo, as the reference does). Features:
0:3 albedo, 3 metallic, 4 roughness (each mapped into its range), 5:8 the
bump's tangent-space delta, used when a tangent is given.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch

import dreammat_tpu_torch
from dreammat_tpu_torch.ops import envmap as envmap_lib
from dreammat_tpu_torch.utils.base import BaseObject
from dreammat_tpu_torch.utils.hw import resolve_device


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-8)


@dreammat_tpu_torch.register("pbr-material")
class PBRMaterial(BaseObject):
    @dataclass
    class Config:
        material_activation: str = "sigmoid"
        environment_texture: str = "load/lights/mud_road_puresky_1k.hdr"
        environment_scale: float = 2.0
        min_metallic: float = 0.0
        max_metallic: float = 0.9
        min_roughness: float = 0.08
        max_roughness: float = 0.9
        use_bump: bool = True
        splitsum_base_res: int = 128

    cfg: Config
    requires_normal: bool = True

    def configure(self, device="cuda") -> None:
        cfg = self.cfg
        self.device = resolve_device(device)
        self.requires_tangent = cfg.use_bump
        if os.path.exists(cfg.environment_texture):
            env = envmap_lib.load_envmap_file(cfg.environment_texture)
        else:
            env = envmap_lib.make_procedural_envmap()
        env = torch.as_tensor(env, dtype=torch.float32, device=self.device) \
            * cfg.environment_scale
        self.splitsum = envmap_lib.build_splitsum(env, base_h=cfg.splitsum_base_res,
                                                  base_w=2 * cfg.splitsum_base_res)
        self.fg_lut = envmap_lib.compute_fg_lut(res=256, device=self.device)

    def _decompose(self, features: torch.Tensor):
        cfg = self.cfg
        if cfg.material_activation == "sigmoid":
            mat = torch.sigmoid(features)
        elif cfg.material_activation == "none":
            mat = features
        else:
            raise ValueError(f"unknown material activation {cfg.material_activation}")
        albedo = mat[..., :3]
        metallic = mat[..., 3:4] * (cfg.max_metallic - cfg.min_metallic) + cfg.min_metallic
        roughness = mat[..., 4:5] * (cfg.max_roughness - cfg.min_roughness) + cfg.min_roughness
        return mat, albedo, metallic, roughness

    @staticmethod
    def _perturbation(mat: torch.Tensor) -> torch.Tensor:
        d = mat[..., 5:8] * 2.0 - 1.0
        d = torch.cat([d[..., :2], d[..., 2:] + 1.0], dim=-1)   # + (0, 0, 1)
        return _unit(torch.clamp(d, -1.0, 1.0))

    def _bump(self, mat, shading_normal, tangent):
        p = self._perturbation(mat)
        bitangent = _unit(torch.linalg.cross(tangent, shading_normal, dim=-1))
        n = tangent * p[..., 0:1] - bitangent * p[..., 1:2] + shading_normal * p[..., 2:3]
        return _unit(n)

    def __call__(self, features: torch.Tensor, positions: Optional[torch.Tensor] = None,
                 shading_normal: Optional[torch.Tensor] = None,
                 light_positions: Optional[torch.Tensor] = None,
                 viewdirs: Optional[torch.Tensor] = None, tangent: Optional[torch.Tensor] = None,
                 draws=None, step: int = 0, is_train: bool = False) -> torch.Tensor:
        if viewdirs is None or shading_normal is None:
            raise ValueError("pbr-material needs viewdirs and shading_normal")
        mat, albedo, metallic, roughness = self._decompose(features)
        if self.cfg.use_bump and tangent is not None:
            shading_normal = self._bump(mat, shading_normal, tangent)
        v = -viewdirs
        n_dot_v = torch.sum(shading_normal * v, dim=-1, keepdim=True)
        reflective = n_dot_v * shading_normal * 2.0 - v
        fg = envmap_lib.sample_fg_lut(self.fg_lut, torch.clamp(n_dot_v, 0.0, 1.0),
                                      torch.clamp(roughness, 0.0, 1.0))
        F0 = (1.0 - metallic) * 0.04 + metallic * albedo
        specular_albedo = F0 * fg[..., 0:1] + fg[..., 1:2]
        diffuse_light = envmap_lib.sample_splitsum_diffuse(self.splitsum, shading_normal)
        specular_light = envmap_lib.sample_splitsum_specular(self.splitsum, reflective,
                                                             roughness ** 2)
        return albedo * diffuse_light + specular_albedo * specular_light

    def export(self, features: torch.Tensor):
        mat, albedo, metallic, roughness = self._decompose(features)
        out = {"albedo": albedo, "metallic": metallic, "roughness": roughness}
        if self.cfg.use_bump:
            out["bump"] = (self._perturbation(mat) + 1.0) / 2.0
        return out
