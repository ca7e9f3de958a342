"""DreamMat PBR material, tables regime.

Counterpart of ``dreammat_tpu/models/material.py`` for the default regime:
raw field features -> albedo / metallic / squared roughness
(``features_to_material``), the jitter smoothness loss
(``material_smoothness_grad``), and the visibility-aware split-sum shading
from the prerendered per-vertex light tables (``shade_prefiltered``). The
Monte-Carlo estimators (``shade_raytracing``) are the next slice: without a
light table the material raises.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

import dreammat_tpu_torch
from dreammat_tpu_torch.ops import envmap as envmap_lib
from dreammat_tpu_torch.utils import ops as uops
from dreammat_tpu_torch.utils.base import BaseObject
from dreammat_tpu_torch.utils.hw import resolve_device


def material_smoothness_grad(material: torch.Tensor, material_jitter: torch.Tensor) -> torch.Tensor:
    """Jitter-difference smoothness loss."""
    lambda_kd, lambda_ks = 0.25, 0.1
    kd_grad = (material[..., :3] - material_jitter[..., :3]).abs()
    ks_grad = (material[..., 3:5] - material_jitter[..., 3:5]).abs()
    kd_luma = (kd_grad[..., 0] + kd_grad[..., 1] + kd_grad[..., 2]) / 3.0
    loss = torch.mean(kd_luma * kd_grad[..., -1]) * lambda_kd
    return loss + torch.mean(ks_grad[..., :-1] * ks_grad[..., -1:]) * lambda_ks


def distribution_ggx(NoH, roughness_sq):
    """GGX NDF; ``roughness_sq`` is alpha (the field predicts r^2)."""
    a2 = roughness_sq ** 2
    denom = NoH ** 2 * (a2 - 1.0) + 1.0
    return a2 / (math.pi * denom ** 2 + 1e-4)


@dreammat_tpu_torch.register("dreammat-material")
class DreamMatMaterial(BaseObject):
    @dataclass
    class Config:
        material_activation: str = "sigmoid"
        environment_texture: str = "load/lights/envmap"
        environment_scale: float = 1.0
        n_environments: int = 5
        env_height: int = 256
        env_width: int = 512
        min_metallic: float = 0.0
        max_metallic: float = 0.9
        min_roughness_squre: float = 0.01
        max_roughness_squre: float = 0.9
        min_roughness: float = 0.1
        max_roughness: float = 0.95
        use_bump: bool = False
        splitsum_height: int = 128
        splitsum_width: int = 256
        diffuse_sample_num: int = 512
        specular_sample_num: int = 256
        geometry_type: str = "schlick"
        random_azimuth: bool = True
        use_raytracing: bool = True
        shading_chunk: int = 0
        use_prefiltered: bool = False

    cfg: Config

    def configure(self, device="cuda") -> None:
        cfg = self.cfg
        self.device = resolve_device(device)
        envs = []
        for i in range(cfg.n_environments):
            idx = str(i + 1)
            for ext in (".exr", ".hdr"):
                if os.path.exists(os.path.join(cfg.environment_texture, f"map{idx}", f"map{idx}{ext}")):
                    raise NotImplementedError(
                        "HDR environment files: only the procedural skies are ported so far")
            sky = envmap_lib.make_procedural_envmap(
                cfg.env_height, cfg.env_width,
                sun_dir=np.array([np.cos(i * 2.2), np.sin(i * 2.2), 0.6 + 0.1 * (i % 3)]),
                sun_intensity=10.0 + 5.0 * i, seed=i,
            )
            sky = envmap_lib.resize_envmap(torch.as_tensor(sky), cfg.env_height, cfg.env_width)
            envs.append(sky * cfg.environment_scale)
        self.envs = torch.stack(envs).to(self.device)  # [E,H,W,3]
        self.baked_visibility = None
        self.fg_lut = envmap_lib.compute_fg_lut(device=self.device) if cfg.use_prefiltered else None

    def set_baked_visibility(self, baked) -> None:
        self.baked_visibility = baked

    def features_to_material(self, features):
        act = uops.get_activation(self.cfg.material_activation)
        material = act(features)
        albedo = torch.clamp(material[..., :3], 0.0, 1.0)
        metallic = material[..., 3:4] * (self.cfg.max_metallic - self.cfg.min_metallic) \
            + self.cfg.min_metallic
        roughness_sq = material[..., 4:5] * (
            self.cfg.max_roughness_squre - self.cfg.min_roughness_squre) \
            + self.cfg.min_roughness_squre
        return material, albedo, metallic, roughness_sq

    def shade_prefiltered(self, normals, view_dirs, metallic, roughness_sq, albedo,
                          light_table, vis_data=None) -> Dict[str, torch.Tensor]:
        """color = albedo * E_d + (F0 * fgA + fgB) * S(roughness), from the
        per-vertex table ``light_table`` [V, 1+K, 3] mixed barycentrically
        per pixel (``vis_data=(tri, bary)``), or a per-pixel table [P,1+K,3]."""
        from dreammat_tpu_torch.data.prerender import TABLE_ALPHAS

        if self.fg_lut is None:
            raise RuntimeError("shade_prefiltered needs cfg.use_prefiltered=true")
        levels = torch.tensor(TABLE_ALPHAS, dtype=torch.float32, device=normals.device)
        K = levels.shape[0]
        if vis_data is not None:
            tri, bary = vis_data
            flat = light_table.reshape(light_table.shape[0], -1).float()
            rows = (bary[:, 0:1] * flat[tri[:, 0]] + bary[:, 1:2] * flat[tri[:, 1]]
                    + bary[:, 2:3] * flat[tri[:, 2]])
            light_table = rows.reshape(tri.shape[0], 1 + K, 3)
        E_d = light_table[:, 0].float()
        S = light_table[:, 1:].float()  # [P,K,3]
        r = torch.clamp(roughness_sq[:, 0], float(levels[0]), float(levels[-1]))
        idx = torch.clamp(torch.searchsorted(levels, r.contiguous(), right=True) - 1, 0, K - 2)
        lo, hi = levels[idx], levels[idx + 1]
        w = ((r - lo) / (hi - lo + 1e-9))[:, None]
        S_lo = S.gather(1, idx[:, None, None].expand(-1, 1, 3))[:, 0]
        S_hi = S.gather(1, (idx + 1)[:, None, None].expand(-1, 1, 3))[:, 0]
        S_r = S_lo * (1 - w) + S_hi * w
        NoV = uops.saturate_dot(normals, view_dirs)
        fg = envmap_lib.sample_fg_lut(
            self.fg_lut, torch.clamp(NoV, 0.0, 1.0),
            torch.sqrt(torch.clamp(roughness_sq, 0.0, 1.0)),
        )
        F0 = 0.04 * (1.0 - metallic) + metallic * albedo
        specular_colors = (F0 * fg[..., 0:1] + fg[..., 1:2]) * S_r
        diffuse_colors = albedo * E_d
        return {
            "color": uops.lin2srgb(diffuse_colors + specular_colors),
            "albedo": uops.lin2srgb(albedo.detach()),
            "roughness": torch.sqrt(roughness_sq + 1e-7),
            "metalness": metallic,
            "specular_light": uops.lin2srgb(S_r.detach()),
            "diffuse_light": uops.lin2srgb(E_d.detach()),
            "specular_color": uops.lin2srgb(specular_colors.detach()),
            "diffuse_color": uops.lin2srgb(diffuse_colors.detach()),
        }

    def __call__(self, pts, features, features_jitter, viewdirs, normals, env_id,
                 is_train: bool = True, mask=None, vis_data=None, light_table=None):
        """Shade a fixed-size pixel batch; returns (outputs, mat_reg_loss)."""
        material, albedo, metallic, roughness_sq = self.features_to_material(features)
        material_j = self.features_to_material(features_jitter)[0]
        mat_reg = material_smoothness_grad(material, material_j)
        if not self.cfg.use_raytracing:
            raise NotImplementedError("the split-sum environment path is not ported yet")
        if not (self.cfg.use_prefiltered and light_table is not None):
            raise NotImplementedError(
                "the Monte-Carlo estimators (shade_raytracing) are the next slice of the "
                "port; this slice shades only from prefiltered light tables")
        out = self.shade_prefiltered(normals, viewdirs, metallic, roughness_sq, albedo,
                                     light_table, vis_data=vis_data)
        return out, mat_reg
