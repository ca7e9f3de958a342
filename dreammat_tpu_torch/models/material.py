"""DreamMat PBR material: prefiltered tables and Monte-Carlo Cook-Torrance.

Counterpart of ``dreammat_tpu/models/material.py``: raw field features ->
albedo / metallic / squared roughness (``features_to_material``), the
jitter smoothness loss (``material_smoothness_grad``), the visibility-aware
split-sum shading from the prerendered light tables (``shade_prefiltered``),
and the Monte-Carlo estimators (``shade_raytracing`` and its direction-
chunked twin ``shade_raytracing_streamed``): a cosine-weighted diffuse set
and a GGX specular set from fixed fibonacci points, rotated per pixel by a
random azimuth in training, the combined-pdf estimator D G / (4 NoV p), and
incoming radiance from the nearest equirect texel times a visibility from,
in this order, a per-pixel table, the per-vertex table, the ray tracer
(``set_raytracer``) or none. With ``use_raytracing: false`` the material
shades through the split-sum environment instead (``shade_splitsum``): a
linear roughness from its own activation range (``min_roughness`` ..
``max_roughness``), the prefiltered stacks of every environment built once
on first use (``ensure_splitsum``, ``splitsum_height`` x
``splitsum_width``), no visibility.

The random azimuths are two named draws, ``mc_rot_diffuse`` and
``mc_rot_specular`` (uniform [P,1] each), taken from the ``draws`` object
(``utils/rng.py``) before any direction is formed. The environments are
``map{i}/map{i}.exr`` or ``.hdr`` under ``environment_texture`` (an
``.exr`` needs OpenCV), each the procedural sky of its index only where
neither file exists, resized to ``env_height`` x ``env_width`` and scaled
by ``environment_scale``.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

import dreammat_tpu_torch
from dreammat_tpu_torch.ops import envmap as envmap_lib
from dreammat_tpu_torch.ops import visibility as vis_lib
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


def fresnel_schlick(F0, HoV):
    return F0 + (1.0 - F0) * torch.clamp(1.0 - HoV, 0.0, 1.0) ** 5.0


def distribution_ggx(NoH, roughness_sq):
    """GGX NDF; ``roughness_sq`` is alpha (the field predicts r^2)."""
    a2 = roughness_sq ** 2
    denom = NoH ** 2 * (a2 - 1.0) + 1.0
    return a2 / (math.pi * denom ** 2 + 1e-4)


def geometry_schlick_ggx(NoX, roughness_sq):
    k = roughness_sq / 2.0
    return NoX / (NoX * (1 - k) + k + 1e-5)


def geometry_schlick(NoV, NoL, roughness_sq):
    return geometry_schlick_ggx(NoV, roughness_sq) * geometry_schlick_ggx(NoL, roughness_sq)


def geometry_ggx_smith_correlated(NoV, NoL, roughness_sq):
    def lam(alpha2, cos_t):
        cos2 = cos_t ** 2
        tan2 = (1.0 - cos2) / (cos2 + 1e-7)
        return 0.5 * torch.sqrt(1.0 + alpha2 * tan2) - 0.5

    alpha_sq = roughness_sq ** 2
    return 1.0 / (1.0 + lam(alpha_sq, NoV) + lam(alpha_sq, NoL))


def occlusion_nograd(trace_fn: Callable, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The shadow rays' hit mask [N] (``trace_fn``'s, see ``set_raytracer``),
    a constant to autograd: occlusion is piecewise constant in the ray, and
    the reference's BVH is not differentiable either. The trace runs under
    ``no_grad``."""
    with torch.no_grad():
        return trace_fn(o.detach(), d.detach())


def _fibonacci_unit(n: int) -> np.ndarray:
    """The reference's fixed direction set: [n,2] (azimuth / 2 pi,
    1 - 2 elevation / pi) of the upper fibonacci hemisphere."""
    az, el = uops.sample_sphere_fibonacci(n)
    return np.stack([az * 0.5 / np.pi, 1.0 - 2.0 * el / np.pi], -1).astype(np.float32)


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
            sky = None
            for ext in (".exr", ".hdr"):
                path = os.path.join(cfg.environment_texture, f"map{idx}", f"map{idx}{ext}")
                if os.path.exists(path):
                    sky = envmap_lib.load_envmap_file(path)
                    break
            if sky is None:  # no file: the procedural sky of this index
                sky = envmap_lib.make_procedural_envmap(
                    cfg.env_height, cfg.env_width,
                    sun_dir=np.array([np.cos(i * 2.2), np.sin(i * 2.2), 0.6 + 0.1 * (i % 3)]),
                    sun_intensity=10.0 + 5.0 * i, seed=i,
                )
            sky = envmap_lib.resize_envmap(torch.as_tensor(np.asarray(sky, np.float32)),
                                           cfg.env_height, cfg.env_width)
            envs.append(sky * cfg.environment_scale)
        self.envs = torch.stack(envs).to(self.device)  # [E,H,W,3]
        self.diffuse_dir_samples = torch.as_tensor(_fibonacci_unit(cfg.diffuse_sample_num),
                                                   device=self.device)
        self.specular_dir_samples = torch.as_tensor(_fibonacci_unit(cfg.specular_sample_num),
                                                    device=self.device)
        self.ray_trace_fun: Optional[Callable] = None
        self.baked_visibility = None
        self.splitsum = None  # built on first use by ensure_splitsum
        self.fg_lut = envmap_lib.compute_fg_lut(device=self.device) if cfg.use_prefiltered else None

    @torch.no_grad()
    def ensure_splitsum(self) -> dict:
        """The split-sum stacks of every environment, stacked on a leading
        axis, and the FG LUT; built once."""
        if self.splitsum is None:
            ss = [envmap_lib.build_splitsum(self.envs[i], self.cfg.splitsum_height,
                                            self.cfg.splitsum_width)
                  for i in range(self.envs.shape[0])]
            self.splitsum = {k: torch.stack([x[k] for x in ss]) for k in ss[0]}
            if self.fg_lut is None:
                self.fg_lut = envmap_lib.compute_fg_lut(device=self.device)
        return self.splitsum

    def set_raytracer(self, fn: Optional[Callable]) -> None:
        """fn(rays_o [N,3], rays_d [N,3]) -> hit mask [N] bool, the
        renderer's ``occlusion``: the shadow rays read nothing else."""
        self.ray_trace_fun = fn

    def set_baked_visibility(self, baked) -> None:
        self.baked_visibility = baked

    # ------------------------------------------------------------------
    # direction sampling
    # ------------------------------------------------------------------
    def _rotations(self, P: int, draws, is_train: bool):
        """The per-pixel azimuth rotations [P,1] of the diffuse and the
        specular set (radians), or (None, None) outside training."""
        if not (is_train and self.cfg.random_azimuth):
            return None, None
        two_pi = 2.0 * math.pi
        return (draws.uniform("mc_rot_diffuse", (P, 1)) * two_pi,
                draws.uniform("mc_rot_specular", (P, 1)) * two_pi)

    def sample_diffuse_directions(self, normals, rot=None, samples=None):
        """Cosine-weighted set in each normal's tangent frame: [P,S,3]."""
        samples = self.diffuse_dir_samples if samples is None else samples
        z = normals
        x = uops.get_orthogonal_directions(normals)
        y = torch.linalg.cross(z, x, dim=-1)
        az = samples[:, 0][None, :, None] * (2.0 * math.pi)
        el = samples[:, 1][None, :, None]
        if rot is not None:
            az = torch.remainder(az + rot[:, :, None], 2.0 * math.pi)
        el_sqrt = torch.sqrt(el + 1e-7)
        cz = torch.sqrt(1.0 - el + 1e-7)
        return el_sqrt * torch.cos(az) * x[:, None] + el_sqrt * torch.sin(az) * y[:, None] \
            + cz * z[:, None]

    def sample_specular_directions(self, reflections, roughness_sq, rot=None):
        """GGX half-vector importance set centred on the reflection
        direction (the reference's Karis approximation): [P,S,3]."""
        z = reflections
        x = uops.get_orthogonal_directions(reflections)
        y = torch.linalg.cross(z, x, dim=-1)
        a = roughness_sq[:, :, None] if roughness_sq.dim() == 2 else roughness_sq
        az, el = self.specular_dir_samples[:, 0], self.specular_dir_samples[:, 1]
        phi = (2.0 * math.pi) * az[None, :, None]
        el = el[None, :, None]
        cos_theta = torch.sqrt((1.0 - el + 1e-6) / (1.0 + (a ** 2 - 1.0) * el + 1e-6) + 1e-6)
        sin_theta = torch.sqrt(1.0 - cos_theta ** 2 + 1e-6)
        if rot is not None:
            phi = torch.remainder(phi + rot[:, :, None], 2.0 * math.pi)
        return torch.cos(phi) * sin_theta * x[:, None] + torch.sin(phi) * sin_theta * y[:, None] \
            + cos_theta * z[:, None]

    # ------------------------------------------------------------------
    # lights
    # ------------------------------------------------------------------
    def get_environment_light(self, directions, env_id):
        """Nearest equirect radiance; ``env_id`` is clamped to the
        configured environments (the reference's eval env 4 with fewer)."""
        e = min(max(int(env_id), 0), self.envs.shape[0] - 1)
        return envmap_lib.sample_equirect_nearest(self.envs[e], directions)

    def get_lights(self, points, directions, env_id, valid_mask=None, vis_data=None):
        """Incoming radiance [P,S,3] with visibility from, in this order, a
        per-pixel table (``vis_data`` a ``PixelVisibility``), the baked
        per-vertex table (``vis_data=(tri_verts, bary)``), the ray tracer,
        or none."""
        env = self.get_environment_light(directions, env_id)
        if isinstance(vis_data, vis_lib.PixelVisibility):
            lights = env * vis_lib.lookup_visibility_pixel(vis_data, directions)[..., None]
        elif self.baked_visibility is not None and vis_data is not None:
            tri_verts, bary = vis_data
            vis = vis_lib.lookup_visibility(self.baked_visibility, tri_verts, bary, directions)
            lights = env * vis[..., None]
        elif self.ray_trace_fun is not None:
            o = points.reshape(-1, 3) + directions.reshape(-1, 3) * 1e-5
            hit = occlusion_nograd(self.ray_trace_fun, o, directions.reshape(-1, 3))
            lights = torch.where(hit.reshape(directions.shape[:-1])[..., None],
                                 torch.zeros_like(env), env)
        else:
            lights = env
        if valid_mask is not None:
            lights = torch.where(valid_mask[..., None], lights, torch.zeros_like(lights))
        return lights

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

    def _geom(self, NoV, NoL, roughness_sq):
        if self.cfg.geometry_type == "schlick":
            return geometry_schlick(NoV, NoL, roughness_sq)
        if self.cfg.geometry_type == "ggx_smith":
            return geometry_ggx_smith_correlated(NoV, NoL, roughness_sq)
        raise NotImplementedError(self.cfg.geometry_type)

    @staticmethod
    def _mc_outputs(colors, albedo, metallic, roughness_sq, spec_light, diff_light,
                    specular_colors, diffuse_colors) -> Dict[str, torch.Tensor]:
        return {
            "color": colors,
            "albedo": uops.lin2srgb(albedo.detach()),
            "roughness": torch.sqrt(roughness_sq + 1e-7),
            "metalness": metallic,
            "specular_light": uops.lin2srgb(spec_light.detach()),
            "diffuse_light": uops.lin2srgb(diff_light.detach()),
            "specular_color": uops.lin2srgb(specular_colors.detach()),
            "diffuse_color": uops.lin2srgb(diffuse_colors.detach()),
        }

    def shade_raytracing(self, pts, normals, view_dirs, env_id, metallic, roughness_sq, albedo,
                         draws, is_train: bool, mask=None, vis_data=None
                         ) -> Dict[str, torch.Tensor]:
        """The MC Cook-Torrance estimator on a [P] pixel batch; ``mask``
        marks real pixels (padding lanes shade to 0 light)."""
        if self.cfg.shading_chunk > 0:
            return self.shade_raytracing_streamed(
                pts, normals, view_dirs, env_id, metallic, roughness_sq, albedo, draws,
                is_train, mask=mask, vis_data=vis_data)
        rot_d, rot_s = self._rotations(pts.shape[0], draws, is_train)
        reflections = uops.reflect(view_dirs, normals)
        F0 = 0.04 * (1.0 - metallic) + metallic * albedo
        diffuse_dirs = self.sample_diffuse_directions(normals, rot_d)
        specular_dirs = self.sample_specular_directions(reflections, roughness_sq, rot_s)
        dn, sn = diffuse_dirs.shape[1], specular_dirs.shape[1]

        NoL_d = uops.saturate_dot(diffuse_dirs, normals[:, None])
        p_diffuse = NoL_d / math.pi * (dn / (dn + sn))
        H_s = uops.safe_normalize(view_dirs[:, None] + specular_dirs)
        NoH_s = uops.saturate_dot(normals[:, None], H_s)
        VoH_s = uops.saturate_dot(view_dirs[:, None], H_s)
        p_specular = (distribution_ggx(NoH_s, roughness_sq[:, None]) * NoH_s
                      / (4.0 * VoH_s + 1e-5) * (sn / (dn + sn)))
        directions = torch.cat([diffuse_dirs, specular_dirs], dim=1)  # [P,S,3]
        probability = torch.cat([p_diffuse, p_specular], dim=1)

        H = uops.safe_normalize(view_dirs[:, None] + directions)
        fresnel = fresnel_schlick(F0[:, None], uops.saturate_dot(H, view_dirs[:, None]))
        NoV = uops.saturate_dot(normals, view_dirs)[:, None]
        NoL = uops.saturate_dot(normals[:, None], directions)
        geom = self._geom(NoV, NoL, roughness_sq[:, None])
        dist = distribution_ggx(uops.saturate_dot(normals[:, None], H), roughness_sq[:, None])

        pts_rep = pts[:, None].expand_as(directions)
        valid = None if mask is None else mask[:, None].expand(directions.shape[:-1])
        lights = self.get_lights(pts_rep, directions, env_id, valid, vis_data)  # [P,S,3]
        spec_w = dist * geom / (4.0 * NoV * probability + 1e-5)
        specular_colors = torch.nan_to_num(torch.mean(fresnel * lights * spec_w, dim=1))
        diffuse_colors = torch.mean(albedo[:, None] * lights[:, :dn], dim=1)
        colors = uops.lin2srgb(diffuse_colors + specular_colors)
        return self._mc_outputs(colors, albedo, metallic, roughness_sq,
                                lights[:, dn:].mean(1), lights[:, :dn].mean(1),
                                specular_colors, diffuse_colors)

    def shade_raytracing_streamed(self, pts, normals, view_dirs, env_id, metallic, roughness_sq,
                                  albedo, draws, is_train: bool, mask=None, vis_data=None
                                  ) -> Dict[str, torch.Tensor]:
        """``shade_raytracing`` with the direction axis consumed in chunks
        of ``shading_chunk`` directions, each under
        ``torch.utils.checkpoint`` when a gradient is needed: peak memory
        is [P, chunk, 3] per intermediate instead of [P, dn + sn, 3]. The
        rotations are drawn before the loop, so a recomputed chunk forms
        the same directions; ``nan_to_num`` is applied to the whole
        specular sum, as in the unchunked estimator."""
        C = self.cfg.shading_chunk
        dn = self.diffuse_dir_samples.shape[0]
        sn = self.specular_dir_samples.shape[0]
        rot_d, rot_s = self._rotations(pts.shape[0], draws, is_train)
        reflections = uops.reflect(view_dirs, normals)
        F0 = 0.04 * (1.0 - metallic) + metallic * albedo
        NoV = uops.saturate_dot(normals, view_dirs)  # [P,1]
        xs = uops.get_orthogonal_directions(reflections)
        ys = torch.linalg.cross(reflections, xs, dim=-1)

        def spec_contrib(dirs, prob, lights):
            Hv = uops.safe_normalize(view_dirs[:, None] + dirs)
            fres = fresnel_schlick(F0[:, None], uops.saturate_dot(Hv, view_dirs[:, None]))
            geom = self._geom(NoV[:, None], uops.saturate_dot(normals[:, None], dirs),
                              roughness_sq[:, None])
            dist = distribution_ggx(uops.saturate_dot(normals[:, None], Hv), roughness_sq[:, None])
            w = dist * geom / (4.0 * NoV[:, None] * prob + 1e-5)
            return torch.sum(fres * lights * w, dim=1)

        def chunk_lights(dirs):
            valid = None if mask is None else mask[:, None].expand(dirs.shape[:-1])
            return self.get_lights(pts[:, None].expand_as(dirs), dirs, env_id, valid, vis_data)

        def diffuse_chunk(samp):
            dirs = self.sample_diffuse_directions(normals, rot_d, samples=samp)
            prob = uops.saturate_dot(dirs, normals[:, None]) / math.pi * (dn / (dn + sn))
            lights = chunk_lights(dirs)
            return spec_contrib(dirs, prob, lights), lights.sum(1)

        def specular_chunk(samp):
            phi = (2.0 * math.pi) * samp[:, 0][None, :, None]
            el = samp[:, 1][None, :, None]
            if rot_s is not None:
                phi = torch.remainder(phi + rot_s[:, :, None], 2.0 * math.pi)
            a = roughness_sq[:, None]
            cos_t = torch.sqrt(torch.clamp(
                (1.0 - el + 1e-6) / (1.0 + (a ** 2 - 1.0) * el + 1e-6) + 1e-6, 0.0, 1.0))
            sin_t = torch.sqrt(torch.clamp(1.0 - cos_t ** 2, 0.0, 1.0) + 1e-6)
            dirs = (torch.cos(phi) * sin_t * xs[:, None] + torch.sin(phi) * sin_t * ys[:, None]
                    + cos_t * reflections[:, None])
            Hv = uops.safe_normalize(view_dirs[:, None] + dirs)
            NoH = uops.saturate_dot(normals[:, None], Hv)
            VoH = uops.saturate_dot(view_dirs[:, None], Hv)
            prob = (distribution_ggx(NoH, roughness_sq[:, None]) * NoH / (4.0 * VoH + 1e-5)
                    * (sn / (dn + sn)))
            lights = chunk_lights(dirs)
            return spec_contrib(dirs, prob, lights), lights.sum(1)

        grad = torch.is_grad_enabled() and (F0.requires_grad or roughness_sq.requires_grad)
        run = (lambda fn, *a: checkpoint(fn, *a, use_reentrant=False)) if grad \
            else (lambda fn, *a: fn(*a))
        spec_sum = dl_sum = sl_sum = 0.0
        for s in range(0, dn, C):
            sp, li = run(diffuse_chunk, self.diffuse_dir_samples[s:s + C])
            spec_sum, dl_sum = spec_sum + sp, dl_sum + li
        for s in range(0, sn, C):
            sp, li = run(specular_chunk, self.specular_dir_samples[s:s + C])
            spec_sum, sl_sum = spec_sum + sp, sl_sum + li
        specular_colors = torch.nan_to_num(spec_sum / (dn + sn))
        diffuse_colors = albedo * (dl_sum / dn)
        colors = uops.lin2srgb(diffuse_colors + specular_colors)
        return self._mc_outputs(colors, albedo, metallic, roughness_sq, sl_sum / sn, dl_sum / dn,
                                specular_colors, diffuse_colors)

    def shade_splitsum(self, normals, view_dirs, env_id, metallic, roughness, albedo
                       ) -> Dict[str, torch.Tensor]:
        """The split-sum environment path; ``roughness`` is linear."""
        self.ensure_splitsum()
        n_dot_v = uops.dot(normals, view_dirs)
        reflective = n_dot_v * normals * 2.0 - view_dirs
        fg = envmap_lib.sample_fg_lut(self.fg_lut, torch.clamp(n_dot_v, 0.0, 1.0),
                                      torch.clamp(roughness, 0.0, 1.0))
        F0 = (1.0 - metallic) * 0.04 + metallic * albedo
        specular_albedo = F0 * fg[..., 0:1] + fg[..., 1:2]
        e = min(max(int(env_id), 0), self.envs.shape[0] - 1)
        ss = {k: v[e] for k, v in self.splitsum.items()}
        diffuse_light = envmap_lib.sample_splitsum_diffuse(ss, normals)
        specular_light = envmap_lib.sample_splitsum_specular(ss, reflective, roughness ** 2)
        color = torch.clamp(albedo * diffuse_light + specular_albedo * specular_light, 0.0, 1.0)
        return {
            "color": color,
            "albedo": albedo,
            "roughness": roughness,
            "metalness": metallic,
            "specular_light": uops.lin2srgb(specular_light.detach()),
            "diffuse_light": uops.lin2srgb(diffuse_light.detach()),
            "specular_color": uops.lin2srgb(specular_albedo.detach()),
            "diffuse_color": uops.lin2srgb(albedo.detach()),
        }

    def __call__(self, pts, features, features_jitter, viewdirs, normals, env_id, draws=None,
                 is_train: bool = True, mask=None, vis_data=None, light_table=None):
        """Shade a fixed-size pixel batch; returns (outputs, mat_reg_loss).
        With ``use_prefiltered`` and a light table: the tables; otherwise
        the MC estimator, whose rotations come from ``draws`` in training;
        with ``use_raytracing: false`` the split-sum environment."""
        material, albedo, metallic, roughness_sq = self.features_to_material(features)
        material_j = self.features_to_material(features_jitter)[0]
        mat_reg = material_smoothness_grad(material, material_j)
        if not self.cfg.use_raytracing:
            act = uops.get_activation(self.cfg.material_activation)(features)
            roughness = act[..., 4:5] * (self.cfg.max_roughness - self.cfg.min_roughness) \
                + self.cfg.min_roughness
            out = self.shade_splitsum(normals, viewdirs, env_id, metallic, roughness, albedo)
        elif self.cfg.use_prefiltered and light_table is not None:
            out = self.shade_prefiltered(normals, viewdirs, metallic, roughness_sq, albedo,
                                         light_table, vis_data=vis_data)
        else:
            out = self.shade_raytracing(pts, normals, viewdirs, env_id, metallic, roughness_sq,
                                        albedo, draws, is_train, mask=mask, vis_data=vis_data)
        return out, mat_reg

    def export(self, features: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Texel-space export maps: albedo, metallic, roughness (and the
        tangent-space bump with ``use_bump``)."""
        material, albedo, metallic, roughness_sq = self.features_to_material(features)
        out = {"albedo": albedo, "metallic": metallic,
               "roughness": torch.sqrt(roughness_sq + 1e-7)}
        if self.cfg.use_bump and material.shape[-1] >= 8:
            perturb = (material[..., 5:8] * 2.0 - 1.0) + torch.tensor([0.0, 0.0, 1.0],
                                                                       device=material.device)
            perturb = uops.safe_normalize(torch.clamp(perturb, -1.0, 1.0))
            out["bump"] = (perturb + 1.0) / 2.0
        return out
