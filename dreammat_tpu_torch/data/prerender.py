"""Condition-map and light-table prerender for the fixed camera rig.

Counterpart of the tables-regime path of ``dreammat_tpu/data/prerender.py``:
G-buffers for every view, the mesh-wide bakes (visibility -> shadowed
radiance -> per-vertex irradiance, plus the FG LUT), then per view the
per-vertex GGX-prefiltered table, the six light-probe images
(metallic {0,1} x roughness {0, 0.5, 1}, white base color) under every
environment, and the depth and normal condition maps, all resized to the
condition resolution (``probe_view_for_camera``, which also serves one
sampled camera of the random-camera mode; ``render_probes_for_view`` is
the same pass under the JAX function's signature). ``vertex_table_for_camera``
makes the table of any camera (the eval views). The reference-parity probe
renderers, the ground truth of the evidence tools: ``render_probes_for_view_exact``
(every sample direction traced through ``renderer.occlusion``, no baked
table) and ``render_probes_for_view_mc`` (the same estimators with the
shadowed-radiance cache in place of the trace, and the per-pixel split-sum
tables). The fast-path gate's two
measures compare the tables with the exact MC estimator (shadow rays
through the renderer's ``occlusion``): ``fastpath_residual`` (relative colour RMSE of one view) and
``fastpath_grad_cos`` (cosine of the material gradients on a pixel subset;
its weights are the named draw ``gate_w``).

Two caches, in the JAX package's file formats, so a file written by either
package loads in the other: the npz prerender cache
(``<cache_dir>/prerender_<mesh_signature>.npz``: probes and normals as
uint8, depth as uint16, the specular tables in f16; written from a
background thread after the arrays are on the host, renamed into place
when complete, and read back from the next run with the same mesh, rig
and sizes; under a process group rank 0 writes it, synchronously, and the
other ranks read it), and the reference's Blender PNG cache
(``load_reference_png_cache`` / ``write_reference_png_cache``).
"""

from __future__ import annotations

import contextlib
import hashlib
import math
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

import dreammat_tpu_torch
from dreammat_tpu_torch.data.cameras import CameraSet
from dreammat_tpu_torch.ops import envmap as envmap_lib
from dreammat_tpu_torch.parallel import distributed as dist
from dreammat_tpu_torch.utils import ops as uops

PROBE_MR = [(0.0, 0.0), (0.0, 0.5), (0.0, 1.0), (1.0, 0.0), (1.0, 0.5), (1.0, 1.0)]
SPEC_ROUGHNESS = [0.0, 0.5, 1.0]  # linear roughness of the exact renderer's three GGX sets
TABLE_ALPHAS = (1e-3, 0.08, 0.25, 0.5, 1.0)
_PROBE_SET_IDX = {0.0: 0, 0.5: 2, 1.0: 4}
_SPEC_ALPHAS = [TABLE_ALPHAS[_PROBE_SET_IDX[r]] for r in SPEC_ROUGHNESS]


@dataclass
class PrerenderData:
    gbuffers: list                 # per-view GBufferView
    lightmaps: Any                 # [Nv, E, h, w, 18] f16
    depths: Any                    # [Nv, h, w, 1] f16
    normals: Any                   # [Nv, h, w, 3] f16
    table_spec: Any = None         # [Nv, E, V, K, 3] f16
    table_diff: Any = None         # [E, V, 3] f32
    lvis: Any = None               # [V, O2, E*3] f16
    oct_res: int = 16
    cond_height: int = 256
    cond_width: int = 256
    seconds: Dict[str, float] = field(default_factory=dict)
    from_cache: bool = False       # probes, maps and tables read from the npz cache


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _shadowed_radiance(renderer, material, n_envs: int):
    """(baked visibility, shadowed-radiance cache lvis [V, O2, E*3]): the
    material's baked visibility (baked now when it has none) times its
    first ``n_envs`` environments."""
    from dreammat_tpu_torch.ops import visibility as vis_lib

    baked = material.baked_visibility
    if baked is None:
        baked = vis_lib.bake_vertex_visibility(renderer.bvh, renderer.mesh.v_pos,
                                               renderer.mesh.v_nrm)
    return baked, vis_lib.bake_shadowed_radiance(baked, material.envs[:n_envs])


def mesh_bakes(renderer, material, n_envs: int):
    """(lvis, e_d_vertex, fg_lut, oct_res): the view-independent bakes."""
    from dreammat_tpu_torch.ops import visibility as vis_lib

    baked, lvis = _shadowed_radiance(renderer, material, n_envs)
    e_d_vertex = vis_lib.bake_vertex_irradiance_conv(lvis, renderer.mesh.v_nrm, baked.oct_res)
    fg_lut = material.fg_lut
    if fg_lut is None:
        fg_lut = envmap_lib.compute_fg_lut(device=lvis.device)
    return lvis, e_d_vertex, fg_lut, baked.oct_res


def _probe_view_body(v_pos, v_nrm, lvis, e_d_vertex, fg_lut, cam_pos, gb,
                     oct_res: int, n_envs: int):
    """One view's probe images [E,H,W,18] (sRGB) and vertex table
    [E, V, 1+K, 3]: per vertex the GGX-prefiltered shadowed radiance at this
    camera's reflection direction, per pixel a barycentric mix, and the
    probes from the FG LUT: probe(m, r) = (1-m) E_d + (F0(m) A + B) S(r)."""
    from dreammat_tpu_torch.ops import visibility as vis_lib

    K = len(TABLE_ALPHAS)
    viewdir_v = uops.safe_normalize(cam_pos[None, :] - v_pos)
    refl_v = uops.safe_normalize(uops.reflect(viewdir_v, v_nrm))
    S_v = vis_lib.bake_vertex_specular_conv(lvis, refl_v, TABLE_ALPHAS, oct_res)  # [V,K,E,3]
    Ev = e_d_vertex.permute(1, 0, 2)[:, None]                                   # [V,1,E,3]
    tab_v = torch.cat([Ev.float(), S_v], dim=1)                                  # [V,1+K,E,3]
    V = tab_v.shape[0]
    flat = tab_v.reshape(V, -1)
    tri, bary = gb.fg_tri, gb.fg_bary
    tp = (bary[:, 0:1] * flat[tri[:, 0]] + bary[:, 1:2] * flat[tri[:, 1]]
          + bary[:, 2:3] * flat[tri[:, 2]])
    P = tp.shape[0]
    tables = tp.reshape(P, 1 + K, n_envs, 3).permute(2, 0, 1, 3)               # [E,P,1+K,3]
    NoV = uops.saturate_dot(gb.fg_normal.float(), gb.fg_viewdir.float())
    per_probe = []
    for (m, r) in PROBE_MR:
        li = _PROBE_SET_IDX[r]
        fg = envmap_lib.sample_fg_lut(fg_lut, NoV, torch.full_like(NoV, r))
        F0 = 0.04 * (1.0 - m) + m * 1.0
        spec = (F0 * fg[..., 0:1] + fg[..., 1:2])[None] * tables[:, :, 1 + li]
        diff = (1.0 - m) * tables[:, :, 0]
        per_probe.append(uops.lin2srgb(torch.nan_to_num(diff + spec)))
    return _scatter_probes(gb, torch.cat(per_probe, dim=-1)), tab_v.permute(2, 0, 1, 3)


def probe_view_for_camera(renderer, bakes, cam_pos, gb, n_envs: int, cond_height: int,
                          cond_width: int):
    """One camera's probes [E,h,w,18], vertex table [E,V,1+K,3], depth
    [h,w,1] and normal [h,w,3] maps at the condition resolution, all f16
    (as the fixed rig stores them), from the mesh ``bakes`` of
    ``mesh_bakes`` and the camera's G-buffer ``gb``."""
    lvis, e_d_vertex, fg_lut, oct_res = bakes
    img, tab = _probe_view_body(renderer.mesh.v_pos, renderer.mesh.v_nrm, lvis, e_d_vertex,
                                fg_lut, cam_pos, gb, oct_res, n_envs)
    return (resize_hw(img, cond_height, cond_width).half(), tab.half(),
            resize_hw(gb.cn_depth.float(), cond_height, cond_width).half(),
            resize_hw(gb.cn_normal.float(), cond_height, cond_width).half())


def render_probes_for_view(renderer, material, gb, n_envs: int, cam_pos, lvis=None,
                           e_d_vertex=None, oct_res: int = 16, fg_lut=None):
    """The fast probe and table pass of one G-buffer (``_probe_view_body``):
    (probes [E,H,W,18] sRGB, vertex table [E,V,1+K,3]), at the G-buffer's
    own resolution. ``lvis``, ``e_d_vertex``, ``oct_res`` and ``fg_lut`` are
    the four of ``mesh_bakes``, given together; without ``lvis`` they are
    made here."""
    mesh = renderer.mesh
    if lvis is None:
        lvis, e_d_vertex, fg_lut, oct_res = mesh_bakes(renderer, material, n_envs)
    cam_pos = torch.as_tensor(cam_pos, dtype=torch.float32, device=mesh.v_pos.device)
    return _probe_view_body(mesh.v_pos, mesh.v_nrm, lvis, e_d_vertex, fg_lut,
                            cam_pos.reshape(3), gb, oct_res, n_envs)


def _probe_inputs(gb):
    """The G-buffer's points, normals, view directions and valid mask with
    the padding lanes' zero normals and view directions replaced by +z
    (zero vectors give NaN sample frames and half-vectors)."""
    up = torch.tensor([0.0, 0.0, 1.0], device=gb.fg_pos.device)
    unit = lambda x: torch.where(torch.linalg.norm(x, dim=-1, keepdim=True) < 0.5, up, x.float())
    return gb.fg_pos.float(), unit(gb.fg_normal), unit(gb.fg_viewdir), gb.fg_valid


def _scatter_probes(gb, out: torch.Tensor) -> torch.Tensor:
    """Per-pixel probes [E,P,18] -> image [E,H,W,18]: valid pixels scattered
    through ``fg_idx``, the rest black."""
    H, W = gb.mask.shape
    vals = torch.where(gb.fg_valid[None, :, None], out, torch.zeros_like(out))
    img = torch.zeros(out.shape[0], H * W, 18, device=out.device).index_add_(1, gb.fg_idx, vals)
    img = img * gb.mask.reshape(1, -1, 1).float()
    return img.reshape(out.shape[0], H, W, 18)


def _probe_level_weights(normal, viewdir, dirs, alpha: float):
    """Per-sample GGX weights of one specular set [pc,sn,3] at GGX alpha:
    w = D G / (4 NoV pdf) (= G VoH / (NoV NoH)) and the Fresnel terms of
    F0 = 0.04 and 1, each [pc,sn,1]."""
    from dreammat_tpu_torch.models.material import (
        distribution_ggx, fresnel_schlick, geometry_schlick)

    NoV = uops.saturate_dot(normal, viewdir)[:, None]
    Hv = uops.safe_normalize(viewdir[:, None] + dirs)
    NoH = uops.saturate_dot(normal[:, None], Hv)
    VoH = uops.saturate_dot(viewdir[:, None], Hv)
    NoL = uops.saturate_dot(normal[:, None], dirs)
    D = distribution_ggx(NoH, alpha)
    G = geometry_schlick(NoV, NoL, alpha)
    pdf = D * NoH / (4.0 * VoH + 1e-5)
    w = D * G / (4.0 * NoV * pdf + 1e-5)
    return w, fresnel_schlick(0.04, VoH), fresnel_schlick(1.0, VoH)


def _probe_colors(E_d, lights_spec, level_data, set_of_roughness):
    """The six probes [pc,18] (sRGB) of one environment: diffuse (1-m) E_d
    plus the mean of Fr(m) L w over the specular set of the probe's
    roughness (``lights_spec[i]`` [pc,sn,3] of set i)."""
    per_probe = []
    for (m, r) in PROBE_MR:
        li = set_of_roughness[r]
        w, Fr04, Fr1 = level_data[li]
        Fr = Fr1 if m == 1.0 else Fr04
        spec = torch.mean(Fr * lights_spec[li] * w, dim=1)
        per_probe.append(uops.lin2srgb(torch.nan_to_num((1.0 - m) * E_d + spec)))
    return torch.cat(per_probe, dim=-1)


def exact_probe_rays(material, pos, normal, viewdir):
    """The exact probe renderer's shadow rays of pixels [pc]: origins and
    directions [pc, S, 3], S = dn + 3 sn: the material's diffuse set, then
    its specular set at each of the three probe alphas, each origin the
    point pushed 1e-5 along its direction."""
    refl = uops.reflect(viewdir, normal)
    pc = pos.shape[0]
    dirs = torch.cat([material.sample_diffuse_directions(normal)] + [
        material.sample_specular_directions(refl, torch.full((pc, 1), a, device=pos.device))
        for a in _SPEC_ALPHAS], dim=1)
    return pos[:, None] + dirs * 1e-5, dirs


# pixels a chunk of the exact probe renderer. A chunk's peak is about
# chunk x S x 130 bytes for S = dn + 3 sn sample directions (the directions,
# the shadow rays' origins, the caster's outputs and one environment's
# radiance and weighted products at a time): 32,768 pixels x 584 directions
# (the DreamMat config's 200 + 3 x 128) is about 2.5 GB, x 1,024 (256 MC
# samples) about 4.4 GB, a small share of an 80 GB card. One 512^2 view of
# a mesh filling a quarter of the frame is two chunks.
EXACT_CHUNK = 1 << 15


@torch.no_grad()
def render_probes_for_view_exact(renderer, material, gb, n_envs: int,
                                 chunk: int = EXACT_CHUNK) -> torch.Tensor:
    """Reference-parity probe stack [n_envs, H, W, 18] (sRGB) with exact
    per-ray visibility: per pixel the material's fixed fibonacci diffuse
    set and three GGX sets at alpha = probe roughness^2 (``TABLE_ALPHAS``
    0, 2 and 4), every direction traced once through ``renderer.occlusion``
    (kernel B at or below ``DENSE_CAST_MAX_TRIS`` triangles, kernel E's
    any-hit entry above) from the point pushed 1e-5 along it, its hit mask
    reused by every environment. Padding lanes are dark. Deterministic:
    the sets are fixed (no random azimuth outside training), so the JAX
    function's ``rng`` has no counterpart."""
    n_dirs_d = material.diffuse_dir_samples.shape[0]
    sn = material.specular_dir_samples.shape[0]
    envs = material.envs[:n_envs]
    set_of_roughness = {r: i for i, r in enumerate(SPEC_ROUGHNESS)}
    pos, nrm, vdr, valid = _probe_inputs(gb)
    outs = []
    for s in range(0, pos.shape[0], chunk):
        p, n, v, ok = pos[s:s + chunk], nrm[s:s + chunk], vdr[s:s + chunk], valid[s:s + chunk]
        pc = p.shape[0]
        o, all_dirs = exact_probe_rays(material, p, n, v)
        hit = renderer.occlusion(o.reshape(-1, 3), all_dirs.reshape(-1, 3))
        occluded = (hit.reshape(pc, -1) | ~ok[:, None])[..., None]
        level_data = [_probe_level_weights(n, v, all_dirs[:, n_dirs_d + i * sn:
                                                         n_dirs_d + (i + 1) * sn], a)
                      for i, a in enumerate(_SPEC_ALPHAS)]
        imgs = []
        for env in envs:
            lights = torch.where(occluded, 0.0, envmap_lib.sample_equirect_nearest(env, all_dirs))
            E_d = lights[:, :n_dirs_d].mean(1)
            spec = [lights[:, n_dirs_d + i * sn:n_dirs_d + (i + 1) * sn] for i in range(3)]
            imgs.append(_probe_colors(E_d, spec, level_data, set_of_roughness))
        outs.append(torch.stack(imgs))                                      # [E,pc,18]
    return _scatter_probes(gb, torch.cat(outs, dim=1))


MC_CHUNK = 4096  # pixels a chunk of the MC probe renderer, the JAX function's default


@torch.no_grad()
def render_probes_for_view_mc(renderer, material, gb, n_envs: int):
    """The probe stack [n_envs, H, W, 18] and the per-pixel split-sum light
    tables [n_envs, P, 1+K, 3] (slot 0 the diffuse irradiance E_d, slots
    1..K the GGX-prefiltered radiance at ``TABLE_ALPHAS``) of one G-buffer
    by the reference's estimators, with visibility from the fused
    shadowed-radiance cache ``lvis`` instead of a trace: per pixel K GGX
    sets from the material's fibonacci specular set, each read from
    ``lvis`` (three vertex rows, bilinear), and E_d the barycentric mix of
    the per-vertex ``bake_vertex_irradiance``; ``MC_CHUNK`` pixels at a
    time. The sets are fixed, so the JAX function's ``rng`` has no
    counterpart."""
    from dreammat_tpu_torch.ops import visibility as vis_lib

    K = len(TABLE_ALPHAS)
    baked, lvis = _shadowed_radiance(renderer, material, n_envs)
    e_d_vertex = vis_lib.bake_vertex_irradiance(baked, lvis, renderer.mesh.v_nrm,
                                                material.diffuse_dir_samples)
    spec_samples = material.specular_dir_samples
    sn = spec_samples.shape[0]
    phi = (2.0 * math.pi) * spec_samples[:, 0][None, :, None]
    el = spec_samples[:, 1][None, :, None]
    set_of_roughness = dict(_PROBE_SET_IDX)
    pos, nrm, vdr, _ = _probe_inputs(gb)
    tri, bary = gb.fg_tri, gb.fg_bary
    outs, tabs = [], []
    for s in range(0, pos.shape[0], MC_CHUNK):
        n, v = nrm[s:s + MC_CHUNK], vdr[s:s + MC_CHUNK]
        tr, ba = tri[s:s + MC_CHUNK], bary[s:s + MC_CHUNK]
        refl = uops.reflect(v, n)
        xs = uops.get_orthogonal_directions(refl)
        ys = torch.linalg.cross(refl, xs, dim=-1)
        sets = []
        for alpha in TABLE_ALPHAS:
            cos_t = torch.sqrt(torch.clamp(
                (1.0 - el + 1e-6) / (1.0 + (alpha ** 2 - 1.0) * el + 1e-6) + 1e-6, 0.0, 1.0))
            sin_t = torch.sqrt(torch.clamp(1.0 - cos_t ** 2, 0.0, 1.0) + 1e-6)
            sets.append(torch.cos(phi) * sin_t * xs[:, None]
                        + torch.sin(phi) * sin_t * ys[:, None] + cos_t * refl[:, None])
        level_data = [_probe_level_weights(n, v, d, a) for d, a in zip(sets, TABLE_ALPHAS)]
        lights_all = vis_lib.lookup_shadowed_radiance_all_envs(
            lvis, tr, ba, torch.cat(sets, dim=1), baked.oct_res)            # [pc,K*sn,E,3]
        imgs, tables = [], []
        for env_id in range(n_envs):
            lights = lights_all[:, :, env_id]
            ev = e_d_vertex[env_id].float()
            E_d = sum(ba[:, k:k + 1] * ev[tr[:, k]] for k in range(3))
            spec = [lights[:, li * sn:(li + 1) * sn] for li in range(K)]
            tab = [E_d] + [torch.nan_to_num((spec[li] * level_data[li][0]).sum(1)
                                            / (level_data[li][0].sum(1) + 1e-6))
                           for li in range(K)]
            tables.append(torch.stack(tab, dim=1))                          # [pc,1+K,3]
            imgs.append(_probe_colors(E_d, spec, level_data, set_of_roughness))
        outs.append(torch.stack(imgs))
        tabs.append(torch.stack(tables))
    return _scatter_probes(gb, torch.cat(outs, dim=1)), torch.cat(tabs, dim=1)


def vertex_table_for_camera(renderer, material, data: PrerenderData, cam_pos,
                            env_id: int) -> torch.Tensor:
    """Per-vertex light table [V, 1+K, 3] for any camera position: one
    specular convolution bake against the cached shadowed radiance."""
    from dreammat_tpu_torch.ops import visibility as vis_lib

    mesh = renderer.mesh
    cam_pos = torch.as_tensor(cam_pos, dtype=torch.float32, device=mesh.v_pos.device)
    viewdir_v = uops.safe_normalize(cam_pos.reshape(1, 3) - mesh.v_pos)
    refl_v = uops.safe_normalize(uops.reflect(viewdir_v, mesh.v_nrm))
    S_v = vis_lib.bake_vertex_specular_conv(data.lvis, refl_v, TABLE_ALPHAS, data.oct_res)
    e = data.table_diff[env_id]
    return torch.cat([e[:, None].float(), S_v[:, :, env_id]], dim=1)


def _view_table(data: PrerenderData, view_id: int, env_id: int) -> torch.Tensor:
    return torch.cat([data.table_diff[env_id][:, None].float(),
                      data.table_spec[view_id, env_id].float()], dim=1)


class _ExactMC:
    """Within the block, the material shades through the exact estimator:
    no baked table, shadow rays through ``renderer.occlusion``."""

    def __init__(self, renderer, material):
        self.renderer, self.material = renderer, material

    def __enter__(self):
        self.saved = (self.material.baked_visibility, self.material.ray_trace_fun)
        self.material.set_baked_visibility(None)
        self.material.set_raytracer(self.renderer.occlusion)

    def __exit__(self, *exc):
        self.material.set_baked_visibility(self.saved[0])
        self.material.set_raytracer(self.saved[1])


def fastpath_residual(renderer, material, data: PrerenderData, view_id: int = 0,
                      env_id: int = 0, metallic: float = 0.5, roughness_sq: float = 0.3) -> float:
    """The tables' colour error on one view against the exact MC estimator
    (per-ray visibility), for a uniform material: foreground RMSE over the
    exact image's RMS."""
    gb = data.gbuffers[view_id]
    P, dev = gb.fg_pos.shape[0], gb.fg_pos.device
    m = torch.full((P, 1), metallic, device=dev)
    r = torch.full((P, 1), roughness_sq, device=dev)
    a = torch.full((P, 3), 0.6, device=dev)
    with torch.no_grad():
        pf = material.shade_prefiltered(gb.fg_normal, gb.fg_viewdir, m, r, a,
                                        _view_table(data, view_id, env_id),
                                        vis_data=(gb.fg_tri, gb.fg_bary))
        with _ExactMC(renderer, material):
            mc = material.shade_raytracing(gb.fg_pos, gb.fg_normal, gb.fg_viewdir, env_id, m, r,
                                           a, None, is_train=False, mask=gb.fg_valid)
    valid = gb.fg_valid
    exact = mc["color"][valid].double()
    d = pf["color"][valid].double() - exact
    denom = float(torch.sqrt(torch.mean(exact ** 2))) + 1e-9
    return float(torch.sqrt(torch.mean(d ** 2))) / denom


def fastpath_grad_cos(renderer, material, data: PrerenderData, view_id: int = 0,
                      env_id: int = 0, grad_pixels: int = 4096, draws=None) -> float:
    """The cosine between d(sum(color * W))/d(features) through the tables
    and through the exact MC estimator, on the first ``grad_pixels``
    pixels of one view, at features 0. ``W`` [GP,3] is the draw
    ``gate_w`` (uniform) of ``draws``, by default a generator seeded 3."""
    from dreammat_tpu_torch.utils.rng import TorchDraws

    gb = data.gbuffers[view_id]
    GP = int(min(grad_pixels, gb.fg_pos.shape[0]))
    dev = gb.fg_pos.device
    draws = TorchDraws(3, dev) if draws is None else draws
    W = draws.uniform("gate_w", (GP, 3)).to(dev)
    sl = lambda x: x[:GP]
    table = _view_table(data, view_id, env_id)

    def grad(light_table):
        z = torch.zeros(GP, 5, device=dev, requires_grad=True)
        vis = (sl(gb.fg_tri), sl(gb.fg_bary)) if light_table is not None else None
        out, _ = material(sl(gb.fg_pos), z, z, sl(gb.fg_viewdir), sl(gb.fg_normal), env_id,
                          None, is_train=False, mask=sl(gb.fg_valid), vis_data=vis,
                          light_table=light_table)
        return torch.autograd.grad(torch.sum(out["color"] * W), z)[0].double()

    g_fast = grad(table)
    with _ExactMC(renderer, material):
        g_exact = grad(None)
    denom = float(torch.linalg.norm(g_fast) * torch.linalg.norm(g_exact)) + 1e-12
    return float(torch.sum(g_fast * g_exact)) / denom


def resize_hw(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[..., H, W, C] -> [..., h, w, C]: half-pixel bilinear, antialiased when
    shrinking (``jax.image.resize(method="linear")`` semantics)."""
    lead, (H, W, C) = img.shape[:-3], img.shape[-3:]
    if (H, W) == (h, w):
        return img
    x = img.reshape(-1, H, W, C).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).reshape(*lead, h, w, C)


def mesh_signature(mesh, cam: CameraSet, height: int, width: int, n_envs: int) -> str:
    """The npz cache's key: the mesh (its first 64 KiB of vertex bytes and
    its face-index sum), the rig's angles and the sizes."""
    h = hashlib.md5()
    h.update(mesh.v_pos.detach().cpu().numpy().astype(np.float32).tobytes()[:65536])
    h.update(np.int64(mesh.t_pos_idx.sum().item()).tobytes())
    h.update(cam.elevation_deg.tobytes())
    h.update(cam.azimuth_deg.tobytes())
    h.update(np.asarray([height, width, n_envs]).tobytes())
    return h.hexdigest()[:16]


# cache files being written by a background thread, by path: a read of the
# same path waits for its writer
_writers: Dict[str, threading.Thread] = {}
_writers_lock = threading.Lock()


def _wait_for_writer(path: str) -> None:
    with _writers_lock:
        writer = _writers.pop(path, None)
    if writer is not None:
        writer.join()


def _load_cache(path: str, device) -> Optional[Dict[str, torch.Tensor]]:
    """The cached probes, maps and tables, decoded to f16 on ``device``, or
    None when the file lacks the tables (stale)."""
    def dec(a, scale):
        if a.dtype in (np.uint8, np.uint16):
            a = (a / np.float32(scale)).astype(np.float16)
        return torch.from_numpy(a).to(device)

    with np.load(path) as z:
        if "table_spec" not in z:
            return None
        return {"lightmaps": dec(z["lightmaps"], 255.0), "depths": dec(z["depths"], 65535.0),
                "normals": dec(z["normals"], 255.0),
                "table_spec": torch.from_numpy(z["table_spec"]).to(device)}


def quantize_for_cache(lightmaps, depths, normals):
    """The cache's quantization on the device: sRGB probes and normals to
    uint8, depth to uint16 (round half up)."""
    q = lambda x, top, dt: torch.clamp(x.float() * top + 0.5, 0, top).to(dt)
    return q(lightmaps, 255.0, torch.uint8), q(depths, 65535.0, torch.int32), \
        q(normals, 255.0, torch.uint8)


def _start_cache_write(path: str, data: PrerenderData) -> None:
    """Quantize on the device, take the arrays to the host, then compress and
    write them from a background thread (to ``<path>.tmp.npz``, renamed
    into place when complete)."""
    lm, d, n = quantize_for_cache(data.lightmaps, data.depths, data.normals)
    arrays = {"lightmaps": lm.cpu().numpy(), "depths": d.cpu().numpy().astype(np.uint16),
              "normals": n.cpu().numpy(), "table_spec": data.table_spec.cpu().numpy()}

    def save():
        t0 = time.time()
        tmp = path + ".tmp.npz"
        np.savez_compressed(tmp, **arrays)
        os.replace(tmp, path)
        dreammat_tpu_torch.info("saved prerender cache %s (%.1fs, background)", path,
                                time.time() - t0)

    writer = threading.Thread(target=save, name="prerender-cache-save")
    with _writers_lock:
        _writers[path] = writer
    writer.start()


def prerender(renderer, material, cam: CameraSet, height: int, width: int, n_envs: int,
              cache_dir: Optional[str] = None, cond_height: int = 256, cond_width: int = 256,
              pixel_budget: Optional[int] = None) -> PrerenderData:
    """All views' G-buffers, the mesh bakes, and the per-view probes and
    light tables (the reference's Blender prerender of the fixed rig). With
    ``cache_dir``, the probes, maps and tables come from its npz file for
    this mesh, rig and size when one exists, and are written to it when
    not; the G-buffers and the mesh bakes are made either way."""
    dev = renderer.device
    seconds: Dict[str, float] = {}
    cache_path = None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        sig = mesh_signature(renderer.mesh, cam, height, width, n_envs)
        cache_path = os.path.join(cache_dir, f"prerender_{sig}.npz")
    _sync(dev)
    t0 = time.time()
    gbuffers, _ = renderer.build_gbuffers_batched(cam, height, width, pixel_budget=pixel_budget)
    _sync(dev)
    seconds["gbuffers"] = time.time() - t0
    dreammat_tpu_torch.info("prerender: G-buffers for %d views in %.2fs", len(cam),
                            seconds["gbuffers"])
    cam_pos = uops.camera_position_from_spherical(
        torch.as_tensor(cam.elevation_deg), torch.as_tensor(cam.azimuth_deg),
        torch.as_tensor(cam.camera_distances)).to(dev)

    t0 = time.time()
    lvis, e_d_vertex, fg_lut, oct_res = mesh_bakes(renderer, material, n_envs)
    _sync(dev)
    seconds["mesh_bakes"] = time.time() - t0
    dreammat_tpu_torch.info("prerender: mesh-wide bakes in %.2fs", seconds["mesh_bakes"])

    # under a process group rank 0 loads or writes the cache first, then the
    # others read what it wrote (JAX prerender.py:684-690)
    with dist.rank_zero_first("prerender_cache") if cache_path else contextlib.nullcontext():
        if cache_path:
            _wait_for_writer(cache_path)
        if cache_path and os.path.exists(cache_path):
            t0 = time.time()
            cached = _load_cache(cache_path, dev)
            if cached is not None:
                _sync(dev)
                seconds["cache_load"] = time.time() - t0
                dreammat_tpu_torch.info("loaded prerender cache %s in %.2fs", cache_path,
                                        seconds["cache_load"])
                return PrerenderData(gbuffers=gbuffers, table_diff=e_d_vertex, lvis=lvis,
                                     oct_res=oct_res, cond_height=cond_height,
                                     cond_width=cond_width, seconds=seconds, from_cache=True,
                                     **cached)
            dreammat_tpu_torch.info("prerender cache %s is stale; regenerating", cache_path)

        t0 = time.time()
        lightmaps, tables, depths, normals = [], [], [], []
        for i, gb in enumerate(gbuffers):
            img, tab, depth, normal = probe_view_for_camera(
                renderer, (lvis, e_d_vertex, fg_lut, oct_res), cam_pos[i], gb, n_envs,
                cond_height, cond_width)
            lightmaps.append(img)
            tables.append(tab[:, :, 1:])
            depths.append(depth)
            normals.append(normal)
        data = PrerenderData(
            gbuffers=gbuffers, lightmaps=torch.stack(lightmaps), depths=torch.stack(depths),
            normals=torch.stack(normals), table_spec=torch.stack(tables), table_diff=e_d_vertex,
            lvis=lvis, oct_res=oct_res, cond_height=cond_height, cond_width=cond_width,
            seconds=seconds,
        )
        _sync(dev)
        seconds["probes_tables"] = time.time() - t0
        dreammat_tpu_torch.info("prerender: probes+tables for %d views in %.2fs", len(cam),
                                seconds["probes_tables"])
        if cache_path and dist.is_rank_zero():
            _start_cache_write(cache_path, data)
            if dist.process_count() > 1:  # the other ranks read it once this rank leaves
                _wait_for_writer(cache_path)
        return data


def _inverse_normalize_depth(depth_raw: np.ndarray, min_val: float = 0.3) -> np.ndarray:
    """Raw depth (scene units, 0 = miss) -> inverse-normalized [min_val, 1]
    foreground, the reference's depth-map transform."""
    mask = depth_raw > 0
    out = np.zeros_like(depth_raw, dtype=np.float32)
    if mask.sum() > 0:
        inv = 1.0 / (depth_raw + 1e-6)
        dmax, dmin = inv[mask].max(), inv[mask].min()
        out[mask] = (1 - min_val) * (inv[mask] - dmin) / (dmax - dmin + 1e-6) + min_val
    return out


_PROBE_TAGS = ["m0.0r0.0", "m0.0r0.5", "m0.0r1.0", "m1.0r0.0", "m1.0r0.5", "m1.0r1.0"]


def load_reference_png_cache(dir_path: str, n_views: int, n_envs: int,
                             cond_height: int = 256, cond_width: int = 256):
    """The reference's Blender PNG cache as numpy f16 (lightmaps [Nv,E,h,w,18],
    depths [Nv,h,w,1], normals [Nv,h,w,3]): ``depth/{i:03d}.png`` (16-bit
    depth in mm, inverse-normalized here), ``normal/{i:03d}.png`` and
    ``light/{i:03d}_m{m}r{r}_env{e}.png``; a missing file leaves zeros."""
    from PIL import Image

    def loadrgb(p, size):
        img = Image.open(p).convert("RGB").resize((size[1], size[0]))
        return np.asarray(img, dtype=np.float32) / 255.0

    lightmaps = np.zeros((n_views, n_envs, cond_height, cond_width, 18), dtype=np.float16)
    depths = np.zeros((n_views, cond_height, cond_width, 1), dtype=np.float16)
    normals = np.zeros((n_views, cond_height, cond_width, 3), dtype=np.float16)
    size = (cond_height, cond_width)
    for i in range(n_views):
        dpath = os.path.join(dir_path, "depth", f"{i:03d}.png")
        npath = os.path.join(dir_path, "normal", f"{i:03d}.png")
        if os.path.exists(dpath):
            img = Image.open(dpath).resize((size[1], size[0]), Image.NEAREST)
            d = np.asarray(img, dtype=np.float32)
            if d.ndim == 3:
                d = d[..., 0]
            depths[i] = _inverse_normalize_depth(d / 1000.0)[..., None]
        if os.path.exists(npath):
            normals[i] = loadrgb(npath, size)
        for e in range(1, n_envs + 1):
            chans = []
            for tag in _PROBE_TAGS:
                p = os.path.join(dir_path, "light", f"{i:03d}_{tag}_env{e}.png")
                chans.append(loadrgb(p, size) if os.path.exists(p)
                             else np.zeros((*size, 3), np.float32))
            lightmaps[i, e - 1] = np.concatenate(chans, axis=-1)
    return lightmaps, depths, normals


def write_reference_png_cache(dir_path: str, lightmaps, depth_raw, normals) -> None:
    """Condition maps in the reference's Blender PNG cache layout:
    lightmaps [Nv,E,H,W,18] sRGB in [0,1], depth_raw [Nv,H,W] scene-unit
    distances (0 = miss) as 16-bit millimetres, normals [Nv,H,W,3] in [0,1]."""
    from PIL import Image

    lightmaps = np.asarray(lightmaps, dtype=np.float32)
    depth_raw = np.asarray(depth_raw, dtype=np.float32)
    normals = np.asarray(normals, dtype=np.float32)
    for sub in ("depth", "normal", "light"):
        os.makedirs(os.path.join(dir_path, sub), exist_ok=True)
    n_views, n_envs = lightmaps.shape[:2]
    for i in range(n_views):
        d16 = np.clip(depth_raw[i] * 1000.0 + 0.5, 0, 65535).astype(np.uint16)
        Image.fromarray(d16).save(os.path.join(dir_path, "depth", f"{i:03d}.png"))
        n8 = np.clip(normals[i] * 255.0 + 0.5, 0, 255).astype(np.uint8)
        Image.fromarray(n8).save(os.path.join(dir_path, "normal", f"{i:03d}.png"))
        for e in range(n_envs):
            for pi, tag in enumerate(_PROBE_TAGS):
                img = lightmaps[i, e, :, :, 3 * pi:3 * pi + 3]
                u8 = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
                Image.fromarray(u8).save(
                    os.path.join(dir_path, "light", f"{i:03d}_{tag}_env{e + 1}.png"))
