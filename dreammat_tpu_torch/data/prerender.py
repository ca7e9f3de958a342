"""Condition-map and light-table prerender for the fixed camera rig.

Counterpart of the tables-regime path of ``dreammat_tpu/data/prerender.py``:
G-buffers for every view, the mesh-wide bakes (visibility -> shadowed
radiance -> per-vertex irradiance, plus the FG LUT), then per view the
per-vertex GGX-prefiltered table, the six light-probe images
(metallic {0,1} x roughness {0, 0.5, 1}, white base color) under every
environment, and the depth and normal condition maps, all resized to the
condition resolution. The npz cache and the reference PNG cache are not
ported yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

import dreammat_tpu_torch
from dreammat_tpu_torch.data.cameras import CameraSet
from dreammat_tpu_torch.ops import envmap as envmap_lib
from dreammat_tpu_torch.utils import ops as uops

PROBE_MR = [(0.0, 0.0), (0.0, 0.5), (0.0, 1.0), (1.0, 0.0), (1.0, 0.5), (1.0, 1.0)]
TABLE_ALPHAS = (1e-3, 0.08, 0.25, 0.5, 1.0)
_PROBE_SET_IDX = {0.0: 0, 0.5: 2, 1.0: 4}


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


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def mesh_bakes(renderer, material, n_envs: int):
    """(lvis, e_d_vertex, fg_lut, oct_res): the view-independent bakes."""
    from dreammat_tpu_torch.ops import visibility as vis_lib

    baked = material.baked_visibility
    if baked is None:
        baked = vis_lib.bake_vertex_visibility(renderer.bvh, renderer.mesh.v_pos,
                                               renderer.mesh.v_nrm)
    lvis = vis_lib.bake_shadowed_radiance(baked, material.envs[:n_envs])
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

    H, W = gb.mask.shape
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
    out = torch.cat(per_probe, dim=-1)                                           # [E,P,18]
    vals = torch.where(gb.fg_valid[None, :, None], out, torch.zeros_like(out))
    img = torch.zeros(n_envs, H * W, 18, device=out.device).index_add_(1, gb.fg_idx, vals)
    img = img * gb.mask.reshape(1, -1, 1).float()
    return img.reshape(n_envs, H, W, 18), tab_v.permute(2, 0, 1, 3)


def resize_hw(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[..., H, W, C] -> [..., h, w, C]: half-pixel bilinear, antialiased when
    shrinking (``jax.image.resize(method="linear")`` semantics)."""
    lead, (H, W, C) = img.shape[:-3], img.shape[-3:]
    if (H, W) == (h, w):
        return img
    x = img.reshape(-1, H, W, C).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).reshape(*lead, h, w, C)


def prerender(renderer, material, cam: CameraSet, height: int, width: int, n_envs: int,
              cond_height: int = 256, cond_width: int = 256,
              pixel_budget: Optional[int] = None) -> PrerenderData:
    """All views' G-buffers, the mesh bakes, and the per-view probes and
    light tables (the reference's Blender prerender of the fixed rig)."""
    dev = renderer.device
    seconds: Dict[str, float] = {}
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

    t0 = time.time()
    lightmaps, tables, depths, normals = [], [], [], []
    for i, gb in enumerate(gbuffers):
        img, tab = _probe_view_body(renderer.mesh.v_pos, renderer.mesh.v_nrm, lvis, e_d_vertex,
                                    fg_lut, cam_pos[i], gb, oct_res, n_envs)
        lightmaps.append(resize_hw(img, cond_height, cond_width).half())
        tables.append(tab[:, :, 1:].half())
        depths.append(resize_hw(gb.cn_depth.float(), cond_height, cond_width).half())
        normals.append(resize_hw(gb.cn_normal.float(), cond_height, cond_width).half())
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
