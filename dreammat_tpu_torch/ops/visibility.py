"""Baked per-vertex visibility and the octahedral convolution bakes.

Counterpart of the tables-regime parts of ``dreammat_tpu/ops/visibility.py``:
the octahedral direction mapping, ``bake_vertex_visibility`` (V x O^2 rays
through the dense caster, kernel B on the card), ``self_occlusion_fraction``,
the fused env x visibility cache ``bake_shadowed_radiance``, and the
gather-free quadrature bakes ``bake_vertex_irradiance_conv`` and
``bake_vertex_specular_conv`` that the prerender builds the light tables
from.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from dreammat_tpu_torch.ops import bvh as bvh_lib


class BakedVisibility(NamedTuple):
    table: torch.Tensor  # [V, O*O] float16 (1 = unoccluded)
    oct_res: int


def _flip_sign(xy):
    return torch.sign(torch.where(xy == 0, torch.ones_like(xy), xy))


def oct_uv_to_dir(uv: torch.Tensor) -> torch.Tensor:
    """Octahedral uv in [0,1]^2 -> unit dirs [...,3]."""
    xy = uv * 2.0 - 1.0
    z = 1.0 - xy[..., 0:1].abs() - xy[..., 1:2].abs()
    folded = (1.0 - xy.flip(-1).abs()) * _flip_sign(xy)
    xy = torch.where(z < 0, folded, xy)
    d = torch.cat([xy, z], dim=-1)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def _oct_uv_to_dir_np(uv: np.ndarray) -> np.ndarray:
    xy = uv * 2.0 - 1.0
    z = 1.0 - np.abs(xy[..., 0:1]) - np.abs(xy[..., 1:2])
    folded = (1.0 - np.abs(xy[..., ::-1])) * np.sign(np.where(xy == 0, 1.0, xy))
    xy = np.where(z < 0, folded, xy)
    d = np.concatenate([xy, z], axis=-1)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _oct_grid_areas(N: int) -> np.ndarray:
    """Per-cell solid angles [N,N] (y-major) of the octahedral UV grid,
    normalized to 4 pi."""
    xs = np.arange(N + 1, dtype=np.float64) / N
    uu, vv = np.meshgrid(xs, xs, indexing="xy")
    d = _oct_uv_to_dir_np(np.stack([uu, vv], axis=-1))
    a, b, c, e = d[:-1, :-1], d[1:, :-1], d[1:, 1:], d[:-1, 1:]
    area = 0.5 * np.linalg.norm(np.cross(b - a, e - a), axis=-1)
    area += 0.5 * np.linalg.norm(np.cross(b - c, e - c), axis=-1)
    return area * (4.0 * np.pi / area.sum())


def _oct_grid_dirs(N: int) -> np.ndarray:
    cs = (np.arange(N, dtype=np.float64) + 0.5) / N
    cu, cv = np.meshgrid(cs, cs, indexing="xy")
    return _oct_uv_to_dir_np(np.stack([cu, cv], axis=-1))


@functools.lru_cache(maxsize=8)
def oct_bin_geometry(oct_res: int, supersample: int = 8):
    """Bin-center directions [O2,3] and solid angles [O2] (numpy float32)."""
    area = _oct_grid_areas(oct_res * supersample)
    sa = area.reshape(oct_res, supersample, oct_res, supersample).sum(axis=(1, 3)).reshape(-1)
    dirs = _oct_grid_dirs(oct_res).reshape(-1, 3)
    return dirs.astype(np.float32), sa.astype(np.float32)


@functools.lru_cache(maxsize=8)
def oct_bin_subgeometry(oct_res: int, sub: int = 3):
    """Subcell quadrature directions [s2,O2,3] and solid angles [s2,O2]."""
    N = oct_res * sub
    area = _oct_grid_areas(N).reshape(oct_res, sub, oct_res, sub)
    dirs = _oct_grid_dirs(N).reshape(oct_res, sub, oct_res, sub, 3)
    sa = np.moveaxis(area, 2, 1).reshape(oct_res * oct_res, sub * sub).T
    dd = np.moveaxis(np.moveaxis(dirs, 2, 1).reshape(oct_res * oct_res, sub * sub, 3), 1, 0)
    return dd.astype(np.float32), sa.astype(np.float32)


def _grid_dirs(N: int, device) -> torch.Tensor:
    xs = (torch.arange(N, dtype=torch.float32, device=device) + 0.5) / N
    vv, uu = torch.meshgrid(xs, xs, indexing="ij")
    return oct_uv_to_dir(torch.stack([uu.reshape(-1), vv.reshape(-1)], dim=-1))


def bake_vertex_visibility(bvh: bvh_lib.FlatBVH, v_pos: torch.Tensor, v_nrm: torch.Tensor,
                           oct_res: int = 16, eps: float = 1e-3, chunk: int = 1 << 16,
                           supersample: int = 1) -> BakedVisibility:
    """Cast V x (oct_res*supersample)^2 rays once (origins pushed off the
    surface along the normal and the ray); each bin stores the fraction of
    its sub-rays that escape."""
    V = v_pos.shape[0]
    s = max(int(supersample), 1)
    N = oct_res * s
    dirs = _grid_dirs(N, v_pos.device)
    N2 = N * N
    point_chunk = max(1, (chunk * 64) // N2)
    tri_data = bvh_lib._plane_tri_data(bvh)
    tables = []
    for i in range(0, V, point_chunk):
        vp = v_pos[i:i + point_chunk]
        vn = v_nrm[i:i + point_chunk]
        c = vp.shape[0]
        origins = (vp + vn * eps)[:, None, :] + dirs[None, :, :] * eps
        out = bvh_lib.cast_rays_chunked(
            bvh, origins.reshape(-1, 3), dirs[None].expand(c, N2, 3).reshape(-1, 3),
            tri_data=tri_data,
        )
        vis = (~out["hit"]).float().reshape(c, oct_res, s, oct_res, s)
        tables.append(vis.mean(dim=(2, 4)).reshape(c, oct_res * oct_res).half())
    return BakedVisibility(table=torch.cat(tables), oct_res=oct_res)


def self_occlusion_fraction(baked: BakedVisibility, v_nrm: torch.Tensor,
                            cos_margin: float = 0.1) -> float:
    """Fraction of upper-hemisphere table bins that are occluded."""
    dirs, _ = oct_bin_geometry(baked.oct_res)
    up = (v_nrm @ torch.as_tensor(dirs, device=v_nrm.device).T) > cos_margin
    occ = (baked.table.float() < 0.5) & up
    return float(occ.sum()) / float(max(int(up.sum()), 1))


def bake_shadowed_radiance(baked: BakedVisibility, envs: torch.Tensor,
                           supersample: int = 4) -> torch.Tensor:
    """L_vis [V, O2, E*3] float16: each env averaged over the bin
    (supersample^2 points) times the vertex's visibility of that bin."""
    from dreammat_tpu_torch.ops.envmap import sample_equirect_bilinear

    O = baked.oct_res
    s = max(int(supersample), 1)
    dirs = _grid_dirs(O * s, envs.device)
    env_rad = torch.stack([sample_equirect_bilinear(e, dirs) for e in envs])
    E = env_rad.shape[0]
    env_rad = env_rad.reshape(E, O, s, O, s, 3).mean(dim=(2, 4)).reshape(E, O * O, 3)
    flat = env_rad.permute(1, 0, 2).reshape(O * O, E * 3)
    return (flat[None] * baked.table.float()[:, :, None]).half()


def bake_vertex_irradiance_conv(lvis: torch.Tensor, v_nrm: torch.Tensor,
                                oct_res: int) -> torch.Tensor:
    """Per-vertex diffuse irradiance / pi, E_d [E, V, 3], as a cosine-kernel
    quadrature over the octahedral bins."""
    dirs, sa = oct_bin_geometry(oct_res)
    dirs = torch.as_tensor(dirs, device=v_nrm.device)
    sa = torch.as_tensor(sa, device=v_nrm.device)
    w = torch.clamp(v_nrm @ dirs.T, min=0.0) * sa                  # [V,O2]
    out = torch.einsum("vo,voc->vc", w, lvis.float()) / math.pi
    V, E = out.shape[0], out.shape[-1] // 3
    return out.reshape(V, E, 3).permute(1, 0, 2).contiguous()


def bake_vertex_specular_conv(lvis: torch.Tensor, refl: torch.Tensor, alphas, oct_res: int,
                              v_chunk: int = 8192, kernel_sub: int = 3) -> torch.Tensor:
    """GGX-prefiltered shadowed radiance S [V, K, E, 3] at each vertex's
    reflection direction, one level per alpha (subcell quadrature of
    D(NoH) NoL over every bin, with N = V = R)."""
    from dreammat_tpu_torch.models.material import distribution_ggx

    sub_dirs, sub_sa = oct_bin_subgeometry(oct_res, kernel_sub)
    sub_dirs = torch.as_tensor(sub_dirs, device=refl.device)   # [s2,O2,3]
    sub_sa = torch.as_tensor(sub_sa, device=refl.device)       # [s2,O2]
    alphas = torch.as_tensor(alphas, dtype=torch.float32, device=refl.device)
    V, C, K = refl.shape[0], lvis.shape[-1], alphas.shape[0]
    outs = []
    for s in range(0, V, v_chunk):
        r = refl[s:s + v_chunk]
        w = torch.zeros(r.shape[0], K, sub_dirs.shape[1], device=refl.device)
        for j in range(sub_dirs.shape[0]):
            RoL = r @ sub_dirs[j].T
            NoL = torch.clamp(RoL, min=0.0)
            NoH = torch.sqrt(torch.clamp((1.0 + RoL) * 0.5, 0.0, 1.0))
            D = distribution_ggx(NoH[:, None, :], alphas[None, :, None])
            w = w + D * (NoL * sub_sa[j])[:, None, :]
        num = torch.einsum("vko,voc->vkc", w, lvis[s:s + v_chunk].float())
        outs.append(num / (w.sum(-1)[..., None] + 1e-8))
    return torch.cat(outs).reshape(V, K, C // 3, 3)
