"""Baked visibility, its lookups, and the octahedral convolution bakes.

Counterpart of ``dreammat_tpu/ops/visibility.py``: the octahedral direction
mapping, its nearest bin (``dir_to_bin``, y-major) and its bilinear
footprint, ``bake_vertex_visibility`` (V x O^2 rays,
their hit mask from ``occluded_chunked``: kernel B on the card, kernel E's
any-hit entry above 2^22 triangles) and its per-pixel twin
``bake_pixel_visibility``, the Monte-Carlo estimators' lookups
(``lookup_visibility``, barycentric over a triangle's vertex tables, and
``lookup_visibility_pixel``), ``self_occlusion_fraction``, the fused env x
visibility cache ``bake_shadowed_radiance`` and its lookups
(``lookup_shadowed_radiance_all_envs``, ``lookup_shadowed_radiance``), the
gather-free quadrature bakes ``bake_vertex_irradiance_conv`` and
``bake_vertex_specular_conv`` that the prerender builds the light tables
from, and ``bake_vertex_irradiance``, the cosine-set estimate of the same
irradiance that the reference-parity MC probe renderer reads.

The JAX package's environment switches of the lookups (``DREAMMAT_VIS_*``,
A/B knobs of its fidelity tool) and its ``filter_mode`` argument are not
ported: the lookups always filter bilinearly and carry no gradient.
``dir_to_bin`` and the one-environment ``lookup_shadowed_radiance`` mirror
the JAX package's functions and have no caller in the port.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from dreammat_tpu_torch.ops import bvh as bvh_lib
from dreammat_tpu_torch.utils import ops as uops


class BakedVisibility(NamedTuple):
    table: torch.Tensor  # [V, O*O] float16 (1 = unoccluded)
    oct_res: int


class PixelVisibility(NamedTuple):
    """Per-pixel octahedral visibility of one G-buffer: row i belongs to
    the view's foreground pixel i, so the lookup has no barycentric
    spatial error, only directional binning."""

    table: torch.Tensor  # [P, O*O] (1 = unoccluded)
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


def dir_to_oct_uv(d: torch.Tensor) -> torch.Tensor:
    """Unit dirs [...,3] -> octahedral uv in [0,1]^2."""
    n = d / (d[..., 0:1].abs() + d[..., 1:2].abs() + d[..., 2:3].abs() + 1e-12)
    xy = n[..., :2]
    folded = (1.0 - xy.flip(-1).abs()) * _flip_sign(xy)
    xy = torch.where(n[..., 2:3] < 0, folded, xy)
    return xy * 0.5 + 0.5


def dir_to_bin(d: torch.Tensor, oct_res: int) -> torch.Tensor:
    """The nearest octahedral bin [...] (int64, y-major: y * oct_res + x)
    of unit dirs [...,3]."""
    uv = dir_to_oct_uv(d)
    x = torch.clamp((uv[..., 0] * oct_res).long(), 0, oct_res - 1)
    y = torch.clamp((uv[..., 1] * oct_res).long(), 0, oct_res - 1)
    return y * oct_res + x


def oct_bilinear_bins_weights(d: torch.Tensor, oct_res: int):
    """Bilinear texel footprint on the octahedral map: bins [...,4] (int64)
    and weights [...,4] (sum 1) for unit dirs [...,3]. Neighbours outside
    the square wrap by the octahedral mirror-with-flip rule."""
    O = oct_res
    uv = dir_to_oct_uv(d)
    x = uv[..., 0] * O - 0.5
    y = uv[..., 1] * O - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0f)[..., None], (y - y0f)[..., None]
    x0, y0 = x0f.long(), y0f.long()
    ix = torch.stack([x0, x0 + 1, x0, x0 + 1], dim=-1)
    iy = torch.stack([y0, y0, y0 + 1, y0 + 1], dim=-1)
    over_x = (ix < 0) | (ix > O - 1)
    ix = torch.where(ix < 0, -1 - ix, torch.where(ix > O - 1, 2 * O - 1 - ix, ix))
    iy = torch.where(over_x, O - 1 - iy, iy)
    over_y = (iy < 0) | (iy > O - 1)
    iy = torch.where(iy < 0, -1 - iy, torch.where(iy > O - 1, 2 * O - 1 - iy, iy))
    ix = torch.where(over_y, O - 1 - ix, ix)
    w = torch.cat([(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy], dim=-1)
    return iy * O + ix, w


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


def morton_order(points: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """The permutation that sorts ``points`` [n, 3] by the Morton code of
    their positions, quantised to ``bits`` per axis over their box: nearby
    points come out close together."""
    lo = points.amin(0)
    span = (points.amax(0) - lo).clamp_min(1e-12)
    q = ((points - lo) / span * ((1 << bits) - 1)).round().long()
    code = torch.zeros_like(q[:, 0])
    for b in range(bits):
        for a in range(3):
            code |= ((q[:, a] >> b) & 1) << (3 * b + a)
    return torch.argsort(code, stable=True)


def bake_rays(v_pos: torch.Tensor, v_nrm: torch.Tensor, dirs: torch.Tensor, eps: float):
    """The rays of one bake chunk in the order the caster culls best:
    vertices sorted by ``morton_order``, direction-major (for each
    direction, every vertex), so that consecutive rays start close
    together and run parallel. Returns (origins [D*c, 3], directions
    [D*c, 3], order [c]); ray (j, i) is vertex order[i]'s ray along
    dirs[j], computed by the same expression as in vertex-major order."""
    order = morton_order(v_pos)
    vp, vn = v_pos[order], v_nrm[order]
    c, n_dirs = vp.shape[0], dirs.shape[0]
    origins = (vp + vn * eps)[None, :, :] + dirs[:, None, :] * eps
    directions = dirs[:, None, :].expand(n_dirs, c, 3)
    return origins.reshape(-1, 3), directions.reshape(-1, 3), order


def bake_vertex_visibility(bvh: bvh_lib.FlatBVH, v_pos: torch.Tensor, v_nrm: torch.Tensor,
                           oct_res: int = 16, eps: float = 1e-3, chunk: int = 1 << 16,
                           supersample: int = 1) -> BakedVisibility:
    """Cast V x (oct_res*supersample)^2 rays once (origins pushed off the
    surface along the normal and the ray); each bin stores the fraction of
    its sub-rays that escape. Each chunk's rays go to the caster in
    ``bake_rays``' order and their hits are scattered back per vertex; only
    the hit mask is read (``occluded_chunked``: kernel B at or below
    ``DENSE_CAST_MAX_TRIS`` triangles, kernel E's any-hit entry above)."""
    V = v_pos.shape[0]
    s = max(int(supersample), 1)
    N = oct_res * s
    dirs = _grid_dirs(N, v_pos.device)
    N2 = N * N
    point_chunk = max(1, (chunk * 64) // N2)
    tri_data = bvh_lib.cast_data(bvh)
    tables = []
    for i in range(0, V, point_chunk):
        vp = v_pos[i:i + point_chunk]
        vn = v_nrm[i:i + point_chunk]
        c = vp.shape[0]
        origins, directions, order = bake_rays(vp, vn, dirs, eps)
        occluded = bvh_lib.occluded_chunked(bvh, origins, directions, tri_data=tri_data)
        hit = torch.empty(c, N2, dtype=torch.bool, device=vp.device)
        hit[order] = occluded.reshape(N2, c).T
        vis = (~hit).float().reshape(c, oct_res, s, oct_res, s)
        tables.append(vis.mean(dim=(2, 4)).reshape(c, oct_res * oct_res).half())
    return BakedVisibility(table=torch.cat(tables), oct_res=oct_res)


def bake_pixel_visibility(bvh: bvh_lib.FlatBVH, pts: torch.Tensor, normals: torch.Tensor,
                          oct_res: int = 16, eps: float = 1e-3, chunk: int = 1 << 16,
                          supersample: int = 1) -> PixelVisibility:
    """An octahedral visibility table at each G-buffer pixel: the vertex
    bake (same caster, kernel B on the card, same bins) run at the shading
    points. Padding pixels bake harmless rows; their lights are zeroed
    downstream."""
    bv = bake_vertex_visibility(bvh, pts, normals, oct_res=oct_res, eps=eps, chunk=chunk,
                                supersample=supersample)
    return PixelVisibility(table=bv.table, oct_res=oct_res)


def _postprocess_vis(out: torch.Tensor) -> torch.Tensor:
    """The shared tail of the lookups: the detach. The exact estimator's
    visibility is a boolean hit, a constant to autograd; a differentiable
    bilinear lookup would add a horizon term that the reference's gradient
    never holds."""
    return out.detach()


def lookup_visibility(baked: BakedVisibility, tri_verts: torch.Tensor, bary: torch.Tensor,
                      directions: torch.Tensor) -> torch.Tensor:
    """Soft visibility [P,S]: the barycentric mix of the three vertex tables
    of each pixel's triangle (``tri_verts`` [P,3], ``bary`` [P,3]) at each
    direction [P,S,3], bilinear over the bins. Carries no gradient."""
    t = baked.table.float()
    P, S = directions.shape[:2]
    bins4, w4 = oct_bilinear_bins_weights(directions, baked.oct_res)
    bins = bins4.reshape(P, S * 4)
    out = (bary[:, 0:1] * t[tri_verts[:, 0]].gather(1, bins)
           + bary[:, 1:2] * t[tri_verts[:, 1]].gather(1, bins)
           + bary[:, 2:3] * t[tri_verts[:, 2]].gather(1, bins))
    return _postprocess_vis((out.reshape(P, S, 4) * w4).sum(-1))


def lookup_visibility_pixel(baked: PixelVisibility, directions: torch.Tensor) -> torch.Tensor:
    """Per-sample visibility [P,S] from a per-pixel table (row i is pixel
    i); the same filtering and detach as ``lookup_visibility``."""
    t = baked.table.float()
    P, S = directions.shape[:2]
    bins4, w4 = oct_bilinear_bins_weights(directions, baked.oct_res)
    out = (t.gather(1, bins4.reshape(P, S * 4)).reshape(P, S, 4) * w4).sum(-1)
    return _postprocess_vis(out)


def self_occlusion_fraction(baked: BakedVisibility, v_nrm: torch.Tensor,
                            cos_margin: float = 0.1) -> float:
    """Fraction of upper-hemisphere table bins that are occluded."""
    dirs, _ = oct_bin_geometry(baked.oct_res)
    up = (v_nrm @ torch.as_tensor(dirs, device=v_nrm.device).T) > cos_margin
    occ = (baked.table.float() < 0.5) & up
    return float(occ.sum()) / float(max(int(up.sum()), 1))


# vertices a chunk of the whole-mesh bakes below: a whole-mesh fp32
# temporary of a 2.6M-vertex mesh's shadowed radiance would be 40 GB
_V_CHUNK = 1 << 18


def bake_shadowed_radiance(baked: BakedVisibility, envs: torch.Tensor,
                           supersample: int = 4) -> torch.Tensor:
    """L_vis [V, O2, E*3] float16: each env averaged over the bin
    (supersample^2 points) times the vertex's visibility of that bin, the
    fp32 products formed ``_V_CHUNK`` vertices at a time."""
    from dreammat_tpu_torch.ops.envmap import sample_equirect_bilinear

    O = baked.oct_res
    s = max(int(supersample), 1)
    dirs = _grid_dirs(O * s, envs.device)
    env_rad = torch.stack([sample_equirect_bilinear(e, dirs) for e in envs])
    E = env_rad.shape[0]
    env_rad = env_rad.reshape(E, O, s, O, s, 3).mean(dim=(2, 4)).reshape(E, O * O, 3)
    flat = env_rad.permute(1, 0, 2).reshape(O * O, E * 3)
    table = baked.table
    out = torch.empty(table.shape[0], O * O, E * 3, dtype=torch.float16, device=table.device)
    for s in range(0, table.shape[0], _V_CHUNK):
        out[s:s + _V_CHUNK] = (flat[None] * table[s:s + _V_CHUNK].float()[:, :, None]).half()
    return out


def lookup_shadowed_radiance_all_envs(lvis: torch.Tensor, tri_verts: torch.Tensor,
                                      bary: torch.Tensor, directions: torch.Tensor,
                                      oct_res: int) -> torch.Tensor:
    """Shadowed incoming radiance of every environment at once, [P,S,E,3]:
    the barycentric mix (``tri_verts``, ``bary`` [P,3]) of the three vertex
    rows of ``lvis`` [V, O2, E*3] at each direction [P,S,3], bilinear over
    the bins."""
    t = lvis.float()
    C = t.shape[-1]
    P, S = directions.shape[:2]
    bins4, w4 = oct_bilinear_bins_weights(directions, oct_res)
    bins = bins4.reshape(P, S * 4)
    out = sum(bary[:, k:k + 1, None] * t[tri_verts[:, k:k + 1], bins] for k in range(3))
    return (out.reshape(P, S, 4, C) * w4[..., None]).sum(2).reshape(P, S, C // 3, 3)


def lookup_shadowed_radiance(lvis: torch.Tensor, tri_verts: torch.Tensor, bary: torch.Tensor,
                             directions: torch.Tensor, oct_res: int,
                             env_id: int = 0) -> torch.Tensor:
    """One environment's shadowed radiance [P,S,3]."""
    return lookup_shadowed_radiance_all_envs(lvis, tri_verts, bary, directions,
                                             oct_res)[:, :, env_id]


def bake_vertex_irradiance_conv(lvis: torch.Tensor, v_nrm: torch.Tensor,
                                oct_res: int) -> torch.Tensor:
    """Per-vertex diffuse irradiance / pi, E_d [E, V, 3], as a cosine-kernel
    quadrature over the octahedral bins (``_V_CHUNK`` vertices at a time)."""
    dirs, sa = oct_bin_geometry(oct_res)
    dirs = torch.as_tensor(dirs, device=v_nrm.device)
    sa = torch.as_tensor(sa, device=v_nrm.device)
    w = torch.clamp(v_nrm @ dirs.T, min=0.0) * sa                  # [V,O2]
    out = torch.cat([torch.einsum("vo,voc->vc", w[s:s + _V_CHUNK], lvis[s:s + _V_CHUNK].float())
                     for s in range(0, w.shape[0], _V_CHUNK)]) / math.pi
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


def bake_vertex_irradiance(baked: BakedVisibility, lvis: torch.Tensor, v_nrm: torch.Tensor,
                           diffuse_samples: torch.Tensor,
                           v_chunk: int = 1 << 14) -> torch.Tensor:
    """Per-vertex diffuse irradiance E_d [E, V, 3] as the reference's
    estimator forms it: the mean over the cosine-weighted set
    ``diffuse_samples`` [dn, 2] (fibonacci azimuth / 2 pi, elevation term)
    in each vertex's normal frame of the shadowed radiance ``lvis``, read
    bilinearly; ``v_chunk`` vertices at a time (their gather is
    [v_chunk, 4 dn, E*3] fp32)."""
    az = diffuse_samples[:, 0][None, :, None] * (2.0 * math.pi)
    el = diffuse_samples[:, 1][None, :, None]
    el_sqrt = torch.sqrt(el + 1e-7)
    cz = torch.sqrt(1.0 - el + 1e-7)
    t = lvis.float()
    dn = diffuse_samples.shape[0]
    means = []
    for s in range(0, v_nrm.shape[0], v_chunk):
        n = v_nrm[s:s + v_chunk]
        x = uops.get_orthogonal_directions(n)
        y = torch.linalg.cross(n, x, dim=-1)
        dirs = (el_sqrt * torch.cos(az) * x[:, None] + el_sqrt * torch.sin(az) * y[:, None]
                + cz * n[:, None])                                      # [c,dn,3]
        bins4, w4 = oct_bilinear_bins_weights(dirs, baked.oct_res)      # [c,dn,4]
        c = n.shape[0]
        rows = torch.arange(s, s + c, device=t.device)[:, None]
        rad = t[rows, bins4.reshape(c, dn * 4)].reshape(c, dn, 4, -1)
        means.append((rad * w4[..., None]).sum(2).mean(1))              # [c,E*3]
    mean = torch.cat(means)
    V, E = mean.shape[0], mean.shape[-1] // 3
    return mean.reshape(V, E, 3).permute(1, 0, 2).contiguous()
