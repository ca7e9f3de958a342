"""Exact signed distance to a closed triangle mesh, and Latent-NeRF's sketch-shape loss.

Counterpart of ``winding_number``, ``point_mesh_sq_distance`` and
``mesh_signed_distance`` in ``dreammat_tpu/ops/shape_loss.py``: the sign
comes from the generalized winding number (van Oosterom-Strackee solid
angles summed over the triangles), the magnitude from the exact
point-triangle distance (Ericson's barycentric clamp), each over the
[chunk, T] product of points and triangles. The DMTet geometry's
``shape_init: mesh:<path>`` bakes it once at the lattice vertices, the
implicit SDF's fits its field to it.

The sketch-shape guide (``ShapeGrid``, ``build_shape_grid``, ``shape_loss``):
the guide mesh is centred at its vertex mean, scaled so its farthest vertex
lies at ``mesh_scale`` and turned by the fixed ``_MATRIX_ROT``; its winding
number and the weight 1 - exp(-d^2 / 2 p^2) (d the distance to the surface,
p ``proximal_surface``) are baked once on a G^3 lattice over
[-bound, bound]^3, on the device in chunks. The loss samples both grids at
the ray samples with ``_trilinear``, which is corner-aligned with clamped
edges (u = (p / 2b + 1/2)(G - 1)), unlike the cell-centred
``trilinear_sample`` of the volume grid, and sums the weighted cross
entropy between the NeRF occupancy 1 - exp(-0.2 sigma) and the inside
indicator (winding > 1/2, clamped to [1e-4, 1 - 1e-4]).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


def winding_number(points: torch.Tensor, tri_verts: torch.Tensor,
                   chunk: int = 4096) -> torch.Tensor:
    """Generalized winding number of ``points`` [P,3] with respect to the
    triangles [T,3,3]: ~0 outside a closed mesh, ~1 inside."""
    out = []
    for s in range(0, points.shape[0], chunk):
        p = points[s:s + chunk]
        a = tri_verts[None, :, 0] - p[:, None]                        # [C,T,3]
        b = tri_verts[None, :, 1] - p[:, None]
        c = tri_verts[None, :, 2] - p[:, None]
        la, lb, lc = (torch.linalg.norm(x, dim=-1) for x in (a, b, c))
        num = torch.sum(a * torch.linalg.cross(b, c, dim=-1), dim=-1)
        den = (la * lb * lc + torch.sum(a * b, dim=-1) * lc + torch.sum(b * c, dim=-1) * la
               + torch.sum(c * a, dim=-1) * lb)
        out.append(torch.sum(2.0 * torch.atan2(num, den), dim=-1) / (4.0 * math.pi))
    return torch.cat(out)


def point_mesh_sq_distance(points: torch.Tensor, tri_verts: torch.Tensor,
                           chunk: int = 4096) -> torch.Tensor:
    """Squared distance from each point [P,3] to the closest triangle of
    [T,3,3]."""
    va, vb, vc = tri_verts[:, 0], tri_verts[:, 1], tri_verts[:, 2]
    ab, ac = vb - va, vc - va
    zero, one = torch.zeros((), device=points.device), torch.ones((), device=points.device)
    out = []
    for s in range(0, points.shape[0], chunk):
        p = points[s:s + chunk]
        ap = p[:, None] - va[None]                                    # [C,T,3]
        d1 = torch.sum(ab[None] * ap, dim=-1)
        d2 = torch.sum(ac[None] * ap, dim=-1)
        bp = p[:, None] - vb[None]
        d3 = torch.sum(ab[None] * bp, dim=-1)
        d4 = torch.sum(ac[None] * bp, dim=-1)
        cp = p[:, None] - vc[None]
        d5 = torch.sum(ab[None] * cp, dim=-1)
        d6 = torch.sum(ac[None] * cp, dim=-1)

        va_ = d3 * d6 - d5 * d4
        vb_ = d5 * d2 - d1 * d6
        vc_ = d1 * d4 - d3 * d2
        denom = torch.clamp(va_ + vb_ + vc_, min=1e-30)
        v = torch.clamp(vb_ / denom, 0.0, 1.0)
        w = torch.minimum(torch.clamp(vc_ / denom, min=0.0), 1.0 - v)
        # vertex and edge regions (Ericson 5.1.5)
        r_a = (d1 <= 0) & (d2 <= 0)
        v, w = torch.where(r_a, zero, v), torch.where(r_a, zero, w)
        r_b = (d3 >= 0) & (d4 <= d3)
        v, w = torch.where(r_b, one, v), torch.where(r_b, zero, w)
        r_c = (d6 >= 0) & (d5 <= d6)
        v, w = torch.where(r_c, zero, v), torch.where(r_c, one, w)
        e_ab = (vc_ <= 0) & (d1 >= 0) & (d3 <= 0)
        t_ab = torch.where((d1 - d3).abs() > 1e-30, d1 / (d1 - d3 + 1e-30), zero)
        v, w = torch.where(e_ab, torch.clamp(t_ab, 0.0, 1.0), v), torch.where(e_ab, zero, w)
        e_ac = (vb_ <= 0) & (d2 >= 0) & (d6 <= 0)
        t_ac = torch.where((d2 - d6).abs() > 1e-30, d2 / (d2 - d6 + 1e-30), zero)
        v, w = torch.where(e_ac, zero, v), torch.where(e_ac, torch.clamp(t_ac, 0.0, 1.0), w)
        e_bc = (va_ <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)
        t_bc = torch.clamp((d4 - d3) / ((d4 - d3 + d5 - d6).abs() + 1e-30), 0.0, 1.0)
        v, w = torch.where(e_bc, 1.0 - t_bc, v), torch.where(e_bc, t_bc, w)

        closest = va[None] + v[..., None] * ab[None] + w[..., None] * ac[None]
        out.append(torch.sum((p[:, None] - closest) ** 2, dim=-1).amin(dim=-1))
    return torch.cat(out)


def mesh_signed_distance(points: torch.Tensor, tri_verts: torch.Tensor,
                         inside_positive: bool = True, chunk: int = 4096) -> torch.Tensor:
    """Signed distance of ``points`` [P,3] to the closed mesh [T,3,3]:
    positive inside (``inside_positive``, the DMTet convention) or outside."""
    d = torch.sqrt(point_mesh_sq_distance(points, tri_verts, chunk=chunk))
    w = winding_number(points, tri_verts, chunk=chunk)
    sign = torch.where(w > 0.5, 1.0, -1.0)
    return (sign if inside_positive else -sign) * d


# the fixed rotation the guide mesh takes after its normalization
_MATRIX_ROT = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32) @ \
    np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], np.float32)


class ShapeGrid(NamedTuple):
    winding: torch.Tensor  # [G,G,G] generalized winding number
    weight: torch.Tensor   # [G,G,G] the CE weight 1 - gaussian(distance)
    bound: float           # the lattice spans [-bound, bound]^3


def guide_triangles(verts: np.ndarray, faces: np.ndarray, mesh_scale: float = 0.7) -> np.ndarray:
    """The guide mesh's triangles [F,3,3], normalized and turned."""
    v = np.asarray(verts, np.float32)
    v = v - v.mean(axis=0)
    v = v / max(float(np.max(np.linalg.norm(v, axis=1))), 1e-12) * mesh_scale
    return np.ascontiguousarray((v @ _MATRIX_ROT.T)[np.asarray(faces, np.int64)])


def build_shape_grid(verts: np.ndarray, faces: np.ndarray, resolution: int = 64,
                     mesh_scale: float = 0.7, proximal_surface: float = 0.3, bound: float = 1.0,
                     device="cuda", chunk: int = 1024) -> ShapeGrid:
    """The guide mesh (raw vertices [V,3], faces [F,3]) baked on a
    ``resolution``^3 lattice on ``device``, ``chunk`` lattice points at a time."""
    tri = torch.from_numpy(guide_triangles(verts, faces, mesh_scale)).to(device)
    g = np.linspace(-bound, bound, resolution, dtype=np.float32)
    pts = torch.from_numpy(np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
                           ).to(device)
    shape = (resolution,) * 3
    wind = winding_number(pts, tri, chunk=chunk).reshape(shape)
    if proximal_surface > 0:
        d2 = point_mesh_sq_distance(pts, tri, chunk=chunk)
        weight = (1.0 - torch.exp(-d2 / (2.0 * proximal_surface ** 2))).reshape(shape)
    else:
        weight = torch.ones(shape, device=pts.device)
    return ShapeGrid(wind, weight, float(bound))


def _trilinear(grid: torch.Tensor, pts: torch.Tensor, bound: float) -> torch.Tensor:
    """[G,G,G] sampled at points [..., 3] in [-bound, bound]^3, corner-aligned,
    edges clamped."""
    G = grid.shape[0]
    u = torch.clamp((pts / (2.0 * bound) + 0.5) * (G - 1), 0.0, G - 1 - 1e-6)
    i0 = torch.floor(u).long()
    f = u - i0
    i1 = torch.clamp(i0 + 1, max=G - 1)
    flat = grid.reshape(-1)
    at = lambda ix, iy, iz: flat.index_select(0, ((ix * G + iy) * G + iz).reshape(-1)
                                              ).reshape(ix.shape)
    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    x1, y1, z1 = i1[..., 0], i1[..., 1], i1[..., 2]
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c00 = at(x0, y0, z0) * (1 - fx) + at(x1, y0, z0) * fx
    c10 = at(x0, y1, z0) * (1 - fx) + at(x1, y1, z0) * fx
    c01 = at(x0, y0, z1) * (1 - fx) + at(x1, y0, z1) * fx
    c11 = at(x0, y1, z1) * (1 - fx) + at(x1, y1, z1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def shape_loss(points: torch.Tensor, density: torch.Tensor, grid: ShapeGrid,
               delta: float = 0.2) -> torch.Tensor:
    """The weighted cross entropy of the NeRF occupancy at the samples
    (``points`` [..., 3], ``density`` [...] or [..., 1]) against the guide's
    inside indicator, summed."""
    if density.dim() == points.dim():
        density = density[..., 0]
    with torch.no_grad():
        indicator = (_trilinear(grid.winding, points, grid.bound) > 0.5).float()
        weight = _trilinear(grid.weight, points, grid.bound)
        q = torch.clamp(indicator, 1e-4, 1.0 - 1e-4)
    nerf_occ = torch.clamp(1.0 - torch.exp(-delta * density), 0.0, 1.1)
    ce = -(nerf_occ * torch.log(q) + (1.0 - nerf_occ) * torch.log(1.0 - q))
    return torch.sum(ce * weight)
