"""Exact signed distance to a closed triangle mesh, chunked over points.

Counterpart of ``winding_number``, ``point_mesh_sq_distance`` and
``mesh_signed_distance`` in ``dreammat_tpu/ops/shape_loss.py``: the sign
comes from the generalized winding number (van Oosterom-Strackee solid
angles summed over the triangles), the magnitude from the exact
point-triangle distance (Ericson's barycentric clamp), each over the
[chunk, T] product of points and triangles. The DMTet geometry's
``shape_init: mesh:<path>`` bakes it once at the lattice vertices.
(``build_shape_grid`` and the shape loss of Latent-NeRF are not ported.)
"""

from __future__ import annotations

import math

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
