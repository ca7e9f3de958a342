"""Differentiable mesh renderer for the DMTet geometry.

Counterpart of ``nvdiff-rasterizer`` in
``dreammat_tpu/models/mesh_rasterizer.py``, in its three parts:

(a) the hit pass: the camera rays against the marching-tets soup, wrapped
    as a one-node ``FlatBVH`` (``tri_v0``, ``tri_e1``, ``tri_e2`` from the
    detached corners, ``tri_id`` = the slot, -1 for invalid slots) and cast
    by ``ops/bvh.py::cast_rays_dense``: kernel B on CUDA tensors, the plain
    caster ``cast_rays_plain`` on CPU ones, as the JAX package casts with
    its Pallas caster on the TPU (its CPU path is a Moeller-Trumbore scan,
    which can differ from the plane test on rays through an edge). The hit
    slot, clamped to [0, F-1] (a miss reads slot 0), carries no gradient;
(b) the differentiable re-interpolation: Moeller-Trumbore on the hit
    triangle's corners recomputes t, the barycentrics, the position and the
    shared-vertex normal, so gradients reach the corners and through them
    the SDF and the deformation;
(c) the silhouette: opacity sigmoid(sharpness max_k sdf(x_k)) over K
    samples of the SDF lattice along each ray's span in the box
    (``trilinear_sample``, cell-centred like the JAX package's, which puts
    the level set at res/(res+1) of the mesh's distance from the centre),
    composited as clip(0.5 opacity + 0.5 hit, 0, 1). As in the JAX
    package, the colour is the material's at the re-interpolated position of
    every ray, so a ray that misses but passes near the surface takes the
    colour of slot 0's plane.

The soup's one-node arrays are put on the device once per soup size, so
the hit pass copies nothing from the host in a step (no host sync).

``render_image`` extracts the isosurface once per image and renders the
view in chunks of ``eval_chunk_rays`` rays, one cast (one kernel-B launch
on the card) per chunk; the outputs are those of one ``render_rays`` per
chunk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

import dreammat_tpu_torch
from dreammat_tpu_torch.models.geometry_volume import trilinear_sample
from dreammat_tpu_torch.models.volume_renderer import ray_aabb
from dreammat_tpu_torch.ops import bvh as bvh_lib
from dreammat_tpu_torch.ops import dmtet
from dreammat_tpu_torch.utils.base import BaseObject
from dreammat_tpu_torch.utils.hw import resolve_device
from dreammat_tpu_torch.utils.ops import safe_normalize


def _moller_trumbore(ro, rd, v0, v1, v2, eps: float = 1e-9):
    """Batched ray-triangle test: (t, u, v, hit), all [...]."""
    e1, e2 = v1 - v0, v2 - v0
    p = torch.linalg.cross(rd, e2, dim=-1)
    det = torch.sum(e1 * p, dim=-1)
    inv = 1.0 / torch.where(det.abs() < eps, torch.full_like(det, eps), det)
    s = ro - v0
    u = torch.sum(s * p, dim=-1) * inv
    q = torch.linalg.cross(s, e1, dim=-1)
    v = torch.sum(rd * q, dim=-1) * inv
    t = torch.sum(e2 * q, dim=-1) * inv
    hit = (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-4) & (det.abs() > eps)
    return t, u, v, hit


@dreammat_tpu_torch.register("nvdiff-rasterizer")
class MeshRasterizer(BaseObject):
    @dataclass
    class Config:
        radius: float = 1.0
        sdf_opacity_sharpness: float = 50.0
        sdf_opacity_samples: int = 48
        # the JAX CPU scan's chunk; the port's plain caster chunks itself
        face_chunk: int = 4096
        context_type: str = "gl"
        # the keys the volume systems' hooks read; the rasterizer has no
        # occupancy grid
        estimator: str = "none"
        grid_prune: bool = False
        grid_update_every: int = 0
        eval_chunk_rays: int = 8192

    cfg: Config
    is_volume: bool = True  # takes rays-only batches

    def __init__(self, cfg, geometry, material, background, device="cuda") -> None:
        self.geometry = geometry
        self.material = material
        self.background = background
        super().__init__(cfg, device=device)

    def configure(self, device="cuda") -> None:
        self.device = resolve_device(device)
        r = self.cfg.radius
        self.bbox_lo = torch.tensor([-r] * 3, dtype=torch.float32, device=self.device)
        self.bbox_hi = torch.tensor([r] * 3, dtype=torch.float32, device=self.device)
        self.mesh = None
        self._nodes = {}

    def init_state(self) -> None:
        return None

    def update_occ(self, geo_field, occ, draws):
        return occ

    # -- (a) hit pass ----------------------------------------------------------
    def _one_node(self, F: int, dev: torch.device):
        """(node box lo, hi, child, first, count, slot ids) of an F-slot soup
        on ``dev``, built once per (F, device)."""
        key = (F, dev)
        if key not in self._nodes:
            i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
            self._nodes[key] = (self.bbox_lo[None].to(dev), self.bbox_hi[None].to(dev),
                                i32([-1]), i32([0]), i32([F]),
                                torch.arange(F, dtype=torch.int32, device=dev))
        return self._nodes[key]

    def soup_bvh(self, tri: torch.Tensor, valid: torch.Tensor) -> bvh_lib.FlatBVH:
        """The soup [F,3,3] as a one-node FlatBVH; invalid slots get id -1."""
        lo, hi, child, first, count, slots = self._one_node(tri.shape[0], tri.device)
        v0 = tri[:, 0].contiguous()
        tid = torch.where(valid, slots, -1)
        return bvh_lib.FlatBVH(lo, hi, child, first, count, v0, (tri[:, 1] - v0).contiguous(),
                               (tri[:, 2] - v0).contiguous(), tid)

    @torch.no_grad()
    def _cast(self, rays_o, rays_d, tri, valid):
        """(hit slot [N] int64 clamped to [0, F-1], hit [N] bool)."""
        out = bvh_lib.cast_rays_dense(self.soup_bvh(tri, valid), rays_o.float().contiguous(),
                                      rays_d.float().contiguous())
        return torch.clamp(out["face"].long(), 0, tri.shape[0] - 1), out["hit"]

    # -- (c) silhouette ------------------------------------------------------------
    def _sdf_opacity(self, geo_field, rays_o, rays_d):
        cfg = self.cfg
        res = self.geometry.cfg.isosurface_resolution + 1
        grid = geo_field.sdf.reshape(res, res, res, 1)
        if self.geometry.cfg.fix_geometry:
            grid = grid.detach()
        t0, t1 = ray_aabb(rays_o, rays_d, self.bbox_lo, self.bbox_hi)
        K = cfg.sdf_opacity_samples
        frac = (torch.arange(K, dtype=torch.float32, device=rays_o.device) + 0.5) / K
        t = t0[:, None] + frac[None, :] * (t1 - t0)[:, None]
        pts = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
        x01 = (pts - self.bbox_lo) / (self.bbox_hi - self.bbox_lo)
        s = trilinear_sample(grid, torch.clamp(x01, 0.0, 1.0))[..., 0]
        s = torch.where((t1 > t0)[:, None], s, torch.full_like(s, -1.0))
        return torch.sigmoid(cfg.sdf_opacity_sharpness * s.amax(dim=1))[:, None]

    # -- render ----------------------------------------------------------------------
    def render_rays(self, geo_field, bg_field, occ, rays_o, rays_d, light_positions, draws=None,
                    step: int = 0, is_train: bool = False, render_rgb: bool = True,
                    mesh: Optional[dmtet.MTOutput] = None) -> Dict[str, torch.Tensor]:
        """Rays [N,3] -> ``opacity``, ``depth``, ``comp_normal``, ``normal``
        [N,1,3], ``comp_rgb_bg``, ``comp_rgb`` (and ``comp_rgb_fg``), the
        ``mesh``, its ``vertex_normals`` [F,3,3] (for ``normal_consistency``),
        ``hit`` and ``positions``. ``mesh`` is the isosurface when the caller
        extracted it already."""
        if mesh is None:
            mesh = self.geometry.isosurface(geo_field)
        hit_id, hit = self._cast(rays_o, rays_d, mesh.tri_verts.detach(), mesh.valid)
        # index_select: its backward is an atomic scatter-add (advanced
        # indexing's backward sorts the indices, and every miss reads slot 0)
        v = mesh.tri_verts.index_select(0, hit_id)                    # [N,3,3]
        t, u, w, _ = _moller_trumbore(rays_o, rays_d, v[:, 0], v[:, 1], v[:, 2])
        bary = torch.stack([1.0 - u - w, u, w], dim=-1)
        pos = rays_o + rays_d * t[:, None]
        vn_soup = dmtet.vertex_normals_by_gid(mesh.tri_verts, mesh.valid, mesh.edge_gid)
        vn = vn_soup.index_select(0, hit_id)
        normal = safe_normalize(torch.sum(bary[..., None] * vn, dim=1))

        opacity = self._sdf_opacity(geo_field, rays_o, rays_d)
        m = hit[:, None].to(opacity.dtype)
        op = torch.clamp(opacity * 0.5 + m * 0.5, 0.0, 1.0)
        comp_rgb_bg = self.background(rays_d, bg_field)
        comp_normal = (normal + 1.0) / 2.0 * m
        out = {
            "opacity": op,
            "depth": torch.where(hit[:, None], t[:, None], torch.zeros_like(t[:, None])),
            "comp_normal": comp_normal,
            "normal": normal[:, None, :],
            "comp_rgb_bg": comp_rgb_bg,
            "mesh": mesh,
            "vertex_normals": vn_soup,
            "hit": hit,
            "positions": pos,
        }
        if render_rgb and self.geometry.feature_dims is not None:
            feats = self.geometry.export_features(geo_field, pos)
            rgb_fg = self.material(feats, positions=pos, shading_normal=normal,
                                   light_positions=light_positions, viewdirs=rays_d, draws=draws,
                                   step=step, is_train=is_train)
            out["comp_rgb_fg"] = rgb_fg * m
            out["comp_rgb"] = rgb_fg * op + comp_rgb_bg * (1.0 - op)
        else:
            # the normal image over the background
            out["comp_rgb"] = comp_normal * op + comp_rgb_bg * (1.0 - op)
        return out

    @torch.no_grad()
    def render_image(self, geo_field, bg_field, occ, rays_o, rays_d, light_position, draws=None,
                     step: int = 0) -> Dict[str, torch.Tensor]:
        """Rays [H,W,3] and one light position [3] -> ``comp_rgb``,
        ``opacity``, ``depth``, ``comp_normal`` [H,W,C]."""
        H, W = rays_o.shape[:2]
        ro, rd = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
        lp = light_position.reshape(1, 3).expand_as(ro)
        mesh = self.geometry.isosurface(geo_field)
        C = min(self.cfg.eval_chunk_rays, ro.shape[0])
        keys = ("comp_rgb", "opacity", "depth", "comp_normal")
        outs = {}
        for i in range(0, ro.shape[0], C):
            o = self.render_rays(geo_field, bg_field, occ, ro[i:i + C], rd[i:i + C], lp[i:i + C],
                                 draws, step=step, is_train=False, mesh=mesh)
            for key in keys:
                outs.setdefault(key, []).append(o[key])
        return {k: torch.cat(v).reshape(H, W, -1) for k, v in outs.items()}
