"""Ray-cast renderer: G-buffers, the shadow-ray tracer and the per-step shade.

Counterpart of ``dreammat_tpu/models/renderer.py``: camera rays for
spherical look-at cameras (``_views_rays``), one cast per chunk of views
through the dense caster (kernel B on the card), the fixed-pixel-budget
foreground compaction with the ControlNet view-space normal (x-flipped) and
inverse-normalized depth and the interpolated texture coordinates
(``_assemble_one``), a one-camera G-buffer for the eval views
(``build_gbuffer``) and for a sampled camera of the random-camera mode at
a fixed pixel budget (``build_gbuffer_from_rays``), the visibility source
chosen at configure time (``visibility_mode``: ``baked`` per-vertex tables,
on the mesh split ``visibility_subdiv`` times by ``subdivide_mesh``;
``raytrace`` shadow rays through ``occlusion``; or ``none``), and
``shade_view``: field query at the G-buffer points (at their texture
coordinates for the UV-space field) and at the jittered points, shading
(tables, the MC estimator or the split-sum environment), scatter into the
image, and the 1-pixel edge blend. The jitter is a tangent-plane offset in
3D (draws ``jitter_angle`` and ``jitter_eps``) and Gaussian UV noise x
0.005 for the UV field (draw ``jitter_uv``, normal [P,2]).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

import dreammat_tpu_torch
from dreammat_tpu_torch.ops import bvh as bvh_lib
from dreammat_tpu_torch.utils import ops as uops
from dreammat_tpu_torch.utils.base import BaseObject
from dreammat_tpu_torch.utils.hw import resolve_device


class GBufferView(NamedTuple):
    mask: torch.Tensor        # [H,W] bool
    cn_normal: torch.Tensor   # [H,W,3] f16 ControlNet view-space normal
    cn_depth: torch.Tensor    # [H,W,1] f16 inverse-normalized depth
    fg_idx: torch.Tensor      # [P] int64 flattened pixel indices (padded)
    fg_valid: torch.Tensor    # [P] bool
    fg_pos: torch.Tensor      # [P,3] world hit positions
    fg_normal: torch.Tensor   # [P,3] interpolated vertex normals
    fg_viewdir: torch.Tensor  # [P,3] surface -> camera
    fg_tri: torch.Tensor      # [P,3] int64 vertex ids of the hit triangle
    fg_bary: torch.Tensor     # [P,3] barycentric weights
    fg_uv: torch.Tensor       # [P,2] interpolated texture coords (zeros without UVs)


def _views_rays(elev, azim, dist, fovy_deg, H: int, W: int):
    """Camera rays [c,H,W,3] for spherical look-at-origin cameras (pixel
    centers, cx = W/2, y flipped)."""
    pos = uops.camera_position_from_spherical(elev, azim, dist)  # [c,3]
    c2w = uops.get_c2w(pos)
    focal = 0.5 * H / torch.tan(0.5 * torch.deg2rad(fovy_deg))
    dev = pos.device
    i = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    j = torch.arange(H, dtype=torch.float32, device=dev) + 0.5
    jj, ii = torch.meshgrid(j, i, indexing="ij")
    base = torch.stack([ii - W / 2.0, -(jj - H / 2.0)], dim=-1)  # [H,W,2]
    c = pos.shape[0]
    dirs = torch.cat([base[None] / focal[:, None, None, None],
                      -torch.ones(c, H, W, 1, device=dev)], dim=-1)
    rot = c2w[:, :3, :3]
    rays_d = (dirs[..., None, :] * rot[:, None, None]).sum(-1)  # [c,H,W,3]
    rays_d = uops.safe_normalize(rays_d)
    rays_o = c2w[:, None, None, :3, 3].expand_as(rays_d)
    return pos, c2w, rays_o, rays_d


def _assemble_one(mesh, P: int, H: int, W: int, face, t, u, v, ro, rd, w2c) -> GBufferView:
    """One view's G-buffer from its cast: foreground compaction to a fixed
    budget P in ascending pixel order, picked with a stride
    (``floor(i * count / P)``) when the count exceeds P, as the JAX batched
    builder picks. The JAX one-camera builder (the eval views) picks with
    ``np.linspace`` there instead; the two picks agree whenever the
    foreground fits the budget, and differ only in a view that warns of
    subsampling. Condition maps in f32 (the batched builder stores them in
    f16)."""
    t_pos_idx, v_nrm = mesh.t_pos_idx, mesh.v_nrm
    HW = H * W
    dev = face.device
    hit = face >= 0
    f_safe = torch.clamp(face, min=0).long()
    u_, v_ = u[:, None], v[:, None]
    tri_all = t_pos_idx[f_safe]
    n_all = uops.safe_normalize((1 - u_ - v_) * v_nrm[tri_all[:, 0]]
                                + u_ * v_nrm[tri_all[:, 1]] + v_ * v_nrm[tri_all[:, 2]])
    n_view = uops.safe_normalize((n_all[:, None, :] * w2c[None, :3, :3]).sum(-1))
    cn = 0.5 * (n_view + 1.0)
    cn = torch.cat([1.0 - cn[:, 0:1], cn[:, 1:]], dim=-1)  # x-flip (bae convention)
    cn_bg = torch.tensor([0.5, 0.5, 1.0], device=dev)
    cn_normal = torch.where(hit[:, None], cn, cn_bg)
    min_val = 0.3
    inv = 1.0 / (t + 1e-6)
    dmax = torch.where(hit, inv, torch.full_like(inv, -float("inf"))).max()
    dmin = torch.where(hit, inv, torch.full_like(inv, float("inf"))).min()
    dn = (1 - min_val) * (inv - dmin) / (dmax - dmin + 1e-6) + min_val
    cn_depth = torch.where(hit, dn, torch.zeros_like(dn))

    ar = torch.arange(HW, device=dev)
    srt = torch.sort(torch.where(hit, ar, torch.full_like(ar, HW))).values
    stride = torch.clamp(hit.sum(), min=P).float() / P
    sel = torch.floor(torch.arange(P, dtype=torch.float32, device=dev) * stride).long()
    srt_p = srt[torch.clamp(sel, 0, HW - 1)]
    valid = srt_p < HW
    fg_idx = torch.where(valid, srt_p, torch.zeros_like(srt_p))

    tg = t[fg_idx]
    ug, vg = u[fg_idx][:, None], v[fg_idx][:, None]
    tri = t_pos_idx[f_safe[fg_idx]]
    nrm = uops.safe_normalize((1 - ug - vg) * v_nrm[tri[:, 0]] + ug * v_nrm[tri[:, 1]]
                              + vg * v_nrm[tri[:, 2]])
    up = torch.tensor([0.0, 0.0, 1.0], device=dev)
    vm = valid[:, None]
    nrm = torch.where(vm, nrm, up)
    rof, rdf = ro.reshape(-1, 3)[fg_idx], rd.reshape(-1, 3)[fg_idx]
    fg_pos = torch.where(vm, rof + tg[:, None] * rdf, torch.zeros_like(rof))
    fg_viewdir = torch.where(vm, -uops.safe_normalize(rdf), up)
    bary = torch.cat([1.0 - ug - vg, ug, vg], dim=-1)
    bary = torch.where(vm, bary, torch.tensor([1.0, 0.0, 0.0], device=dev))
    if mesh.v_tex is not None and mesh.t_tex_idx is not None:
        tt, vt = mesh.t_tex_idx[f_safe[fg_idx]], mesh.v_tex
        fg_uv = (1 - ug - vg) * vt[tt[:, 0]] + ug * vt[tt[:, 1]] + vg * vt[tt[:, 2]]
        fg_uv = torch.where(vm, fg_uv, torch.zeros_like(fg_uv))
    else:
        fg_uv = torch.zeros(P, 2, device=dev)
    return GBufferView(
        mask=hit.reshape(H, W),
        cn_normal=cn_normal.reshape(H, W, 3),
        cn_depth=cn_depth.reshape(H, W, 1),
        fg_idx=fg_idx, fg_valid=valid, fg_pos=fg_pos, fg_normal=nrm,
        fg_viewdir=fg_viewdir, fg_tri=tri, fg_bary=bary, fg_uv=fg_uv,
    )


def _edge_blend(img: torch.Tensor, mask_f: torch.Tensor, background: torch.Tensor) -> torch.Tensor:
    """1-pixel antialias substitute: dilate the foreground one pixel (masked
    3x3 mean) and blend with the background by the 3x3 coverage; interior
    pixels stay exact. img [H,W,C], mask_f [H,W]."""
    m = mask_f[..., None]

    def win(x):  # 3x3 box sum, zero padding ("SAME")
        y = F.avg_pool2d(x.permute(2, 0, 1)[None], 3, stride=1, padding=1,
                         count_include_pad=True) * 9.0
        return y[0].permute(1, 2, 0)

    wsum = win(m)
    neigh = win(img * m) / torch.clamp(wsum, min=1e-6)
    filled = img * m + neigh * (1.0 - m)
    cov = torch.where(m > 0.5, torch.ones_like(wsum), wsum / 9.0)
    return filled * cov + background * (1.0 - cov)


@dreammat_tpu_torch.register("raytracing-renderer")
class RaytraceRenderer(BaseObject):
    @dataclass
    class Config:
        context_type: str = "jax"  # accepted for config parity; unused
        change_type: str = "gaussian"
        change_eps: float = 0.05
        antialias: bool = True
        jitter_resample: str = "view"
        pixel_budget: int = 0
        visibility_mode: str = "baked"
        visibility_oct_res: int = 16
        visibility_supersample: int = 1
        visibility_subdiv: int = 0
        visibility_subdiv_max_verts: int = 1 << 20

    cfg: Config

    def configure(self, geometry, material, background=None, device="cuda") -> None:
        self.device = resolve_device(device)
        self.geometry = geometry
        self.material = material
        self.mesh = geometry.isosurface()
        if self.cfg.visibility_subdiv > 0 and self.cfg.visibility_mode == "baked":
            from dreammat_tpu_torch.models.mesh import subdivide_mesh

            self.mesh = subdivide_mesh(self.mesh, self.cfg.visibility_subdiv,
                                       max_verts=self.cfg.visibility_subdiv_max_verts)
        if self.cfg.visibility_mode not in ("baked", "raytrace", "none"):
            raise ValueError(f"unknown visibility_mode '{self.cfg.visibility_mode}'")
        self.bvh = bvh_lib.build_bvh(
            self.mesh.v_pos.cpu().numpy(), self.mesh.t_pos_idx.cpu().numpy(), device=self.device)
        self.tri_data = bvh_lib.cast_data(self.bvh)
        if self.cfg.visibility_mode == "raytrace":
            self.material.set_raytracer(self.occlusion)
        elif self.cfg.visibility_mode == "baked":
            from dreammat_tpu_torch.ops import visibility as vis_lib

            self.material.set_baked_visibility(vis_lib.bake_vertex_visibility(
                self.bvh, self.mesh.v_pos, self.mesh.v_nrm,
                oct_res=self.cfg.visibility_oct_res, supersample=self.cfg.visibility_supersample,
            ))

    def occlusion(self, rays_o: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
        """The material's tracer: the hit mask [N] of the reference's
        ``trace`` (whose positions, normals and depth no consumer of the
        shadow rays reads). At or below ``DENSE_CAST_MAX_TRIS`` triangles
        the JAX package runs its shadow rays through the XLA dense caster,
        not its Pallas kernel; here they go through ``occluded_chunked``, so
        kernel B on the card, which returns bit for bit what the plain caster
        (``cast_rays_plain``, the port of the JAX dense caster) returns.
        Above it both walk the BVH: here kernel E's any-hit entry, whose
        mask is the closest-hit walk's."""
        return bvh_lib.occluded_chunked(self.bvh, rays_o, rays_d, tri_data=self.tri_data)

    def build_gbuffer(self, rays_o: torch.Tensor, rays_d: torch.Tensor, w2c: torch.Tensor,
                      pixel_budget: Optional[int] = None) -> GBufferView:
        """One camera's G-buffer from its rays [H,W,3] (the eval views)."""
        H, W = rays_o.shape[:2]
        ro, rd = rays_o.reshape(-1, 3).float(), rays_d.reshape(-1, 3).float()
        out = bvh_lib.cast_rays_chunked(self.bvh, ro, rd, tri_data=self.tri_data)
        hit_count = int((out["face"] >= 0).sum())
        P = pixel_budget or self.cfg.pixel_budget
        if not P or P <= 0:
            P = int(np.ceil(max(hit_count, 1) / 1024) * 1024)
        if hit_count > P:
            dreammat_tpu_torch.warn("foreground pixels (%d) exceed pixel budget (%d); "
                                    "subsampling", hit_count, P)
        return _assemble_one(self.mesh, P, H, W, out["face"], out["t"], out["u"], out["v"],
                             ro, rd, w2c)

    def build_gbuffer_from_rays(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
                                w2c: torch.Tensor, pixel_budget: int) -> GBufferView:
        """One sampled camera's G-buffer from its rays [H,W,3] at the fixed
        ``pixel_budget`` (random-camera mode): one cast, condition maps in
        f16 as ``build_gbuffers_batched`` stores them."""
        H, W = rays_o.shape[:2]
        ro, rd = rays_o.reshape(-1, 3).float(), rays_d.reshape(-1, 3).float()
        out = bvh_lib.cast_rays_chunked(self.bvh, ro, rd, tri_data=self.tri_data)
        gb = _assemble_one(self.mesh, pixel_budget, H, W, out["face"], out["t"], out["u"],
                           out["v"], ro, rd, w2c)
        return gb._replace(cn_normal=gb.cn_normal.half(), cn_depth=gb.cn_depth.half())

    def build_gbuffers_batched(self, cam, height: int, width: int,
                               pixel_budget: Optional[int] = None, view_chunk: int = 8):
        """All views' G-buffers: one cast per chunk of views, one shared
        pixel budget. Returns (per-view list, stacked GBufferView)."""
        dev = self.device
        arr = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
        elev, azim = arr(cam.elevation_deg), arr(cam.azimuth_deg)
        dist, fovy = arr(cam.camera_distances), arr(cam.fovy_deg)
        Nv = len(cam)
        casts, rays = [], []
        for s in range(0, Nv, view_chunk):
            sl = slice(s, s + view_chunk)
            _, c2w, ro, rd = _views_rays(elev[sl], azim[sl], dist[sl], fovy[sl], height, width)
            out = bvh_lib.cast_rays_chunked(self.bvh, ro.reshape(-1, 3), rd.reshape(-1, 3),
                                            tri_data=self.tri_data)
            c = ro.shape[0]
            casts.append({k: out[k].reshape(c, -1) for k in ("face", "t", "u", "v")})
            rays.append((ro, rd, uops.get_w2c(c2w)))
        counts = torch.cat([(c["face"] >= 0).sum(1) for c in casts]).cpu().numpy()
        P = pixel_budget or self.cfg.pixel_budget
        if not P or P <= 0:
            P = int(np.ceil(max(int(counts.max()), 1) / 1024) * 1024)
        if int(counts.max()) > P:
            dreammat_tpu_torch.warn("foreground pixels (%d) exceed pixel budget (%d); "
                                    "subsampling", int(counts.max()), P)
        gbuffers: List[GBufferView] = []
        for c, (ro, rd, w2c) in zip(casts, rays):
            for i in range(ro.shape[0]):
                gb = _assemble_one(self.mesh, P, height, width, c["face"][i], c["t"][i],
                                   c["u"][i], c["v"][i], ro[i], rd[i], w2c[i])
                gbuffers.append(gb._replace(cn_normal=gb.cn_normal.half(),
                                            cn_depth=gb.cn_depth.half()))
        stacked = GBufferView(*(torch.stack(xs) for xs in zip(*gbuffers)))
        return gbuffers, stacked

    def jitter_points(self, gb: GBufferView, ang_u: torch.Tensor, eps_n: torch.Tensor):
        """Smoothness-reg query points: tangent-plane jitter of the G-buffer
        points. ``ang_u`` [P,1] is a uniform draw, ``eps_n`` [P,1] a normal one."""
        x = uops.get_orthogonal_directions(gb.fg_normal)
        y = torch.linalg.cross(gb.fg_normal, x, dim=-1)
        ang = ang_u * 2.0 * np.pi
        if self.cfg.change_type == "gaussian":
            eps = eps_n * self.cfg.change_eps
        else:
            eps = torch.full_like(ang, self.cfg.change_eps)
        return gb.fg_pos + (torch.cos(ang) * x + torch.sin(ang) * y) * eps

    @property
    def uv_field(self) -> bool:
        return getattr(self.geometry.cfg, "n_input_dims", 3) == 2

    def draw_jitter_points(self, gb: GBufferView, draws) -> torch.Tensor:
        P = gb.fg_pos.shape[0]
        if self.uv_field:
            return gb.fg_uv + draws.normal("jitter_uv", (P, 2)) * 0.005
        return self.jitter_points(gb, draws.uniform("jitter_angle", (P, 1)),
                                  draws.normal("jitter_eps", (P, 1)))

    def shade_view(self, field_, gb: GBufferView, env_id: int, draws=None,
                   light_table: Optional[torch.Tensor] = None,
                   jitter_pts: Optional[torch.Tensor] = None,
                   is_train: bool = True,
                   pixel_vis: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Field query + shade + scatter for one view. ``jitter_pts`` are the
        view's cached jitter points; without them they are drawn now (an
        eval render without ``draws`` uses the G-buffer points, which only
        zeroes its unused smoothness loss). ``pixel_vis`` [P, O^2] switches
        the MC estimator's visibility to the view's per-pixel table."""
        H, W = gb.mask.shape
        pts = gb.fg_uv if self.uv_field else gb.fg_pos
        if jitter_pts is None:
            jitter_pts = pts if (draws is None and not is_train) \
                else self.draw_jitter_points(gb, draws)
        feats = self.geometry.apply(field_, pts)
        feats_jitter = self.geometry.apply(field_, jitter_pts)
        if pixel_vis is not None:
            from dreammat_tpu_torch.ops.visibility import PixelVisibility

            vis_data = PixelVisibility(pixel_vis, self.cfg.visibility_oct_res)
        else:
            vis_data = (gb.fg_tri, gb.fg_bary)
        shade_out, mat_reg = self.material(
            gb.fg_pos, feats, feats_jitter, gb.fg_viewdir, gb.fg_normal, env_id, draws,
            is_train=is_train, mask=gb.fg_valid, vis_data=vis_data, light_table=light_table,
        )
        maskf = gb.mask.reshape(-1, 1).float()
        dev = maskf.device

        def composite(vals, background):
            C = vals.shape[-1]
            vals = torch.where(gb.fg_valid[:, None], vals, torch.zeros_like(vals))
            img = torch.zeros(H * W, C, device=dev, dtype=vals.dtype).index_add(0, gb.fg_idx, vals)
            img = img * maskf + background * (1.0 - maskf)
            return img.reshape(H, W, C)

        white = torch.ones(1, 3, device=dev)
        comp_rgb = composite(shade_out["color"], white)
        comp_normal = gb.cn_normal.float()
        if self.cfg.antialias:
            mf = gb.mask.float()
            comp_rgb = _edge_blend(comp_rgb, mf, white)
            comp_normal = _edge_blend(comp_normal, mf, torch.tensor([0.5, 0.5, 1.0], device=dev))
        one = torch.ones(1, 1, device=dev)
        return {
            "comp_rgb": comp_rgb,
            "opacity": gb.mask[..., None].float(),
            "comp_depth": gb.cn_depth.float(),
            "comp_normal": comp_normal,
            "albedo": composite(shade_out["albedo"], white),
            "metalness": composite(shade_out["metalness"], one),
            "roughness": composite(shade_out["roughness"], one),
            "specular_light": composite(shade_out["specular_light"], white),
            "diffuse_light": composite(shade_out["diffuse_light"], white),
            "specular_color": composite(shade_out["specular_color"], white),
            "diffuse_color": composite(shade_out["diffuse_color"], white),
            "loss_mat_reg": mat_reg,
        }
