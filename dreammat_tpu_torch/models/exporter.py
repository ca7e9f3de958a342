"""Mesh exporter: UV unwrap -> texel bake -> OBJ + MTL + texture maps.

Counterpart of ``dreammat_tpu/models/exporter.py``: a self-contained smart
unwrap (charts of connected faces sharing a dominant normal axis and sign,
each parameterized by a least-squares conformal map with the dominant-axis
projection as its fallback, scaled to a uniform texel density and
shelf-packed; host numpy/scipy, copied from the JAX package), the texel
rasterization through the dense ray caster (the UV triangles at z = 0, one
ray per texel centre along -z; kernel B on the card), a field query at the
texels' surface points, the material's export maps, an inpainting of the
padding by repeated masked 3x3 means (``conv2d``), and the OBJ/MTL writer.
The field is queried at 3D texel positions, as in the JAX package, so a
UV-space field (``n_input_dims: 2``) cannot be exported: the JAX
exporter fails there on a broadcast, the port raises
``UVFieldExportError`` before any work.

Kernel B on the UV plane: every plane has N = (0, 0, n_z) and d0 = 0, so
A = n_z, B = -n_z and t = 1 exactly; the slab test's 1/d of 1e12 on x and y
makes the cull's rounding about 6e4 in t against the 1e-4 box padding's
1e8, so the cull stays conservative, and the pre-division reject's proof
does not depend on the mesh's scale. Texels on a shared edge take the
first triangle in leaf order in the kernel and in ``cast_rays_plain``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

import dreammat_tpu_torch
from dreammat_tpu_torch.ops import bvh as bvh_lib
from dreammat_tpu_torch.utils import saving
from dreammat_tpu_torch.utils.base import BaseObject
from dreammat_tpu_torch.utils.hw import resolve_device


def _lscm_chart(v_pos: np.ndarray, chart_faces: np.ndarray) -> Optional[np.ndarray]:
    """Least-squares conformal map of one chart -> per-corner UV [n,3,2].

    The xatlas-quality replacement for plain dominant-axis projection
    (reference uses xatlas, threestudio/models/mesh.py:208-243): LSCM
    minimizes angle distortion over the chart instead of foreshortening
    tilted faces by up to cos 45°. Sparse least squares (scipy lsqr) with
    the two farthest-apart boundary vertices pinned. Returns None when the
    solve is unusable (degenerate chart, flipped triangles) — caller falls
    back to the orthographic projection."""
    try:
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla
    except Exception:  # pragma: no cover - scipy is in the image
        return None
    n_f = chart_faces.shape[0]
    if n_f < 2:
        return None
    vid, local = np.unique(chart_faces.ravel(), return_inverse=True)
    local = local.reshape(n_f, 3)
    P = v_pos[vid]  # [n_v, 3]
    n_v = len(vid)

    # per-triangle orthonormal frame -> local 2D coords
    p1, p2, p3 = P[local[:, 0]], P[local[:, 1]], P[local[:, 2]]
    e1 = p2 - p1
    e2 = p3 - p1
    nrm = np.cross(e1, e2)
    a2 = np.linalg.norm(nrm, axis=-1)  # 2*area
    good = a2 > 1e-18
    if not good.any():
        return None
    X = e1 / (np.linalg.norm(e1, axis=-1, keepdims=True) + 1e-18)
    Z = nrm / (a2[:, None] + 1e-18)
    Y = np.cross(Z, X)
    x2 = np.einsum("fd,fd->f", e1, X)
    x3 = np.einsum("fd,fd->f", e2, X)
    y3 = np.einsum("fd,fd->f", e2, Y)
    s = 1.0 / np.sqrt(np.maximum(a2, 1e-18))
    # gradient coefficients (W_real, W_imag) per corner, scaled by 1/sqrt(2A)
    Wr = np.stack([x3 - x2, -x3, x2], axis=1) * s[:, None]
    Wi = np.stack([y3 - 0.0, -y3, np.zeros_like(y3)], axis=1) * s[:, None]
    Wi[:, 0] = y3 * s  # y2 == 0: corner coeffs are (y3-y2, -y3, y2-0) -> (y3, -y3, 0)

    # pin the two farthest-apart vertices (bbox diameter endpoints)
    lo = np.argmin(P @ np.ones(3))
    hi = np.argmax(np.linalg.norm(P - P[lo], axis=-1))
    if lo == hi:
        return None
    pins = np.array([lo, hi])
    order = np.argsort(pins)  # searchsorted below needs sorted pins
    pinned = pins[order]
    pin_uv = np.array([[0.0, 0.0], [1.0, 0.0]])[order]
    free_mask = np.ones(n_v, bool)
    free_mask[pinned] = False
    free_id = np.cumsum(free_mask) - 1  # n_v -> index into free vars

    rows_, cols_, vals_ = [], [], []
    b = np.zeros(2 * n_f)
    for c in range(3):
        vtx = local[:, c]
        is_free = free_mask[vtx]
        fi = free_id[vtx]
        tri = np.arange(n_f)
        # real rows (2t): Wr*u - Wi*v ; imag rows (2t+1): Wi*u + Wr*v
        for row_off, cu, cv in ((0, Wr[:, c], -Wi[:, c]), (1, Wi[:, c], Wr[:, c])):
            r = 2 * tri + row_off
            rows_ += [r[is_free], r[is_free]]
            cols_ += [2 * fi[is_free], 2 * fi[is_free] + 1]
            vals_ += [cu[is_free], cv[is_free]]
            pin_rows = r[~is_free]
            if len(pin_rows):
                which = np.searchsorted(pinned, vtx[~is_free])
                b[pin_rows] -= (
                    cu[~is_free] * pin_uv[which, 0] + cv[~is_free] * pin_uv[which, 1]
                )
    A = sp.csr_matrix(
        (np.concatenate(vals_), (np.concatenate(rows_), np.concatenate(cols_))),
        shape=(2 * n_f, 2 * (n_v - 2)),
    )
    sol = spla.lsqr(A, b, atol=1e-10, btol=1e-10, iter_lim=4000)[0]
    uvv = np.zeros((n_v, 2))
    uvv[free_mask] = sol.reshape(-1, 2)
    uvv[pinned] = pin_uv

    # reject solves with flipped or collapsed triangles (bad charts bake
    # wrong texels through the UV rasterizer)
    q1, q2, q3 = uvv[local[:, 0]], uvv[local[:, 1]], uvv[local[:, 2]]
    area2d = (q2[:, 0] - q1[:, 0]) * (q3[:, 1] - q1[:, 1]) - (
        q2[:, 1] - q1[:, 1]
    ) * (q3[:, 0] - q1[:, 0])
    tot = area2d.sum()
    if tot < 0:  # globally mirrored: flip v
        uvv[:, 1] = -uvv[:, 1]
        area2d = -area2d
        tot = -tot
    if tot <= 1e-18 or (area2d[good] <= 0).mean() > 0.02:
        return None
    return uvv[local]  # [n_f, 3, 2]


def smart_unwrap(v_pos: np.ndarray, faces: np.ndarray, padding: float = 0.01,
                 method: str = "lscm"):
    """Returns (v_tex [F*3,2], t_tex_idx [F,3]): per-chart LSCM conformal
    parameterization (``method="lscm"``, default; orthographic dominant-axis
    projection as fallback and as ``method="ortho"``), charts = connected
    faces sharing a dominant normal axis+sign, rescaled to uniform texel
    density (2D chart area == 3D chart area), shelf-packed into [0,1]^2."""
    F = faces.shape[0]
    v0, v1, v2 = v_pos[faces[:, 0]], v_pos[faces[:, 1]], v_pos[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    fn = fn / (np.linalg.norm(fn, axis=-1, keepdims=True) + 1e-12)
    axis = np.argmax(np.abs(fn), axis=-1)  # 0,1,2
    sign = np.sign(fn[np.arange(F), axis])
    bucket = axis * 2 + (sign > 0).astype(np.int64)  # 0..5

    # connected components within buckets (via shared edges)
    # union-find over faces
    parent = np.arange(F)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    edge_map: Dict[Tuple[int, int], int] = {}
    for f in range(F):
        for k in range(3):
            a, b = faces[f, k], faces[f, (k + 1) % 3]
            key = (min(a, b), max(a, b))
            if key in edge_map:
                g = edge_map[key]
                if bucket[g] == bucket[f]:
                    ra, rb = find(f), find(g)
                    if ra != rb:
                        parent[ra] = rb
            else:
                edge_map[key] = f
    comp = np.array([find(f) for f in range(F)])

    # per-chart 2D coords (project along dominant axis)
    proj_axes = {0: (1, 2), 1: (0, 2), 2: (0, 1)}
    charts = {}
    for f in range(F):
        charts.setdefault(comp[f], []).append(f)

    uv = np.zeros((F, 3, 2), dtype=np.float64)
    rects = []  # (chart_id, w, h)
    for cid, fl in charts.items():
        fl = np.asarray(fl)
        cf = faces[fl]
        cuv = None
        if method == "lscm":
            cuv = _lscm_chart(v_pos, cf)
        if cuv is None:  # ortho fallback (tiny/degenerate/failed charts)
            a = int(axis[fl[0]])
            u_ax, v_ax = proj_axes[a]
            tri = v_pos[cf]  # [n,3,3]
            pu = tri[..., u_ax]
            pv = tri[..., v_ax]
            if sign[fl[0]] < 0:  # mirror to keep orientation
                pu = -pu
            cuv = np.stack([pu, pv], axis=-1)
        # uniform texel density: scale so 2D chart area == 3D chart area
        tri3 = v_pos[cf]
        a3 = 0.5 * np.linalg.norm(
            np.cross(tri3[:, 1] - tri3[:, 0], tri3[:, 2] - tri3[:, 0]), axis=-1
        ).sum()
        a2d = 0.5 * np.abs(
            (cuv[:, 1, 0] - cuv[:, 0, 0]) * (cuv[:, 2, 1] - cuv[:, 0, 1])
            - (cuv[:, 1, 1] - cuv[:, 0, 1]) * (cuv[:, 2, 0] - cuv[:, 0, 0])
        ).sum()
        if a2d > 1e-18 and a3 > 0:
            cuv = cuv * np.sqrt(a3 / a2d)
        cuv = cuv - cuv.reshape(-1, 2).min(axis=0)
        uv[fl] = cuv
        rects.append((cid, float(cuv[..., 0].max()), float(cuv[..., 1].max())))

    # shelf packing by decreasing height
    rects.sort(key=lambda r: -r[2])
    total_area = sum((w + 1e-6) * (h + 1e-6) for _, w, h in rects)
    target_w = float(np.sqrt(total_area) * 1.15) + 1e-6
    x = y = shelf_h = 0.0
    place = {}
    for cid, w, h in rects:
        if x + w > target_w and x > 0:
            y += shelf_h + padding * target_w
            x, shelf_h = 0.0, 0.0
        place[cid] = (x, y)
        x += w + padding * target_w
        shelf_h = max(shelf_h, h)
    total_h = y + shelf_h

    scale = 1.0 / max(target_w, total_h + 1e-6) * (1.0 - 2 * padding)
    for cid, fl in charts.items():
        fl = np.asarray(fl)
        ox, oy = place[cid]
        uv[fl, :, 0] = (uv[fl, :, 0] + ox) * scale + padding
        uv[fl, :, 1] = (uv[fl, :, 1] + oy) * scale + padding

    v_tex = uv.reshape(F * 3, 2).astype(np.float32)
    t_tex_idx = np.arange(F * 3, dtype=np.int32).reshape(F, 3)
    return v_tex, t_tex_idx


def uv_texel_rays(v_tex: np.ndarray, t_tex_idx: np.ndarray, resolution: int, device="cuda"):
    """(BVH of the UV triangles laid at z = 0, origins [R,3], directions
    [R,3]): one ray per texel centre (row-major, v rows) from z = 1 along
    -z."""
    V = np.zeros((len(v_tex), 3), dtype=np.float32)
    V[:, :2] = v_tex
    bvh = bvh_lib.build_bvh(V, t_tex_idx, device=device)
    t = (np.arange(resolution) + 0.5) / resolution
    uu, vv = np.meshgrid(t, t, indexing="xy")
    origins = np.stack([uu, vv, np.ones_like(uu)], axis=-1).reshape(-1, 3).astype(np.float32)
    o = torch.as_tensor(origins, device=bvh.tri_v0.device)
    d = torch.tensor([[0.0, 0.0, -1.0]], device=o.device).expand_as(o).contiguous()
    return bvh, o, d


def rasterize_uv_texels(v_tex: np.ndarray, t_tex_idx: np.ndarray, resolution: int,
                        device="cuda") -> Dict[str, torch.Tensor]:
    """For each texel centre: the covering UV triangle and its barycentrics
    (the caster's dict: face, u, v, hit)."""
    return bvh_lib.cast_rays_chunked(*uv_texel_rays(v_tex, t_tex_idx, resolution, device))


def inpaint_padding(img: torch.Tensor, valid: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Grow the valid texels into the background, ``iters`` rings: each
    ring fills an invalid texel with the mean of its valid 3x3 neighbours.
    img [H,W,C], valid [H,W]."""
    v = valid.float()[None, None]
    x = img.permute(2, 0, 1)[:, None] * v  # [C,1,H,W]
    ker = torch.ones(1, 1, 3, 3, dtype=img.dtype, device=img.device)
    for _ in range(iters):
        xs = F.conv2d(x, ker, padding=1)
        vs = F.conv2d(v, ker, padding=1)
        fill = xs / torch.clamp(vs, min=1e-6)
        newv = (torch.clamp(vs, max=1.0) > 0).float()
        x = torch.where(v > 0, x, fill * newv)
        v = torch.maximum(v, newv)
    return x[:, 0].permute(1, 2, 0)


@dreammat_tpu_torch.register("dummy-exporter")
class DummyExporter(BaseObject):
    """No-op exporter: configs that disable export resolve this name."""

    @dataclass
    class Config:
        save_video: bool = False

    cfg: Config

    def configure(self, geometry=None, material=None, device="cuda") -> None:
        self.geometry = geometry
        self.material = material

    def __call__(self, *args, **kwargs):
        return []


class UVFieldExportError(NotImplementedError):
    """The export of a UV-space (2D) material field."""


UV_FIELD_EXPORT = ("the export queries the material field at 3D texel positions "
                   "(dreammat_tpu/models/exporter.py:361, geometry.py:116), which a "
                   "UV-space field (system.geometry.n_input_dims=2) cannot take; the JAX "
                   "package fails there too, and neither package exports a UV-space field")


@dreammat_tpu_torch.register("mesh-exporter")
class MeshExporter(BaseObject):
    @dataclass
    class Config:
        fmt: str = "obj-mtl"
        save_name: str = "model"
        texture_size: int = 2048
        texture_format: str = "jpg"
        save_uv: bool = True

    cfg: Config

    def configure(self, geometry, material, device="cuda") -> None:
        self.device = resolve_device(device)
        self.geometry = geometry
        self.material = material
        self.seconds: Dict[str, float] = {}

    def export_obj_with_mtl(self, field_, out_dir: str) -> str:
        """Unwrap, bake and write ``<save_name>.obj`` / ``.mtl`` and the
        maps into ``out_dir``; ``self.seconds`` holds each part's time."""
        if getattr(self.geometry.cfg, "n_input_dims", 3) != 3:
            raise UVFieldExportError(UV_FIELD_EXPORT)
        sec = self.seconds = {}
        mesh = self.geometry.isosurface()
        dev = self.device
        sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
        v_pos = mesh.v_pos.cpu().numpy()
        faces = mesh.t_pos_idx.cpu().numpy()
        t0 = time.time()
        if mesh.v_tex is not None and mesh.t_tex_idx is not None:
            v_tex, t_tex_idx = mesh.v_tex.cpu().numpy(), mesh.t_tex_idx.cpu().numpy()
        else:
            v_tex, t_tex_idx = smart_unwrap(v_pos, faces)
        sec["unwrap"] = time.time() - t0
        self.uv = (v_tex, t_tex_idx)

        res = self.cfg.texture_size
        t0 = time.time()
        rast = rasterize_uv_texels(v_tex, t_tex_idx, res, device=dev)
        sync()
        sec["texel_bake"] = time.time() - t0
        t0 = time.time()
        face = torch.clamp(rast["face"], min=0).long()
        u, v = rast["u"][:, None], rast["v"][:, None]
        tris = mesh.t_pos_idx[face]
        vp = mesh.v_pos
        pos = (1 - u - v) * vp[tris[:, 0]] + u * vp[tris[:, 1]] + v * vp[tris[:, 2]]
        with torch.no_grad():
            feats = torch.cat([self.geometry.apply(field_, p) for p in pos.split(1 << 18)])
            maps = self.material.export(feats)
        sync()
        sec["field_query"] = time.time() - t0
        valid = rast["hit"].reshape(res, res)

        t0 = time.time()

        def finish(img):
            filled = inpaint_padding(img.reshape(res, res, -1), valid)
            q = torch.clamp(filled, 0.0, 1.0) * 255.0 + 0.5
            return q.to(torch.uint8).cpu().numpy()

        albedo = finish(maps["albedo"])
        metallic = finish(maps["metallic"])
        roughness = finish(maps["roughness"])
        bump = finish(maps["bump"]) if "bump" in maps else None
        sec["inpaint"] = time.time() - t0
        self.maps = {"albedo": albedo, "metallic": metallic[..., 0],
                     "roughness": roughness[..., 0]}
        t0 = time.time()
        path = saving.save_obj_with_mtl(
            out_dir, self.cfg.save_name, v_pos, faces, v_tex, t_tex_idx,
            mesh.v_nrm.cpu().numpy(), albedo_map=albedo, metallic_map=metallic[..., 0],
            roughness_map=roughness[..., 0], bump_map=bump)
        sec["writes"] = time.time() - t0
        return path
