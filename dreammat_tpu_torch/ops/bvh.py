"""Flat BVH (host build), the dense first-hit caster and the BVH walk.

Counterpart of ``dreammat_tpu/ops/bvh.py`` for the ported path:

- ``build_bvh``: the host builder, the C++ one in ``native/bvh_builder.cpp``
  (compiled with g++ into ``build/dreammat_tpu_torch/`` at first use and
  loaded through ctypes) with the numpy builder as its fallback. Both give
  the same DFS/skip-link layout; the triangles come out in leaf order.
- ``cast_rays_dense``: first hit of R rays against all T triangles from the
  per-triangle plane/edge equations (``_plane_tri_data``). On a CUDA tensor
  it launches kernel B (``csrc/ray_cast.cu``, which replaces the Pallas
  ``_dense_pallas_kernel``); on a CPU tensor it runs ``cast_rays_plain``,
  the plain PyTorch version (a port of ``cast_rays_plane``).
- ``cast_rays_bvh``: first hit by the stackless skip-link walk of the BVH,
  Moller-Trumbore in each leaf (the JAX package's ``cast_rays``, an XLA
  while loop). On a CUDA tensor it launches kernel E
  (``csrc/bvh_traverse.cu``) on the nodes and triangles that ``pack_bvh``
  packs once per BVH; on a CPU tensor it runs ``cast_rays_bvh_plain``.
- ``cast_rays_chunked``: the dispatcher the renderer, the bakes and the
  export call. At or below ``DENSE_CAST_MAX_TRIS`` triangles it takes the
  dense caster, above it the walk, as the JAX package does; ``cast_data``
  makes once per BVH what the chosen caster reads. ``occluded_chunked`` is
  its hit mask, through the walk's any-hit entry above the threshold;
  ``occlusion_rays`` the walk's any-hit mask at every size.

Miss semantics: t = 10 (``MISS_DEPTH``), face = -1, u = v = 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from dreammat_tpu_torch.utils.hw import resolve_device

LEAF_SIZE = 4
MISS_DEPTH = 10.0
DENSE_CAST_MAX_TRIS = 1 << 22

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class FlatBVH(NamedTuple):
    node_min: torch.Tensor    # [N,3] f32
    node_max: torch.Tensor    # [N,3] f32
    node_miss: torch.Tensor   # [N] i32, node after this subtree (-1 = done)
    node_first: torch.Tensor  # [N] i32, first tri slot of a leaf
    node_count: torch.Tensor  # [N] i32, tri count of a leaf (0 = internal)
    tri_v0: torch.Tensor      # [T,3] f32 (T = padded, leaf-ordered)
    tri_e1: torch.Tensor      # [T,3]
    tri_e2: torch.Tensor      # [T,3]
    tri_id: torch.Tensor      # [T] i32 original face index (-1 = padding)


# ---------------------------------------------------------------------------
# host build
# ---------------------------------------------------------------------------

_NATIVE = {"tried": False, "lib": None}


_GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def _load_native():
    """Build (once) and load native/bvh_builder.cpp; None when unavailable,
    with one warning naming the reason. The library is keyed by a hash of
    the source and flags, so an edited builder is rebuilt."""
    if _NATIVE["tried"]:
        return _NATIVE["lib"]
    _NATIVE["tried"] = True
    src = os.path.join(_REPO, "native", "bvh_builder.cpp")
    if not os.path.exists(src):
        return _native_missing(f"{src} is not there")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_GXX_FLAGS).encode()).hexdigest()[:16]
    lib_path = os.path.join(_REPO, "build", "dreammat_tpu_torch", f"libbvh_builder-{digest}.so")
    if not os.path.exists(lib_path):
        try:
            os.makedirs(os.path.dirname(lib_path), exist_ok=True)
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            subprocess.run(["g++", *_GXX_FLAGS, src, "-o", tmp],
                           check=True, capture_output=True, text=True, timeout=120)
            os.replace(tmp, lib_path)
        except subprocess.CalledProcessError as e:
            return _native_missing(f"g++ failed (rc {e.returncode}): {e.stderr.strip()[-2000:]}")
        except (OSError, subprocess.SubprocessError) as e:
            return _native_missing(f"g++ could not run: {e}")
    try:
        lib = ctypes.CDLL(lib_path)
    except OSError as e:
        return _native_missing(f"{lib_path} did not load: {e}")
    lib.bvh_build.restype = ctypes.c_void_p
    lib.bvh_build.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.bvh_read.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
    ]
    _NATIVE["lib"] = lib
    return lib


def _native_missing(why: str):
    import dreammat_tpu_torch

    dreammat_tpu_torch.warn("native BVH builder unavailable (%s); using the numpy builder", why)
    return None


def _build_native(vertices: np.ndarray, faces: np.ndarray):
    lib = _load_native()
    if lib is None:
        return None
    v = np.ascontiguousarray(vertices, dtype=np.float32)
    f = np.ascontiguousarray(faces, dtype=np.int64)
    n_nodes, n_tris = ctypes.c_int64(), ctypes.c_int64()
    handle = lib.bvh_build(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), v.shape[0],
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), f.shape[0],
        ctypes.byref(n_nodes), ctypes.byref(n_tris),
    )
    N, T = n_nodes.value, n_tris.value
    node_min = np.empty((N, 3), np.float32)
    node_max = np.empty((N, 3), np.float32)
    node_miss = np.empty(N, np.int32)
    node_first = np.empty(N, np.int32)
    node_count = np.empty(N, np.int32)
    out_tris = np.empty(T, np.int64)
    lib.bvh_read(
        handle,
        node_min.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        node_max.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        node_miss.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        node_first.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        node_count.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return node_min, node_max, node_miss, node_first, node_count, out_tris


def _build_python(vertices: np.ndarray, faces: np.ndarray):
    """Numpy builder (median split on the largest centroid axis)."""
    F = faces.shape[0]
    v0, v1, v2 = vertices[faces[:, 0]], vertices[faces[:, 1]], vertices[faces[:, 2]]
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)
    centroids = (tri_min + tri_max) * 0.5
    nodes: list = []
    out_tris: list = []

    def emit(tri_idx: np.ndarray) -> None:
        bmin = tri_min[tri_idx].min(axis=0)
        bmax = tri_max[tri_idx].max(axis=0)
        if len(tri_idx) <= LEAF_SIZE:
            nodes.append([bmin, bmax, len(out_tris), len(tri_idx)])
            out_tris.extend(tri_idx.tolist())
            return
        nodes.append([bmin, bmax, 0, 0])
        c = centroids[tri_idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        left = c[:, axis] <= np.median(c[:, axis])
        if left.all() or not left.any():
            order = np.argsort(c[:, axis], kind="stable")
            half = len(tri_idx) // 2
            emit(tri_idx[order[:half]])
            emit(tri_idx[order[half:]])
        else:
            emit(tri_idx[left])
            emit(tri_idx[~left])

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000 + 2 * F))
    try:
        emit(np.arange(F))
        N = len(nodes)
        node_count = np.array([n[3] for n in nodes], dtype=np.int32)
        subtree_end = np.zeros(N, dtype=np.int32)

        def end(i: int) -> int:
            if node_count[i] > 0:
                subtree_end[i] = i + 1
                return i + 1
            subtree_end[i] = end(end(i + 1))
            return subtree_end[i]

        end(0)
    finally:
        sys.setrecursionlimit(old)
    node_min = np.stack([n[0] for n in nodes]).astype(np.float32)
    node_max = np.stack([n[1] for n in nodes]).astype(np.float32)
    node_first = np.array([n[2] for n in nodes], dtype=np.int32)
    node_miss = np.where(subtree_end >= N, -1, subtree_end).astype(np.int32)
    return node_min, node_max, node_miss, node_first, node_count, np.asarray(out_tris, np.int64)


def build_bvh(vertices: np.ndarray, faces: np.ndarray, device="cuda",
              use_native: bool = True) -> FlatBVH:
    """Host BVH build; the flat arrays land on ``device``."""
    device = resolve_device(device)
    vertices = np.asarray(vertices, dtype=np.float32)
    faces = np.asarray(faces, dtype=np.int64)
    built = _build_native(vertices, faces) if use_native else None
    if built is None:
        built = _build_python(vertices, faces)
    node_min, node_max, node_miss, node_first, node_count, out = built
    v0, v1, v2 = vertices[faces[:, 0]], vertices[faces[:, 1]], vertices[faces[:, 2]]
    T = int(np.ceil(max(len(out), 1) / LEAF_SIZE) * LEAF_SIZE)
    pad = np.zeros((T - len(out), 3), np.float32)
    tv0 = np.concatenate([v0[out], pad])
    te1 = np.concatenate([(v1 - v0)[out], pad])
    te2 = np.concatenate([(v2 - v0)[out], pad])
    tid = np.concatenate([out.astype(np.int32), -np.ones(T - len(out), np.int32)])
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    return FlatBVH(t(node_min), t(node_max), t(node_miss), t(node_first), t(node_count),
                   t(tv0), t(te1), t(te2), t(tid))


# ---------------------------------------------------------------------------
# dense caster
# ---------------------------------------------------------------------------

def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _plane_tri_data(bvh: FlatBVH):
    """Per-triangle plane/edge constants [12, T]: rows N | d0 | g_u | c_u |
    g_v | c_v, with t = -(o.N + d0)/(d.N), u = (o.g_u + c_u) + t d.g_u,
    v = (o.g_v + c_v) + t d.g_v; plus tri ids [T] (int32, -1 for padding and
    degenerate triangles)."""
    v0, e1, e2 = bvh.tri_v0, bvh.tri_e1, bvh.tri_e2
    n = _cross(e1, e2)
    gu_raw = _cross(e2, n)
    gv_raw = _cross(n, e1)
    du = torch.sum(gu_raw * e1, dim=-1, keepdim=True)
    dv = torch.sum(gv_raw * e2, dim=-1, keepdim=True)
    degen = (du.abs() < 1e-18) | (dv.abs() < 1e-18)
    gu = gu_raw / torch.where(du.abs() < 1e-18, torch.ones_like(du), du)
    gv = gv_raw / torch.where(dv.abs() < 1e-18, torch.ones_like(dv), dv)
    d0 = -torch.sum(n * v0, dim=-1)
    cu = -torch.sum(gu * v0, dim=-1)
    cv = -torch.sum(gv * v0, dim=-1)
    tid = torch.where(degen[:, 0], torch.full_like(bvh.tri_id, -1), bvh.tri_id)
    rows = torch.cat([n.T, d0[None], gu.T, cu[None], gv.T, cv[None]], dim=0)
    return rows.contiguous(), tid.to(torch.int32).contiguous()


def _finish(t, face, u, v) -> Dict[str, torch.Tensor]:
    hit = face >= 0
    zero = torch.zeros_like(t)
    return {
        "t": torch.where(hit, t, torch.full_like(t, MISS_DEPTH)),
        "face": face,
        "u": torch.where(hit, u, zero),
        "v": torch.where(hit, v, zero),
        "hit": hit,
    }


def cast_rays_plain(bvh: FlatBVH, rays_o, rays_d, t_max: float = MISS_DEPTH,
                    chunk: Optional[int] = None, tri_data=None) -> Dict[str, torch.Tensor]:
    """Plain PyTorch dense caster (the JAX package's ``cast_rays_plane``):
    [chunk, T] plane-equation tests in fp32 elementwise math, first minimum
    of t in triangle order wins."""
    rows, tid = _plane_tri_data(bvh) if tri_data is None else tri_data
    o = rays_o.float()
    d = rays_d.float()
    R, T = o.shape[0], rows.shape[1]
    rc = chunk or max(128, min(4096, ((1 << 24) // max(T, 1)) // 128 * 128))
    ok_tri = (tid >= 0)[None, :]

    def dot3(x, r0):
        return x[:, 0:1] * rows[r0] + x[:, 1:2] * rows[r0 + 1] + x[:, 2:3] * rows[r0 + 2]

    outs = {k: [] for k in ("t", "face", "u", "v")}
    for s in range(0, R, rc):
        oc, dc = o[s:s + rc], d[s:s + rc]
        A = dot3(oc, 0) + rows[3]
        B = dot3(dc, 0)
        safe = B.abs() > 1e-12
        t = -A / torch.where(safe, B, torch.ones_like(B))
        u = (dot3(oc, 4) + rows[7]) + t * dot3(dc, 4)
        v = (dot3(oc, 8) + rows[11]) + t * dot3(dc, 8)
        valid = safe & (t > 1e-6) & (t < t_max) & (u >= 0) & (v >= 0) & (u + v <= 1.0) & ok_tri
        tm = torch.where(valid, t, torch.full_like(t, float("inf")))
        lane = torch.argmin(tm, dim=-1)
        tl = tm.gather(1, lane[:, None])[:, 0]
        hit = torch.isfinite(tl)
        outs["t"].append(tl)
        outs["face"].append(torch.where(hit, tid[lane], torch.full_like(lane, -1, dtype=torch.int32)))
        outs["u"].append(u.gather(1, lane[:, None])[:, 0])
        outs["v"].append(v.gather(1, lane[:, None])[:, 0])
    return _finish(*(torch.cat(outs[k]) for k in ("t", "face", "u", "v")))


# 1 + 2^-20: the slack of the pre-division reject's threshold (ray_cast.cu)
CUT_SLACK = 1.0 + 2.0 ** -20


def cast_reject_plain(A: torch.Tensor, B: torch.Tensor, tb: torch.Tensor) -> torch.Tensor:
    """Kernel B's pre-division reject in plain fp32 PyTorch: True where a
    pair with plane terms A = o.N + d0 and B = d.N may be skipped before
    t = -A / B is formed, given the ray's running best t ``tb``: |B| <=
    1e-12, or A = 0 or A, B of equal signs (then t <= 0), or not |A| <
    RN(RN(tb (1 + 2^-20)) |B|) (then t >= tb, or t is NaN). The plain test
    rejects every such pair; the proof is in ``csrc/ray_cast.cu``."""
    A, B = A.float(), B.float()
    cut = tb.float() * CUT_SLACK
    opposite = torch.signbit(A) != torch.signbit(B)
    return ~((B.abs() > 1e-12) & opposite & (A != 0) & (A.abs() < cut * B.abs()))


_CAST_ARGTYPES = (
    [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_float] + [ctypes.c_void_p] * 6
)


def _tile_boxes(bvh: FlatBVH, tid: torch.Tensor, tile: int) -> torch.Tensor:
    """Boxes of consecutive ``tile``-triangle groups in leaf order, [n, 8]
    (min x, y, z, 0, max x, y, z, 0: two float4 per box), for the kernel's
    cull. Padding and degenerate triangles (id -1) take no part. A group
    with no live triangle gets the box lo = hi = (+inf, +inf, +inf), which
    the kernel's slab test meets with no ray (its slabs start at +inf or
    end at -inf on every axis); the empty box lo = +inf, hi = -inf would
    meet every ray (min and max of its slab bounds are -inf and +inf)."""
    v0 = bvh.tri_v0
    corners = torch.stack([v0, v0 + bvh.tri_e1, v0 + bvh.tri_e2])       # [3,T,3]
    dead = (tid < 0)[:, None]
    inf = torch.full_like(v0, float("inf"))
    lo = torch.where(dead, inf, corners.amin(0))
    hi = torch.where(dead, -inf, corners.amax(0))
    pad = (-lo.shape[0]) % tile
    lo = torch.cat([lo, inf[:1].expand(pad, 3)]).reshape(-1, tile, 3).amin(1)
    hi = torch.cat([hi, -inf[:1].expand(pad, 3)]).reshape(-1, tile, 3).amax(1)
    hi = torch.where(lo == float("inf"), lo, hi)   # no live triangle: lo = hi = +inf
    zero = torch.zeros_like(lo[:, :1])
    return torch.cat([lo, zero, hi, zero], dim=1).contiguous()


def _packed_tris(rows: torch.Tensor, tid: torch.Tensor) -> torch.Tensor:
    """[T, 16] float32, per triangle the four float4 the kernel reads:
    (N, d0), (g_u, c_u), (g_v, c_v), (id as int32 bits, 0, 0, 0)."""
    zeros = torch.zeros(rows.shape[1], 3, dtype=torch.float32, device=rows.device)
    return torch.cat([rows.T, tid.view(torch.float32)[:, None], zeros], dim=1).contiguous()


def cast_rays_dense(bvh: FlatBVH, rays_o, rays_d, t_max: float = MISS_DEPTH,
                    tri_data=None, pairs_out: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    """First hit of every ray against every triangle. CUDA tensors launch
    kernel B; CPU tensors run ``cast_rays_plain``. ``pairs_out``, an int64
    [1] tensor on the rays' device, if given, has the (ray, triangle) pairs
    tested added to it: those the kernel's cull keeps, or all R x T."""
    if pairs_out is not None and (pairs_out.dtype != torch.int64 or pairs_out.shape != (1,)
                                  or pairs_out.device != rays_o.device):
        raise ValueError("pairs_out must be an int64 [1] tensor on the rays' device")
    if rays_o.device.type == "cpu":
        out = cast_rays_plain(bvh, rays_o, rays_d, t_max=t_max, tri_data=tri_data)
        if pairs_out is not None:
            T = (bvh.tri_v0 if tri_data is None else tri_data[0].T).shape[0]
            pairs_out += rays_o.shape[0] * T
        return out
    rows, tid = _plane_tri_data(bvh) if tri_data is None else tri_data
    for name, x in (("rays_o", rays_o), ("rays_d", rays_d)):
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 [R,3] tensor")
        if x.device != rays_o.device:
            raise ValueError("rays_o and rays_d must be on the same device")
    if rays_o.shape != rays_d.shape:
        raise ValueError("rays_o and rays_d differ in shape")
    if rows.device != rays_o.device or rows.dtype != torch.float32 or rows.shape[0] != 12 \
            or not rows.is_contiguous() or tid.dtype != torch.int32 or tid.shape[0] != rows.shape[1]:
        raise ValueError("triangle data must be float32 [12,T] and int32 [T] on the rays' device")
    from dreammat_tpu_torch.ops import kernels

    fn = kernels.function("ray_cast", "ray_cast_dense", _CAST_ARGTYPES)
    tile = kernels.function("ray_cast", "ray_cast_tile_size", [])()
    sub = kernels.function("ray_cast", "ray_cast_sub_size", [])()
    tris = _packed_tris(rows, tid)
    boxes, sub_boxes = _tile_boxes(bvh, tid, tile), _tile_boxes(bvh, tid, sub)
    R, T = rays_o.shape[0], rows.shape[1]
    dev = rays_o.device
    t = torch.empty(R, dtype=torch.float32, device=dev)
    face = torch.empty(R, dtype=torch.int32, device=dev)
    u = torch.empty(R, dtype=torch.float32, device=dev)
    v = torch.empty(R, dtype=torch.float32, device=dev)
    if R == 0:
        return _finish(t, face, u, v)
    rc = fn(rays_o.data_ptr(), rays_d.data_ptr(), tris.data_ptr(), boxes.data_ptr(),
            sub_boxes.data_ptr(), R, T, float(t_max), t.data_ptr(),
            face.data_ptr(), u.data_ptr(), v.data_ptr(),
            None if pairs_out is None else pairs_out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ray_cast kernel launch failed (cudaError {rc})")
    cast_rays_dense.launches += 1
    return _finish(t, face, u, v)


cast_rays_dense.launches = 0


# ---------------------------------------------------------------------------
# BVH walk
# ---------------------------------------------------------------------------

def _max(a, b):
    """max(a, b) as kernel E takes it (``a > b ? a : b``)."""
    return torch.where(a > b, a, b)


def _min(a, b):
    """min(a, b) as kernel E takes it (``a < b ? a : b``)."""
    return torch.where(a < b, a, b)


def _inv_dir(d: torch.Tensor) -> torch.Tensor:
    """1 / d per axis, |d| clamped to 1e-12 with d's sign (d = 0 counts as +)."""
    tiny = torch.where(d >= 0, torch.full_like(d, 1e-12), torch.full_like(d, -1e-12))
    return torch.ones_like(d) / torch.where(d.abs() < 1e-12, tiny, d)


def _slab(o, inv, lo, hi, t_best):
    """The JAX package's ``_ray_aabb``: whether the ray meets the box
    [lo, hi] before ``t_best``, in kernel E's order of fp32 operations."""
    t0 = [(lo[:, a] - o[:, a]) * inv[:, a] for a in range(3)]
    t1 = [(hi[:, a] - o[:, a]) * inv[:, a] for a in range(3)]
    near = [_min(t0[a], t1[a]) for a in range(3)]
    far = [_max(t0[a], t1[a]) for a in range(3)]
    tmin = _max(_max(near[0], near[1]), near[2])
    tmax = _min(_min(far[0], far[1]), far[2])
    return (tmax >= _max(tmin, torch.zeros_like(tmin))) & (tmin < t_best)


def _moller_trumbore(o, d, v0, e1, e2):
    """The JAX package's ``_tri_hits`` for one triangle a ray, each cross
    and dot product written out component by component and summed left to
    right, as kernel E rounds it. Returns (t, u, v, valid without the
    running-best test)."""
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    ax, ay, az = v0.unbind(1)
    e1x, e1y, e1z = e1.unbind(1)
    e2x, e2y, e2z = e2.unbind(1)
    px, py, pz = dy * e2z - dz * e2y, dz * e2x - dx * e2z, dx * e2y - dy * e2x
    det = (e1x * px + e1y * py) + e1z * pz
    ok = det.abs() > 1e-9
    inv_det = torch.where(ok, torch.ones_like(det) / det, torch.zeros_like(det))
    tx, ty, tz = ox - ax, oy - ay, oz - az
    u = ((tx * px + ty * py) + tz * pz) * inv_det
    qx, qy, qz = ty * e1z - tz * e1y, tz * e1x - tx * e1z, tx * e1y - ty * e1x
    v = ((dx * qx + dy * qy) + dz * qz) * inv_det
    t = ((e2x * qx + e2y * qy) + e2z * qz) * inv_det
    valid = ok & (u >= 0) & (v >= 0) & (u + v <= 1.0) & (t > 1e-6)
    return t, u, v, valid


def cast_rays_bvh_plain(bvh: FlatBVH, rays_o, rays_d, t_max: float = MISS_DEPTH,
                        counters_out: Optional[torch.Tensor] = None, any_hit: bool = False
                        ) -> Dict[str, torch.Tensor]:
    """Plain PyTorch BVH walk (the JAX package's ``cast_rays``), vectorised
    over rays: each ray starts at the root and, per step, tests its node's
    box against (0, best t); a met internal node descends to the next node
    in DFS order, anything else jumps along the node's miss link; a met
    leaf tests its triangles by Moller-Trumbore in slot order, a hit taking
    the best only with a strictly smaller t (so the first of equal t wins).
    Rays that have left the tree drop out. ``counters_out``, an int64 [2]
    tensor, gets the nodes visited and the (ray, triangle) pairs tested
    added to it. ``any_hit``: the same walk, each ray dropped at its first
    valid pair (t < t_max), returning ``{"hit": ...}`` alone; until that
    pair it tests what the closest-hit walk tests, so its mask is that
    walk's."""
    o = rays_o.float()
    d = rays_d.float()
    inv = _inv_dir(d)
    R, dev = o.shape[0], o.device
    tb = torch.full((R,), float(t_max), dtype=torch.float32, device=dev)
    fb = torch.full((R,), -1, dtype=torch.int32, device=dev)
    ub = torch.zeros(R, dtype=torch.float32, device=dev)
    vb = torch.zeros(R, dtype=torch.float32, device=dev)
    node_box = torch.cat([bvh.node_min, bvh.node_max], dim=1)
    node_links = torch.stack([bvh.node_miss, bvh.node_first, bvh.node_count], dim=1).long()
    tri_geom = torch.cat([bvh.tri_v0, bvh.tri_e1, bvh.tri_e2], dim=1)
    tri_id = bvh.tri_id.to(torch.int32)
    idx = torch.arange(R, device=dev)
    cur = torch.zeros(R, dtype=torch.long, device=dev)
    found = torch.zeros(R, dtype=torch.bool, device=dev)
    nodes = pairs = 0
    while idx.numel():
        box, links = node_box[cur], node_links[cur]
        oi, di = o[idx], d[idx]
        met = _slab(oi, inv[idx], box[:, :3], box[:, 3:], tb[idx])
        count = links[:, 2]
        nodes += idx.numel()
        leaf = torch.nonzero(met & (count > 0))[:, 0]
        for lane in range(LEAF_SIZE):
            sel = leaf[count[leaf] > lane]
            if any_hit:
                sel = sel[~found[idx[sel]]]
            if not sel.numel():
                break
            pairs += sel.numel()
            slot = links[sel, 1] + lane
            geom = tri_geom[slot]
            t, u, v, valid = _moller_trumbore(oi[sel], di[sel], geom[:, :3], geom[:, 3:6],
                                              geom[:, 6:])
            ray = idx[sel]
            better = valid & (t < tb[ray])
            ray, slot = ray[better], slot[better]
            if any_hit:
                found[ray] = True
                continue
            tb[ray], ub[ray], vb[ray] = t[better], u[better], v[better]
            fb[ray] = tri_id[slot]
        nxt = torch.where(met & (count == 0), cur + 1, links[:, 0])
        keep = (nxt >= 0) & ~found[idx]
        idx, cur = idx[keep], nxt[keep]
    if counters_out is not None:
        counters_out += torch.tensor([nodes, pairs], dtype=torch.int64, device=counters_out.device)
    return {"hit": found} if any_hit else _finish(tb, fb, ub, vb)


class PackedBVH(NamedTuple):
    """Kernel E's view of a BVH (``pack_bvh``)."""
    nodes: torch.Tensor  # [M, 16] f32 records: (lo1, word1), (hi1, word2), (lo2, word2), (hi2, next)
    tris: torch.Tensor   # [T, 12] f32: (v0 xyz, id), (e1 xyz, 0), (e2 xyz, 0); ints as bits


def pack_bvh(bvh: FlatBVH) -> PackedBVH:
    """What kernel E reads, the integers stored as their bits; made once per
    BVH (the renderer keeps it as its ``tri_data``). Triangles as three
    float4. Nodes as 64-byte records, one per internal node in DFS order
    after a virtual record 0 whose first child is the root and which has no
    second: an internal node P's record holds the boxes of its children,
    the first P + 1 and the second P + 1's miss link, each with its word (a
    leaf's first slot * 8 + its count, an internal node's record * 8; -1
    for no second child), the second word in both halves, and in the second
    half the record whose second child is the second child's miss link (-1
    when that link is -1): (lo1, word1), (hi1, word2), (lo2, word2), (hi2,
    next), so either child's half is two float4. The skip-link walk's next
    node after a second child is that link, so the walk over the records
    tests the nodes in the walk's order. Raises if a miss link leads to a
    node that is no internal node's second child (not the builders'
    layout)."""
    T = bvh.tri_v0.shape[0]
    if T >= 1 << 28:
        raise ValueError("kernel E codes a leaf's first slot in 28 bits: at most 2^28 slots")
    dev = bvh.node_min.device
    bits = lambda x: x.to(torch.int32).view(torch.float32)[:, None]
    miss, count = bvh.node_miss.long(), bvh.node_count.long()
    N = miss.shape[0]
    inner = torch.nonzero(count == 0)[:, 0]
    record = torch.zeros(N, dtype=torch.long, device=dev)
    record[inner] = torch.arange(1, inner.shape[0] + 1, device=dev)
    word = torch.where(count > 0, bvh.node_first.long() * 8 + count, record * 8)
    parent = torch.cat([torch.full((1,), -1, dtype=torch.long, device=dev), inner])
    first = parent + 1                                   # the root under record 0
    second = torch.where(parent >= 0, miss[first.clamp(max=N - 1)], -1)
    has2 = second >= 0
    # the record whose second child a node is (-1: none)
    owner = torch.full((N,), -1, dtype=torch.long, device=dev)
    owner[second[has2]] = torch.arange(parent.shape[0], device=dev)[has2]
    after = torch.where(has2, miss[second.clamp(min=0)], -1)
    nxt = torch.where(after >= 0, owner[after.clamp(min=0)], -1)
    if bool(((after >= 0) & (nxt < 0)).any()):
        raise ValueError("a miss link leads to no internal node's second child: not a "
                         "skip-link DFS layout")
    s2 = second.clamp(min=0)
    zero = torch.zeros_like(bvh.node_min[:1]).expand(parent.shape[0], 3)
    word2 = bits(torch.where(has2, word[s2], -1))
    nodes = torch.cat([
        bvh.node_min[first], bits(word[first]), bvh.node_max[first], word2,
        torch.where(has2[:, None], bvh.node_min[s2], zero), word2,
        torch.where(has2[:, None], bvh.node_max[s2], zero), bits(nxt)], dim=1)
    zero = torch.zeros_like(bvh.tri_v0[:, :1])
    tris = torch.cat([bvh.tri_v0, bits(bvh.tri_id), bvh.tri_e1, zero, bvh.tri_e2, zero], dim=1)
    return PackedBVH(nodes.contiguous(), tris.contiguous())


_WALK_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_float] + [ctypes.c_void_p] * 6
_OCCLUDED_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_float] + [ctypes.c_void_p] * 3


def cast_rays_bvh(bvh: FlatBVH, rays_o, rays_d, t_max: float = MISS_DEPTH,
                  packed: Optional[PackedBVH] = None,
                  counters_out: Optional[torch.Tensor] = None,
                  any_hit: bool = False) -> Dict[str, torch.Tensor]:
    """First hit by the BVH walk, or with ``any_hit`` the hit mask alone
    (``{"hit": ...}``, the walk stopped at each ray's first valid pair).
    CUDA tensors launch kernel E's closest-hit or any-hit entry on
    ``packed`` (``pack_bvh(bvh)`` when not given); CPU tensors run
    ``cast_rays_bvh_plain``. ``counters_out``, an int64 [2] tensor on the
    rays' device, if given, has the nodes visited and the (ray, triangle)
    pairs tested added to it. ``launches`` counts the kernel's launches,
    ``any_hit_launches`` those of the any-hit entry."""
    if counters_out is not None and (counters_out.dtype != torch.int64
                                     or counters_out.shape != (2,)
                                     or counters_out.device != rays_o.device):
        raise ValueError("counters_out must be an int64 [2] tensor on the rays' device")
    if rays_o.device.type == "cpu":
        return cast_rays_bvh_plain(bvh, rays_o, rays_d, t_max=t_max, counters_out=counters_out,
                                   any_hit=any_hit)
    packed = pack_bvh(bvh) if packed is None else packed
    for name, x in (("rays_o", rays_o), ("rays_d", rays_d)):
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 [R,3] tensor")
        if x.device != rays_o.device:
            raise ValueError("rays_o and rays_d must be on the same device")
    if rays_o.shape != rays_d.shape:
        raise ValueError("rays_o and rays_d differ in shape")
    if not isinstance(packed, PackedBVH):
        raise ValueError("packed must be pack_bvh's PackedBVH")
    for name, x, width in (("nodes", packed.nodes, 16), ("tris", packed.tris, 12)):
        if x.device != rays_o.device or x.dtype != torch.float32 or x.dim() != 2 \
                or x.shape[1] != width or not x.is_contiguous():
            raise ValueError(f"packed {name} must be float32 [.,{width}] on the rays' device")
    from dreammat_tpu_torch.ops import kernels

    R, dev = rays_o.shape[0], rays_o.device
    ctr = None if counters_out is None else counters_out.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (rays_o.data_ptr(), rays_d.data_ptr(), packed.nodes.data_ptr(),
            packed.tris.data_ptr(), R, float(t_max))
    if any_hit:
        hit = torch.empty(R, dtype=torch.bool, device=dev)
        if R == 0:
            return {"hit": hit}
        fn = kernels.function("bvh_traverse", "bvh_occluded", _OCCLUDED_ARGTYPES)
        rc = fn(*args, hit.data_ptr(), ctr, stream)
    else:
        t = torch.empty(R, dtype=torch.float32, device=dev)
        face = torch.empty(R, dtype=torch.int32, device=dev)
        u = torch.empty(R, dtype=torch.float32, device=dev)
        v = torch.empty(R, dtype=torch.float32, device=dev)
        if R == 0:
            return _finish(t, face, u, v)
        fn = kernels.function("bvh_traverse", "bvh_traverse", _WALK_ARGTYPES)
        rc = fn(*args, t.data_ptr(), face.data_ptr(), u.data_ptr(), v.data_ptr(), ctr, stream)
    if rc != 0:
        raise RuntimeError(f"bvh_traverse kernel launch failed (cudaError {rc})")
    cast_rays_bvh.launches += 1
    if any_hit:
        cast_rays_bvh.any_hit_launches += 1
        return {"hit": hit}
    return _finish(t, face, u, v)


cast_rays_bvh.launches = 0
cast_rays_bvh.any_hit_launches = 0


def uses_walk(bvh: FlatBVH) -> bool:
    """Whether ``cast_rays_chunked`` walks this BVH: above
    ``DENSE_CAST_MAX_TRIS`` (padded) triangles, as in the JAX package."""
    return bvh.tri_v0.shape[0] > DENSE_CAST_MAX_TRIS


def cast_data(bvh: FlatBVH):
    """What ``cast_rays_chunked``'s caster reads, made once per BVH: the
    plane data (``_plane_tri_data``) for the dense caster, the packed nodes
    and triangles (``pack_bvh``) for the walk."""
    return pack_bvh(bvh) if uses_walk(bvh) else _plane_tri_data(bvh)


def cast_rays_chunked(bvh: FlatBVH, rays_o, rays_d, t_max: float = MISS_DEPTH,
                      tri_data=None) -> Dict[str, torch.Tensor]:
    """The casting entry point of the renderer, the bakes and the export:
    the dense caster (kernel B on the card) at or below
    ``DENSE_CAST_MAX_TRIS`` triangles, the walk (kernel E) above.
    ``tri_data`` is ``cast_data(bvh)``, made here when not given."""
    o, d = rays_o.float().contiguous(), rays_d.float().contiguous()
    if uses_walk(bvh):
        return cast_rays_bvh(bvh, o, d, t_max=t_max, packed=tri_data)
    return cast_rays_dense(bvh, o, d, t_max=t_max, tri_data=tri_data)


def occluded_chunked(bvh: FlatBVH, rays_o, rays_d, t_max: float = MISS_DEPTH,
                     tri_data=None) -> torch.Tensor:
    """``cast_rays_chunked``'s hit mask, bool [R], for the callers that read
    nothing else (the visibility bakes, the shadow rays): the dense caster's
    at or below ``DENSE_CAST_MAX_TRIS`` triangles, above it the walk's
    any-hit entry, which stops each ray at its first hit and returns the
    same mask."""
    o, d = rays_o.float().contiguous(), rays_d.float().contiguous()
    if uses_walk(bvh):
        return cast_rays_bvh(bvh, o, d, t_max=t_max, packed=tri_data, any_hit=True)["hit"]
    return cast_rays_dense(bvh, o, d, t_max=t_max, tri_data=tri_data)["hit"]


def occlusion_rays(bvh: FlatBVH, rays_o, rays_d, t_max: float = MISS_DEPTH) -> torch.Tensor:
    """Occlusion query, bool [R]: a hit of the BVH walk closer than
    ``t_max`` (the JAX package's ``occlusion_rays``, which walks at every
    mesh size), by the walk's any-hit entry."""
    return cast_rays_bvh(bvh, rays_o.float().contiguous(), rays_d.float().contiguous(),
                         t_max=t_max, any_hit=True)["hit"]
