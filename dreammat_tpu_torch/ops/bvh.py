"""Flat BVH (host build) and the dense first-hit ray caster.

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
- ``cast_rays_chunked``: the dispatcher the renderer and the bakes call.
  Meshes above ``DENSE_CAST_MAX_TRIS`` need the BVH-traversal kernel, which
  is not ported yet, and raise.

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


def build_bvh(vertices: np.ndarray, faces: np.ndarray, device="cpu",
              use_native: bool = True) -> FlatBVH:
    """Host BVH build; the flat arrays land on ``device``."""
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


_CAST_ARGTYPES = (
    [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_float] + [ctypes.c_void_p] * 6
)


def _tile_boxes(bvh: FlatBVH, tid: torch.Tensor, tile: int):
    """Boxes of consecutive ``tile``-triangle groups in leaf order, [n, 6]
    (min | max), and the scene box [6], for the kernel's cull. Padding and
    degenerate triangles (id -1) take no part."""
    v0 = bvh.tri_v0
    corners = torch.stack([v0, v0 + bvh.tri_e1, v0 + bvh.tri_e2])       # [3,T,3]
    dead = (tid < 0)[:, None]
    inf = torch.full_like(v0, float("inf"))
    lo = torch.where(dead, inf, corners.amin(0))
    hi = torch.where(dead, -inf, corners.amax(0))
    pad = (-lo.shape[0]) % tile
    lo = torch.cat([lo, inf[:1].expand(pad, 3)]).reshape(-1, tile, 3).amin(1)
    hi = torch.cat([hi, -inf[:1].expand(pad, 3)]).reshape(-1, tile, 3).amax(1)
    scene = torch.cat([lo.amin(0), hi.amax(0)])
    return torch.cat([lo, hi], dim=1).contiguous(), scene.contiguous()


def cast_rays_dense(bvh: FlatBVH, rays_o, rays_d, t_max: float = MISS_DEPTH,
                    tri_data=None, pairs_out: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    """First hit of every ray against every triangle. CUDA tensors launch
    kernel B; CPU tensors run ``cast_rays_plain``. ``pairs_out``, an int64
    [1] tensor on the rays' device, if given, has the (ray, triangle) pairs
    tested added to it: those the kernel's tile cull keeps, or all R x T."""
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
    boxes, scene = _tile_boxes(bvh, tid, tile)
    R, T = rays_o.shape[0], rows.shape[1]
    dev = rays_o.device
    t = torch.empty(R, dtype=torch.float32, device=dev)
    face = torch.empty(R, dtype=torch.int32, device=dev)
    u = torch.empty(R, dtype=torch.float32, device=dev)
    v = torch.empty(R, dtype=torch.float32, device=dev)
    if R == 0:
        return _finish(t, face, u, v)
    rc = fn(rays_o.data_ptr(), rays_d.data_ptr(), rows.data_ptr(), tid.data_ptr(),
            boxes.data_ptr(), scene.data_ptr(), R, T, float(t_max), t.data_ptr(),
            face.data_ptr(), u.data_ptr(), v.data_ptr(),
            None if pairs_out is None else pairs_out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ray_cast kernel launch failed (cudaError {rc})")
    cast_rays_dense.launches += 1
    return _finish(t, face, u, v)


cast_rays_dense.launches = 0


def cast_rays_chunked(bvh: FlatBVH, rays_o, rays_d, t_max: float = MISS_DEPTH,
                      tri_data=None) -> Dict[str, torch.Tensor]:
    """The casting entry point of the renderer and the visibility bake."""
    if bvh.tri_v0.shape[0] > DENSE_CAST_MAX_TRIS:
        raise NotImplementedError(
            f"meshes above {DENSE_CAST_MAX_TRIS} triangles need the BVH-traversal "
            "kernel, which is not ported yet"
        )
    return cast_rays_dense(bvh, rays_o.float().contiguous(), rays_d.float().contiguous(),
                           t_max=t_max, tri_data=tri_data)
