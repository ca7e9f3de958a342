"""Triangle mesh type and host-side construction.

Counterpart of ``dreammat_tpu/models/mesh.py`` for the ported path: the OBJ
loader with the reference's normalization, area-weighted vertex normals,
``fix_winding_outward`` and the procedural icosphere. Meshes are built with
numpy on the host and held as tensors on one device. The PLY and glb
loaders are not ported yet.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


def load_obj(path: str):
    """Minimal OBJ reader: v / vt / f (fan-triangulated)."""
    verts, uvs, faces, faces_uv = [], [], [], []
    with open(path, "r", errors="ignore") as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                uvs.append([float(x) for x in line.split()[1:3]])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    parts = tok.split("/")
                    vi = int(parts[0])
                    ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
                    idx.append((vi, ti))
                for k in range(1, len(idx) - 1):
                    tri = [idx[0], idx[k], idx[k + 1]]
                    faces.append([t[0] - 1 if t[0] > 0 else len(verts) + t[0] for t in tri])
                    faces_uv.append([t[1] - 1 if t[1] > 0 else len(uvs) + t[1] for t in tri])
    v = np.asarray(verts, dtype=np.float32)
    f = np.asarray(faces, dtype=np.int32)
    vt = np.asarray(uvs, dtype=np.float32) if uvs else None
    ft = np.asarray(faces_uv, dtype=np.int32) if uvs else None
    return v, f, vt, ft


def compute_vertex_normals(v: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals."""
    v0, v1, v2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    vn = np.zeros_like(v)
    for k in range(3):
        np.add.at(vn, f[:, k], fn)
    norm = np.linalg.norm(vn, axis=-1, keepdims=True)
    vn = np.where(norm > 1e-20, vn / np.maximum(norm, 1e-20), np.array([0.0, 0.0, 1.0]))
    return vn.astype(np.float32)


@dataclass
class Mesh:
    v_pos: torch.Tensor                 # [V,3] float32
    t_pos_idx: torch.Tensor             # [F,3] int64
    v_nrm: torch.Tensor                 # [V,3] float32
    v_tex: Optional[torch.Tensor] = None      # [V,2]
    t_tex_idx: Optional[torch.Tensor] = None  # [F,3]

    @staticmethod
    def from_numpy(v, f, vt=None, ft=None, device="cpu") -> "Mesh":
        return Mesh(
            v_pos=torch.as_tensor(np.asarray(v, np.float32), device=device),
            t_pos_idx=torch.as_tensor(np.asarray(f, np.int64), device=device),
            v_nrm=torch.as_tensor(compute_vertex_normals(np.asarray(v, np.float32), np.asarray(f)),
                                  device=device),
            v_tex=None if vt is None else torch.as_tensor(np.asarray(vt, np.float32), device=device),
            t_tex_idx=None if ft is None else torch.as_tensor(np.asarray(ft, np.int64), device=device),
        )


_DIR2VEC = {
    "+x": np.array([1, 0, 0]), "+y": np.array([0, 1, 0]), "+z": np.array([0, 0, 1]),
    "-x": np.array([-1, 0, 0]), "-y": np.array([0, -1, 0]), "-z": np.array([0, 0, -1]),
}


def load_mesh(path: str, scale: Optional[float] = None, mesh_up: str = "+z",
              mesh_front: str = "+x", device="cpu") -> Mesh:
    """Load and normalize an OBJ: center at the vertex centroid, rotate so
    ``mesh_up``/``mesh_front`` map to +z/+x, scale the max |coord| to
    ``scale``, and make the winding point outward."""
    ext = os.path.splitext(path)[1].lower()
    if ext != ".obj":
        raise NotImplementedError(f"{ext} meshes: only the OBJ loader is ported so far")
    v, f, vt, ft = load_obj(path)
    v = v - v.mean(axis=0, keepdims=True)
    if scale is not None:
        z_ = _DIR2VEC[mesh_up].astype(np.float64)
        x_ = _DIR2VEC[mesh_front].astype(np.float64)
        y_ = np.cross(z_, x_)
        mesh2std = np.linalg.inv(np.stack([x_, y_, z_], axis=0).T)
        v = v / np.abs(v).max() * scale
        v = (mesh2std @ v.T).T.astype(np.float32)
    f = fix_winding_outward(v, f, name=path)
    return Mesh.from_numpy(v, f, vt, ft, device=device)


def fix_winding_outward(v: np.ndarray, f: np.ndarray, name: str = "mesh") -> np.ndarray:
    """Flip an inside-out mesh's winding (negative divergence-theorem signed
    volume) so normals point outward; near-zero volume is left untouched."""
    w = v.astype(np.float64)[f]
    vol6 = float(np.sum(np.linalg.det(w)))
    scale = float(np.abs(v).max()) or 1.0
    if vol6 < -1e-6 * scale ** 3:
        logging.getLogger("dreammat_tpu_torch").warning(
            "%s: negative signed volume (%.3g) - flipping face winding so "
            "normals point outward", name, vol6 / 6.0)
        return f[:, [0, 2, 1]]
    return f


def icosphere_arrays(subdiv: int = 2, radius: float = 1.0):
    """Vertices [V,3] float32 and faces [F,3] int32 of a subdivided icosahedron."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
         [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
         [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
        dtype=np.float64,
    )
    faces = np.array(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
        dtype=np.int64,
    )
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    for _ in range(subdiv):
        edge_map = {}
        new_faces = []
        vlist = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_map:
                m = vlist[a] + vlist[b]
                edge_map[key] = len(vlist)
                vlist.append(m / np.linalg.norm(m))
            return edge_map[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.array(vlist)
        faces = np.array(new_faces, dtype=np.int64)
    return (verts * radius).astype(np.float32), faces.astype(np.int32)


def make_icosphere(subdiv: int = 2, radius: float = 1.0, device="cpu") -> Mesh:
    v, f = icosphere_arrays(subdiv, radius)
    return Mesh.from_numpy(v, f, device=device)
