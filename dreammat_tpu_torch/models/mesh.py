"""Triangle mesh type and host-side construction.

Counterpart of ``dreammat_tpu/models/mesh.py`` for the ported path: the
OBJ, PLY (ascii and binary) and binary glTF (.glb) loaders, numpy only,
with the reference's normalization, area-weighted vertex normals,
``fix_winding_outward``, the procedural icosphere, the torus of
``tools/quantify_fastpath.py`` (a self-occluding test shape) and its
natural (u, v) parameterisation (``torus_grid_arrays``: with its seams
duplicated, one vertex a texture vertex), writers (``write_obj`` and
``write_glb`` with optional texture coordinates, ``write_ply``) to hand it to the
loaders, and ``subdivide_mesh``, the midpoint (1:4) split of the
renderer's mesh for ``visibility_subdiv``. Meshes are built with numpy on
the host and held as tensors on one device.
"""

from __future__ import annotations

import json
import logging
import os
import struct
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from dreammat_tpu_torch.utils.hw import resolve_device


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


def load_ply(path: str):
    """PLY reader (ascii, binary little and big endian): vertex positions and
    fan-triangulated faces (binary faces: a uchar count and int32 indices)."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii", errors="ignore").splitlines()
    fmt = "ascii"
    nv = nf = 0
    vert_props = []
    reading = None
    for line in header:
        t = line.split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            reading = t[1]
            if t[1] == "vertex":
                nv = int(t[2])
            elif t[1] == "face":
                nf = int(t[2])
        elif t[0] == "property" and reading == "vertex":
            vert_props.append((t[-1], t[1]))
    names = [p[0] for p in vert_props]
    if fmt == "ascii":
        body = data[header_end:].decode("ascii").split()
        pos = 0
        verts = np.zeros((nv, 3), dtype=np.float32)
        stride = len(vert_props)
        xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
        for i in range(nv):
            row = body[pos:pos + stride]
            verts[i] = [float(row[xi]), float(row[yi]), float(row[zi])]
            pos += stride
        faces = []
        while pos < len(body):
            n = int(body[pos])
            idx = [int(x) for x in body[pos + 1:pos + 1 + n]]
            for k in range(1, n - 1):
                faces.append([idx[0], idx[k], idx[k + 1]])
            pos += n + 1
        return verts, np.asarray(faces, dtype=np.int32), None, None
    sizes = {"float": 4, "float32": 4, "double": 8, "uchar": 1, "uint8": 1,
             "int": 4, "int32": 4, "uint": 4, "uint32": 4, "short": 2, "ushort": 2}
    endian = "<" if "little" in fmt else ">"
    off = header_end
    stride = sum(sizes[p[1]] for p in vert_props)
    verts = np.zeros((nv, 3), dtype=np.float32)
    offs = {}
    o = 0
    for nme, typ in vert_props:
        offs[nme] = (o, typ)
        o += sizes[typ]
    for i in range(nv):
        base = off + i * stride
        vals = []
        for axis in ("x", "y", "z"):
            ao, typ = offs[axis]
            fmtc = {"float": "f", "float32": "f", "double": "d"}[typ]
            vals.append(struct.unpack_from(endian + fmtc, data, base + ao)[0])
        verts[i] = vals
    off += nv * stride
    faces = []
    while off < len(data) and len(faces) < nf * 2:
        n = struct.unpack_from(endian + "B", data, off)[0]
        off += 1
        idx = struct.unpack_from(endian + f"{n}i", data, off)
        off += 4 * n
        for k in range(1, n - 1):
            faces.append([idx[0], idx[k], idx[k + 1]])
    return verts, np.asarray(faces, dtype=np.int32), None, None


def load_glb(path: str):
    """Binary glTF (.glb) reader: POSITION, indices (u8, u16 or u32; none
    means consecutive triangles) and TEXCOORD_0 of every primitive of every
    mesh, concatenated; accessors with a byte stride are read row by row."""
    with open(path, "rb") as f:
        data = f.read()
    magic, _version, length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:
        raise ValueError(f"{path}: not a glb file")
    off = 12
    js = None
    binbuf = b""
    while off < length:
        clen, ctype = struct.unpack_from("<II", data, off)
        off += 8
        chunk = data[off:off + clen]
        off += clen
        if ctype == 0x4E4F534A:  # JSON
            js = json.loads(chunk.decode("utf-8"))
        elif ctype == 0x004E4942:  # BIN
            binbuf = chunk
    if js is None:
        raise ValueError(f"{path}: no JSON chunk")

    def read_accessor(idx):
        acc = js["accessors"][idx]
        bv = js["bufferViews"][acc["bufferView"]]
        comp = {5120: np.int8, 5121: np.uint8, 5122: np.int16,
                5123: np.uint16, 5125: np.uint32, 5126: np.float32}[acc["componentType"]]
        ncomp = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4}[acc["type"]]
        start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        count = acc["count"]
        itemsize = np.dtype(comp).itemsize * ncomp
        stride = bv.get("byteStride", itemsize)
        if stride == itemsize:
            arr = np.frombuffer(binbuf, dtype=comp, count=count * ncomp, offset=start)
        else:
            arr = np.concatenate([
                np.frombuffer(binbuf, dtype=comp, count=ncomp, offset=start + i * stride)
                for i in range(count)])
        return arr.reshape(count, ncomp) if ncomp > 1 else arr

    all_v, all_f, all_vt = [], [], []
    base = 0
    for mesh in js.get("meshes", []):
        for prim in mesh.get("primitives", []):
            v = read_accessor(prim["attributes"]["POSITION"]).astype(np.float32)
            if "indices" in prim:
                f_idx = read_accessor(prim["indices"]).astype(np.int64).reshape(-1, 3)
            else:
                f_idx = np.arange(len(v), dtype=np.int64).reshape(-1, 3)
            all_v.append(v)
            all_f.append(f_idx + base)
            if "TEXCOORD_0" in prim["attributes"]:
                all_vt.append(read_accessor(prim["attributes"]["TEXCOORD_0"]).astype(np.float32))
            base += len(v)
    v = np.concatenate(all_v, 0)
    f = np.concatenate(all_f, 0).astype(np.int32)
    vt = np.concatenate(all_vt, 0) if len(all_vt) == len(all_v) and all_vt else None
    ft = f if vt is not None and len(vt) == len(v) else None
    return v, f, vt, ft


_LOADERS = {".obj": load_obj, ".ply": load_ply, ".glb": load_glb, ".gltf": load_glb}


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
    def from_numpy(v, f, vt=None, ft=None, device="cuda") -> "Mesh":
        device = resolve_device(device)
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
              mesh_front: str = "+x", device="cuda") -> Mesh:
    """Load (.obj, .ply, .glb) and normalize a mesh: center at the vertex
    centroid, rotate so ``mesh_up``/``mesh_front`` map to +z/+x, scale the
    max |coord| to ``scale``, and make the winding point outward."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in _LOADERS:
        raise ValueError(f"unsupported mesh format {ext}")
    v, f, vt, ft = _LOADERS[ext](path)
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


def torus_arrays(R: float = 0.7, r: float = 0.28, nu: int = 24, nv: int = 12):
    """Vertices [nu*nv,3] float32 and faces [2*nu*nv,3] int64 of a torus
    about z: ``nu`` segments around the axis, ``nv`` around the tube."""
    us, vs = np.arange(nu) / nu * 2 * np.pi, np.arange(nv) / nv * 2 * np.pi
    uu, vv = np.meshgrid(us, vs, indexing="ij")
    v = np.stack([(R + r * np.cos(vv)) * np.cos(uu), (R + r * np.cos(vv)) * np.sin(uu),
                  r * np.sin(vv)], -1).reshape(-1, 3).astype(np.float32)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a, b = i * nv + j, ((i + 1) % nu) * nv + j
    c, d = ((i + 1) % nu) * nv + (j + 1) % nv, i * nv + (j + 1) % nv
    f = np.stack([np.stack([a, b, c], -1), np.stack([a, c, d], -1)], 2).reshape(-1, 3)
    return v, f.astype(np.int64)


def torus_grid_arrays(R: float = 0.7, r: float = 0.28, nu: int = 24, nv: int = 12):
    """``torus_arrays``' torus with its seams' vertices duplicated, one
    vertex per texture vertex of ``torus_uv_arrays``: vertices
    [(nu+1)*(nv+1),3] float32, faces [2*nu*nv,3] int64 (``torus_uv_arrays``'
    texture faces) and (u, v) [(nu+1)*(nv+1),2] float32, the layout a .glb's
    TEXCOORD_0 holds."""
    vt, ft = torus_uv_arrays(nu, nv)
    uu, vv = vt[:, 0].astype(np.float64) * 2 * np.pi, vt[:, 1].astype(np.float64) * 2 * np.pi
    v = np.stack([(R + r * np.cos(vv)) * np.cos(uu), (R + r * np.cos(vv)) * np.sin(uu),
                  r * np.sin(vv)], -1).astype(np.float32)
    return v, ft, vt


def torus_uv_arrays(nu: int = 24, nv: int = 12):
    """The natural (u, v) parameterisation of ``torus_arrays``' torus:
    texture vertices [(nu+1)*(nv+1),2] float32 on the unit square (the
    seams duplicated) and texture faces [2*nu*nv,3] int64, face for face."""
    ui, vi = np.meshgrid(np.arange(nu + 1), np.arange(nv + 1), indexing="ij")
    vt = np.stack([ui / nu, vi / nv], -1).reshape(-1, 2).astype(np.float32)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a, b = i * (nv + 1) + j, (i + 1) * (nv + 1) + j
    c, d = (i + 1) * (nv + 1) + j + 1, i * (nv + 1) + j + 1
    ft = np.stack([np.stack([a, b, c], -1), np.stack([a, c, d], -1)], 2).reshape(-1, 3)
    return vt, ft.astype(np.int64)


def write_obj(path: str, v: np.ndarray, f: np.ndarray, vt: Optional[np.ndarray] = None,
              ft: Optional[np.ndarray] = None) -> str:
    """An OBJ of ``v`` and 1-based ``f`` lines, with ``vt`` lines and
    ``a/ta`` face corners when texture coordinates are given."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        fh.writelines(f"v {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in v)
        if vt is None:
            fh.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in f)
        else:
            fh.writelines(f"vt {s_:.6f} {t_:.6f}\n" for s_, t_ in vt)
            fh.writelines(f"f {a + 1}/{ta + 1} {b + 1}/{tb + 1} {c + 1}/{tc + 1}\n"
                          for (a, b, c), (ta, tb, tc) in zip(f, ft))
    return path


def write_glb(path: str, v: np.ndarray, f: np.ndarray, vt: Optional[np.ndarray] = None) -> str:
    """A binary glTF (.glb) of one mesh primitive: float32 POSITION, float32
    TEXCOORD_0 when ``vt`` (one (u, v) a vertex) is given, and uint16
    indices (uint32 past 65,535 vertices)."""
    v = np.ascontiguousarray(v, dtype=np.float32)
    idx = np.asarray(f).astype(np.uint16 if len(v) <= 65535 else np.uint32).reshape(-1)
    blobs = [v.tobytes()]
    attributes = {"POSITION": 0}
    accessors = [{"bufferView": 0, "componentType": 5126, "count": len(v), "type": "VEC3",
                  "min": v.min(0).tolist(), "max": v.max(0).tolist()}]
    if vt is not None:
        blobs.append(np.ascontiguousarray(vt, dtype=np.float32).tobytes())
        attributes["TEXCOORD_0"] = len(accessors)
        accessors.append({"bufferView": len(accessors), "componentType": 5126,
                          "count": len(v), "type": "VEC2"})
    accessors.append({"bufferView": len(accessors), "componentType": 5123
                      if idx.dtype == np.uint16 else 5125, "count": idx.size, "type": "SCALAR"})
    blobs.append(idx.tobytes())
    views, off = [], 0
    for b in blobs:
        views.append({"buffer": 0, "byteOffset": off, "byteLength": len(b)})
        off += len(b)
    body = b"".join(blobs) + b"\0" * (-off % 4)
    js = {"asset": {"version": "2.0"}, "buffers": [{"byteLength": len(body)}],
          "bufferViews": views, "accessors": accessors,
          "meshes": [{"primitives": [{"attributes": attributes,
                                      "indices": len(accessors) - 1}]}]}
    jb = json.dumps(js).encode()
    jb += b" " * (-len(jb) % 4)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<III", 0x46546C67, 2, 28 + len(jb) + len(body)))
        fh.write(struct.pack("<II", len(jb), 0x4E4F534A) + jb)
        fh.write(struct.pack("<II", len(body), 0x004E4942) + body)
    return path


def write_ply(path: str, v: np.ndarray, f: np.ndarray) -> str:
    """A binary little-endian PLY: float x, y, z and int32 triangles."""
    v = np.ascontiguousarray(v, dtype="<f4")
    faces = np.empty(len(f), dtype=[("n", "u1"), ("idx", "<i4", (3,))])
    faces["n"], faces["idx"] = 3, f
    head = (f"ply\nformat binary_little_endian 1.0\nelement vertex {len(v)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(f)}\nproperty list uchar int vertex_indices\nend_header\n")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(head.encode("ascii") + v.tobytes() + faces.tobytes())
    return path


def make_icosphere(subdiv: int = 2, radius: float = 1.0, device="cuda") -> Mesh:
    v, f = icosphere_arrays(subdiv, radius)
    return Mesh.from_numpy(v, f, device=device)


def subdivide_mesh(mesh: Mesh, levels: int = 1, max_verts: int = 1 << 20) -> Mesh:
    """Uniform midpoint (1:4) subdivision of the same surface, on the host
    in numpy: one new vertex per unique edge (shared edges once, so the
    surface stays watertight), each face split into its three corners and
    the middle. Midpoint normals are the normalized mean of the edge's two;
    the texture topology is split alike, face for face. Stops before a
    level that would pass ``max_verts``."""

    def split_topology(faces):
        F = faces.shape[0]
        edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0)
        uniq, inv = np.unique(np.sort(edges, axis=1), axis=0, return_inverse=True)
        inv = inv.reshape(-1)

        def expand(attr, normalize=False):
            mids = 0.5 * (attr[uniq[:, 0]] + attr[uniq[:, 1]])
            if normalize:
                mids = mids / (np.linalg.norm(mids, axis=-1, keepdims=True) + 1e-12)
            return np.concatenate([attr, mids], axis=0)

        def new_faces(V):
            m01, m12, m20 = V + inv[:F], V + inv[F:2 * F], V + inv[2 * F:]
            v0, v1, v2 = faces[:, 0], faces[:, 1], faces[:, 2]
            return np.concatenate([np.stack([v0, m01, m20], 1), np.stack([v1, m12, m01], 1),
                                   np.stack([v2, m20, m12], 1), np.stack([m01, m12, m20], 1)])

        return expand, new_faces, len(uniq)

    dev = mesh.v_pos.device
    v = mesh.v_pos.detach().cpu().numpy().astype(np.float64)
    f = mesh.t_pos_idx.detach().cpu().numpy().astype(np.int64)
    vn = mesh.v_nrm.detach().cpu().numpy().astype(np.float64)
    uv = mesh.v_tex is not None and mesh.t_tex_idx is not None
    vt = mesh.v_tex.detach().cpu().numpy().astype(np.float64) if uv else None
    ft = mesh.t_tex_idx.detach().cpu().numpy().astype(np.int64) if uv else None
    for _ in range(max(int(levels), 0)):
        expand, faces_of, n_edges = split_topology(f)
        if v.shape[0] + n_edges > max_verts:
            break
        f_new = faces_of(v.shape[0])
        v, vn = expand(v), expand(vn, normalize=True)
        if uv:
            expand_t, faces_t, _ = split_topology(ft)
            ft = faces_t(vt.shape[0])
            vt = expand_t(vt)
        f = f_new
    t = lambda x, dt: torch.as_tensor(np.asarray(x, dt), device=dev)
    return Mesh(v_pos=t(v, np.float32), t_pos_idx=t(f, np.int64), v_nrm=t(vn, np.float32),
                v_tex=t(vt, np.float32) if uv else None,
                t_tex_idx=t(ft, np.int64) if uv else None)
