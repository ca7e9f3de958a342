"""Marching tetrahedra isosurface extraction on a regular grid (host numpy).

A copy of ``dreammat_tpu/ops/marching.py`` (the port imports nothing of the
JAX package): each grid cube is split into the six tetrahedra around its
main diagonal and the zero level set is extracted per tetrahedron, with
vertices shared along grid edges. Faces are oriented against the field's
gradient (outward = toward negative field). It runs once per export, on
the host.
"""

from __future__ import annotations

import numpy as np

# six tets around the 0-7 main diagonal; cube corners indexed by binary
# (x<<2 | y<<1 | z) offsets
_CUBE_OFFSETS = np.array(
    [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
     [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]], dtype=np.int64
)
_TETS = np.array(
    [[0, 5, 1, 7], [0, 1, 3, 7], [0, 3, 2, 7],
     [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7]], dtype=np.int64
)

# per-case triangle list; each triangle is 3 tet-local edges (a, b) meaning
# the surface vertex on edge corner_a—corner_b. Winding is arbitrary here —
# fixed afterwards against the field gradient.
_OTHERS = {0: (1, 2, 3), 1: (0, 2, 3), 2: (0, 1, 3), 3: (0, 1, 2)}


def _case_tris(case: int):
    inside = [i for i in range(4) if case & (1 << i)]
    if len(inside) in (0, 4):
        return []
    if len(inside) == 1:
        v = inside[0]
        o = _OTHERS[v]
        return [((v, o[0]), (v, o[1]), (v, o[2]))]
    if len(inside) == 3:
        v = [i for i in range(4) if i not in inside][0]
        o = _OTHERS[v]
        return [((v, o[0]), (v, o[1]), (v, o[2]))]
    a, b = inside
    c, d = [i for i in range(4) if i not in inside]
    e1, e2, e3, e4 = (a, c), (a, d), (b, c), (b, d)
    return [(e1, e2, e3), (e3, e2, e4)]


_TRI_TABLE = {case: _case_tris(case) for case in range(16)}


def marching_tets_grid(field: np.ndarray, xs: np.ndarray):
    """field: [R,R,R] signed scalar (zero level set extracted, positive =
    inside); xs: [R] per-axis coordinates (same for x/y/z, 'ij' indexing).
    Returns (vertices [V,3] float32, faces [F,3] int32) with outward
    orientation (normals toward field < 0)."""
    R = field.shape[0]
    assert field.shape == (R, R, R) and xs.shape == (R,)
    f = np.asarray(field, np.float64)

    # global ids of the 8 corners of every cube: [(R-1)^3, 8]
    base = np.arange(R - 1, dtype=np.int64)
    bi, bj, bk = np.meshgrid(base, base, base, indexing="ij")
    corner_ids = np.empty(((R - 1) ** 3, 8), np.int64)
    for c, (dx, dy, dz) in enumerate(_CUBE_OFFSETS):
        corner_ids[:, c] = (((bi + dx) * R + (bj + dy)) * R + (bk + dz)).ravel()

    fflat = f.ravel()
    tri_edge_a = []  # global id of edge start, per emitted triangle vertex
    tri_edge_b = []
    for tet in _TETS:
        ids = corner_ids[:, tet]  # [N,4]
        vals = fflat[ids]
        case = ((vals > 0) << np.arange(4)).sum(axis=1)
        for cval, tris in _TRI_TABLE.items():
            if not tris:
                continue
            sel = np.nonzero(case == cval)[0]
            if sel.size == 0:
                continue
            for tri in tris:
                ea = np.stack([ids[sel, la] for (la, _) in tri], axis=1)  # [n,3]
                eb = np.stack([ids[sel, lb] for (_, lb) in tri], axis=1)
                tri_edge_a.append(ea)
                tri_edge_b.append(eb)

    if not tri_edge_a:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))

    ea = np.concatenate(tri_edge_a).reshape(-1)  # [3T]
    eb = np.concatenate(tri_edge_b).reshape(-1)
    # canonical edge key (unordered pair of global grid vertices)
    lo, hi = np.minimum(ea, eb), np.maximum(ea, eb)
    keys = lo * (R**3) + hi
    uniq, inverse = np.unique(keys, return_inverse=True)
    faces = inverse.reshape(-1, 3).astype(np.int64)

    ulo, uhi = uniq // (R**3), uniq % (R**3)
    fa, fb = fflat[ulo], fflat[uhi]
    t = fa / (fa - fb + 1e-30)  # zero crossing along the edge
    t = np.clip(t, 0.0, 1.0)[:, None]

    def pos(gid):
        i, rem = gid // (R * R), gid % (R * R)
        j, k = rem // R, rem % R
        return np.stack([xs[i], xs[j], xs[k]], axis=-1)

    verts = pos(ulo) * (1 - t) + pos(uhi) * t

    # drop degenerate triangles (all three crossings on one shared corner)
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    n = np.cross(v1 - v0, v2 - v0)
    area2 = np.linalg.norm(n, axis=-1)
    keep = area2 > 1e-12
    faces, n = faces[keep], n[keep]

    # orient: outward = direction of decreasing field; flip where the
    # geometric normal points toward the inside (positive gradient)
    grad = np.stack(np.gradient(f), axis=-1)  # [R,R,R,3] d field / d index
    cent = (verts[faces[:, 0]] + verts[faces[:, 1]] + verts[faces[:, 2]]) / 3.0
    step = xs[1] - xs[0]
    idx = np.clip(np.round((cent - xs[0]) / step).astype(np.int64), 0, R - 1)
    g = grad[idx[:, 0], idx[:, 1], idx[:, 2]]
    flip = (n * g).sum(axis=-1) > 0
    faces[flip] = faces[flip][:, ::-1]

    return verts.astype(np.float32), faces.astype(np.int32)
