"""Differentiable marching tetrahedra (DMTet) with a fixed face budget.

Counterpart of ``dreammat_tpu/ops/dmtet.py``: surface vertices are the
linear zero crossings of per-lattice-vertex SDF values along tet edges, so
gradients flow from the rendered pixels into the SDF and the optional
per-vertex deformation.

- ``build_tet_lattice``: the (res+1)^3 vertex lattice in [0, 1]^3, six tets
  per cube around the main diagonal (host numpy, once).
- ``marching_tets_fixed``: a fixed budget of ``max_tets`` tets is selected
  without a sync to the host: the crossing tets in ascending index order,
  then the non-crossing ones (a stable sort of the 0/1 "not crossing" key,
  the order ``lax.top_k`` gives over the 0/1 crossing mask in the JAX
  package). The order fixes the triangle slots and so the "first minimum in
  slot order" tie-break of the hit pass. Each selected tet emits up to two
  triangles into a [2k, 3, 3] buffer with a validity mask; invalid slots
  are all-zero triangles with edge ids -1. Gradients flow through the
  gathered SDF values and positions only.
- Surface-vertex identity is a global edge id per corner, lo * Nv + hi of
  the edge's sorted lattice vertex ids, kept in int64 (the JAX package
  forms it in int32 without x64, where it wraps above resolution 34).
- ``face_normals``, ``vertex_normals_by_gid`` (area-weighted, summed over
  equal edge ids by a stable sort and ``index_add_``),
  ``laplacian_smoothness`` and ``normal_consistency``.

No function here copies from the host to the device per call (the tables
are put on a device once), so a training step's soup is built without a
host sync.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from dreammat_tpu_torch.ops.marching import _case_tris

_CUBE_OFFSETS = np.array(
    [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
     [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]], dtype=np.int64
)
_TETS = np.array(
    [[0, 5, 1, 7], [0, 1, 3, 7], [0, 3, 2, 7],
     [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7]], dtype=np.int64
)

# tet-local edges, indexed 0..5: (corner_a, corner_b)
_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int64)
_EDGE_TO_IDX = {tuple(sorted(e)): i for i, e in enumerate(_EDGES.tolist())}


def _build_tri_table():
    """The 16-case table from the host extractor's ``_case_tris``: per case
    up to two triangles of tet-local edge indices (-1 padded) and their
    count. Winding is fixed per face at run time."""
    table = -np.ones((16, 6), np.int64)
    n_tris = np.zeros(16, np.int64)
    for case in range(16):
        tris = _case_tris(case)
        n_tris[case] = len(tris)
        flat = [_EDGE_TO_IDX[tuple(sorted((a, b)))] for tri in tris for (a, b) in tri]
        table[case, :len(flat)] = flat
    return table, n_tris


_TRI_TABLE, _N_TRIS = _build_tri_table()


@functools.lru_cache(maxsize=None)
def _device_tables(device: torch.device):
    """The edges' corners (a, b), the case table, the triangle counts and
    the winding swap [0, 2, 1] on ``device``, copied there once."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    return t(_EDGES[:, 0]), t(_EDGES[:, 1]), t(_TRI_TABLE), t(_N_TRIS), t([0, 2, 1])


class TetLattice(NamedTuple):
    verts: np.ndarray   # [Nv, 3] float32 in [0, 1]
    tets: np.ndarray    # [Nt, 4] int32 vertex ids


def build_tet_lattice(res: int) -> TetLattice:
    """Regular (res+1)^3 grid split into 6 tets per cube (host, once)."""
    n = res + 1
    xs = np.linspace(0.0, 1.0, n, dtype=np.float32)
    verts = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1).reshape(-1, 3)
    ix, iy, iz = np.meshgrid(*[np.arange(res)] * 3, indexing="ij")
    corners = np.stack([ix, iy, iz], -1).reshape(-1, 1, 3) + _CUBE_OFFSETS[None]
    cid = (corners[..., 0] * n + corners[..., 1]) * n + corners[..., 2]   # [C,8]
    tets = cid[:, _TETS].reshape(-1, 4)
    return TetLattice(verts, tets.astype(np.int32))


class MTOutput(NamedTuple):
    tri_verts: torch.Tensor   # [F, 3, 3] triangle corner positions
    valid: torch.Tensor       # [F] bool
    edge_gid: torch.Tensor    # [F, 3] int64 global edge id per corner (-1 invalid)


def marching_tets_fixed(sdf: torch.Tensor, verts: torch.Tensor, tets: torch.Tensor,
                        max_tets: int) -> MTOutput:
    """sdf [Nv] (> 0 inside), verts [Nv, 3] (possibly deformed), tets [Nt, 4]
    int64 -> 2 * min(max_tets, Nt) triangle slots."""
    Nt, Nv = tets.shape[0], sdf.shape[0]
    dev = sdf.device
    with torch.no_grad():
        o4 = (sdf > 0)[tets]                                          # [Nt,4]
        code = o4[:, 0].long() + 2 * o4[:, 1] + 4 * o4[:, 2] + 8 * o4[:, 3]
        crossing = (code != 0) & (code != 15)
        k = min(max_tets, Nt)
        idx = torch.argsort((~crossing).to(torch.uint8), stable=True)[:k]
        sel_valid = crossing[idx]
        t4 = tets[idx].long()                                         # [k,4]
        sel_code = code[idx]
        ea, eb, tri_table, n_tris_table, swap = _device_tables(dev)
        ga, gb = t4[:, ea], t4[:, eb]
        gid6 = torch.minimum(ga, gb) * Nv + torch.maximum(ga, gb)     # [k,6] int64
        tri_edges = tri_table[sel_code]                               # [k,6]
        n_tris = n_tris_table[sel_code]
        te = torch.clamp(tri_edges.reshape(-1, 2, 3), 0, 5)            # [k,2,3]
        slot_valid = sel_valid[:, None] & (torch.arange(2, device=dev)[None, :] < n_tris[:, None])
        rows = torch.arange(k, device=dev)[:, None, None]

    # gathers by index_select and gather, whose backward is an atomic
    # scatter-add (advanced indexing's backward sorts the indices)
    sv = sdf.index_select(0, t4.reshape(-1)).reshape(k, 4)            # [k,4]
    pv = verts.index_select(0, t4.reshape(-1)).reshape(k, 4, 3)       # [k,4,3]
    sa, sb = sv.index_select(1, ea), sv.index_select(1, eb)
    denom = sa - sb
    denom = torch.where(denom.abs() < 1e-10, torch.full_like(denom, 1e-10), denom)
    t = torch.clamp(sa / denom, 0.0, 1.0)[..., None]                  # [k,6,1]
    epos = pv.index_select(1, ea) * (1.0 - t) + pv.index_select(1, eb) * t  # [k,6,3]
    tv = torch.gather(epos[:, None].expand(k, 2, 6, 3), 2,
                      te[..., None].expand(k, 2, 3, 3))               # [k,2,3,3]
    gid = gid6[rows, te]                                              # [k,2,3]

    # orientation: outward is from the inside corners' centroid toward the
    # outside ones'; flip the triangles whose normal disagrees
    w_in = (sv > 0).to(sv.dtype)[..., None]                           # [k,4,1]
    c_in = torch.sum(pv * w_in, dim=1) / torch.clamp(torch.sum(w_in, dim=1), min=1e-6)
    c_out = torch.sum(pv * (1 - w_in), dim=1) / torch.clamp(torch.sum(1 - w_in, dim=1),
                                                            min=1e-6)
    out_dir = (c_out - c_in)[:, None, :]                              # [k,1,3]
    n = torch.linalg.cross(tv[..., 1, :] - tv[..., 0, :], tv[..., 2, :] - tv[..., 0, :], dim=-1)
    flip = torch.sum(n * out_dir, dim=-1) < 0                         # [k,2]
    tv = torch.where(flip[..., None, None], tv.index_select(2, swap), tv)
    gid = torch.where(flip[..., None], gid[:, :, swap], gid)

    tri_verts = torch.where(slot_valid[..., None, None], tv, torch.zeros_like(tv))
    edge_gid = torch.where(slot_valid[..., None], gid, torch.full_like(gid, -1))
    return MTOutput(tri_verts.reshape(2 * k, 3, 3), slot_valid.reshape(2 * k),
                    edge_gid.reshape(2 * k, 3))


def _cross_edges(tri_verts: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(tri_verts[:, 1] - tri_verts[:, 0],
                              tri_verts[:, 2] - tri_verts[:, 0], dim=-1)


def face_normals(tri_verts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[F,3] unit face normals; zero for invalid slots."""
    n = _cross_edges(tri_verts)
    n = n * torch.rsqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-12)
    return torch.where(valid[:, None], n, torch.zeros_like(n))


def _segments(gids: torch.Tensor):
    """A stable sort of the ids and the dense run index of each sorted entry."""
    order = torch.argsort(gids, stable=True)
    sg = gids[order]
    new_run = torch.ones_like(sg, dtype=torch.bool)
    new_run[1:] = sg[1:] != sg[:-1]
    return order, sg, torch.cumsum(new_run.long(), dim=0) - 1


def _segment_sum(x: torch.Tensor, seg_id: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device).index_add(0, seg_id, x)


def vertex_normals_by_gid(tri_verts: torch.Tensor, valid: torch.Tensor,
                          edge_gid: torch.Tensor) -> torch.Tensor:
    """Area-weighted shared-vertex normals, [F, 3, 3] unit vectors per corner
    (zero for invalid slots): the cross products of the faces that share an
    edge id, summed."""
    F = tri_verts.shape[0]
    fn = _cross_edges(tri_verts)
    fn = torch.where(valid[:, None], fn, torch.zeros_like(fn))
    order, _, seg_id = _segments(edge_gid.reshape(-1))
    sc = fn.repeat_interleave(3, dim=0).index_select(0, order)        # [3F,3]
    per_elem = _segment_sum(sc, seg_id, 3 * F).index_select(0, seg_id)
    vn = torch.zeros_like(per_elem).index_copy(0, order, per_elem).reshape(F, 3, 3)
    vn = vn * torch.rsqrt(torch.sum(vn * vn, dim=-1, keepdim=True) + 1e-12)
    return torch.where(valid[:, None, None], vn, torch.zeros_like(vn))


def laplacian_smoothness(tri_verts: torch.Tensor, valid: torch.Tensor,
                         edge_gid: torch.Tensor) -> torch.Tensor:
    """Uniform-Laplacian smoothness over the soup: the mean over unique
    surface vertices of ||mean(in-face neighbours) - v||. A vertex counts
    when one of its corners is valid and its edge id is >= 0 (every valid
    vertex: the ids are int64)."""
    F = tri_verts.shape[0]
    # each corner's two neighbours in its face: corners (1, 2, 0) and (2, 0, 1)
    nbr = (torch.roll(tri_verts, -1, dims=1) + torch.roll(tri_verts, 1, dims=1)).reshape(-1, 3)
    vmask = valid.repeat_interleave(3).to(tri_verts.dtype)
    order, sg, seg_id = _segments(edge_gid.reshape(-1))
    n = 3 * F
    vm = vmask[order]
    nbr_sum = _segment_sum(nbr.index_select(0, order) * vm[:, None], seg_id, n)
    cnt = _segment_sum(2.0 * vm, seg_id, n)
    pos_sum = _segment_sum(tri_verts.reshape(-1, 3).index_select(0, order) * vm[:, None],
                           seg_id, n)
    occ = _segment_sum(vm, seg_id, n)
    v = pos_sum / torch.clamp(occ, min=1.0)[:, None]
    lap = nbr_sum / torch.clamp(cnt, min=1.0)[:, None] - v
    seg_max = torch.zeros(n, dtype=vm.dtype, device=vm.device).scatter_reduce(
        0, seg_id, vm, "amax", include_self=False)
    seg_min = torch.zeros(n, dtype=sg.dtype, device=sg.device).scatter_reduce(
        0, seg_id, sg, "amin", include_self=False)
    seg_valid = (seg_max > 0) & (seg_min >= 0)
    norm = torch.sqrt(torch.sum(lap * lap, dim=-1) + 1e-12)
    return torch.sum(torch.where(seg_valid, norm, torch.zeros_like(norm))) / torch.clamp(
        seg_valid.sum(), min=1)


def normal_consistency(tri_verts: torch.Tensor, valid: torch.Tensor,
                       edge_gid: torch.Tensor, vn: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Mean (1 - cos) between each valid face's normal and its corners'
    shared-vertex normals (``vn``: those ``vertex_normals_by_gid`` gave for
    this soup, when the caller has them)."""
    fn = face_normals(tri_verts, valid)
    if vn is None:
        vn = vertex_normals_by_gid(tri_verts, valid, edge_gid)
    cos = torch.sum(fn[:, None, :] * vn, dim=-1)                      # [F,3]
    pen = torch.where(valid[:, None], 1.0 - cos, torch.zeros_like(cos))
    return torch.sum(pen) / torch.clamp(valid.sum() * 3, min=1)
