"""Port parity: differentiable marching tetrahedra and the DMTet geometry.

The same numpy inputs go through ``dreammat_tpu/ops/dmtet.py`` (jitted) and
``dreammat_tpu_torch/ops/dmtet.py`` on the CPU:

- the lattice and the 16-case table, exactly;
- ``marching_tets_fixed`` at resolution 12 on a bumpy sphere over a
  deformed lattice, with a budget that holds every crossing tet and one
  that truncates it: the same slots in the same order (valid masks and
  edge ids equal), ``tri_verts`` within 1e-6; its gradients with respect
  to the SDF and the deformation within 1e-5 (relative to the largest);
- the three mesh losses and the vertex normals, values within 1e-6 and
  gradients within 1e-5;
- at resolution 64 (finding 1 of the DMTet port): the JAX package's edge
  ids wrap at int32 (many are negative), the port's are the int64 ids; the
  JAX ``laplacian_smoothness`` drops the vertices whose id wrapped, the
  port's counts every vertex and equals the JAX formula on wrap-free ids;
- ``trilinear_sample`` (cell-centred) and the signed distance to a mesh
  (``ops/shape_loss.py``) within 1e-5;
- the ``tetrahedra-sdf-grid`` geometry: its initial SDF for each
  ``shape_init`` (``mesh:`` on an icosphere OBJ), the isosurface through
  the weight bridge, the features, and the host export, exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreammat_tpu
import dreammat_tpu.models  # noqa: F401
import dreammat_tpu_torch
import dreammat_tpu_torch.models  # noqa: F401
from dreammat_tpu.ops import dmtet as jdmtet
from dreammat_tpu_torch.models.diffusion.convert import geometry_params_from_numpy
from dreammat_tpu_torch.ops import dmtet as tdmtet

from test_torch_dreammat_step import _np
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401

TINY_GRID = {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
             "log2_hashmap_size": 10, "base_resolution": 4, "per_level_scale": 1.5}


def _close(a, b, tol, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max() if a.size else 0.0
    assert err <= tol * max(np.abs(b).max() if b.size else 0.0, 1.0), (what, err)


def _scene(res, seed=0, radius=0.5, bump=0.04, deform=0.5):
    """Lattice positions over [-1, 1]^3 moved by a random bounded
    deformation, a bumpy sphere SDF (inside positive) and the deformation."""
    lat = tdmtet.build_tet_lattice(res)
    v = lat.verts * 2.0 - 1.0
    rng = np.random.RandomState(seed)
    sdf = (radius - np.linalg.norm(v, axis=-1) + bump * np.sin(9 * v[:, 0]) * np.cos(7 * v[:, 1])
           + 0.01 * rng.normal(size=len(v))).astype(np.float32)
    dfm = (deform * rng.normal(size=v.shape)).astype(np.float32)
    return lat, v.astype(np.float32), sdf, dfm


def _deformed(v, dfm, res, tanh):
    return v + 0.45 * (2.0 / res) * tanh(dfm)


def _jax_march(v, sdf, dfm, tets, res, k):
    def f(s, d):
        return jdmtet.marching_tets_fixed(s, _deformed(jnp.asarray(v), d, res, jnp.tanh),
                                          jnp.asarray(tets), k)
    return jax.jit(f)(jnp.asarray(sdf), jnp.asarray(dfm))


def _torch_march(v, sdf, dfm, tets, res, k, grad=False):
    s = torch.from_numpy(sdf).requires_grad_(grad)
    d = torch.from_numpy(dfm).requires_grad_(grad)
    out = tdmtet.marching_tets_fixed(s, _deformed(torch.from_numpy(v), d, res, torch.tanh),
                                     torch.from_numpy(tets).long(), k)
    return out, s, d


def test_lattice_and_case_table_equal_jax():
    jl, tl = jdmtet.build_tet_lattice(5), tdmtet.build_tet_lattice(5)
    assert np.array_equal(jl.verts, tl.verts) and np.array_equal(jl.tets, tl.tets)
    assert tl.tets.dtype == np.int32 and tl.tets.shape == (6 * 125, 4)
    assert np.array_equal(jdmtet._TRI_TABLE, tdmtet._TRI_TABLE)
    assert np.array_equal(jdmtet._N_TRIS, tdmtet._N_TRIS)


@pytest.mark.parametrize("budget", ["all", "truncated"])
def test_marching_tets_fixed_matches_jax(budget):
    res = 12
    lat, v, sdf, dfm = _scene(res)
    occ = (sdf > 0)[lat.tets]
    n_cross = int(((occ.sum(1) > 0) & (occ.sum(1) < 4)).sum())
    assert n_cross > 200
    k = n_cross + 300 if budget == "all" else n_cross // 2
    j = _jax_march(v, sdf, dfm, lat.tets, res, k)
    t, _, _ = _torch_march(v, sdf, dfm, lat.tets, res, k)
    assert t.tri_verts.shape == (2 * k, 3, 3) and t.edge_gid.dtype == torch.int64
    assert np.array_equal(t.valid.numpy(), np.asarray(j.valid))
    assert np.array_equal(t.edge_gid.numpy(), np.asarray(j.edge_gid))
    _close(t.tri_verts, j.tri_verts, 1e-6, "tri_verts")
    n_valid = int(t.valid.sum())
    if budget == "all":
        # every crossing tet emits one or two triangles, in the first slots
        assert n_valid >= n_cross and not t.valid[2 * n_cross:].any()
    else:
        # the first k crossing tets in index order, every slot pair used
        assert t.valid.reshape(k, 2)[:, 0].all()
    # invalid slots are all-zero triangles with ids -1
    inv = ~t.valid
    assert (t.tri_verts[inv] == 0).all() and (t.edge_gid[inv] == -1).all()


def test_marching_tets_fixed_gradients_match_jax():
    res = 12
    lat, v, sdf, dfm = _scene(res, seed=1)
    k = 4096
    W = np.random.RandomState(2).normal(size=(2 * k, 3, 3)).astype(np.float32)

    def jloss(s, d):
        out = jdmtet.marching_tets_fixed(s, _deformed(jnp.asarray(v), d, res, jnp.tanh),
                                         jnp.asarray(lat.tets), k)
        return jnp.sum(out.tri_verts * W)

    jgs, jgd = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(sdf), jnp.asarray(dfm))
    t, s, d = _torch_march(v, sdf, dfm, lat.tets, res, k, grad=True)
    torch.sum(t.tri_verts * torch.from_numpy(W)).backward()
    assert float(jnp.abs(jgs).max()) > 0 and float(jnp.abs(jgd).max()) > 0
    _close(s.grad, jgs, 1e-5, "d/d sdf")
    _close(d.grad, jgd, 1e-5, "d/d deformation")


@pytest.mark.parametrize("name", ["face_normals", "vertex_normals_by_gid",
                                  "laplacian_smoothness", "normal_consistency"])
def test_mesh_losses_match_jax(name):
    res = 12
    lat, v, sdf, dfm = _scene(res, seed=3)
    k = 4096
    j = _jax_march(v, sdf, dfm, lat.tets, res, k)
    tv = np.array(j.tri_verts)
    valid, gid = np.array(j.valid), np.array(j.edge_gid)
    W = np.random.RandomState(4).normal(size=tv.shape).astype(np.float32)
    jf, tf = getattr(jdmtet, name), getattr(tdmtet, name)
    args = (name == "face_normals") and (valid,) or (valid, gid)

    def jloss(x):
        y = jf(x, *[jnp.asarray(a) for a in args])
        return jnp.sum(y * W[:, 0]) if name == "face_normals" else (
            jnp.sum(y * W) if y.ndim else y)

    jval = jf(jnp.asarray(tv), *[jnp.asarray(a) for a in args])
    jgrad = jax.jit(jax.grad(jloss))(jnp.asarray(tv))
    x = torch.from_numpy(tv).requires_grad_(True)
    y = tf(x, *[torch.from_numpy(a) for a in args])
    _close(y.detach(), jval, 1e-6, name)
    (torch.sum(y * torch.from_numpy(W[:, 0])) if name == "face_normals" else (
        torch.sum(y * torch.from_numpy(W)) if y.ndim else y)).backward()
    assert float(jnp.abs(jgrad).max()) > 0
    _close(x.grad, jgrad, 1e-5, f"d {name}")


def test_edge_ids_wrap_at_int32_in_jax_and_not_in_the_port():
    """Finding 1: at resolution 64 (Nv = 65^3) the JAX package's edge ids
    lo * Nv + hi wrap at int32 (the package runs without x64), so some are
    negative; no two collide, so the normals are right, but its
    ``laplacian_smoothness`` counts a vertex only when its id is >= 0 and
    drops the rest. The port's int64 ids are exact, and its loss counts
    every vertex: it equals the JAX formula on wrap-free (dense rank) ids."""
    res, k = 64, 1 << 15
    lat, v, sdf, dfm = _scene(res, bump=0.0, deform=0.0)
    sdf = (0.5 - np.linalg.norm(v, axis=-1)).astype(np.float32)
    j = _jax_march(v, sdf, dfm, lat.tets, res, k)
    t, _, _ = _torch_march(v, sdf, dfm, lat.tets, res, k)
    valid = t.valid.numpy()
    jg, tg = np.asarray(j.edge_gid)[valid], t.edge_gid.numpy()[valid]
    assert j.edge_gid.dtype == jnp.int32
    n_neg = int((jg < 0).sum())
    assert n_neg > 1000, n_neg
    assert (tg >= 0).all()
    # the port's ids are the exact int64 ones; the JAX ids are them mod 2^32
    assert np.array_equal(((tg + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32), jg)
    assert len(np.unique(jg)) == len(np.unique(tg))  # no collision
    _close(t.tri_verts, j.tri_verts, 1e-6, "tri_verts")

    tv, vd = t.tri_verts, t.valid
    port = float(tdmtet.laplacian_smoothness(tv, vd, t.edge_gid))
    jax_wrapped = float(jdmtet.laplacian_smoothness(j.tri_verts, j.valid, j.edge_gid))
    dense = torch.unique(t.edge_gid, return_inverse=True)[1] - 1  # -1 stays the smallest
    dense = torch.where(t.edge_gid < 0, -1, dense).to(torch.int32).numpy()
    jax_exact = float(jdmtet.laplacian_smoothness(j.tri_verts, j.valid, jnp.asarray(dense)))
    assert abs(port - jax_exact) <= 1e-6 * max(abs(jax_exact), 1e-3)
    assert abs(port - jax_wrapped) > 1e-6 * abs(port)
    # vertices counted: every valid one in the port, fewer in the JAX package
    assert len(np.unique(tg)) > len(np.unique(jg[jg >= 0]))


def test_trilinear_sample_matches_jax():
    from dreammat_tpu.models.geometry_volume import trilinear_sample as jtri
    from dreammat_tpu_torch.models.geometry_volume import trilinear_sample as ttri

    rng = np.random.RandomState(5)
    grid = rng.normal(size=(7, 6, 5, 2)).astype(np.float32)
    x = rng.uniform(-0.05, 1.05, (9, 11, 3)).astype(np.float32).clip(0, 1)
    W = rng.normal(size=(9, 11, 2)).astype(np.float32)
    jg = jax.grad(lambda g: jnp.sum(jtri(g, jnp.asarray(x)) * W))(jnp.asarray(grid))
    g = torch.from_numpy(grid).requires_grad_(True)
    y = ttri(g, torch.from_numpy(x))
    _close(y.detach(), jtri(jnp.asarray(grid), jnp.asarray(x)), 1e-6, "sample")
    torch.sum(y * torch.from_numpy(W)).backward()
    _close(g.grad, jg, 1e-5, "grad")


def _icosphere_obj(tmp_path, radius=0.6):
    from dreammat_tpu_torch.models.mesh import icosphere_arrays, write_obj

    v, f = icosphere_arrays(2, radius)
    path = str(tmp_path / "ico.obj")
    write_obj(path, v, f)
    return path, v, f


def test_mesh_signed_distance_matches_jax(tmp_path):
    from dreammat_tpu.ops import shape_loss as jsl
    from dreammat_tpu_torch.ops import shape_loss as tsl

    _, v, f = _icosphere_obj(tmp_path)
    tri = v[f].astype(np.float32)
    rng = np.random.RandomState(6)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    pts[:4] = tri[:4, 0] + 0.0  # points on the surface (vertex regions)
    for name in ("winding_number", "point_mesh_sq_distance"):
        j = getattr(jsl, name)(jnp.asarray(pts), jnp.asarray(tri), chunk=128)
        t = getattr(tsl, name)(torch.from_numpy(pts), torch.from_numpy(tri), chunk=128)
        _close(t, j, 1e-5, name)
    for inside_positive in (True, False):
        j = jsl.mesh_signed_distance(jnp.asarray(pts), jnp.asarray(tri), inside_positive,
                                     chunk=128)
        t = tsl.mesh_signed_distance(torch.from_numpy(pts), torch.from_numpy(tri),
                                     inside_positive, chunk=128)
        _close(t, j, 1e-5, "signed")
    inside = np.linalg.norm(pts, axis=-1) < 0.5
    assert (t.numpy()[inside] < 0).all()  # inside_positive=False


def _geometries(tmp_path, shape_init, params=0.5, **over):
    cfg = {"radius": 1.0, "isosurface_resolution": 10, "max_crossing_tets": 1500,
           "shape_init": shape_init, "shape_init_params": params,
           "pos_encoding_config": TINY_GRID,
           "mlp_network_config": {"n_neurons": 16, "n_hidden_layers": 1}, **over}
    jg = dreammat_tpu.find("tetrahedra-sdf-grid")(cfg)
    tg = dreammat_tpu_torch.find("tetrahedra-sdf-grid")(cfg, device="cpu")
    return jg, tg


@pytest.mark.parametrize("shape_init,params", [("sphere", 0.5), ("ellipsoid", [0.6, 0.4, 0.5]),
                                               ("mesh", 0.7), (None, 0.5)])
def test_dmtet_geometry_init_matches_jax(tmp_path, shape_init, params):
    if shape_init == "mesh":
        shape_init = "mesh:" + _icosphere_obj(tmp_path)[0]
    jg, tg = _geometries(tmp_path, shape_init, params)
    jp = _np(jg.init(jax.random.PRNGKey(0)))
    tf = tg.init(torch.Generator().manual_seed(0))
    assert sorted(n for n, _ in tf.named_parameters()) == sorted(
        ["sdf", "deformation", "table"] + [f"feature_mlp.{i}.{p}" for i in range(2)
                                           for p in ("weight", "bias")])
    assert tf.sdf.shape == jp["sdf"].shape and (tf.deformation == 0).all()
    if shape_init is None:  # a random draw: only its scale
        assert abs(float(tf.sdf.detach().std()) - 0.1) < 0.01
    else:
        _close(tf.sdf.detach(), jp["sdf"], 1e-5, "sdf0")
    tf.load_state_dict(geometry_params_from_numpy(jp), strict=True)


@pytest.mark.parametrize("fix_geometry", [False, True])
def test_dmtet_geometry_matches_jax(tmp_path, fix_geometry):
    jg, tg = _geometries(tmp_path, "sphere", 0.55, fix_geometry=fix_geometry)
    jp = _np(jg.init(jax.random.PRNGKey(1)))
    rng = np.random.RandomState(7)
    jp["sdf"] = (jp["sdf"] + 0.03 * rng.normal(size=jp["sdf"].shape)).astype(np.float32)
    jp["table"] = rng.normal(0, 0.5, jp["table"].shape).astype(np.float32)
    if not fix_geometry:
        jp["deformation"] = rng.normal(size=jp["deformation"].shape).astype(np.float32)
    tf = tg.init(torch.Generator().manual_seed(0))
    tf.load_state_dict(geometry_params_from_numpy(jp), strict=True)
    assert hasattr(tf, "deformation") != fix_geometry
    jpa = jax.tree_util.tree_map(jnp.asarray, jp)
    jm, tm = jax.jit(jg.isosurface)(jpa), tg.isosurface(tf)
    assert np.array_equal(tm.valid.numpy(), np.asarray(jm.valid))
    assert np.array_equal(tm.edge_gid.numpy(), np.asarray(jm.edge_gid))
    _close(tm.tri_verts.detach(), jm.tri_verts, 1e-6, "tri_verts")
    assert tm.tri_verts.requires_grad != fix_geometry
    pts = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    _close(tg.export(tf, torch.from_numpy(pts))["features"].detach(),
           jg.export(jpa, jnp.asarray(pts))["features"], 1e-5, "features")
    (jv, jf), (tv, tff) = jg.isosurface_mesh(jpa), tg.isosurface_mesh(tf)
    assert len(tff) > 50 and np.array_equal(tv, jv) and np.array_equal(tff, jf)


def test_export_ignores_the_deformation(tmp_path):
    """Finding 6: ``isosurface_mesh`` extracts the SDF's level set on the
    undeformed lattice in both packages, so a trained deformation, which
    moves the training surface, does not reach the exported mesh."""
    jg, tg = _geometries(tmp_path, "sphere", 0.55)
    jp = _np(jg.init(jax.random.PRNGKey(2)))
    tf = tg.init(torch.Generator().manual_seed(0))
    tf.load_state_dict(geometry_params_from_numpy(jp), strict=True)
    v0, f0 = tg.isosurface_mesh(tf)
    m0 = tg.isosurface(tf).tri_verts.detach()
    with torch.no_grad():
        tf.deformation.normal_(generator=torch.Generator().manual_seed(3))
    jp["deformation"] = tf.deformation.detach().numpy().copy()
    v1, f1 = tg.isosurface_mesh(tf)
    m1 = tg.isosurface(tf).tri_verts.detach()
    assert (m1 - m0).abs().max() > 0.01          # the training surface moved
    assert np.array_equal(v1, v0) and np.array_equal(f1, f0)  # the export did not
    jv, jf = jg.isosurface_mesh(jax.tree_util.tree_map(jnp.asarray, jp))
    assert np.array_equal(jv, v1) and np.array_equal(jf, f1)
