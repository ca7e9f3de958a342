"""Port parity: dreammat_tpu_torch.ops.bvh against the JAX casters.

The port's plain dense caster (what it runs on a CPU tensor) is held
against the JAX Pallas dense caster in interpret mode and the
Moller-Trumbore brute force, on the same rays and the same BVH layout. The
port's plain BVH walk (``cast_rays_bvh_plain``, what kernel E repeats) is
held against the JAX package's ``cast_rays``, the skip-link walk it takes
above ``DENSE_CAST_MAX_TRIS`` triangles, on the BVHs of both builders; and
``cast_rays_chunked`` in both packages is shown to walk above the
threshold and to take the dense casters at or below it. The CUDA kernels
are held against the plain versions in the ``cuda``-marked tests, which
run on the card's machine without JAX (``python -m pytest --noconftest -m
cuda``); the JAX package is imported by the tests that compare against it.
"""

import numpy as np
import pytest
import torch

from dreammat_tpu_torch.models.mesh import icosphere_arrays
from dreammat_tpu_torch.ops import bvh as tbvh
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401


def _rays(rng, n, radius=3.0):
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * radius
    d = rng.normal(size=(n, 3)) * 0.3 - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _sphere(level):
    v, f = icosphere_arrays(level)
    return np.asarray(v, np.float32), np.asarray(f, np.int64)


def _hit_pos(out, v, f):
    face = np.maximum(np.asarray(out["face"]), 0)
    tri = f[face]
    u = np.asarray(out["u"])[:, None]
    w = np.asarray(out["v"])[:, None]
    return (1 - u - w) * v[tri[:, 0]] + u * v[tri[:, 1]] + w * v[tri[:, 2]]


@pytest.fixture
def jax_ref():
    jnp = pytest.importorskip("jax.numpy")
    from dreammat_tpu.ops import bvh as jbvh

    return jnp, jbvh


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ray-cast kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("use_native", [True, False])
def test_same_bvh_layout_as_jax(use_native, jax_ref):
    _, jbvh = jax_ref
    v, f = _sphere(2)
    jb = jbvh.build_bvh(v, f, use_native=use_native)
    tb = tbvh.build_bvh(v, f, device="cpu", use_native=use_native)
    for name in ("node_min", "node_max", "node_miss", "node_first", "node_count",
                 "tri_v0", "tri_e1", "tri_e2", "tri_id"):
        assert np.array_equal(np.asarray(getattr(jb, name)), getattr(tb, name).numpy()), name


def test_plain_caster_matches_pallas_and_bruteforce(jax_ref):
    jnp, jbvh = jax_ref
    v, f = _sphere(2)
    o, d = _rays(np.random.RandomState(4), 600)
    jb = jbvh.build_bvh(v, f)
    pallas = jbvh.cast_rays_dense_pallas(jb, jnp.asarray(o), jnp.asarray(d),
                                         block_r=128, block_t=128, interpret=True)
    brute = jbvh.cast_rays_bruteforce(jnp.asarray(v), jnp.asarray(f), jnp.asarray(o),
                                      jnp.asarray(d))
    got = tbvh.cast_rays_chunked(tbvh.build_bvh(v, f, device="cpu"), torch.from_numpy(o), torch.from_numpy(d))
    gh = got["hit"].numpy()
    for ref in (pallas, brute):
        hit = np.asarray(ref["hit"])
        assert np.array_equal(gh, hit)
        assert np.allclose(got["t"].numpy()[hit], np.asarray(ref["t"])[hit], atol=1e-4)
        assert np.allclose(_hit_pos(got, v, f)[hit], _hit_pos(ref, v, f)[hit], atol=2e-3)
    # same triangle order -> the same face wins, ties included
    assert np.array_equal(got["face"].numpy(), np.asarray(pallas["face"]))
    assert gh.mean() > 0.9


def test_t_max_and_miss(jax_ref):
    jnp, jbvh = jax_ref
    v, f = _sphere(1)
    b = tbvh.build_bvh(v, f, device="cpu")
    o = torch.tensor([[0.0, 0.0, 3.0], [0.0, 0.0, 3.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])
    out = tbvh.cast_rays_chunked(b, o, d)
    assert bool(out["hit"][0]) and not bool(out["hit"][1])
    assert float(out["t"][1]) == tbvh.MISS_DEPTH and int(out["face"][1]) == -1
    assert float(out["u"][1]) == 0.0 and float(out["v"][1]) == 0.0
    jb = jbvh.build_bvh(v, f)
    ref = jbvh.cast_rays_plane(jb, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    assert abs(float(out["t"][0]) - float(ref["t"][0])) < 1e-5
    out2 = tbvh.cast_rays_chunked(b, o, d, t_max=1.0)
    assert not bool(out2["hit"][0]) and float(out2["t"][0]) == tbvh.MISS_DEPTH


def test_plane_tri_data_matches_jax(jax_ref):
    _, jbvh = jax_ref
    v, f = _sphere(2)
    rows_j, tid_j = jbvh._plane_tri_data(jbvh.build_bvh(v, f))
    rows_t, tid_t = tbvh._plane_tri_data(tbvh.build_bvh(v, f, device="cpu"))
    assert np.allclose(rows_t.numpy(), np.asarray(rows_j), atol=1e-6, rtol=1e-6)
    assert np.array_equal(tid_t.numpy(), np.asarray(tid_j).astype(np.int32))


def _walk_rays(v, f, n=8192, seed=0):
    """Rays from outside towards the torus (half) and bake rays from just
    above its vertices along a 16 x 16 grid of directions (half)."""
    from dreammat_tpu_torch.models.mesh import compute_vertex_normals
    from dreammat_tpu_torch.ops import visibility as tvis

    o, d = _rays(np.random.RandomState(seed), n // 2)
    vp = torch.from_numpy(v)
    vn = torch.from_numpy(compute_vertex_normals(v, f))
    bo, bd, _ = tvis.bake_rays(vp, vn, tvis._grid_dirs(16, "cpu"), 1e-3)
    pick = np.random.RandomState(seed + 1).choice(bo.shape[0], n // 2, replace=False)
    return (np.concatenate([o, bo.numpy()[pick]]).astype(np.float32),
            np.concatenate([d, bd.numpy()[pick]]).astype(np.float32))


@pytest.mark.parametrize("use_native", [True, False])
def test_walk_matches_jax_cast_rays(use_native, jax_ref):
    """The plain walk against the JAX package's jitted ``cast_rays`` on the
    same BVH, 4096 rays from outside and 4096 bake rays from the surface, at
    t_max 10 and 0.3. XLA contracts a * b + c into FMAs on the CPU, the walk
    rounds each product (as kernel E does), so a bake ray whose hit grazes
    an edge may find another face: at most 1e-3 of all rays (6 of 8192 at
    t_max 10, all of them bake rays; the JAX package's own walk and dense
    caster split on 26 of these rays), none of the rays from outside.
    Where the faces agree t is within 1e-5 and so is the hit point v0 + u
    e1 + v e2. u and v are within 1e-5 where their condition number
    |o - v0| max(|e1|, |e2|) / |det| is at most 100, and within 1e-5 times
    that number over 100 where it is larger: u = (o - v0) . (d x e2) / det
    carries the fp32 rounding of its numerator, about 2^-24 |o - v0| |e2|,
    over |det|, and the two sides round it differently (up to 5.3 x 2^-24
    times the number here). On the native builder's BVH the larger numbers
    are those of 628 of 4961 agreeing hits at t_max 10 (far hits that graze,
    up to 2261; u and v then differ by up to 5.4e-5) and 16 of 1882 at
    t_max 0.3; the largest difference is 0.72 of its bound."""
    from dreammat_tpu_torch.models.mesh import torus_arrays

    jnp, jbvh = jax_ref
    v, f = torus_arrays(0.7, 0.28, 48, 24)
    v = np.asarray(v, np.float32)
    jb = jbvh.build_bvh(v, f, use_native=use_native)
    tb = tbvh.build_bvh(v, f, device="cpu", use_native=use_native)
    o, d = _walk_rays(v, f)
    for t_max in (tbvh.MISS_DEPTH, 0.3):
        ref = {k: np.asarray(x) for k, x in jbvh.cast_rays(jb, jnp.asarray(o), jnp.asarray(d),
                                                            t_max=t_max).items()}
        got = {k: x.numpy() for k, x in tbvh.cast_rays_bvh(tb, torch.from_numpy(o),
                                                            torch.from_numpy(d),
                                                            t_max=t_max).items()}
        differ = (got["face"] != ref["face"]) | (got["hit"] != ref["hit"])
        print(f"t_max {t_max}: {int(differ.sum())} of {len(o)} rays differ in face or hit")
        assert differ.mean() <= 1e-3, int(differ.sum())
        assert not differ[:len(o) // 2].any()  # the rays from outside
        same = ~differ & got["hit"]
        assert same.sum() > 0.2 * len(o)
        assert np.abs(got["t"][same] - ref["t"][same]).max() <= 1e-5
        tri = f[got["face"][same]]
        v0, e1, e2 = (v[tri[:, 0]].astype(np.float64), v[tri[:, 1]] - v[tri[:, 0]],
                      v[tri[:, 2]] - v[tri[:, 0]])
        det = np.abs(np.einsum("ij,ij->i", e1, np.cross(d[same].astype(np.float64), e2)))
        cond = np.linalg.norm(o[same] - v0, axis=-1) * np.maximum(
            np.linalg.norm(e1, axis=-1), np.linalg.norm(e2, axis=-1)) / det
        print(f"t_max {t_max}: u, v conditioned above 100 on {int((cond > 100).sum())} of "
              f"{int(same.sum())} agreeing hits")
        assert (cond > 100).mean() < 0.15
        for k in ("u", "v"):
            err = np.abs(got[k][same] - ref[k][same])
            assert (err <= 1e-5 * np.maximum(1.0, cond / 100)).all(), (k, err.max())
        assert np.abs(_hit_pos(got, v, f)[same] - _hit_pos(ref, v, f)[same]).max() <= 1e-5
        miss = ~got["hit"]
        assert (got["t"][miss] == tbvh.MISS_DEPTH).all() and (got["face"][miss] == -1).all()
        assert (got["u"][miss] == 0).all() and (got["v"][miss] == 0).all()
        if t_max < 1:
            assert (got["t"][got["hit"]] < t_max).all()


def test_walk_counters_and_wrapper_checks():
    """The plain walk's counters: one node a step of each ray, one pair a
    tested leaf triangle; the walk and the dense caster agree on a convex
    mesh; ``occlusion_rays`` is the walk's hit mask."""
    v, f = _sphere(2)
    b = tbvh.build_bvh(v, f, device="cpu")
    o, d = (torch.from_numpy(x) for x in _rays(np.random.RandomState(2), 300))
    ctr = torch.zeros(2, dtype=torch.int64)
    out = tbvh.cast_rays_bvh(b, o, d, counters_out=ctr)
    n_nodes, n_tris = b.node_min.shape[0], b.tri_v0.shape[0]
    assert 300 <= int(ctr[0]) < 300 * n_nodes and 0 < int(ctr[1]) < 300 * n_tris
    dense = tbvh.cast_rays_dense(b, o, d)
    assert torch.equal(out["face"], dense["face"]) and torch.equal(out["hit"], dense["hit"])
    assert torch.equal(tbvh.occlusion_rays(b, o, d, t_max=2.5),
                       tbvh.cast_rays_bvh(b, o, d, t_max=2.5)["hit"])
    with pytest.raises(ValueError):
        tbvh.cast_rays_bvh(b, o, d, counters_out=torch.zeros(1, dtype=torch.int64))
    packed = tbvh.pack_bvh(b)
    # a record a node with children, after the virtual record of the root
    # (the records' fields: tests/test_torch_bvh_walk.py)
    n_inner = int((b.node_count == 0).sum())
    assert packed.nodes.shape == (n_inner + 1, 16) and packed.tris.shape == (n_tris, 12)
    word = packed.nodes[:, 3].contiguous().view(torch.int32)
    assert int(word[0]) == 8 and int(word[1]) == 16  # the root, record 1; its first child's
    leaf = b.node_count > 0
    assert torch.equal(packed.tris[:, 3].view(torch.int32), b.tri_id)
    assert int(leaf.sum()) == n_nodes - n_inner


@pytest.mark.parametrize("walk", [True, False], ids=["above", "at-or-below"])
def test_dispatcher_walks_above_the_threshold(walk, jax_ref, monkeypatch):
    """``cast_rays_chunked`` in both packages with ``DENSE_CAST_MAX_TRIS``
    set below the mesh (the walk) or at its size (the dense casters); the
    port's ``cast_data`` follows, and the answers agree as above."""
    import jax

    jnp, jbvh = jax_ref
    v, f = _sphere(2)
    jb = jbvh.build_bvh(v, f)
    tb = tbvh.build_bvh(v, f, device="cpu")
    limit = 64 if walk else tb.tri_v0.shape[0]
    monkeypatch.setattr(jbvh, "DENSE_CAST_MAX_TRIS", limit)
    monkeypatch.setattr(tbvh, "DENSE_CAST_MAX_TRIS", limit)
    jax.clear_caches()
    ran = []
    for mod, names in ((jbvh, ("cast_rays", "cast_rays_plane")),
                       (tbvh, ("cast_rays_bvh_plain", "cast_rays_plain"))):
        for name in names:
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k: (
                ran.append(_n), _fn(*a, **k))[1])
    o, d = _rays(np.random.RandomState(5), 500)
    ref = jbvh.cast_rays_chunked(jb, jnp.asarray(o), jnp.asarray(d), chunk=256)
    data = tbvh.cast_data(tb)
    assert isinstance(data, tbvh.PackedBVH) == walk
    got = tbvh.cast_rays_chunked(tb, torch.from_numpy(o), torch.from_numpy(d), tri_data=data)
    want = ["cast_rays", "cast_rays_bvh_plain"] if walk else ["cast_rays_plane", "cast_rays_plain"]
    assert sorted(set(ran)) == sorted(want), ran
    differ = got["face"].numpy() != np.asarray(ref["face"])
    assert differ.mean() <= 1e-3, int(differ.sum())


def test_pairs_out_counts_every_pair_on_cpu():
    """The plain caster tests every (ray, triangle) pair and says so."""
    v, f = _sphere(1)
    b = tbvh.build_bvh(v, f, device="cpu")
    o, d = (torch.from_numpy(x) for x in _rays(np.random.RandomState(1), 50))
    pairs = torch.full((1,), 7, dtype=torch.int64)
    out = tbvh.cast_rays_dense(b, o, d, pairs_out=pairs)
    assert int(pairs) == 7 + 50 * b.tri_v0.shape[0]
    assert torch.equal(out["face"], tbvh.cast_rays_dense(b, o, d)["face"])
    with pytest.raises(ValueError):
        tbvh.cast_rays_dense(b, o, d, pairs_out=torch.zeros(1, dtype=torch.int32))


def _camera_rays(h, w, dist=3.0, half=1.2):
    """Pinhole rays from (0, 0, dist) through an h x w grid on the z = 0
    plane, in raster order: each block of consecutive rays is a thin strip."""
    ys, xs = np.meshgrid(np.linspace(-half, half, h), np.linspace(-half, half, w), indexing="ij")
    target = np.stack([xs, ys, np.zeros_like(xs)], -1).reshape(-1, 3)
    o = np.broadcast_to(np.array([0.0, 0.0, dist]), target.shape)
    d = target - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda(cuda):
    v, f = _sphere(4)
    b = tbvh.build_bvh(v, f, device=cuda)
    # random rays (spread over the scene) and camera rays in raster order
    rand, cam = _rays(np.random.RandomState(0), 20000), _camera_rays(125, 160)
    o, d = (torch.from_numpy(np.concatenate([x, y])).to(cuda) for x, y in zip(rand, cam))
    before = tbvh.cast_rays_dense.launches
    pairs = torch.zeros(1, dtype=torch.int64, device=cuda)
    got = tbvh.cast_rays_dense(b, o, d, pairs_out=pairs)
    ref = tbvh.cast_rays_plain(b, o, d)
    torch.cuda.synchronize()
    assert tbvh.cast_rays_dense.launches == before + 1
    # the cull keeps some tiles and drops others on rays aimed at a sphere
    assert 0 < int(pairs) < o.shape[0] * b.tri_v0.shape[0]
    # rounded like the plain version and visited in leaf order: bit for bit
    for key in ("hit", "t", "face", "u", "v"):
        assert torch.equal(got[key], ref[key]), key


def test_tile_boxes_hold_every_live_triangle():
    """The kernel's cull skips a triangle tile only when its box misses
    every ray's segment; the tile boxes must therefore hold every live
    triangle."""
    v, f = _sphere(3)
    b = tbvh.build_bvh(v, f, device="cpu")
    rows, tid = tbvh._plane_tri_data(b)
    tid = tid.clone()
    tid[7] = -1  # a dead triangle takes no part
    boxes = tbvh._tile_boxes(b, tid, 64)
    assert boxes.shape == (-(-tid.shape[0] // 64), 8)
    assert not bool(boxes[:, 3].any()) and not bool(boxes[:, 7].any())  # two float4 per box
    corners = torch.stack([b.tri_v0, b.tri_v0 + b.tri_e1, b.tri_v0 + b.tri_e2])
    lo, hi = corners.amin(0), corners.amax(0)
    live = tid >= 0
    tile = torch.arange(tid.shape[0]) // 64
    assert bool((lo[live] >= boxes[tile[live], :3]).all())
    assert bool((hi[live] <= boxes[tile[live], 4:7]).all())
    # a tile's box is the tightest: some live corner touches each face
    t0 = tile == 0
    assert torch.equal(boxes[0, :3], lo[t0 & live].amin(0))
    assert torch.equal(boxes[0, 4:7], hi[t0 & live].amax(0))
