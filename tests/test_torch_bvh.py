"""Port parity: dreammat_tpu_torch.ops.bvh against the JAX casters.

The port's plain caster (what it runs on a CPU tensor) is held against the
JAX Pallas dense caster in interpret mode and the Moller-Trumbore brute
force, on the same rays and the same BVH layout. The CUDA kernel is held
against the plain version in the ``cuda``-marked test, which runs on the
card's machine without JAX (``python -m pytest --noconftest -m cuda``); the
JAX package is imported by the tests that compare against it.
"""

import numpy as np
import pytest
import torch

from dreammat_tpu_torch.models.mesh import icosphere_arrays
from dreammat_tpu_torch.ops import bvh as tbvh


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
    tb = tbvh.build_bvh(v, f, use_native=use_native)
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
    got = tbvh.cast_rays_chunked(tbvh.build_bvh(v, f), torch.from_numpy(o), torch.from_numpy(d))
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
    b = tbvh.build_bvh(v, f)
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
    rows_t, tid_t = tbvh._plane_tri_data(tbvh.build_bvh(v, f))
    assert np.allclose(rows_t.numpy(), np.asarray(rows_j), atol=1e-6, rtol=1e-6)
    assert np.array_equal(tid_t.numpy(), np.asarray(tid_j).astype(np.int32))


def test_large_mesh_raises_until_traversal_kernel():
    v, f = _sphere(0)
    b = tbvh.build_bvh(v, f)
    big = b._replace(tri_v0=torch.zeros(tbvh.DENSE_CAST_MAX_TRIS + 1, 3))
    with pytest.raises(NotImplementedError):
        tbvh.cast_rays_chunked(big, torch.zeros(1, 3), torch.ones(1, 3))


def test_pairs_out_counts_every_pair_on_cpu():
    """The plain caster tests every (ray, triangle) pair and says so."""
    v, f = _sphere(1)
    b = tbvh.build_bvh(v, f)
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
    # random rays (every ray block spans the scene: no tile is culled) and
    # camera rays in raster order (thin strips: about half the tiles are)
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
    # FMA contraction may flip a silhouette ray: at most 1e-5 of them, or one
    flips = int((got["hit"] != ref["hit"]).sum())
    assert flips <= max(1, int(1e-5 * o.shape[0]))
    both = got["hit"] & ref["hit"]
    assert (got["t"][both] - ref["t"][both]).abs().max().item() <= 1e-4


def test_tile_boxes_hold_every_live_triangle():
    """The kernel's cull skips a triangle tile only when its box misses the
    rays' box; the tile boxes must therefore hold every live triangle."""
    v, f = _sphere(3)
    b = tbvh.build_bvh(v, f)
    rows, tid = tbvh._plane_tri_data(b)
    tid = tid.clone()
    tid[7] = -1  # a dead triangle takes no part
    boxes, scene = tbvh._tile_boxes(b, tid, 64)
    assert boxes.shape == (-(-tid.shape[0] // 64), 6)
    corners = torch.stack([b.tri_v0, b.tri_v0 + b.tri_e1, b.tri_v0 + b.tri_e2])
    lo, hi = corners.amin(0), corners.amax(0)
    live = tid >= 0
    tile = torch.arange(tid.shape[0]) // 64
    assert bool((lo[live] >= boxes[tile[live], :3]).all())
    assert bool((hi[live] <= boxes[tile[live], 3:]).all())
    assert torch.equal(scene, torch.cat([lo[live].amin(0), hi[live].amax(0)]))
    # a tile's box is the tightest: some live corner touches each face
    t0 = tile == 0
    assert torch.equal(boxes[0, :3], lo[t0 & live].amin(0))
