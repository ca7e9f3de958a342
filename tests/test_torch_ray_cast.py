"""Kernels B (the dense first-hit caster) and E (the BVH walk), and the
bake's ray order.

On the CPU: the pre-division reject of ``csrc/ray_cast.cu`` (in its plain
form, ``cast_reject_plain``) never drops a pair that the plain test
accepts; the padded boxes of the kernel's cull always meet the segment of
a ray up to its plain hit; and the visibility bake's direction-major Morton
order gives the same table as the vertex-major order. The cull and the
reject are also checked on the traffic of the Monte-Carlo estimators and
the export: shadow rays leaving a self-occluding torus 1e-5 off its
surface, and the texel rays of the UV plane (every triangle at z = 0,
every ray along -z, so the slab test divides by 1e-12 on x and y and every
hit has t = 1). On the card (``cuda``-marked; ``python -m pytest
--noconftest -m cuda``): the kernel returns bit for bit what
``cast_rays_plain`` returns, on ties, shared edges, degenerate triangles,
rays that miss, t_max clipping, ragged R and T, shadow rays, the UV
plane (texel centres on shared edges included), and the rays of a sampled
camera of the random-camera mode (camera, centre and up perturbs on) on
a subdivided torus. Kernel E returns bit for bit what
``cast_rays_bvh_plain`` returns, with the same nodes visited and pairs
tested, on ties, shared edges, degenerate triangles, misses, t_max
clipping, ragged R, a bake batch, shadow rays and the UV plane.
"""

import numpy as np
import pytest
import torch

from dreammat_tpu_torch.models.mesh import Mesh, icosphere_arrays, subdivide_mesh, torus_arrays
from dreammat_tpu_torch.ops import bvh as tbvh
from dreammat_tpu_torch.ops import visibility as tvis
from torch_threads import one_thread  # noqa: F401

CULL_PAD = 1e-4  # ray_cast.cu


def _sphere(level):
    v, f = icosphere_arrays(level)
    return np.asarray(v, np.float32), np.asarray(f, np.int64)


def _rays(rng, n, radius=3.0, spread=0.3):
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * radius
    d = rng.normal(size=(n, 3)) * spread - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d.astype(np.float32))


def _shadow_rays(v, f, n_pts=96, seed=0):
    """Rays from points on random triangles, along directions of the upper
    hemisphere of their face normal, origins 1e-5 along the direction (the
    MC estimator's shadow rays)."""
    rng = np.random.default_rng(seed)
    face = rng.integers(0, f.shape[0], n_pts)
    bary = rng.dirichlet([2.0, 2.0, 2.0], n_pts)
    tri = v[f[face]].astype(np.float64)
    p = (bary[:, :, None] * tri).sum(1)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = rng.normal(size=(n_pts, 64, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = np.where((d * n[:, None]).sum(-1, keepdims=True) < 0, -d, d).reshape(-1, 3)
    o = np.repeat(p, 64, axis=0) + d * 1e-5
    return torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d.astype(np.float32))


def _uv_plane(res=64):
    """(UV vertices at z = 0, faces, texel origins, directions): the
    torus's smart-unwrap charts beside a grid of diagonal-split quads
    whose edges pass through texel centres."""
    from dreammat_tpu_torch.models.exporter import smart_unwrap, uv_texel_rays

    v, f = torus_arrays()
    vt, ft = smart_unwrap(v, f)
    k = 8  # a k x k grid of quads over [0, 0.5]^2, each split on its diagonal
    g = np.stack(np.meshgrid(np.arange(k + 1), np.arange(k + 1), indexing="xy"), -1)
    gv = (g.reshape(-1, 2) * (0.5 / k)).astype(np.float32)
    q = np.arange(k * k)
    a = (q // k) * (k + 1) + q % k
    grid_f = np.concatenate([np.stack([a, a + 1, a + k + 2], 1), np.stack([a, a + k + 2, a + k + 1], 1)])
    verts = np.concatenate([vt * 0.5 + 0.5, gv])  # charts in [0.5, 1]^2
    faces = np.concatenate([ft, grid_f + len(vt)])
    bvh, o, d = uv_texel_rays(verts, faces, res, device="cpu")
    return bvh, o, d


def _plain_accepts(A, B, tb):
    """The plain caster's test on t alone: |B| > 1e-12, t > 1e-6, t < tb."""
    safe = B.abs() > 1e-12
    t = -A / torch.where(safe, B, torch.ones_like(B))
    return safe & (t > 1e-6) & (t < tb)


def _assert_reject_is_safe(A, B, tb):
    rejected = tbvh.cast_reject_plain(A, B, tb)
    bad = rejected & _plain_accepts(A, B, tb)
    assert not bool(bad.any()), (A[bad][:5], B[bad][:5], tb.expand_as(A)[bad][:5])
    return rejected


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pre_division_reject_keeps_every_accepted_pair_random(seed):
    rng = np.random.default_rng(seed)
    n = 200_000
    mag = lambda lo, hi: 10.0 ** rng.uniform(lo, hi, n)
    sign = lambda: rng.choice([-1.0, 1.0], n)
    A = torch.tensor(sign() * mag(-14, 2), dtype=torch.float32)
    B = torch.tensor(sign() * mag(-14, 1), dtype=torch.float32)
    tb = torch.tensor(np.where(rng.random(n) < 0.3, 10.0, mag(-6, 1)), dtype=torch.float32)
    rejected = _assert_reject_is_safe(A, B, tb)
    # the rule is not vacuous: about half the pairs fail on sign, more on tb
    assert 0.5 < float(rejected.float().mean()) < 1.0
    assert bool((~rejected & _plain_accepts(A, B, tb)).any())


def _ulps(x, k):
    """x stepped k floats up (k > 0) or down (k < 0)."""
    x = x.clone()
    target = torch.full_like(x, float("inf") if k > 0 else float("-inf"))
    for _ in range(abs(k)):
        x = torch.nextafter(x, target)
    return x


@pytest.mark.parametrize("tb_value", [10.0, 1.0, 0.37, float(np.nextafter(np.float32(1e-6), np.float32(1))),
                                      1e-6])
def test_pre_division_reject_adversarial(tb_value):
    rng = np.random.default_rng(7)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    B = f32(np.concatenate([
        rng.choice([-1.0, 1.0], 400) * 10.0 ** rng.uniform(-11.9, 1, 400),
        [1e-12, -1e-12], [float(np.nextafter(np.float32(1e-12), np.float32(1)))] * 2,
        [-float(np.nextafter(np.float32(1e-12), np.float32(1)))],
        [1e-30, 1.4e-45, 0.0, -0.0, float("nan"), float("inf"), float("-inf")]]))
    tb = f32([tb_value])
    cut = tb * tbvh.CUT_SLACK
    # A within a few ulps of the threshold RN(cut |B|) and of tb |B|, with
    # the sign that makes t positive, and with the other sign
    cols = []
    for centre in (cut * B.abs(), tb * B.abs()):
        for k in range(-4, 5):
            cols.append(-torch.sign(B) * _ulps(centre, k) if k else -torch.sign(B) * centre)
    A = torch.stack(cols)
    A = torch.cat([A, -A, torch.zeros_like(A[:1]), -torch.zeros_like(A[:1]),
                   torch.full_like(A[:1], 1.4e-45), torch.full_like(A[:1], -1.4e-45),
                   torch.full_like(A[:1], 1e-40), torch.full_like(A[:1], -1e-40),
                   torch.full_like(A[:1], float("nan"))])
    _assert_reject_is_safe(A, B.expand_as(A), tb)


@pytest.mark.parametrize("kind", ["sphere", "shadow", "uv_plane"])
def test_pre_division_reject_on_the_caster_pairs(kind):
    # every (ray, triangle) pair of a cast, with the ray's final best t as tb
    if kind == "uv_plane":
        b, o, d = _uv_plane(32)
    else:
        v, f = _sphere(2) if kind == "sphere" else torus_arrays()
        b = tbvh.build_bvh(v, f, device="cpu")
        o, d = _rays(np.random.default_rng(3), 500) if kind == "sphere" else _shadow_rays(v, f, 8)
    rows, tid = tbvh._plane_tri_data(b)
    out = tbvh.cast_rays_plain(b, o, d, t_max=10.0)
    dot = lambda x: x[:, 0:1] * rows[0] + x[:, 1:2] * rows[1] + x[:, 2:3] * rows[2]
    A, B = dot(o) + rows[3], dot(d)
    fractions = []
    for tb in (torch.tensor(10.0), torch.where(out["hit"], out["t"], torch.tensor(10.0))[:, None]):
        fractions.append(float(_assert_reject_is_safe(A, B, tb).float().mean()))
    if kind == "uv_plane":
        # every plane is 1 ahead of every ray (t = 1 exactly): no pair can
        # be rejected before the division; the strict t < best decides ties
        assert fractions == [0.0, 0.0]
    else:
        # the sign rule alone rejects some; the running best rejects more
        assert 0.1 < fractions[0] < fractions[1]


def _slab_meets(o, d, tb, lo, hi):
    """The kernel's slab test (``meets`` in ray_cast.cu) in plain fp32: the
    segment (0, tb) of each ray against the padded box [lo, hi]."""
    inv = 1.0 / torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
    s0 = (lo - CULL_PAD) * inv - o * inv
    s1 = (hi + CULL_PAD) * inv - o * inv
    t0 = torch.clamp(torch.minimum(s0, s1).amax(-1), min=0.0)
    t1 = torch.minimum(torch.maximum(s0, s1).amin(-1), tb)
    return t0 <= t1


@pytest.mark.parametrize("kind", ["random", "grazing", "bake", "shadow", "uv_plane"])
def test_cull_boxes_meet_every_plain_hit(kind):
    """The cull may skip a box only if no ray can hit inside it: the tile
    and sub-tile boxes of each ray's plain hit meet its segment (0, t], t
    the hit's t (the kernel's running best is never below it there)."""
    v, f = torus_arrays() if kind == "shadow" else _sphere(3)
    b = tbvh.build_bvh(v, f, device="cpu")
    rng = np.random.default_rng(11)
    if kind == "shadow":
        o, d = _shadow_rays(v, f, 48)
    elif kind == "uv_plane":
        b, o, d = _uv_plane(64)
    elif kind == "random":
        o, d = _rays(rng, 3000)
    elif kind == "grazing":  # rays tangent to the sphere: silhouette hits
        o, d = _rays(rng, 3000, spread=0.0)
        side = torch.nn.functional.normalize(torch.linalg.cross(o, torch.randn(3000, 3)), dim=-1)
        o = o + side * 0.995
    else:
        vp, vn = torch.from_numpy(v[:64]), torch.from_numpy(v[:64])
        o, d, _ = tvis.bake_rays(vp, vn / vn.norm(dim=-1, keepdim=True), tvis._grid_dirs(8, "cpu"), 1e-3)
    rows, tid = tbvh._plane_tri_data(b)
    out = tbvh.cast_rays_plain(b, o, d, tri_data=(rows, tid))
    hit = out["hit"]
    assert bool(hit.any())
    slot = {int(x): i for i, x in enumerate(tid.tolist()) if x >= 0}
    idx = torch.tensor([slot[int(x)] for x in out["face"][hit]])
    for size in (256, 64):
        boxes = tbvh._tile_boxes(b, tid, size)[idx // size]
        ok = _slab_meets(o[hit], d[hit], out["t"][hit], boxes[:, :3],
                         boxes[:, 4:7])
        assert bool(ok.all()), int((~ok).sum())


def test_bake_order_gives_the_vertex_major_table():
    v, f = _sphere(2)
    b = tbvh.build_bvh(v, f, device="cpu")
    vp = torch.from_numpy(v)
    vn = vp / vp.norm(dim=-1, keepdim=True)
    oct_res, eps = 4, 1e-3
    got = tvis.bake_vertex_visibility(b, vp, vn, oct_res=oct_res, eps=eps, chunk=256)
    # the vertex-major order: for each vertex, every direction
    dirs = tvis._grid_dirs(oct_res, "cpu")
    o = ((vp + vn * eps)[:, None, :] + dirs[None, :, :] * eps).reshape(-1, 3)
    d = dirs[None].expand(vp.shape[0], -1, 3).reshape(-1, 3)
    hit = tbvh.cast_rays_plain(b, o, d)["hit"].reshape(vp.shape[0], -1)
    want = (~hit).float().half()
    assert torch.equal(got.table, want)
    assert 0.2 < float(want.float().mean()) < 0.8  # both occluded and open bins
    # the same rays, bit for bit, in another order
    o2, d2, order = tvis.bake_rays(vp, vn, dirs, eps)
    n2 = dirs.shape[0]
    assert torch.equal(o2.reshape(n2, -1, 3).transpose(0, 1), o.reshape(-1, n2, 3)[order])
    assert torch.equal(d2.reshape(n2, -1, 3).transpose(0, 1), d.reshape(-1, n2, 3)[order])


def test_morton_order_is_a_local_permutation():
    pts = torch.from_numpy(np.random.default_rng(5).random((4096, 3)).astype(np.float32))
    order = tvis.morton_order(pts)
    assert torch.equal(torch.sort(order).values, torch.arange(4096))
    step = lambda p: (p[1:] - p[:-1]).norm(dim=-1).mean()
    assert step(pts[order]) < 0.25 * step(pts)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ray-cast kernel has no CPU mode")
    return torch.device("cuda")


def _assert_exact(bvh, o, d, t_max=tbvh.MISS_DEPTH):
    o, d = o.contiguous(), d.contiguous()
    got = tbvh.cast_rays_dense(bvh, o, d, t_max=t_max)
    ref = tbvh.cast_rays_plain(bvh, o, d, t_max=t_max)
    torch.cuda.synchronize()
    for key in ("hit", "t", "face", "u", "v"):
        same = got[key] == ref[key]
        assert bool(same.all()), (key, int((~same).sum()), o.shape[0])
    return got


def _mesh_bvh(v, f, device):
    return tbvh.build_bvh(v, f, device=device)


@pytest.mark.cuda
def test_kernel_exact_on_duplicate_triangles(cuda):
    v, f = _sphere(3)
    b = _mesh_bvh(v, np.concatenate([f, f[::-1]]), cuda)  # every face twice: exact ties
    o, d = _rays(np.random.default_rng(0), 20000)
    got = _assert_exact(b, o.to(cuda), d.to(cuda))
    assert float(got["hit"].float().mean()) > 0.5


@pytest.mark.cuda
def test_kernel_exact_through_shared_edges_and_vertices(cuda):
    v, f = _sphere(3)
    b = _mesh_bvh(v, f, cuda)
    edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    targets = np.concatenate([(v[edges[:, 0]] + v[edges[:, 1]]) / 2, v]).astype(np.float32)
    eye = np.float32([0.3, -0.2, 3.0])
    d = targets - eye
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(eye, d.shape)
    _assert_exact(b, torch.from_numpy(np.ascontiguousarray(o)).to(cuda),
                  torch.from_numpy(d.astype(np.float32)).to(cuda))


@pytest.mark.cuda
def test_kernel_exact_with_degenerate_triangles(cuda):
    v, f = _sphere(3)
    degen = np.stack([f[:200, 0], f[:200, 0], f[:200, 1]], 1)  # zero area: id -1
    b = _mesh_bvh(v, np.concatenate([f, degen]), cuda)
    assert int((tbvh._plane_tri_data(b)[1] < 0).sum()) >= 200
    o, d = _rays(np.random.default_rng(1), 10000)
    _assert_exact(b, o.to(cuda), d.to(cuda))


@pytest.mark.cuda
def test_kernel_exact_on_misses_and_t_max(cuda):
    v, f = _sphere(3)
    b = _mesh_bvh(v, f, cuda)
    rng = np.random.default_rng(2)
    o, d = _rays(rng, 8000)
    away_o, away_d = _rays(rng, 2000, radius=50.0)
    o = torch.cat([o, away_o, away_o]).to(cuda)
    d = torch.cat([d, away_d, -away_d]).to(cuda)  # far rays: towards the scene and away
    got = _assert_exact(b, o, d)
    assert not bool(got["hit"][8000 + 2000:].any())
    clipped = _assert_exact(b, o, d, t_max=2.5)  # clips the far side and some front hits
    assert int(clipped["hit"].sum()) < int(got["hit"].sum())


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 63, 65, 257, 12345])
def test_kernel_exact_on_ragged_sizes(cuda, R):
    v, f = _sphere(3)
    b = _mesh_bvh(v, f[:1243], cuda)  # T neither a multiple of 64 nor of 256
    o, d = _rays(np.random.default_rng(R), R)
    pairs = torch.zeros(1, dtype=torch.int64, device=cuda)
    tbvh.cast_rays_dense(b, o.to(cuda), d.to(cuda), pairs_out=pairs)
    _assert_exact(b, o.to(cuda), d.to(cuda))
    assert 0 < int(pairs) <= R * b.tri_v0.shape[0]


@pytest.mark.cuda
def test_kernel_exact_on_a_bake_batch(cuda):
    v, f = _sphere(4)
    b = _mesh_bvh(v, f, cuda)
    vp = torch.from_numpy(v).to(cuda)
    o, d, _ = tvis.bake_rays(vp[:512], vp[:512] / vp[:512].norm(dim=-1, keepdim=True),
                             tvis._grid_dirs(16, cuda), 1e-3)
    got = _assert_exact(b, o, d)
    assert 0.2 < float(got["hit"].float().mean()) < 0.8


@pytest.mark.cuda
def test_kernel_exact_on_shadow_rays(cuda):
    v, f = torus_arrays(nu=96, nv=48)
    b = _mesh_bvh(v, f, cuda)
    o, d = _shadow_rays(v, f, 2048, seed=4)
    got = _assert_exact(b, o.to(cuda), d.to(cuda))
    assert 0.05 < float(got["hit"].float().mean()) < 0.95  # the torus shadows itself


@pytest.mark.cuda
@pytest.mark.parametrize("res", [64, 256])
def test_kernel_exact_on_the_uv_plane(cuda, res):
    b, o, d = _uv_plane(res)
    b = tbvh.FlatBVH(*(x.to(cuda) for x in b))
    got = _assert_exact(b, o.to(cuda), d.to(cuda))
    assert bool((got["t"][got["hit"]] == 1.0).all())
    assert 0.3 < float(got["hit"].float().mean()) < 0.9


@pytest.mark.cuda
def test_kernel_exact_on_a_sampled_camera(cuda):
    from dreammat_tpu_torch.utils import ops as uops

    v, f = torus_arrays(nu=48, nv=24)
    m = subdivide_mesh(Mesh.from_numpy(v, f, device=cuda), 1)
    b = tbvh.build_bvh(m.v_pos.cpu().numpy(), m.t_pos_idx.cpu().numpy(), device=cuda)
    rng = np.random.RandomState(3)
    pos = uops.camera_position_from_spherical(20.0, 37.0, 2.4).numpy()
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=cuda)[None]
    c2w = uops.get_c2w(t(pos + (rng.rand(3) * 2 - 1) * 0.1), t(rng.randn(3) * 0.05),
                       t(np.float32([0, 0, 1]) + rng.randn(3) * 0.02))[0]
    dirs = uops.get_ray_directions(512, 512, 0.5 * 512 / np.tan(np.deg2rad(15.0)), device=cuda)
    o, d = uops.get_rays(dirs, c2w)
    got = _assert_exact(b, o, d)
    assert 0.05 < float(got["hit"].float().mean()) < 0.95


# ---------------------------------------------------------------------------
# kernel E (the BVH walk) on the card
# ---------------------------------------------------------------------------

def _assert_walk_exact(bvh, o, d, t_max=tbvh.MISS_DEPTH):
    """Kernel E against the plain walk on the card: bit for bit, and the
    nodes and pairs its counter returns equal to the plain walk's."""
    o, d = o.contiguous(), d.contiguous()
    before = tbvh.cast_rays_bvh.launches
    ctr = torch.zeros(2, dtype=torch.int64, device=o.device)
    got = tbvh.cast_rays_bvh(bvh, o, d, t_max=t_max, counters_out=ctr)
    ref_ctr = torch.zeros(2, dtype=torch.int64, device=o.device)
    ref = tbvh.cast_rays_bvh_plain(bvh, o, d, t_max=t_max, counters_out=ref_ctr)
    torch.cuda.synchronize()
    assert tbvh.cast_rays_bvh.launches == before + 1
    for key in ("hit", "t", "face", "u", "v"):
        same = got[key] == ref[key]
        assert bool(same.all()), (key, int((~same).sum()), o.shape[0])
    assert torch.equal(ctr, ref_ctr), (ctr.tolist(), ref_ctr.tolist())
    return got


@pytest.mark.cuda
def test_walk_exact_on_duplicate_triangles(cuda):
    v, f = _sphere(3)
    b = _mesh_bvh(v, np.concatenate([f, f[::-1]]), cuda)  # every face twice: exact ties
    o, d = _rays(np.random.default_rng(0), 20000)
    got = _assert_walk_exact(b, o.to(cuda), d.to(cuda))
    assert float(got["hit"].float().mean()) > 0.5


@pytest.mark.cuda
def test_walk_exact_through_shared_edges_and_vertices(cuda):
    v, f = _sphere(3)
    b = _mesh_bvh(v, f, cuda)
    edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    targets = np.concatenate([(v[edges[:, 0]] + v[edges[:, 1]]) / 2, v]).astype(np.float32)
    eye = np.float32([0.3, -0.2, 3.0])
    d = targets - eye
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(eye, d.shape)
    _assert_walk_exact(b, torch.from_numpy(np.ascontiguousarray(o)).to(cuda),
                       torch.from_numpy(d.astype(np.float32)).to(cuda))


@pytest.mark.cuda
def test_walk_exact_with_degenerate_triangles(cuda):
    v, f = _sphere(3)
    degen = np.stack([f[:200, 0], f[:200, 0], f[:200, 1]], 1)  # zero area: det 0
    b = _mesh_bvh(v, np.concatenate([f, degen]), cuda)
    o, d = _rays(np.random.default_rng(1), 10000)
    _assert_walk_exact(b, o.to(cuda), d.to(cuda))


@pytest.mark.cuda
def test_walk_exact_on_misses_and_t_max(cuda):
    v, f = _sphere(3)
    b = _mesh_bvh(v, f, cuda)
    rng = np.random.default_rng(2)
    o, d = _rays(rng, 8000)
    away_o, away_d = _rays(rng, 2000, radius=50.0)
    o = torch.cat([o, away_o, away_o]).to(cuda)
    d = torch.cat([d, away_d, -away_d]).to(cuda)  # far rays: towards the scene and away
    got = _assert_walk_exact(b, o, d)
    assert not bool(got["hit"][8000 + 2000:].any())
    clipped = _assert_walk_exact(b, o, d, t_max=2.5)  # clips the far side and some front hits
    assert int(clipped["hit"].sum()) < int(got["hit"].sum())


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 63, 65, 257, 12345])
def test_walk_exact_on_ragged_sizes(cuda, R):
    v, f = _sphere(3)
    b = _mesh_bvh(v, f[:1243], cuda)
    o, d = _rays(np.random.default_rng(R), R)
    _assert_walk_exact(b, o.to(cuda), d.to(cuda))


@pytest.mark.cuda
def test_walk_exact_on_a_bake_batch_and_shadow_rays(cuda):
    v, f = torus_arrays(nu=96, nv=48)
    b = _mesh_bvh(v, f, cuda)
    m = Mesh.from_numpy(v, f, device=cuda)
    o, d, _ = tvis.bake_rays(m.v_pos[:512], m.v_nrm[:512], tvis._grid_dirs(16, cuda), 1e-3)
    got = _assert_walk_exact(b, o, d)
    assert 0.05 < float(got["hit"].float().mean()) < 0.95
    o, d = _shadow_rays(v, f, 2048, seed=4)
    got = _assert_walk_exact(b, o.to(cuda), d.to(cuda))
    assert 0.05 < float(got["hit"].float().mean()) < 0.95  # the torus shadows itself


@pytest.mark.cuda
def test_walk_exact_on_the_uv_plane(cuda):
    b, o, d = _uv_plane(256)
    b = tbvh.FlatBVH(*(x.to(cuda) for x in b))
    got = _assert_walk_exact(b, o.to(cuda), d.to(cuda))
    # Moller-Trumbore's t = e2.q / det rounds to 1 or to 1 - 2^-24 here (the
    # plain walk's too: 877 of the hits at 256^2), not to exactly 1 as
    # kernel B's plane equations do
    assert bool(((got["t"][got["hit"]] - 1.0).abs() <= 2.0 ** -24).all())
    assert 0.3 < float(got["hit"].float().mean()) < 0.9
