"""Kernel E v2's two entries and its node records, on the CPU.

The walk's any-hit form (``cast_rays_bvh_plain(..., any_hit=True)``, what
kernel E's any-hit entry repeats) stops each ray at its first valid pair;
until then it tests what the closest-hit walk tests, so its hit mask is
the closest-hit walk's bit for bit, with at most its nodes and pairs. It
is held against the JAX package's ``occlusion_rays`` (a closest-hit walk's
mask) within the 1e-3 of rays that XLA's FMA contraction moves in
``tests/test_torch_bvh.py``, none of the rays from outside. ``pack_bvh``'s
records hold each internal node's children's boxes bit for bit, and a walk
over the records in the kernel's order (``_record_walk``, the kernel's loop
written out over rays) returns bit for bit what the plain walk returns,
with the same counters. The hit-mask callers (the visibility bakes, the
renderer's ``occlusion`` for the shadow rays, ``occlusion_rays``) reach the
any-hit walk above ``DENSE_CAST_MAX_TRIS`` (lowered) and the dense caster
at or below it; on the tiny torus above the threshold the bake table and
the fast-path gate's RMSE and gradient cosine are those of the closest-hit
walk. The ``cuda``-marked test holds both entries against their plain
versions on the card (``python -m pytest --noconftest -m cuda``).
"""

import types

import numpy as np
import pytest
import torch

from dreammat_tpu_torch.models.mesh import compute_vertex_normals, torus_arrays
from dreammat_tpu_torch.ops import bvh as tbvh
from dreammat_tpu_torch.ops import visibility as tvis
from test_torch_bvh import _rays, _sphere, _walk_rays
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401


@pytest.fixture
def jax_ref():
    jnp = pytest.importorskip("jax.numpy")
    from dreammat_tpu.ops import bvh as jbvh

    return jnp, jbvh


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel E has no CPU mode")
    return torch.device("cuda")


def _torus():
    v, f = torus_arrays(0.7, 0.28, 48, 24)
    return np.asarray(v, np.float32), np.asarray(f, np.int64)


MESHES = {"sphere": lambda: _sphere(2), "torus": _torus}


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _record_walk(packed: tbvh.PackedBVH, o, d, t_max=tbvh.MISS_DEPTH, any_hit=False,
                 counters_out=None):
    """Kernel E v2's loop over ``pack_bvh``'s records, vectorised over rays:
    test the held record's first or second child; a met internal child's
    record is read next (its first child), a met leaf's triangles are
    tested in slot order; then on to the second child, or from a second
    child (or a record without one) to the second child of the next
    record, until there is none."""
    rec_lo = [packed.nodes[:, 0:3], packed.nodes[:, 8:11]]
    rec_hi = [packed.nodes[:, 4:7], packed.nodes[:, 12:15]]
    word1, word2, nxt = (_bits(packed.nodes[:, k]).long() for k in (3, 7, 15))
    tri = packed.tris
    tri_id = _bits(tri[:, 3])
    inv = tbvh._inv_dir(d)
    R = o.shape[0]
    tb = torch.full((R,), float(t_max))
    fb = torch.full((R,), -1, dtype=torch.int32)
    ub, vb = torch.zeros(R), torch.zeros(R)
    found = torch.zeros(R, dtype=torch.bool)
    idx = torch.arange(R)
    rec = torch.zeros(R, dtype=torch.long)
    second = torch.zeros(R, dtype=torch.bool)
    nodes = pairs = 0
    while idx.numel():
        s = second[:, None]
        lo = torch.where(s, rec_lo[1][rec], rec_lo[0][rec])
        hi = torch.where(s, rec_hi[1][rec], rec_hi[0][rec])
        word = torch.where(second, word2[rec], word1[rec])
        met = tbvh._slab(o[idx], inv[idx], lo, hi, tb[idx])
        nodes += idx.numel()
        count = word & 7
        leaf = torch.nonzero(met & (count > 0))[:, 0]
        for lane in range(tbvh.LEAF_SIZE):
            sel = leaf[count[leaf] > lane]
            sel = sel[~found[idx[sel]]]
            if not sel.numel():
                break
            pairs += sel.numel()
            slot = (word[sel] >> 3) + lane
            g = tri[slot]
            t, u, v, valid = tbvh._moller_trumbore(o[idx[sel]], d[idx[sel]], g[:, 0:3],
                                                   g[:, 4:7], g[:, 8:11])
            ray = idx[sel]
            better = valid & (t < tb[ray])
            ray, slot = ray[better], slot[better]
            if any_hit:
                found[ray] = True
                continue
            tb[ray], ub[ray], vb[ray] = t[better], u[better], v[better]
            fb[ray] = tri_id[slot]
        descend = met & (count == 0)
        to_second = ~descend & ~second & (word2[rec] != -1)
        rec = torch.where(descend, word >> 3, torch.where(to_second, rec, nxt[rec]))
        second = ~descend
        keep = (rec >= 0) & ~found[idx]
        idx, rec, second = idx[keep], rec[keep], second[keep]
    if counters_out is not None:
        counters_out += torch.tensor([nodes, pairs])
    return {"hit": found} if any_hit else tbvh._finish(tb, fb, ub, vb)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("use_native", [True, False])
def test_records_hold_the_childrens_boxes(mesh, use_native):
    """Record k + 1 is internal node P_k (DFS order): its first child P + 1
    and its second, P + 1's miss link, each box bit for bit with its word
    (the second's in both halves), and the record whose second child is the
    second child's miss link."""
    v, f = MESHES[mesh]()
    b = tbvh.build_bvh(v, f, device="cpu", use_native=use_native)
    p = tbvh.pack_bvh(b)
    count, miss = b.node_count.long(), b.node_miss.long()
    inner = torch.nonzero(count == 0)[:, 0]
    assert p.nodes.shape == (inner.shape[0] + 1, 16) and p.tris.shape == (b.tri_v0.shape[0], 12)
    record = torch.zeros_like(count)
    record[inner] = torch.arange(1, inner.shape[0] + 1)
    word = torch.where(count > 0, b.node_first.long() * 8 + count, record * 8)
    words = [_bits(p.nodes[:, k]).long() for k in (3, 7, 15)]
    # the virtual record: the root first, no second, nothing after
    assert torch.equal(p.nodes[0, 0:3], b.node_min[0]) and torch.equal(p.nodes[0, 4:7],
                                                                        b.node_max[0])
    assert [int(w[0]) for w in words] == [int(word[0]), -1, -1]
    first, second = inner + 1, miss[inner + 1]
    assert bool((second > 0).all())  # both builders' nodes have two children
    r = torch.arange(1, inner.shape[0] + 1)
    assert torch.equal(p.nodes[r, 0:3], b.node_min[first])
    assert torch.equal(p.nodes[r, 4:7], b.node_max[first])
    assert torch.equal(p.nodes[r, 8:11], b.node_min[second])
    assert torch.equal(p.nodes[r, 12:15], b.node_max[second])
    assert torch.equal(words[0][r], word[first]) and torch.equal(words[1][r], word[second])
    assert torch.equal(_bits(p.nodes[:, 11]), _bits(p.nodes[:, 7]))  # word2 in both halves
    # the next record's second child is the second child's miss link
    after = miss[second]
    nxt = words[2][r]
    assert torch.equal(nxt < 0, after < 0)
    assert torch.equal(miss[inner[nxt[nxt >= 0] - 1] + 1], after[nxt >= 0])
    # a leaf's word: its first slot and count
    leaf = count > 0
    assert torch.equal((word[leaf] & 7), count[leaf])
    assert torch.equal(word[leaf] >> 3, b.node_first.long()[leaf])
    assert torch.equal(_bits(p.tris[:, 3]), b.tri_id)


def test_records_refuse_a_layout_without_skip_links():
    v, f = _sphere(1)
    b = tbvh.build_bvh(v, f, device="cpu")
    miss = b.node_miss.clone()
    miss[int(miss[1])] = 1  # the root's second child's link back to its first child
    bad = b._replace(node_miss=miss)
    with pytest.raises(ValueError):
        tbvh.pack_bvh(bad)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("t_max", [tbvh.MISS_DEPTH, 0.3])
def test_any_hit_mask_is_the_closest_hit_mask(mesh, t_max):
    """On rays from outside and bake rays from the surface: the any-hit
    walk's hit bit for bit the closest-hit walk's, its nodes and pairs at
    most the closest-hit walk's; and the walk over kernel E's records
    returns bit for bit what the plain walk returns, counters included,
    in both forms."""
    v, f = MESHES[mesh]()
    b = tbvh.build_bvh(v, f, device="cpu")
    o, d = (torch.from_numpy(x) for x in _walk_rays(v, f, n=4096))
    ctr = {k: torch.zeros(2, dtype=torch.int64) for k in ("closest", "any")}
    closest = tbvh.cast_rays_bvh(b, o, d, t_max=t_max, counters_out=ctr["closest"])
    anyhit = tbvh.cast_rays_bvh(b, o, d, t_max=t_max, counters_out=ctr["any"], any_hit=True)
    assert set(anyhit) == {"hit"} and anyhit["hit"].dtype == torch.bool
    assert torch.equal(anyhit["hit"], closest["hit"])
    assert 0.05 < float(closest["hit"].float().mean()) < 0.95
    assert bool((ctr["any"] <= ctr["closest"]).all()), (ctr["any"], ctr["closest"])
    assert int(ctr["any"][1]) < int(ctr["closest"][1])  # it stops early somewhere
    packed = tbvh.pack_bvh(b)
    for any_hit, ref in ((False, closest), (True, anyhit)):
        rctr = torch.zeros(2, dtype=torch.int64)
        got = _record_walk(packed, o, d, t_max=t_max, any_hit=any_hit, counters_out=rctr)
        for key in ref:
            assert torch.equal(got[key], ref[key]), (any_hit, key)
        assert torch.equal(rctr, ctr["any" if any_hit else "closest"]), any_hit


@pytest.mark.parametrize("use_native", [True, False])
def test_any_hit_against_jax_occlusion_rays(use_native, jax_ref):
    """The JAX package's ``occlusion_rays`` (its jitted closest-hit walk's
    mask) against the any-hit walk on the torus at t_max 10 and 0.3: at
    most 1e-3 of the rays differ (bake rays that graze an edge, where XLA's
    FMAs decide otherwise; ``test_walk_matches_jax_cast_rays``), none of
    the rays from outside."""
    jnp, jbvh = jax_ref
    v, f = _torus()
    jb = jbvh.build_bvh(v, f, use_native=use_native)
    tb = tbvh.build_bvh(v, f, device="cpu", use_native=use_native)
    o, d = _walk_rays(v, f)
    for t_max in (tbvh.MISS_DEPTH, 0.3):
        ref = np.asarray(jbvh.occlusion_rays(jb, jnp.asarray(o), jnp.asarray(d), t_max=t_max))
        got = tbvh.occlusion_rays(tb, torch.from_numpy(o), torch.from_numpy(d),
                                  t_max=t_max).numpy()
        differ = got != ref
        print(f"t_max {t_max}: {int(differ.sum())} of {len(o)} rays differ")
        assert differ.mean() <= 1e-3, int(differ.sum())
        assert not differ[:len(o) // 2].any()
        assert 0.05 < got.mean() < 0.95


class _Calls:
    """The plain casters' calls, by caster and entry, while patched."""

    def __init__(self, monkeypatch):
        self.ran = []
        for name in ("cast_rays_bvh_plain", "cast_rays_plain"):
            fn = getattr(tbvh, name)

            def counted(*a, _fn=fn, _name=name, **k):
                self.ran.append((_name, k.get("any_hit", False)))
                return _fn(*a, **k)

            monkeypatch.setattr(tbvh, name, counted)

    def take(self):
        out, self.ran = sorted(set(self.ran)), []
        return out


@pytest.mark.parametrize("walk", [True, False], ids=["above", "at-or-below"])
def test_hit_mask_callers_dispatch(walk, monkeypatch):
    """With ``DENSE_CAST_MAX_TRIS`` below the mesh, the vertex and pixel
    bakes and the renderer's ``occlusion`` take the any-hit walk; at its
    size, the dense caster, with the same masks and tables.
    ``occlusion_rays`` walks any-hit at every size."""
    from dreammat_tpu_torch.models.renderer import RaytraceRenderer

    v, f = _sphere(2)
    b = tbvh.build_bvh(v, f, device="cpu")
    monkeypatch.setattr(tbvh, "DENSE_CAST_MAX_TRIS", 64 if walk else b.tri_v0.shape[0])
    calls = _Calls(monkeypatch)
    vp = torch.from_numpy(v[:40])
    vn = torch.from_numpy(compute_vertex_normals(v, f)[:40])
    want = [("cast_rays_bvh_plain", True)] if walk else [("cast_rays_plain", False)]
    baked = tvis.bake_vertex_visibility(b, vp, vn, oct_res=4)
    assert calls.take() == want
    pix = tvis.bake_pixel_visibility(b, vp, vn, oct_res=4)
    assert calls.take() == want and torch.equal(pix.table, baked.table)
    ren = types.SimpleNamespace(bvh=b, tri_data=tbvh.cast_data(b))
    o, d = (torch.from_numpy(x) for x in _rays(np.random.RandomState(3), 300))
    mask = RaytraceRenderer.occlusion(ren, o, d)
    assert calls.take() == want
    assert torch.equal(mask, tbvh.cast_rays_chunked(b, o, d)["hit"])
    calls.take()
    assert torch.equal(tbvh.occlusion_rays(b, o, d), mask)
    assert calls.take() == [("cast_rays_bvh_plain", True)]


def test_big_mesh_bake_and_gate_as_the_closest_hit_walk(tmp_path, monkeypatch):
    """The tiny DreamMat system on the 576-triangle torus with the threshold
    at 256 (as ``tests/test_torch_big_mesh.py``): its visibility bake and
    the gate's shadow rays reach the any-hit walk, and the bake table, the
    gate's colour RMSE and its gradient cosine are those of the same
    system with the closest-hit walk's mask in their place, exactly."""
    import dreammat_tpu_torch
    from dreammat_tpu_torch.data import prerender as tpr
    from dreammat_tpu_torch.models.mesh import write_obj
    from dreammat_tpu_torch.utils.config import load_config

    monkeypatch.setattr(tbvh, "DENSE_CAST_MAX_TRIS", 256)
    obj = write_obj(str(tmp_path / "torus.obj"), *torus_arrays())
    cfg = load_config("configs/dreammat_tiny.yaml", [
        "system.prompt_processor.prompt=a torus", f"system.geometry.shape_init=mesh:{obj}",
        "system.material.use_prefiltered=true", "data.fix_view_num=1",
        "system.renderer.visibility_oct_res=8", "data.fastpath_check=false",
        "data.static_field_maps=false"])
    calls = _Calls(monkeypatch)
    sys_ = dreammat_tpu_torch.find("dreammat-system")(cfg.system, device="cpu")
    dm = dreammat_tpu_torch.find("random-camera-datamodule")(
        cfg.data, sys_.renderer, sys_.material, device="cpu")
    dm.setup()
    ren, mat = sys_.renderer, sys_.material
    assert ("cast_rays_bvh_plain", True) in calls.take()  # the bake
    P = min(4096, dm.data.gbuffers[0].fg_pos.shape[0])
    W = np.random.RandomState(3).uniform(size=(P, 3)).astype(np.float32)
    draws = types.SimpleNamespace(uniform=lambda name, shape: torch.from_numpy(W.copy()))

    def measures():
        table = tvis.bake_vertex_visibility(ren.bvh, ren.mesh.v_pos, ren.mesh.v_nrm,
                                            oct_res=ren.cfg.visibility_oct_res).table
        return (table, tpr.fastpath_residual(ren, mat, dm.data),
                tpr.fastpath_grad_cos(ren, mat, dm.data, draws=draws))

    table, rmse, gcos = measures()
    assert calls.take() == [("cast_rays_bvh_plain", True)]
    assert torch.equal(table, mat.baked_visibility.table)
    monkeypatch.setattr(tbvh, "occluded_chunked", lambda bvh, o, d, t_max=tbvh.MISS_DEPTH,
                        tri_data=None: tbvh.cast_rays_chunked(bvh, o, d, t_max, tri_data)["hit"])
    c_table, c_rmse, c_gcos = measures()
    assert calls.take() == [("cast_rays_bvh_plain", False)]
    assert torch.equal(table, c_table)
    assert rmse == c_rmse and gcos == c_gcos, (rmse, c_rmse, gcos, c_gcos)
    assert np.isfinite(rmse) and np.isfinite(gcos)


@pytest.mark.cuda
def test_both_entries_match_the_plain_walks_on_cuda(cuda):
    """On the card, on the torus and a sphere, rays from outside and from
    the surface at t_max 10 and 0.3: the closest-hit entry bit for bit the
    plain walk, the any-hit entry's mask bit for bit both plain walks',
    each entry's nodes and pairs those of its plain walk."""
    for v, f in (_torus(), _sphere(3)):
        b = tbvh.build_bvh(v, f, device=cuda)
        packed = tbvh.pack_bvh(b)
        o, d = (torch.from_numpy(x).to(cuda) for x in _walk_rays(v, f, n=20000))
        for t_max in (tbvh.MISS_DEPTH, 0.3):
            before = (tbvh.cast_rays_bvh.launches, tbvh.cast_rays_bvh.any_hit_launches)
            got, ref = {}, {}
            for any_hit in (False, True):
                kc = torch.zeros(2, dtype=torch.int64, device=cuda)
                pc = torch.zeros(2, dtype=torch.int64, device=cuda)
                got[any_hit] = tbvh.cast_rays_bvh(b, o, d, t_max=t_max, packed=packed,
                                                  counters_out=kc, any_hit=any_hit)
                ref[any_hit] = tbvh.cast_rays_bvh_plain(b, o, d, t_max=t_max,
                                                        counters_out=pc, any_hit=any_hit)
                torch.cuda.synchronize()
                for key in ref[any_hit]:
                    same = got[any_hit][key] == ref[any_hit][key]
                    assert bool(same.all()), (any_hit, key, int((~same).sum()))
                assert torch.equal(kc, pc), (any_hit, kc.tolist(), pc.tolist())
            assert torch.equal(got[True]["hit"], ref[False]["hit"])
            assert (tbvh.cast_rays_bvh.launches, tbvh.cast_rays_bvh.any_hit_launches) == (
                before[0] + 2, before[1] + 1)
