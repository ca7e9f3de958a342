"""Port parity: the reference-parity probe renderers and their lookups.

- The four visibility functions the MC probe renderer reads
  (``dir_to_bin``, ``lookup_shadowed_radiance_all_envs``,
  ``lookup_shadowed_radiance``, ``bake_vertex_irradiance``)
  against ``dreammat_tpu.ops.visibility`` on the same seeded inputs: bins
  equal, values within relative L2 1e-5.
- The three prerender functions against ``dreammat_tpu.data.prerender`` on
  the level-2 icosphere at 32^2, 2 environments, 64 samples, both
  packages given the JAX package's G-buffer, and the MC and exact
  renderers again on the 24 x 12 torus (576 triangles), where one part of
  the mesh shadows another, at the same tolerances. Of the shadow rays
  more than 0.1 above the normal's horizon, over 3e-3 hit on the torus
  (0.0064 here) and under 1e-3 on the sphere (3.4e-4), so the torus's
  parity covers rays stopped by another part of the mesh:
  ``render_probes_for_view`` (the convolution bake, as
  ``tests/test_torch_prerender.py``) within relative L2 1e-4;
  ``render_probes_for_view_mc`` on the JAX package's visibility table,
  probes and split-sum tables within relative L2 2e-4;
  ``render_probes_for_view_exact`` with the JAX package's hit mask
  (the port's renderer traces through the JAX caster) within relative L2
  5e-4, and its own hit mask on at most 1e-3 of the shadow rays apart
  from the JAX package's. The margins are rounding: grazing shadow rays
  (1e-5 off the surface) flip with the order of the fp32 sums, and a
  sample direction within ~2e-7 of an environment texel's edge reads the
  next texel in the nearest lookup.
- The port's exact renderer against its MC renderer on the sphere, where
  the baked visibility is exact (as ``tests/test_cycles_parity.py`` holds
  the JAX package's): mean |difference| over the foreground below 0.05,
  the background black.
- The exact renderer on a torus above a lowered ``DENSE_CAST_MAX_TRIS``:
  its shadow rays walk the BVH through the walk's any-hit entry (counted
  on the plain walk here), no dense caster runs, and the image is the dense
  route's wherever the two hit masks agree (at most 1e-3 of the rays
  differ: the walk's Moller-Trumbore test and the dense caster's plane
  test round grazing rays differently).
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
from dreammat_tpu.data import prerender as jpre
from dreammat_tpu.data.cameras import camera_rays_and_matrices as jrays
from dreammat_tpu.data.cameras import make_fixed_cameras as jcams
from dreammat_tpu.models.mesh import Mesh as JMesh
from dreammat_tpu.models.mesh import compute_vertex_normals as jnormals
from dreammat_tpu.models.mesh import make_icosphere as jico
from dreammat_tpu.ops import visibility as jvis
from dreammat_tpu_torch.data import prerender as tpre
from dreammat_tpu_torch.models.mesh import Mesh, torus_arrays
from dreammat_tpu_torch.models.renderer import GBufferView
from dreammat_tpu_torch.ops import bvh as tbvh
from dreammat_tpu_torch.ops import visibility as tvis
from dreammat_tpu_torch.ops.visibility import BakedVisibility
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401

ENC = {"otype": "HashGrid", "n_levels": 2, "n_features_per_level": 2, "log2_hashmap_size": 8,
       "base_resolution": 4, "per_level_scale": 1.5}
MAT = {"environment_texture": "/nonexistent", "n_environments": 2, "env_height": 16,
       "env_width": 32, "diffuse_sample_num": 64, "specular_sample_num": 64,
       "use_prefiltered": True}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _unit(rng, shape):
    d = rng.normal(size=(*shape, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# the visibility functions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lookups():
    rng = np.random.RandomState(0)
    V, O, E, P, S = 40, 8, 2, 24, 10
    return {
        "lvis": rng.rand(V, O * O, E * 3).astype(np.float16),
        "tri": rng.randint(0, V, size=(P, 3)),
        "bary": rng.dirichlet(np.ones(3), size=P).astype(np.float32),
        "dirs": _unit(rng, (P, S)),
        "oct_res": O,
    }


def test_dir_to_bin():
    d = _unit(np.random.RandomState(1), (500,))
    d = np.concatenate([d, np.eye(3, dtype=np.float32), -np.eye(3, dtype=np.float32)])
    for O in (8, 16):
        got = tvis.dir_to_bin(torch.from_numpy(d), O).numpy()
        assert np.array_equal(got, np.asarray(jvis.dir_to_bin(jnp.asarray(d), O))), O


def test_lookup_shadowed_radiance(lookups):
    L = lookups
    args = (L["lvis"], L["tri"], L["bary"], L["dirs"], L["oct_res"])
    want = jvis.lookup_shadowed_radiance_all_envs(*(jnp.asarray(a) for a in args[:4]), args[4])
    t_args = (torch.from_numpy(args[0]), torch.from_numpy(args[1]), torch.from_numpy(args[2]),
              torch.from_numpy(args[3]), args[4])
    got = tvis.lookup_shadowed_radiance_all_envs(*t_args)
    assert got.shape == want.shape == (24, 10, 2, 3)
    assert _rel(got.numpy(), want) < 1e-5
    one = tvis.lookup_shadowed_radiance(*t_args, env_id=1)
    want_one = jvis.lookup_shadowed_radiance(*(jnp.asarray(a) for a in args[:4]), args[4],
                                             env_id=1)
    assert _rel(one.numpy(), want_one) < 1e-5


def test_bake_vertex_irradiance(lookups):
    ico = jico(2)
    V = ico.v_pos.shape[0]
    rng = np.random.RandomState(2)
    lvis = rng.rand(V, 64, 6).astype(np.float16)
    az, el = (rng.rand(32).astype(np.float32) for _ in range(2))
    samples = np.stack([az, el], -1)
    want = jvis.bake_vertex_irradiance(jvis.BakedVisibility(None, 8), jnp.asarray(lvis),
                                       ico.v_nrm, jnp.asarray(samples))
    nrm = torch.from_numpy(np.array(ico.v_nrm))
    got = tvis.bake_vertex_irradiance(BakedVisibility(None, 8), torch.from_numpy(lvis), nrm,
                                      torch.from_numpy(samples), v_chunk=50)
    assert got.shape == want.shape == (2, V, 3)
    assert _rel(got.numpy(), want) < 1e-5


# ---------------------------------------------------------------------------
# the probe renderers on the level-2 icosphere and on the torus
# ---------------------------------------------------------------------------

def _rig(mesh: str):
    """Both packages' rigs on one mesh (``sphere``: the level-2 icosphere;
    ``torus``: 24 x 12, 576 triangles), the JAX package's G-buffer of one
    32^2 view in both, and the port's material on the JAX package's
    visibility table (the port's own kept aside)."""
    jgeo = dreammat_tpu.find("dreammat-mesh")({"shape_init": "procedural:sphere",
                                               "pos_encoding_config": ENC})
    tgeo = dreammat_tpu_torch.find("dreammat-mesh")(
        {"shape_init": "procedural:sphere", "shape_init_params": 2, "pos_encoding_config": ENC},
        device="cpu")
    if mesh == "sphere":
        jgeo.set_mesh(jico(2))
    else:
        v, f = torus_arrays(0.7, 0.28, 24, 12)
        jgeo.set_mesh(JMesh(jnp.asarray(v), jnp.asarray(f.astype(np.int32)),
                            jnp.asarray(jnormals(v, f))))
        tgeo.mesh = Mesh.from_numpy(v, f, device="cpu")
    jmat = dreammat_tpu.find("dreammat-material")(MAT)
    jren = dreammat_tpu.find("raytracing-renderer")(
        {}, jgeo, jmat, dreammat_tpu.find("solid-color-background")({}))
    tmat = dreammat_tpu_torch.find("dreammat-material")(MAT, device="cpu")
    tren = dreammat_tpu_torch.find("raytracing-renderer")({}, tgeo, tmat, None, device="cpu")
    jb = jmat.baked_visibility
    tmat.set_baked_visibility(BakedVisibility(torch.from_numpy(np.array(jb.table)), jb.oct_res))
    cd = jrays(jcams(2, seed=1), 0, 32, 32)
    jgb = jren.build_gbuffer(cd["rays_o"], cd["rays_d"], cd["w2c"])
    tgb = GBufferView(*(torch.from_numpy(np.array(x)) for x in jgb))
    tgb = tgb._replace(fg_idx=tgb.fg_idx.long(), fg_tri=tgb.fg_tri.long())
    return {"jren": jren, "jmat": jmat, "jgb": jgb, "tren": tren, "tmat": tmat, "tgb": tgb,
            "cam_pos": np.asarray(cd["camera_position"])}


def _exact_pair(s):
    jex = np.asarray(jpre.render_probes_for_view_exact(s["jren"], s["jmat"], s["jgb"], 2,
                                                       jax.random.PRNGKey(0), chunk=256))
    tex = tpre.render_probes_for_view_exact(s["tren"], s["tmat"], s["tgb"], 2)
    return jex, tex


@pytest.fixture(scope="module")
def sphere():
    return _rig("sphere")


@pytest.fixture(scope="module")
def torus():
    return _rig("torus")


@pytest.fixture(scope="module")
def exact_pair(sphere):
    return _exact_pair(sphere)


def test_render_probes_for_view(sphere):
    s = sphere
    jp, jt = jpre.render_probes_for_view(s["jren"], s["jmat"], s["jgb"], 2, s["cam_pos"])
    tp, tt = tpre.render_probes_for_view(s["tren"], s["tmat"], s["tgb"], 2, s["cam_pos"])
    assert tp.shape == jp.shape == (2, 32, 32, 18) and tt.shape == jt.shape
    assert _rel(tp.numpy(), jp) < 1e-4
    assert _rel(tt.numpy(), jt) < 1e-4


def _check_mc(s):
    mc = jax.jit(lambda key: jpre.render_probes_for_view_mc(s["jren"], s["jmat"], s["jgb"], 2,
                                                            key))
    jimg, jtab = mc(jax.random.PRNGKey(0))
    timg, ttab = tpre.render_probes_for_view_mc(s["tren"], s["tmat"], s["tgb"], 2)
    assert timg.shape == jimg.shape == (2, 32, 32, 18)
    assert ttab.shape == jtab.shape == (2, s["tgb"].fg_pos.shape[0], 6, 3)
    assert _rel(timg.numpy(), jimg) < 2e-4
    assert _rel(ttab.numpy(), jtab) < 2e-4


def test_render_probes_for_view_mc(sphere):
    _check_mc(sphere)


def test_render_probes_for_view_mc_torus(torus):
    _check_mc(torus)


def _check_exact(s, jex, tex):
    """The exact renderer against the JAX package's; returns the share of
    the valid pixels' shadow rays that hit among those more than 0.1 above
    the normal's horizon (the rays that only another part of the mesh can
    stop)."""
    assert tex.shape == jex.shape == (2, 32, 32, 18)
    # the port's own shadow-ray mask against the JAX package's
    pos, nrm, vdr, valid = tpre._probe_inputs(s["tgb"])
    o, d = tpre.exact_probe_rays(s["tmat"], pos, nrm, vdr)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    jtrace = lambda o, d: torch.from_numpy(np.array(s["jren"].trace(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))[3]))
    jhit = jtrace(o, d)
    flips = (s["tren"].occlusion(o, d) != jhit).float().mean().item()
    assert flips <= 1e-3, flips
    # on the JAX package's mask
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(s["tren"], "occlusion", jtrace)
        got = tpre.render_probes_for_view_exact(s["tren"], s["tmat"], s["tgb"], 2, chunk=300)
    assert _rel(got.numpy(), jex) < 5e-4
    up = (d.reshape(pos.shape[0], -1, 3) * nrm[:, None]).sum(-1) > 0.1
    return jhit.reshape(pos.shape[0], -1)[up & valid[:, None]].float().mean().item()


def test_render_probes_for_view_exact(sphere, exact_pair):
    hit = _check_exact(sphere, *exact_pair)
    assert hit < 1e-3, hit  # convex: the facets stop a few grazing rays


def test_render_probes_for_view_exact_torus(torus):
    hit = _check_exact(torus, *_exact_pair(torus))
    assert hit > 3e-3, hit  # one part of the torus shadows another


def test_exact_matches_mc_on_sphere(sphere, exact_pair):
    s = sphere
    _, ex = exact_pair
    mc, _ = tpre.render_probes_for_view_mc(s["tren"], s["tmat"], s["tgb"], 2)
    assert not torch.isnan(ex).any()
    fg = s["tgb"].mask
    assert (ex - mc).abs()[:, fg].mean().item() < 0.05
    assert ex[:, ~fg].abs().max().item() == 0.0


# ---------------------------------------------------------------------------
# the exact renderer above the (lowered) dense-caster threshold
# ---------------------------------------------------------------------------

LIMIT = 256  # the lowered DENSE_CAST_MAX_TRIS; the torus has 576 triangles


def _torus_rig():
    geo = dreammat_tpu_torch.find("dreammat-mesh")(
        {"shape_init": "procedural:sphere", "pos_encoding_config": ENC}, device="cpu")
    geo.mesh = Mesh.from_numpy(*torus_arrays(0.7, 0.28, 24, 12), device="cpu")
    mat = dreammat_tpu_torch.find("dreammat-material")(
        dict(MAT, diffuse_sample_num=16, specular_sample_num=16), device="cpu")
    ren = dreammat_tpu_torch.find("raytracing-renderer")(
        {"visibility_mode": "raytrace"}, geo, mat, None, device="cpu")
    return mat, ren


def test_exact_walks_above_the_threshold():
    from dreammat_tpu_torch.data.cameras import camera_rays_and_matrices, make_fixed_cameras

    mat, dense = _torus_rig()
    cd = camera_rays_and_matrices(make_fixed_cameras(1, seed=0), 0, 24, 24, device="cpu")
    gb = dense.build_gbuffer(cd["rays_o"], cd["rays_d"], cd["w2c"])
    want = tpre.render_probes_for_view_exact(dense, mat, gb, 2)
    pos, nrm, vdr, _ = tpre._probe_inputs(gb)
    o, d = (x.reshape(-1, 3) for x in tpre.exact_probe_rays(mat, pos, nrm, vdr))
    dense_hit = dense.occlusion(o, d)

    calls = {"any_hit": 0, "closest": 0}
    plain_walk = tbvh.cast_rays_bvh_plain

    def counted(*a, **k):
        calls["any_hit" if k.get("any_hit") else "closest"] += 1
        return plain_walk(*a, **k)

    def no_dense(*a, **k):
        raise AssertionError("a dense caster ran above the threshold")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbvh, "DENSE_CAST_MAX_TRIS", LIMIT)
        _, walking = _torus_rig()
        assert tbvh.uses_walk(walking.bvh) and isinstance(walking.tri_data, tbvh.PackedBVH)
        mp.setattr(tbvh, "cast_rays_bvh_plain", counted)
        for name in ("cast_rays_plain", "cast_rays_dense"):
            mp.setattr(tbvh, name, no_dense)
        got = tpre.render_probes_for_view_exact(walking, mat, gb, 2)
        assert calls["any_hit"] >= 1 and calls["closest"] == 0, calls
        walk_hit = walking.occlusion(o, d)
    differ = (walk_hit != dense_hit).float().mean().item()
    assert differ <= 1e-3, differ
    if differ == 0.0:
        assert torch.equal(got, want)
    else:  # the pixels whose rays all agree are equal
        same = (walk_hit == dense_hit).reshape(pos.shape[0], -1).all(1) & gb.fg_valid
        idx = gb.fg_idx[same]
        flat = lambda x: x.reshape(2, -1, 18)[:, idx]
        assert torch.equal(flat(got), flat(want))
