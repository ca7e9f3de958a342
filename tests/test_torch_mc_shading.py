"""Port parity: the visibility lookups, the pixel bake and the Monte-Carlo
estimators against the JAX package.

The inputs are made from a numpy seed on a small torus (24 x 12 quads, the
shape of ``tests/test_visibility.py``): shading points on random triangles
with interpolated normals, tilted view directions, a random per-vertex
visibility table, and material features. Both packages shade them with
the same tiny material (24 diffuse and 12 specular directions, a 16 x 32
procedural sky).

Tolerances:

- lookups: at least 99.9% of samples fall in the same octahedral bins (a
  direction on a bin edge may round to either side in the two frameworks),
  and where they do the values agree to 1e-5;
- the pixel bake: at least 99.9% of bins equal (grazing rays, see
  ``test_torch_prerender.py``); the JAX table feeds the shading tests;
- the MC estimator, for each visibility source (none, the per-vertex
  table, the per-pixel table, shadow rays through the plain caster) at
  ``is_train`` False and True (the JAX rotations handed to the port):
  colour and every output to 1e-4, the gradient with respect to the
  features to cosine 0.9999 and relative norm error 1e-4, and the shadow
  rays' hit masks in at least 99.9% agreement;
- the streamed estimator (``shading_chunk`` 8) against the unchunked one,
  in the port: 1e-5 on every output and on the gradient.
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
from dreammat_tpu.ops import bvh as jbvh
from dreammat_tpu.ops import visibility as jvis
from dreammat_tpu_torch.models.mesh import compute_vertex_normals, torus_arrays
from dreammat_tpu_torch.ops import bvh as tbvh
from dreammat_tpu_torch.ops import visibility as tvis
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401


P = 64
OCT = 8
MAT_CFG = {"environment_texture": "/nonexistent", "n_environments": 2, "env_height": 16,
           "env_width": 32, "diffuse_sample_num": 24, "specular_sample_num": 12,
           "environment_scale": 2.0}
OUTPUTS = ("color", "albedo", "roughness", "metalness", "specular_light", "diffuse_light",
           "specular_color", "diffuse_color")


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(0)
    v, f = torus_arrays()
    vn = compute_vertex_normals(v, f)
    face = rng.randint(0, f.shape[0], P)
    bary = rng.dirichlet([2.0, 2.0, 2.0], P).astype(np.float32)
    tri = f[face]
    pts = (bary[:, :, None] * v[tri]).sum(1).astype(np.float32)
    nrm = _unit((bary[:, :, None] * vn[tri]).sum(1))
    view = _unit(nrm + 0.4 * rng.normal(size=(P, 3)))
    feats = (rng.normal(size=(P, 5)) * 1.5).astype(np.float32)
    table = (rng.rand(v.shape[0], OCT * OCT) > 0.3).astype(np.float16)
    mask = np.ones(P, bool)
    mask[-3:] = False
    return dict(v=v, f=f, vn=vn, pts=pts, nrm=nrm, view=view, feats=feats, tri=tri,
                bary=bary, table=table, mask=mask, rng_key=jax.random.PRNGKey(5))


def _t(x):
    return torch.from_numpy(np.array(x))


class GivenDraws:
    def __init__(self, arrays):
        self.arrays = arrays

    def uniform(self, name, shape):
        x = self.arrays[name]
        assert tuple(x.shape) == tuple(shape), (name, x.shape, shape)
        return _t(x)


def _jax_rotations(key, n):
    k1, k2 = jax.random.split(key)
    return {"mc_rot_diffuse": np.asarray(jax.random.uniform(k1, (n, 1))),
            "mc_rot_specular": np.asarray(jax.random.uniform(k2, (n, 1)))}


# ---------------------------------------------------------------------------
# lookups and the pixel bake
# ---------------------------------------------------------------------------

def _directions(rng, n, s):
    return _unit(rng.normal(size=(n, s, 3)))


@pytest.mark.parametrize("table", ["binary", "fractional"])
def test_lookup_visibility_matches_jax(scene, table):
    """A table of 0/1 bins (one ray a bin) and one of quarter fractions
    (a bake with ``supersample=2``)."""
    d = _directions(np.random.RandomState(1), P, 40)
    tab = scene["table"]
    if table == "fractional":
        tab = (np.random.RandomState(4).randint(0, 5, tab.shape) / 4.0).astype(np.float16)
    jb = jvis.BakedVisibility(jnp.asarray(tab), OCT)
    tb = tvis.BakedVisibility(_t(tab), OCT)
    got = tvis.lookup_visibility(tb, _t(scene["tri"]), _t(scene["bary"]), _t(d))
    ref = np.asarray(jvis.lookup_visibility(jb, jnp.asarray(scene["tri"]),
                                            jnp.asarray(scene["bary"]), jnp.asarray(d)))
    tbins = tvis.oct_bilinear_bins_weights(_t(d), OCT)[0].numpy()
    jbins = np.asarray(jvis.oct_bilinear_bins_weights(jnp.asarray(d), OCT)[0])
    same = (tbins == jbins).all(-1)
    assert same.mean() >= 0.999
    assert np.abs(got.numpy() - ref)[same].max() <= 1e-5


def test_lookup_visibility_pixel_matches_jax(scene):
    rng = np.random.RandomState(2)
    d = _directions(rng, P, 40)
    table = (rng.rand(P, OCT * OCT) > 0.4).astype(np.float16)
    got = tvis.lookup_visibility_pixel(tvis.PixelVisibility(_t(table), OCT), _t(d))
    ref = np.asarray(jvis.lookup_visibility_pixel(jvis.PixelVisibility(jnp.asarray(table), OCT),
                                                  jnp.asarray(d)))
    tbins = tvis.oct_bilinear_bins_weights(_t(d), OCT)[0].numpy()
    same = (tbins == np.asarray(jvis.oct_bilinear_bins_weights(jnp.asarray(d), OCT)[0])).all(-1)
    assert same.mean() >= 0.999
    assert np.abs(got.numpy() - ref)[same].max() <= 1e-5


def test_lookups_carry_no_gradient(scene):
    d = _t(_directions(np.random.RandomState(3), P, 8)).requires_grad_()
    a = tvis.lookup_visibility(tvis.BakedVisibility(_t(scene["table"]), OCT), _t(scene["tri"]),
                               _t(scene["bary"]), d)
    b = tvis.lookup_visibility_pixel(tvis.PixelVisibility(_t(scene["table"][:P]), OCT), d)
    assert not a.requires_grad and not b.requires_grad


def test_bake_pixel_visibility_matches_jax(scene):
    jb = jbvh.build_bvh(scene["v"], scene["f"])
    tb = tbvh.build_bvh(scene["v"], scene["f"], device="cpu")
    got = tvis.bake_pixel_visibility(tb, _t(scene["pts"]), _t(scene["nrm"]), oct_res=OCT)
    ref = jvis.bake_pixel_visibility(jb, jnp.asarray(scene["pts"]), jnp.asarray(scene["nrm"]),
                                     oct_res=OCT)
    assert got.table.shape == ref.table.shape
    assert (got.table.float().numpy() == np.asarray(ref.table, np.float32)).mean() >= 0.999
    assert 0.0 < float(got.table.float().mean()) < 1.0  # the torus shadows itself


# ---------------------------------------------------------------------------
# the MC estimators
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rig(scene):
    jmat = dreammat_tpu.find("dreammat-material")(dict(MAT_CFG))
    tmat = dreammat_tpu_torch.find("dreammat-material")(dict(MAT_CFG), device="cpu")
    jb = jbvh.build_bvh(scene["v"], scene["f"])
    tb = tbvh.build_bvh(scene["v"], scene["f"], device="cpu")
    pix = np.asarray(jvis.bake_pixel_visibility(jb, jnp.asarray(scene["pts"]),
                                                jnp.asarray(scene["nrm"]), oct_res=OCT).table)

    def jtrace(o, d):
        out = jbvh.cast_rays_dense(jb, o, d)
        return None, None, out["t"][:, None], out["hit"]

    tri_data = tbvh._plane_tri_data(tb)

    def ttrace(o, d):  # the port's tracer contract: the hit mask alone
        return tbvh.occluded_chunked(tb, o, d, tri_data=tri_data)

    return dict(jmat=jmat, tmat=tmat, jb=jb, tb=tb, pix=pix, jtrace=jtrace, ttrace=ttrace)


def _set_source(rig, scene, source):
    """Both materials' visibility source; returns (jax vis_data, port vis_data)."""
    jmat, tmat = rig["jmat"], rig["tmat"]
    table = scene["table"]
    jmat.set_baked_visibility(jvis.BakedVisibility(jnp.asarray(table), OCT)
                              if source == "baked" else None)
    tmat.set_baked_visibility(tvis.BakedVisibility(_t(table), OCT) if source == "baked" else None)
    jmat.set_raytracer(rig["jtrace"] if source == "raytrace" else None)
    tmat.set_raytracer(rig["ttrace"] if source == "raytrace" else None)
    if source == "pixel":
        return (jvis.PixelVisibility(jnp.asarray(rig["pix"]), OCT),
                tvis.PixelVisibility(_t(rig["pix"]), OCT))
    if source == "baked":
        return ((jnp.asarray(scene["tri"]), jnp.asarray(scene["bary"])),
                (_t(scene["tri"]), _t(scene["bary"])))
    return None, None


def _jax_shade(jmat, scene, vis, is_train):
    """The JAX material's outputs and the gradient of a weighted colour sum,
    in one jitted call (op by op, the first source's call compiled every op
    for 40 s on a CPU)."""
    def f(feats):
        out, _ = jmat(jnp.asarray(scene["pts"]), feats, feats, jnp.asarray(scene["view"]),
                      jnp.asarray(scene["nrm"]), jnp.int32(1), scene["rng_key"],
                      is_train=is_train, mask=jnp.asarray(scene["mask"]), vis_data=vis)
        return out

    w = jnp.asarray(np.random.RandomState(4).rand(P, 3).astype(np.float32))

    @jax.jit
    def both(x):
        out, vjp = jax.vjp(f, x)
        return out, vjp({k: (w if k == "color" else jnp.zeros_like(v))
                         for k, v in out.items()})[0]

    out, g = both(jnp.asarray(scene["feats"]))
    return {k: np.asarray(v) for k, v in out.items()}, np.asarray(g)


def _port_shade(tmat, scene, vis, is_train, draws):
    feats = _t(scene["feats"]).requires_grad_()
    out, _ = tmat(_t(scene["pts"]), feats, feats, _t(scene["view"]), _t(scene["nrm"]), 1, draws,
                  is_train=is_train, mask=_t(scene["mask"]), vis_data=vis)
    w = _t(np.random.RandomState(4).rand(P, 3).astype(np.float32))
    g, = torch.autograd.grad(torch.sum(out["color"] * w), feats)
    return {k: v.detach().numpy() for k, v in out.items()}, g.numpy()


def _assert_grad_close(g, ref, cos_min=0.9999, rel_max=1e-4):
    g, ref = g.astype(np.float64).ravel(), ref.astype(np.float64).ravel()
    cos = g @ ref / (np.linalg.norm(g) * np.linalg.norm(ref))
    rel = np.linalg.norm(g - ref) / np.linalg.norm(ref)
    assert cos >= cos_min and rel <= rel_max, (cos, rel)


@pytest.mark.parametrize("is_train", [False, True])
@pytest.mark.parametrize("source", ["none", "baked", "pixel", "raytrace"])
def test_mc_estimator_matches_jax(rig, scene, source, is_train):
    jvis_data, tvis_data = _set_source(rig, scene, source)
    jout, jg = _jax_shade(rig["jmat"], scene, jvis_data, is_train)
    draws = GivenDraws(_jax_rotations(scene["rng_key"], P))
    tout, tg = _port_shade(rig["tmat"], scene, tvis_data, is_train, draws)
    for k in OUTPUTS:
        assert np.abs(tout[k] - jout[k]).max() <= 1e-4, (k, np.abs(tout[k] - jout[k]).max())
    _assert_grad_close(tg, jg)


def test_shadow_ray_hits_match_jax(rig, scene):
    """The raytrace source's shadow rays (the port's directions, origins
    1e-5 off the surface): the plain caster against the JAX dense caster."""
    tmat = rig["tmat"]
    nrm, view = _t(scene["nrm"]), _t(scene["view"])
    refl = 2.0 * (nrm * view).sum(-1, keepdim=True) * nrm - view
    r = torch.full((P, 1), 0.3)
    dirs = torch.cat([tmat.sample_diffuse_directions(nrm),
                      tmat.sample_specular_directions(refl, r)], 1).reshape(-1, 3)
    o = (_t(scene["pts"])[:, None].expand(-1, dirs.shape[0] // P, 3).reshape(-1, 3)
         + dirs * 1e-5)
    got = tbvh.cast_rays_chunked(rig["tb"], o, dirs)["hit"].numpy()
    ref = np.asarray(jbvh.cast_rays_dense(rig["jb"], jnp.asarray(o.numpy()),
                                          jnp.asarray(dirs.numpy()))["hit"])
    assert (got == ref).mean() >= 0.999
    assert 0.0 < got.mean() < 1.0


@pytest.mark.parametrize("source", ["baked", "raytrace"])
def test_streamed_matches_unchunked(rig, scene, source):
    _, tvis_data = _set_source(rig, scene, source)
    outs = []
    for chunk in (0, 8):
        tmat = dreammat_tpu_torch.find("dreammat-material")(
            dict(MAT_CFG, shading_chunk=chunk), device="cpu")
        tmat.set_baked_visibility(rig["tmat"].baked_visibility)
        tmat.set_raytracer(rig["tmat"].ray_trace_fun)
        draws = GivenDraws(_jax_rotations(scene["rng_key"], P))
        outs.append(_port_shade(tmat, scene, tvis_data, True, draws))
    (a, ga), (b, gb) = outs
    for k in OUTPUTS:
        assert np.abs(a[k] - b[k]).max() <= 1e-5, (k, np.abs(a[k] - b[k]).max())
    assert np.abs(ga - gb).max() <= 1e-5 * max(np.abs(ga).max(), 1.0)
