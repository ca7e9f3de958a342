"""Port parity: the NeRF-volume stack and the DreamFusion system against JAX.

Every case feeds the same numpy inputs, and the JAX package's random draws
by name, to both packages on the CPU at tiny size, with the weights carried
across by the weight bridge (``geometry_params_from_numpy``,
``volume_scene_from_numpy``):

- the implicit volume (density, features and each normal type; the density
  biases and activations), the background, both materials in every
  training mode and in evaluation, to relative 1e-5;
- ``ray_aabb``, the compositing weights, the occupancy refresh and the
  grid tightening, both estimators, ``render_rays`` (every output key, in
  training and evaluation, and the field's gradient through it) and the
  chunked ``render_image``, to relative 1e-5 (the gradient 1e-4: sums run
  in another order);
- ``marching_tets_grid``, exactly, on a sphere field;
- the rays-only datamodule: equal cameras, rays and lights per step and
  per eval view (1e-6 absolute: float32 camera maths in two frameworks);
- two ``configs/dreamfusion_tiny.yaml`` steps (``fit``): losses to relative
  1e-4, the scene's moves to relative L2 0.05 (Adam with eps 1e-15 turns
  rounding-level gradients into whole lr-sized steps);
- ``launch_torch.main`` on ``configs/dreamfusion_tiny.yaml`` with
  ``--device cpu``: its files, and ``--export --resume`` from its
  checkpoint; the volume entry points need CUDA unless the CPU is asked for.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreammat_tpu
import dreammat_tpu.data  # noqa: F401
import dreammat_tpu.models  # noqa: F401
import dreammat_tpu.systems  # noqa: F401
import dreammat_tpu_torch
import dreammat_tpu_torch.data  # noqa: F401
import dreammat_tpu_torch.models  # noqa: F401
import dreammat_tpu_torch.systems  # noqa: F401
from dreammat_tpu.models.diffusion import convert as jconvert
from dreammat_tpu.models.diffusion.unet import UNetConfig as JUNetConfig
from dreammat_tpu.models.prompt import PromptEmbeddings as JPromptEmbeddings
from dreammat_tpu.utils.config import load_config as jload
from dreammat_tpu_torch.models.diffusion.convert import (
    flax_to_torch_state_dict, geometry_params_from_numpy, volume_scene_from_numpy,
)
from dreammat_tpu_torch.models.prompt import PromptEmbeddings
from dreammat_tpu_torch.utils.config import load_config as tload

from test_torch_dreammat_step import _csv_losses, _np, _numpy_random_init, _rel
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401

RTOL = 1e-5
# finite-difference normals divide fp32 density differences by eps = 0.01,
# which scales the densities' rounding (~1e-6 of ~10) by 100
RTOL_FD_NORMAL = 1e-4
TINY_GRID = {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
             "log2_hashmap_size": 10, "base_resolution": 4, "per_level_scale": 1.5}


class GivenDraws:
    """The port's draws interface serving arrays by name: one dict, or one
    per step (``step`` set by ``fit``)."""

    def __init__(self, draws):
        self.draws = draws
        self.step = 0

    def _get(self, name, shape):
        d = self.draws[self.step] if isinstance(self.draws, list) else self.draws
        x = np.asarray(d[name])
        assert tuple(x.shape) == tuple(shape), (name, x.shape, shape)
        return torch.from_numpy(np.array(x))

    def uniform(self, name, shape):
        return self._get(name, shape)

    normal = uniform

    def integers(self, name, low, high, shape):
        return self._get(name, shape).long()


def _close(a, b, rtol=RTOL, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.abs(a - b).max() <= rtol * max(np.abs(b).max(), 1e-6), (what, np.abs(a - b).max())


def _geometries(normal_type="finite_difference", **over):
    cfg = {"radius": 1.0, "normal_type": normal_type, "pos_encoding_config": TINY_GRID,
           "mlp_network_config": {"n_neurons": 16, "n_hidden_layers": 1}, **over}
    jg = dreammat_tpu.find("implicit-volume")(cfg)
    tg = dreammat_tpu_torch.find("implicit-volume")(cfg, device="cpu")
    params = _np(jg.init(jax.random.PRNGKey(0)))
    # a table far from its U(-1e-4, 1e-4) init, so the encoding matters
    params["table"] = np.random.RandomState(1).normal(0, 0.5, params["table"].shape).astype(
        np.float32)
    field = tg.init(torch.Generator().manual_seed(0))
    field.load_state_dict(geometry_params_from_numpy(params), strict=True)
    return jg, tg, jax.tree_util.tree_map(jnp.asarray, params), field


def _points(n=48, seed=2, r=0.9):
    return np.random.RandomState(seed).uniform(-r, r, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("normal_type", ["finite_difference", "finite_difference_laplacian",
                                         "pred", "analytic"])
def test_implicit_volume_matches_jax(normal_type):
    jg, tg, jp, tf = _geometries(normal_type)
    pts = _points().reshape(6, 8, 3)
    jout = jax.jit(lambda p, x: jg.apply(p, x, output_normal=True))(jp, jnp.asarray(pts))
    tout = tg.apply(tf, torch.from_numpy(pts), output_normal=True)
    fd = normal_type.startswith("finite_difference")
    for key in ("density", "features", "normal", "shading_normal"):
        rtol = RTOL_FD_NORMAL if fd and "normal" in key else RTOL
        _close(tout[key].detach(), jout[key], rtol=rtol, what=key)
    _close(tg.forward_density(tf, torch.from_numpy(pts)).detach(),
           jg.forward_density(jp, jnp.asarray(pts)), what="forward_density")
    _close(tg.export(tf, torch.from_numpy(pts))["features"].detach(),
           jg.export(jp, jnp.asarray(pts))["features"], what="export")


@pytest.mark.parametrize("bias,activation", [("blob_magic3d", "softplus"),
                                             ("blob_dreamfusion", "exp"), (0.5, "none")])
def test_density_bias_and_activation_match_jax(bias, activation):
    jg, tg, jp, tf = _geometries(density_bias=bias, density_activation=activation)
    pts = _points(64, seed=3)
    _close(tg.forward_density(tf, torch.from_numpy(pts)).detach(),
           jg.forward_density(jp, jnp.asarray(pts)), what="density")


def test_background_matches_jax():
    jb = dreammat_tpu.find("neural-environment-map-background")({})
    tb = dreammat_tpu_torch.find("neural-environment-map-background")({}, device="cpu")
    params = _np(jb.init(jax.random.PRNGKey(4)))
    field = tb.init(torch.Generator().manual_seed(0))
    field.load_state_dict(geometry_params_from_numpy(params), strict=True)
    d = np.random.RandomState(5).normal(size=(40, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _close(tb(torch.from_numpy(d), field).detach(), jb(jnp.asarray(d), params), what="bg")


def _material_inputs(n=24, seed=6):
    rng = np.random.RandomState(seed)
    f = rng.normal(size=(n, 3)).astype(np.float32)
    pos = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    light = np.broadcast_to(np.float32([0.3, -1.5, 1.2]), (n, 3)).copy()
    return f, pos, nrm, light


def _key_for_mode(mode, diffuse_prob=0.75, textureless_prob=0.5):
    """A key whose shading draw picks ``mode`` (0 albedo, 1 textureless, 2 shaded)."""
    for i in range(100):
        k = jax.random.PRNGKey(i)
        u = np.asarray(jax.random.uniform(jax.random.split(k)[1], (2,)))
        m = 0 if u[0] > diffuse_prob else (1 if u[1] < textureless_prob else 2)
        if m == mode:
            return k
    raise AssertionError(mode)


@pytest.mark.parametrize("case", ["albedo", "textureless", "shaded", "ambient_window",
                                  "eval", "eval_ambient_window", "no_soft_shading"])
def test_diffuse_point_light_material_matches_jax(case):
    cfg = {"ambient_only_steps": 10, "soft_shading": case != "no_soft_shading"}
    jm = dreammat_tpu.find("diffuse-with-point-light-material")(cfg)
    tm = dreammat_tpu_torch.find("diffuse-with-point-light-material")(cfg, device="cpu")
    f, pos, nrm, light = _material_inputs()
    is_train = not case.startswith("eval")
    step = 3 if case in ("ambient_window", "eval_ambient_window") else 20
    mode = {"albedo": 0, "textureless": 1}.get(case, 2)
    k = _key_for_mode(mode)
    jout = jm(jnp.asarray(f), jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(light),
              rng=k if is_train else None, step=step, is_train=is_train)
    k_soft, k_shading = jax.random.split(k)
    draws = GivenDraws({"soft_shading": jax.random.uniform(k_soft, ()),
                        "shading_mode": jax.random.uniform(k_shading, (2,))})
    tout = tm(torch.from_numpy(f), torch.from_numpy(pos), torch.from_numpy(nrm),
              torch.from_numpy(light), draws=draws if is_train else None, step=step,
              is_train=is_train)
    _close(tout, jout, what=case)
    _close(tm.export(torch.from_numpy(f))["albedo"], jm.export(jnp.asarray(f))["albedo"])


@pytest.mark.parametrize("is_train", [True, False])
def test_no_material_matches_jax(is_train):
    jm = dreammat_tpu.find("no-material")({})
    tm = dreammat_tpu_torch.find("no-material")({}, device="cpu")
    f = _material_inputs()[0]
    _close(tm(torch.from_numpy(f), is_train=is_train), jm(jnp.asarray(f), is_train=is_train))
    _close(tm.export(torch.from_numpy(f))["albedo"], jm.export(jnp.asarray(f))["albedo"])


def test_marching_tets_grid_equals_jax():
    from dreammat_tpu.ops.marching import marching_tets_grid as jmarch
    from dreammat_tpu_torch.ops.marching import marching_tets_grid as tmarch

    xs = np.linspace(-1, 1, 21).astype(np.float32)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1)
    field = 0.6 - np.linalg.norm(g, axis=-1) + 0.05 * np.sin(7 * g[..., 0])
    (jv, jf), (tv, tf) = jmarch(field, xs), tmarch(field, xs)
    assert len(tf) > 100
    assert np.array_equal(tv, jv) and np.array_equal(tf, jf)


# -- the renderer ------------------------------------------------------------
@pytest.fixture(scope="module")
def rig():
    """Both renderers over the same field, diffuse material and background."""
    jg, tg, jp, tf = _geometries("finite_difference")
    mcfg = {"ambient_only_steps": 0, "soft_shading": True}
    jm = dreammat_tpu.find("diffuse-with-point-light-material")(mcfg)
    tm = dreammat_tpu_torch.find("diffuse-with-point-light-material")(mcfg, device="cpu")
    jb = dreammat_tpu.find("neural-environment-map-background")({})
    tb = dreammat_tpu_torch.find("neural-environment-map-background")({}, device="cpu")
    bp = _np(jb.init(jax.random.PRNGKey(4)))
    bfield = tb.init(torch.Generator().manual_seed(0))
    bfield.load_state_dict(geometry_params_from_numpy(bp), strict=True)
    rcfg = {"radius": 1.0, "num_samples_per_ray": 16, "grid_resolution": 8,
            "num_samples_per_ray_importance": 12}
    jr = dreammat_tpu.find("nerf-volume-renderer")(rcfg, jg, jm, jb)
    tr = dreammat_tpu_torch.find("nerf-volume-renderer")(rcfg, tg, tm, tb, device="cpu")
    jri = dreammat_tpu.find("nerf-volume-renderer")({**rcfg, "estimator": "importance"},
                                                    jg, jm, jb)
    tri = dreammat_tpu_torch.find("nerf-volume-renderer")(
        {**rcfg, "estimator": "importance", "return_normal_perturb": True}, tg, tm, tb,
        device="cpu")
    # an occupancy grid with empty cells, after one refresh
    k_occ = jax.random.PRNGKey(11)
    state = jr.update_occ(jp, {"occ": jnp.zeros((8, 8, 8))}, k_occ)
    occ = torch.from_numpy(np.array(state["occ"]))
    return dict(jg=jg, tg=tg, jp=jp, tf=tf, jr=jr, tr=tr, jri=jri, tri=tri,
                bp=jax.tree_util.tree_map(jnp.asarray, bp), bfield=bfield, state=state,
                occ=occ, k_occ=k_occ)


def _rays(n=20, seed=8):
    rng = np.random.RandomState(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = 2.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    target = rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[0] = -o[0] / 2.0 + np.float32([0.0, 0.9, 0.0])  # one ray that misses the box
    d[0] /= np.linalg.norm(d[0])
    light = np.broadcast_to(np.float32([1.0, 2.0, 1.5]), (n, 3)).copy()
    return o, d.astype(np.float32), light


def test_ray_aabb_weights_occupancy_and_tightening_match_jax(rig):
    from dreammat_tpu.models.volume_renderer import ray_aabb as jaabb
    from dreammat_tpu_torch.models.volume_renderer import ray_aabb as taabb

    jr, tr = rig["jr"], rig["tr"]
    o, d, _ = _rays()
    lo, hi = np.float32([-1] * 3), np.float32([1] * 3)
    (jt0, jt1), (tt0, tt1) = jaabb(o, d, lo, hi), taabb(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(lo), torch.from_numpy(hi))
    _close(tt0, jt0), _close(tt1, jt1)
    assert float(jt1[0]) <= float(jt0[0]) and (np.asarray(jt1[1:]) > np.asarray(jt0[1:])).all()

    rng = np.random.RandomState(9)
    sigma = rng.uniform(0, 20, (6, 10)).astype(np.float32)
    delta = rng.uniform(0.01, 0.1, (6, 10)).astype(np.float32)
    _close(tr._weights(torch.from_numpy(sigma), torch.from_numpy(delta)),
           jr._weights(jnp.asarray(sigma), jnp.asarray(delta)), what="weights")

    # the refresh: from the rig's grid, with the JAX draw of its key
    k = jax.random.PRNGKey(12)
    jocc = jr.update_occ(rig["jp"], rig["state"], k)["occ"]
    tocc = tr.update_occ(rig["tf"], rig["occ"], GivenDraws(
        {"occ_jitter": jax.random.uniform(k, (512, 3))}))
    _close(tocc, jocc, what="occ")
    occ_bin = np.asarray(jocc) > jr.cfg.occ_threshold
    assert 0 < occ_bin.sum() < occ_bin.size  # some cells empty, some not
    jn0, jn1 = jr._tighten_by_grid(jnp.asarray(occ_bin), jnp.asarray(o), jnp.asarray(d),
                                   jt0, jt1)
    tn0, tn1 = tr._tighten_by_grid(torch.from_numpy(occ_bin), torch.from_numpy(o),
                                   torch.from_numpy(d), tt0, tt1)
    _close(tn0, jn0, what="t0"), _close(tn1, jn1, what="t1")


def test_estimators_match_jax(rig):
    jr, tr = rig["jr"], rig["tr"]
    rng = np.random.RandomState(10)
    t0 = rng.uniform(0.5, 1.0, 7).astype(np.float32)
    t1 = t0 + rng.uniform(0.5, 1.5, 7).astype(np.float32)
    k = jax.random.PRNGKey(13)
    for randomized in (True, False):
        js = jr._stratified(k, jnp.asarray(t0), jnp.asarray(t1), 9, randomized)
        ts = tr._stratified(GivenDraws({"s": jax.random.uniform(k, (7, 9))}), "s",
                            torch.from_numpy(t0), torch.from_numpy(t1), 9, randomized)
        _close(ts, js, what=f"stratified {randomized}")
    tc = np.array(js)
    wc = rng.uniform(0, 1, (7, 9)).astype(np.float32)
    ji = jr._importance_resample(k, jnp.asarray(tc), jnp.asarray(wc), jnp.asarray(t0),
                                 jnp.asarray(t1), 11)
    ti = tr._importance_resample(GivenDraws({"ray_importance": jax.random.uniform(k, (7, 11))}),
                                 torch.from_numpy(tc), torch.from_numpy(wc),
                                 torch.from_numpy(t0), torch.from_numpy(t1), 11)
    _close(ti, ji, what="importance")
    assert (np.diff(np.asarray(ti), axis=1) >= 0).all()


def _render_draws(k, N, S, Sc, perturb=False):
    k_strat, k_coarse, k_imp, k_mat, k_perturb = jax.random.split(k, 5)
    k_soft, k_shading = jax.random.split(k_mat)
    d = {"ray_strat": jax.random.uniform(k_strat, (N, S)),
         "ray_coarse": jax.random.uniform(k_coarse, (N, Sc)),
         "ray_importance": jax.random.uniform(k_imp, (N, S)),
         "soft_shading": jax.random.uniform(k_soft, ()),
         "shading_mode": jax.random.uniform(k_shading, (2,))}
    if perturb:
        d["normal_perturb"] = jax.random.normal(k_perturb, (N, S, 3))
    return d


RENDER_KEYS = ("comp_rgb", "comp_rgb_fg", "comp_rgb_bg", "opacity", "depth", "z_variance",
               "weights", "t_points", "t_dirs", "points", "density", "normal", "comp_normal")


@pytest.mark.parametrize("estimator,is_train", [("occgrid", True), ("occgrid", False),
                                                ("importance", True), ("importance", False)])
def test_render_rays_matches_jax(rig, estimator, is_train):
    jr, tr = (rig["jr"], rig["tr"]) if estimator == "occgrid" else (rig["jri"], rig["tri"])
    o, d, light = _rays()
    k = jax.random.PRNGKey(14)
    step = 7
    jout = jax.jit(lambda gp, bp, st, o_, d_, l_: jr.render_rays(
        gp, bp, st, o_, d_, l_, k, step=step, is_train=is_train))(
        rig["jp"], rig["bp"], rig["state"], jnp.asarray(o), jnp.asarray(d), jnp.asarray(light))
    draws = GivenDraws(_render_draws(k, len(o), 16, 12, perturb=is_train))
    tout = tr.render_rays(rig["tf"], rig["bfield"], rig["occ"], torch.from_numpy(o),
                          torch.from_numpy(d), torch.from_numpy(light), draws, step=step,
                          is_train=is_train)
    for key in RENDER_KEYS:
        _close(tout[key].detach(), jout[key], what=key,
               rtol=RTOL_FD_NORMAL if "normal" in key else RTOL)
    assert float(jout["opacity"].max()) > 0.5 and float(jout["opacity"][0, 0]) == 0.0
    if estimator == "importance" and is_train:
        # the JAX renderer has the perturbed normals only with the option on
        assert "normal_perturb" in tout and tout["normal_perturb"].shape == tout["normal"].shape


def test_render_rays_gradient_matches_jax(rig):
    """d sum(comp_rgb * c) / d (field, background) through the occupancy
    estimator in training: the density, the finite-difference normals,
    the material and the compositing."""
    jr, tr = rig["jr"], rig["tr"]
    o, d, light = _rays()
    c = np.random.RandomState(15).normal(size=(len(o), 3)).astype(np.float32)
    k = jax.random.PRNGKey(16)

    def jloss(gp, bp):
        out = jr.render_rays(gp, bp, rig["state"], jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(light), k, step=7, is_train=True)
        return jnp.sum(out["comp_rgb"] * c) + jnp.sum(out["normal"][..., 0] * out["weights"])

    jgeo, jbg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(rig["jp"], rig["bp"])
    tf, bfield = rig["tf"], rig["bfield"]
    for p in list(tf.parameters()) + list(bfield.parameters()):
        p.grad = None
    out = tr.render_rays(tf, bfield, rig["occ"], torch.from_numpy(o), torch.from_numpy(d),
                         torch.from_numpy(light), GivenDraws(_render_draws(k, len(o), 16, 12)),
                         step=7, is_train=True)
    (torch.sum(out["comp_rgb"] * torch.from_numpy(c))
     + torch.sum(out["normal"][..., 0] * out["weights"])).backward()
    for ref, module in ((geometry_params_from_numpy(_np(jgeo)), tf),
                        (geometry_params_from_numpy(_np(jbg)), bfield)):
        for name, p in module.named_parameters():
            assert _rel(p.grad.numpy(), ref[name].numpy()) < 1e-4, name
    assert float(jnp.abs(jgeo["table"]).max()) > 0


def test_render_image_matches_jax(rig):
    """An eval view in chunks of 24 rays (the last one short)."""
    jr, tr = rig["jr"], rig["tr"]
    jr.cfg.eval_chunk_rays = tr.cfg.eval_chunk_rays = 24
    from dreammat_tpu.data.cameras import camera_rays_and_matrices as jcam
    from dreammat_tpu.data.cameras import make_eval_cameras

    cd = jcam(make_eval_cameras(4, 20.0, 2.0, 60.0), 1, 10, 10)
    ro, rd = np.array(cd["rays_o"]), np.array(cd["rays_d"])
    lp = np.array(cd["camera_position"]).reshape(3)
    jout = jax.jit(lambda gp, bp, st, ro_, rd_, lp_: jr.render_image(
        gp, bp, st, ro_, rd_, lp_, jax.random.PRNGKey(0), step=7))(
        rig["jp"], rig["bp"], rig["state"], jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(lp))
    tout = tr.render_image(rig["tf"], rig["bfield"], rig["occ"], torch.from_numpy(ro),
                           torch.from_numpy(rd), torch.from_numpy(lp), None, step=7)
    assert sorted(tout) == sorted(jout) == ["comp_normal", "comp_rgb", "depth", "opacity"]
    for key in jout:
        _close(tout[key], jout[key], what=key, rtol=RTOL_FD_NORMAL if "normal" in key else RTOL)


# -- the datamodule ----------------------------------------------------------
@pytest.mark.parametrize("strategy", ["dreamfusion", "magic3d"])
def test_rays_only_datamodule_matches_jax(rig, strategy):
    over = {"width": 12, "height": 10, "eval_width": 8, "eval_height": 6,
            "camera_distance_range": [1.5, 2.0], "camera_perturb": 0.1, "center_perturb": 0.1,
            "up_perturb": 0.05, "progressive_until": 2, "light_sample_strategy": strategy,
            "n_test_views": 3, "use_fix_views": False}
    jdm = dreammat_tpu.find("random-camera-datamodule")(over, rig["jr"], None)
    tdm = dreammat_tpu_torch.find("random-camera-datamodule")(over, rig["tr"], None,
                                                              device="cpu")
    jdm.setup(), tdm.setup()
    for step in range(3):
        jb, tb = jdm.collate(step), tdm.collate(step)
        for key in ("c2w", "rays_o", "rays_d", "light_positions", "elevation", "azimuth",
                    "camera_distances"):
            a, b = np.asarray(tb[key]), np.asarray(jb[key])
            assert a.shape == b.shape and np.abs(a - b).max() <= 1e-6, (step, key)
        assert (tb["height"], tb["width"]) == (jb["height"], jb["width"]) == (10, 12)
    for i in range(3):
        jb, tb = jdm.eval_rays(i), tdm.eval_rays(i)
        for key in ("rays_o", "rays_d", "light_position", "elevation", "azimuth"):
            a, b = np.asarray(tb[key]), np.asarray(jb[key]).reshape(np.asarray(tb[key]).shape)
            assert np.abs(a - b).max() <= 1e-6, (i, key)


# -- the system --------------------------------------------------------------
SEED = 0
DF_OVERRIDES = ["system.prompt_processor.prompt=a red apple",
                "system.prompt_processor.use_cache=false"]


def _given_prompt_embeddings(seed=7):
    rng = np.random.RandomState(seed)
    N, D = 16, JUNetConfig.tiny().cross_attention_dim
    shapes = {"text_vd": (4, N, D), "uncond_vd": (4, N, D), "text": (N, D), "uncond": (N, D),
              "null": (N, D)}
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


def volume_pair(config, overrides, system_type):
    """The JAX and the port system of ``config`` with the same guidance
    weights and prompt embeddings; the JAX initial state."""
    jcfg, tcfg = jload(config, overrides), tload(config, overrides)
    k_init, k_guidance, _ = jax.random.split(jax.random.PRNGKey(SEED), 3)
    jsys = dreammat_tpu.find(system_type)(jcfg.system)
    jdm = dreammat_tpu.find(jcfg.data_type)(jcfg.data, jsys.renderer, jsys.material)
    jdm.setup()
    emb = _given_prompt_embeddings()
    jsys.prompt_processor = "given"
    jsys.prompt_utils = JPromptEmbeddings(**{k: jnp.asarray(v) for k, v in emb.items()})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconvert, "fast_random_init", _numpy_random_init)
        jsys.on_fit_start(k_guidance)
    tsys = dreammat_tpu_torch.find(system_type)(tcfg.system, device="cpu")
    tdm = dreammat_tpu_torch.find(tcfg.data_type)(tcfg.data, tsys.renderer, tsys.material,
                                                  device="cpu")
    tdm.setup()
    tsys.prompt_processor = "given"
    tsys.prompt_utils = PromptEmbeddings(**{k: torch.from_numpy(v) for k, v in emb.items()})
    tsys.on_fit_start(SEED)
    gp = _np(jsys.guidance.params)
    tsys.guidance.unet.load_state_dict(flax_to_torch_state_dict(gp["unet"], "unet"),
                                       strict=not hasattr(tsys.guidance, "init_lora"))
    tsys.guidance.vae.load_state_dict(flax_to_torch_state_dict(gp["vae"], "vae"), strict=True)
    return jsys, jdm, tsys, tdm, _np(jsys.init_state(k_init))


def step_draws(jsys, n_steps, N, S, lat_hw, vsd=False):
    """The draws of each step of the JAX ``fit`` (its keys split as there),
    in the port's layout (latent draws NHWC -> NCHW)."""
    nchw = lambda x: np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1))
    rng = jax.random.split(jax.random.PRNGKey(SEED), 3)[2]
    G = jsys.renderer.cfg.grid_resolution
    every = max(jsys.renderer.cfg.grid_update_every, 1)
    out = []
    for it in range(n_steps):
        rng, k = jax.random.split(rng)
        k_render, k_guide = jax.random.split(k)
        d = _render_draws(k_render, N, S, jsys.renderer.cfg.num_samples_per_ray_importance)
        if it % every == 0:
            d["occ_jitter"] = jax.random.uniform(jax.random.fold_in(k, 0x0CC), (G ** 3, 3))
        lat = (1, *lat_hw, 4)
        keys = jax.random.split(k_guide, 6 if vsd else 3)
        d.update(vae_eps=nchw(jax.random.normal(keys[0], lat)),
                 t=jax.random.uniform(keys[1], (1,)), noise=nchw(jax.random.normal(keys[2], lat)))
        if vsd:
            T = jsys.guidance.num_train_timesteps
            d.update(t2=jax.random.randint(keys[3], (1,), 0, T),
                     noise2=nchw(jax.random.normal(keys[4], lat)),
                     camera_drop=jax.random.uniform(keys[5], (1, 1)))
        out.append(d)
    return out


def scene_moves(jstate, state0, tsys):
    """(port, JAX) moves of every scene parameter after training."""
    j1 = volume_scene_from_numpy(_np(jstate["geo"]), _np(jstate["bg"]),
                                 jstate["render"]["occ"])
    j0 = volume_scene_from_numpy(state0["geo"], state0["bg"], state0["render"]["occ"])
    return {name: ((p.detach() - j0[name]).numpy(), (j1[name] - j0[name]).numpy())
            for name, p in tsys.field.named_parameters()}


def test_dreamfusion_two_steps_match_jax(tmp_path):
    jsys, jdm, tsys, tdm, state0 = volume_pair("configs/dreamfusion_tiny.yaml", DF_OVERRIDES,
                                               "dreamfusion-system")
    assert type(tsys.guidance).__name__ == "StableDiffusionGuidance"
    jstate = jsys.fit(jdm, max_steps=2, seed=SEED, trial_dir=str(tmp_path / "jax"),
                      val_check_interval=0, checkpoint_every=0, log_every=1)
    tsys.init_state(SEED)
    tsys.field.load_state_dict(volume_scene_from_numpy(state0["geo"], state0["bg"],
                                                       state0["render"]["occ"]), strict=True)
    f = tsys.guidance.vae_factor
    h, w = tdm.cfg.height, tdm.cfg.width
    draws = GivenDraws(step_draws(jsys, 2, h * w, tsys.renderer.cfg.num_samples_per_ray,
                                  (h // f, w // f)))
    out = tsys.fit(tdm, max_steps=2, seed=SEED, trial_dir=str(tmp_path / "torch"),
                   log_every=1, val_check_interval=0, checkpoint_every=0, draws=draws)
    assert out["step"] == 2 and tsys.step_kinds == ["volume", "volume"]
    jl = _csv_losses(os.path.join(tmp_path, "jax", "logs", "metrics.csv"))
    tl = _csv_losses(os.path.join(tmp_path, "torch", "logs", "metrics.csv"))
    assert len(jl) == len(tl) == 2 and np.allclose(tl, jl, rtol=1e-4, atol=0), (tl, jl)
    # the occupancy grid was refreshed at step 0 as in the JAX fit
    _close(tsys.field.occ, jstate["render"]["occ"], what="occ")
    for name, (moved_t, moved_j) in scene_moves(jstate, state0, tsys).items():
        assert np.abs(moved_t).max() > 0, name
        assert _rel(moved_t, moved_j) < 0.05, name


def test_launch_torch_dreamfusion_tiny_on_cpu(tmp_path):
    import launch_torch

    args = ["--config", "configs/dreamfusion_tiny.yaml", "--device", "cpu",
            "system.prompt_processor.prompt=a red apple",
            "system.prompt_processor.use_cache=false", "data.n_test_views=2",
            "checkpoint.every_n_train_steps=2", f"exp_root_dir={tmp_path}"]
    out = launch_torch.main(["--train", *args])
    system, trial = out["system"], out["trial_dir"]
    assert type(system).__name__ == "DreamFusion"
    assert type(system.renderer).__name__ == "NeRFVolumeRenderer"
    assert len(system.step_losses) == 2 and all(np.isfinite(system.step_losses))
    save = os.path.join(trial, "save")
    for rel in ("it2-test/0.png", "it2-test/1.png", "it2-test.gif", "export/model.obj"):
        assert os.path.getsize(os.path.join(save, rel)) > 0, rel
    with open(os.path.join(save, "export", "model.obj")) as fh:
        lines = fh.read().splitlines()
    vs = [ln.split() for ln in lines if ln.startswith("v ")]
    assert len(vs) > 100 and all(len(v) == 7 for v in vs)
    assert sum(ln.startswith("f ") for ln in lines) > 100
    os.remove(os.path.join(save, "export", "model.obj"))
    ckpt = os.path.join(trial, "ckpts", "step000002.pt")
    res = launch_torch.main(["--export", "--resume", ckpt, *args])
    assert res["system"].global_step == 2
    assert os.path.getsize(os.path.join(save, "export", "model.obj")) > 0
    for name, p in res["system"].field.state_dict().items():
        assert torch.equal(p, system.field.state_dict()[name]), name


@pytest.mark.parametrize("entry", ["dreamfusion_system", "volume_renderer", "volume_geometry"])
def test_volume_entry_points_need_cuda_unless_cpu_is_asked_for(entry):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    cfg = tload("configs/dreamfusion_tiny.yaml", DF_OVERRIDES)
    find = dreammat_tpu_torch.find
    cpu = find("dreamfusion-system")(cfg.system, device="cpu")
    build = {
        "dreamfusion_system": lambda **kw: find("dreamfusion-system")(cfg.system, **kw),
        "volume_renderer": lambda **kw: find("nerf-volume-renderer")(
            cfg.system["renderer"], cpu.geometry, cpu.material, cpu.background, **kw),
        "volume_geometry": lambda **kw: find("implicit-volume")(cfg.system["geometry"], **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        build()
    assert build(device="cpu").device.type == "cpu"
