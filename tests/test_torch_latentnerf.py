"""Port parity: the rest of the NeRF-volume family (Latent-NeRF, SJC) against JAX.

Every case feeds the same numpy inputs, and the JAX package's random draws
by name, to both packages on the CPU at tiny size, with the weights carried
across by the weight bridge (``geometry_params_from_numpy``,
``volume_scene_from_numpy``):

- the textured background and its texture's gradient, the three materials
  (``hybrid-rgb-latent-material``, ``sd-latent-adapter-material``,
  ``neural-radiance-material`` at every SH degree), to relative 1e-5;
- ``volume-grid``: density, features and each normal type, and the
  gradient of the grids and the density scale (relative 1e-4: finite
  differences divide by eps = 0.01; sums run in another order);
- the sketch-shape guide: the baked winding and weight grids to 1e-5
  absolute, ``shape_loss`` and its gradient to relative 1e-5;
- the patch renderer in training with the JAX offset and draws injected
  (every output key; its gradient is the Latent-NeRF step's), and in evaluation, where
  it hands the rays to the base renderer (equal to it);
- ``custom-mesh``, the DreamMat mesh geometry under a second name;
- one step of ``latentnerf-system`` (latent, through the patch renderer,
  with a guide shape), of its ``refinement`` (RGB with the VAE encode and
  ``sd-latent-adapter-material``) and of ``sjc-system`` (a ``volume-grid``
  and a ``textured-background``): losses to relative 1e-4, the scene's
  moves to relative L2 0.05 (Adam with eps 1e-15 turns rounding-level
  gradients into whole lr-sized steps); the latent eval decoded at the
  render's own size;
- the entry points need CUDA unless the CPU is asked for.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreammat_tpu
import dreammat_tpu_torch
from dreammat_tpu_torch.models.diffusion.convert import (
    geometry_params_from_numpy, volume_scene_from_numpy,
)
from dreammat_tpu_torch.utils.config import load_config as tload

from test_torch_dreammat_step import _csv_losses, _np, _rel
from test_torch_volume import (
    SEED, TINY_GRID, GivenDraws, _close, _geometries, _render_draws, scene_moves,
    volume_pair,
)
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401

RTOL = 1e-5
RTOL_FD = 1e-4


def _dirs(n=40, seed=5):
    d = np.random.RandomState(seed).normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("activation", ["sigmoid", "none"])
def test_textured_background_and_its_gradient_match_jax(activation):
    cfg = {"n_output_dims": 4, "height": 8, "width": 12, "color_activation": activation}
    jb = dreammat_tpu.find("textured-background")(cfg)
    tb = dreammat_tpu_torch.find("textured-background")(cfg, device="cpu")
    params = _np(jb.init(jax.random.PRNGKey(4)))
    field = tb.init(torch.Generator().manual_seed(0))
    field.load_state_dict(geometry_params_from_numpy(params), strict=True)
    d = _dirs()
    d[0] = [0.0, 0.0, 1.0]   # the pole (u clamped)
    d[1] = [-1.0, 1e-7, 0.0]  # the seam of v
    c = np.random.RandomState(6).normal(size=(40, 4)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jout = jb(jnp.asarray(d), jp)
    jgrad = jax.grad(lambda p: jnp.sum(jb(jnp.asarray(d), p) * c))(jp)
    tout = tb(torch.from_numpy(d), field)
    (tout * torch.from_numpy(c)).sum().backward()
    _close(tout.detach(), jout, what="bg")
    _close(field.texture.grad, jgrad["texture"], what="grad")


def _features(n=24, c=8, seed=6):
    return np.random.RandomState(seed).normal(size=(n, c)).astype(np.float32)


@pytest.mark.parametrize("activation", ["sigmoid", "scale_-11_01", "none"])
def test_hybrid_rgb_latent_material_matches_jax(activation):
    cfg = {"n_output_dims": 7, "color_activation": activation}
    jm = dreammat_tpu.find("hybrid-rgb-latent-material")(cfg)
    tm = dreammat_tpu_torch.find("hybrid-rgb-latent-material")(cfg, device="cpu")
    f = _features()
    assert tm.requires_normal == jm.requires_normal
    _close(tm(torch.from_numpy(f)), jm(jnp.asarray(f)))
    _close(tm.export(torch.from_numpy(f))["albedo"], jm.export(jnp.asarray(f))["albedo"])


def test_sd_latent_adapter_material_matches_jax():
    jm = dreammat_tpu.find("sd-latent-adapter-material")({})
    tm = dreammat_tpu_torch.find("sd-latent-adapter-material")({}, device="cpu")
    f = _features(c=4) * 2
    _close(tm(torch.from_numpy(f)), jm(jnp.asarray(f)))
    _close(tm.export(torch.from_numpy(f))["albedo"], jm.export(jnp.asarray(f))["albedo"])


@pytest.mark.parametrize("sh_degree", [1, 2, 3, 4])
def test_neural_radiance_material_matches_jax(sh_degree):
    cfg = {"input_feature_dims": 5, "sh_degree": sh_degree, "seed": 3}
    jm = dreammat_tpu.find("neural-radiance-material")(cfg)
    tm = dreammat_tpu_torch.find("neural-radiance-material")(cfg, device="cpu")
    tm.field.load_state_dict(geometry_params_from_numpy({"mlp": _np(jm.params)}), strict=True)
    f, d = _features(c=6), _dirs(24)
    _close(tm(torch.from_numpy(f), viewdirs=torch.from_numpy(d)),
           jm(jnp.asarray(f), viewdirs=jnp.asarray(d)))
    _close(tm.export(torch.from_numpy(f))["albedo"], jm.export(jnp.asarray(f))["albedo"])
    with pytest.raises(ValueError, match="viewdirs"):
        tm(torch.from_numpy(f))


# -- the volume grid ---------------------------------------------------------
def _grids(normal_type):
    cfg = {"grid_size": [6, 7, 8], "n_feature_dims": 3, "normal_type": normal_type}
    jg = dreammat_tpu.find("volume-grid")(cfg)
    tg = dreammat_tpu_torch.find("volume-grid")(cfg, device="cpu")
    params = _np(jg.init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(1)
    params["grid"] = rng.normal(0, 2.0, params["grid"].shape).astype(np.float32)
    params["density_scale"] = np.float32(0.3)
    if "normal_grid" in params:
        params["normal_grid"] = rng.normal(size=params["normal_grid"].shape).astype(np.float32)
    field = tg.init(torch.Generator().manual_seed(0))
    field.load_state_dict(geometry_params_from_numpy(params), strict=True)
    return jg, tg, jax.tree_util.tree_map(jnp.asarray, params), field


@pytest.mark.parametrize("normal_type", ["finite_difference", "finite_difference_laplacian",
                                         "pred"])
def test_volume_grid_and_its_gradient_match_jax(normal_type):
    jg, tg, jp, tf = _grids(normal_type)
    pts = np.random.RandomState(2).uniform(-1.05, 1.05, (6, 8, 3)).astype(np.float32)
    rng = np.random.RandomState(3)
    cd, cf, cn = (rng.normal(size=(6, 8, k)).astype(np.float32) for k in (1, 3, 3))

    def jloss(p):
        o = jg.apply(p, jnp.asarray(pts), output_normal=True)
        return jnp.sum(o["density"] * cd) + jnp.sum(o["features"] * cf) + jnp.sum(
            o["normal"] * cn)

    jout = jax.jit(lambda p: jg.apply(p, jnp.asarray(pts), output_normal=True))(jp)
    jgrad = _np(jax.jit(jax.grad(jloss))(jp))
    tout = tg.apply(tf, torch.from_numpy(pts), output_normal=True)
    (torch.sum(tout["density"] * torch.from_numpy(cd))
     + torch.sum(tout["features"] * torch.from_numpy(cf))
     + torch.sum(tout["normal"] * torch.from_numpy(cn))).backward()
    fd = normal_type != "pred"
    for key in ("density", "features", "normal", "shading_normal"):
        _close(tout[key].detach(), jout[key], rtol=RTOL_FD if fd and "normal" in key else RTOL,
               what=key)
    ref = geometry_params_from_numpy(jgrad)
    for name, p in tf.named_parameters():
        assert _rel(p.grad.numpy(), ref[name].numpy()) < RTOL_FD, name
    _close(tg.forward_density(tf, torch.from_numpy(pts)).detach(),
           jg.forward_density(jp, jnp.asarray(pts)), what="forward_density")
    _close(tg.export(tf, torch.from_numpy(pts))["features"].detach(),
           jg.export(jp, jnp.asarray(pts))["features"], what="export")


# -- the sketch-shape guide --------------------------------------------------
def test_shape_grid_and_shape_loss_match_jax():
    from dreammat_tpu.ops import shape_loss as jshape
    from dreammat_tpu_torch.models.mesh import torus_arrays
    from dreammat_tpu_torch.ops import shape_loss as tshape

    v, f = torus_arrays(nu=12, nv=6)
    jgrid = jshape.build_shape_grid(v, f, resolution=12)
    tgrid = tshape.build_shape_grid(v, f, resolution=12, device="cpu")
    wind = np.asarray(jgrid.winding)
    assert 0 < (wind > 0.5).sum() < wind.size
    assert np.abs(tgrid.winding.numpy() - wind).max() <= 1e-5
    assert np.abs(tgrid.weight.numpy() - np.asarray(jgrid.weight)).max() <= 1e-5
    rng = np.random.RandomState(4)
    pts = rng.uniform(-1.1, 1.1, (10, 9, 3)).astype(np.float32)
    dens = rng.uniform(0, 30, (10, 9)).astype(np.float32)
    jl, jg = jax.value_and_grad(lambda d: jshape.shape_loss(jnp.asarray(pts), d, jgrid))(
        jnp.asarray(dens))
    td = torch.from_numpy(dens).requires_grad_(True)
    tl = tshape.shape_loss(torch.from_numpy(pts), td, tgrid)
    tl.backward()
    _close(tl.detach(), jl, what="loss")
    _close(td.grad, jg, what="grad")
    # a trailing channel is the same
    _close(tshape.shape_loss(torch.from_numpy(pts), td.detach()[..., None], tgrid), jl)


# -- the patch renderer ------------------------------------------------------
@pytest.fixture(scope="module")
def patch_rig():
    jg, tg, jp, tf = _geometries("finite_difference")
    mcfg = {"n_output_dims": 3, "color_activation": "sigmoid"}
    jm = dreammat_tpu.find("no-material")(mcfg)
    tm = dreammat_tpu_torch.find("no-material")(mcfg, device="cpu")
    bcfg = {"n_output_dims": 3, "color": [0.2, 0.5, 0.9]}
    jb = dreammat_tpu.find("solid-color-background")(bcfg)
    tb = dreammat_tpu_torch.find("solid-color-background")(bcfg, device="cpu")
    rcfg = {"patch_size": 8, "global_downsample": 4,
            "base_renderer": {"radius": 1.0, "num_samples_per_ray": 12, "grid_resolution": 8,
                              "eval_chunk_rays": 64}}
    jr = dreammat_tpu.find("patch-renderer")(rcfg, jg, jm, jb)
    tr = dreammat_tpu_torch.find("patch-renderer")(rcfg, tg, tm, tb, device="cpu")
    state = jax.jit(jr.update_occ)(jp, jr.init_state(jax.random.PRNGKey(1)),
                                   jax.random.PRNGKey(11))
    from dreammat_tpu.data.cameras import camera_rays_and_matrices as jcam
    from dreammat_tpu.data.cameras import make_eval_cameras

    cd = jcam(make_eval_cameras(4, 20.0, 2.0, 60.0), 1, 18, 18)
    ro, rd = np.array(cd["rays_o"]), np.array(cd["rays_d"])
    lp = np.array(cd["camera_position"]).reshape(3)
    return dict(jr=jr, tr=tr, jp=jp, tf=tf, state=state,
                occ=torch.from_numpy(np.array(state["occ"])), ro=ro, rd=rd, lp=lp)


def patch_draws(k, H, W, PS, ds, S, Sc=64):
    """The JAX patch renderer's draws of ``render_rays(rng=k)`` by name."""
    k_off, k_g, k_p = jax.random.split(k, 3)
    Ng = len(range(ds // 2, H, ds)) * len(range(ds // 2, W, ds))
    d = {"global/" + n: v for n, v in _render_draws(k_g, Ng, S, Sc).items()}
    d.update({"patch/" + n: v for n, v in _render_draws(k_p, PS * PS, S, Sc).items()})
    d["patch_y"] = jax.random.randint(k_off, (), 0, H - PS + 1)
    d["patch_x"] = jax.random.randint(jax.random.fold_in(k_off, 1), (), 0, W - PS + 1)
    return d


def test_patch_renderer_merge_matches_jax(patch_rig):
    r = patch_rig
    ro, rd = r["ro"].reshape(-1, 3), r["rd"].reshape(-1, 3)
    lp = np.broadcast_to(r["lp"], ro.shape).copy()
    for i in range(40):  # a key whose patch is off the origin in both axes
        k = jax.random.PRNGKey(100 + i)
        d = patch_draws(k, 18, 18, 8, 4, 12)
        if 0 < int(d["patch_y"]) < 10 and 0 < int(d["patch_x"]) < 10:
            break
    jout = jax.jit(lambda gp: r["jr"].render_rays(
        gp, {}, r["state"], jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(lp), k, step=3,
        is_train=True))(r["jp"])
    tout = r["tr"].render_rays(r["tf"], None, r["occ"], torch.from_numpy(ro),
                               torch.from_numpy(rd), torch.from_numpy(lp), GivenDraws(d), step=3,
                               is_train=True)
    assert sorted(tout) == sorted(jout)
    for key in jout:
        _close(tout[key].detach(), jout[key], what=key, rtol=RTOL_FD if "normal" in key else RTOL)
    assert tout["comp_rgb"].shape == (18 * 18, 3) and tout["weights"].shape == (16, 12)
    # the knobs of the occupancy refresh come from the base renderer
    assert (r["tr"].cfg.estimator, r["tr"].cfg.grid_update_every) == ("occgrid", 16)


def test_patch_renderer_evaluation_is_the_base_renderers(patch_rig):
    """Evaluation goes to the base renderer, whose parity with the JAX one
    ``tests/test_torch_volume.py`` holds (the JAX patch renderer delegates
    the same way)."""
    r = patch_rig
    args = (r["tf"], None, r["occ"], torch.from_numpy(r["ro"]), torch.from_numpy(r["rd"]),
            torch.from_numpy(r["lp"]), None)
    tout, base = r["tr"].render_image(*args, step=3), r["tr"].base.render_image(*args, step=3)
    assert sorted(tout) == sorted(base) == ["comp_rgb", "depth", "opacity"]
    for key in tout:
        assert torch.equal(tout[key], base[key]), key
    n = 20
    rays = [torch.from_numpy(x.reshape(-1, 3)[:n]) for x in (r["ro"], r["rd"])]
    lp = torch.from_numpy(np.broadcast_to(r["lp"], (n, 3)).copy())
    with torch.no_grad():
        eval_rays = r["tr"].render_rays(r["tf"], None, r["occ"], *rays, lp, None, step=3)
        base_rays = r["tr"].base.render_rays(r["tf"], None, r["occ"], *rays, lp, None, step=3)
    assert sorted(eval_rays) == sorted(base_rays)
    for key in eval_rays:
        assert torch.equal(eval_rays[key], base_rays[key]), key


def test_custom_mesh_is_the_dreammat_mesh_geometry():
    from dreammat_tpu_torch.models.geometry import DreamMatMesh

    cls = dreammat_tpu_torch.find("custom-mesh")
    assert issubclass(cls, DreamMatMesh) and cls is not DreamMatMesh
    cfg = {"shape_init": "procedural:sphere", "shape_init_params": 0.6, "n_feature_dims": 5,
           "pos_encoding_config": TINY_GRID}
    jgeo = dreammat_tpu.find("custom-mesh")(cfg)
    tgeo = cls(cfg, device="cpu")
    params = _np(jgeo.init(jax.random.PRNGKey(4)))
    params["table"] = params["table"] * 1e3
    field = tgeo.init(torch.Generator().manual_seed(0))
    field.load_state_dict(geometry_params_from_numpy(params), strict=True)
    assert np.abs(tgeo.isosurface().v_pos.numpy() - np.asarray(jgeo.isosurface().v_pos)).max() \
        <= 1e-6
    pts = np.random.RandomState(2).uniform(-0.7, 0.7, (64, 3)).astype(np.float32)
    with torch.no_grad():
        _close(tgeo.apply(field, torch.from_numpy(pts)),
               jgeo.apply(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(pts)))


# -- the systems -------------------------------------------------------------
SJC = "configs/sjc_tiny.yaml"
PROMPT = ["system.prompt_processor.prompt=a red apple"]
def fast_pair(config, overrides, system_type):
    """``volume_pair`` with the JAX occupancy refresh jitted (eager, it
    compiles op by op)."""
    from dreammat_tpu.models.volume_renderer import NeRFVolumeRenderer as JNeRF

    jitted = jax.jit(JNeRF.update_occ, static_argnums=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JNeRF, "update_occ", lambda self, *a: jitted(self, *a))
        return volume_pair(config, overrides, system_type)


def one_step(tmp_path, overrides, system_type, render_draws):
    """One ``fit`` step of both packages from the same state; the (JAX, port)
    losses and scene moves. ``render_draws(k_render, h, w)`` gives the
    renderer's draws of the JAX step's key."""
    jsys, jdm, tsys, tdm, state0 = fast_pair(SJC, PROMPT + overrides, system_type)
    jstate = jsys.fit(jdm, max_steps=1, state=jax.tree_util.tree_map(jnp.asarray, state0),
                      seed=SEED, trial_dir=str(tmp_path / "jax"), val_check_interval=0,
                      checkpoint_every=0, log_every=1)
    tsys.init_state(SEED)
    tsys.field.load_state_dict(volume_scene_from_numpy(state0["geo"], state0["bg"],
                                                       state0["render"]["occ"]), strict=True)
    h, w = tdm.cfg.height, tdm.cfg.width
    f = tsys.guidance.vae_factor
    rng = jax.random.split(jax.random.PRNGKey(SEED), 3)[2]
    _, k = jax.random.split(rng)
    k_render, k_guide = jax.random.split(k)
    d = render_draws(k_render, h, w)
    G = getattr(jsys.renderer, "base", jsys.renderer).cfg.grid_resolution
    d["occ_jitter"] = jax.random.uniform(jax.random.fold_in(k, 0x0CC), (G ** 3, 3))
    latents = (1, h // f, w // f, 4)
    nchw = lambda x: np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1))
    keys = jax.random.split(k_guide, 3)
    d.update(vae_eps=nchw(jax.random.normal(keys[0], latents)),
             t=jax.random.uniform(keys[1], (1,)), noise=nchw(jax.random.normal(keys[2], latents)))
    tsys.fit(tdm, max_steps=1, seed=SEED, trial_dir=str(tmp_path / "torch"), log_every=1,
             val_check_interval=0, checkpoint_every=0, draws=GivenDraws([d]))
    jl = _csv_losses(os.path.join(tmp_path, "jax", "logs", "metrics.csv"))
    tl = _csv_losses(os.path.join(tmp_path, "torch", "logs", "metrics.csv"))
    assert len(jl) == len(tl) == 1 and np.allclose(tl, jl, rtol=1e-4, atol=0), (tl, jl)
    for name, (moved_t, moved_j) in scene_moves(jstate, state0, tsys).items():
        if not np.abs(moved_j).any():  # the volume grid's scale at a zero grid
            assert not np.abs(moved_t).any(), name
            continue
        assert _rel(moved_t, moved_j) < 0.05, name
    return jsys, jstate, tsys, tdm


def _plain_draws(S, Sc=64):
    return lambda k, h, w: _render_draws(k, h * w, S, Sc)


def test_latentnerf_step_with_patch_renderer_and_guide_shape_matches_jax(tmp_path):
    from dreammat_tpu_torch.models.mesh import torus_arrays, write_obj

    obj = write_obj(str(tmp_path / "guide.obj"), *torus_arrays(nu=12, nv=6))
    over = ["system_type=latentnerf-system", f"system.guide_shape={obj}",
            "system.guide_shape_grid_res=12", "system.loss.lambda_shape=1.0",
            "data.width=16", "data.height=16", "data.eval_width=4", "data.eval_height=4",
            "system.guidance.width=16", "system.guidance.height=16",
            "system.renderer_type=patch-renderer",
            "system.renderer!={patch_size: 8, global_downsample: 4, base_renderer: "
            "{radius: 1.0, num_samples_per_ray: 16, grid_resolution: 8, grid_update_every: 2}}"]
    _, _, tsys, tdm = one_step(
        tmp_path, over, "latentnerf-system",
        lambda k, h, w: patch_draws(k, h, w, 8, 4, 16))
    assert type(tsys.renderer).__name__ == "PatchRenderer"
    assert tsys.shape_grid is not None and tsys.background.cfg.n_output_dims == 4
    assert "loss_shape" in open(os.path.join(tmp_path, "torch", "logs", "metrics.csv")).read()
    # evaluation decodes the 4^2 latent render at its own size (the tiny
    # VAE's factor is 2), as the JAX _eval_out does; the VAE's parity is
    # tests/test_torch_diffusion.py's
    batch = tdm.eval_rays(0)
    f = tsys.guidance.vae_factor
    img = tsys.eval_out(batch, 1)["comp_rgb"]
    with torch.no_grad():
        lat = tsys.renderer.render_image(tsys.field.geo, tsys.field.bg, tsys.field.occ,
                                         batch["rays_o"], batch["rays_d"],
                                         batch["light_position"], None, step=1)["comp_rgb"]
        want = torch.clamp(tsys.guidance.vae.decode(lat.permute(2, 0, 1)[None])[0]
                           .permute(1, 2, 0) * 0.5 + 0.5, 0.0, 1.0)
    assert lat.shape == (4, 4, 4) and img.shape == (4 * f, 4 * f, 3)
    assert torch.equal(img, want)


def test_latentnerf_refinement_step_matches_jax(tmp_path):
    over = ["system_type=latentnerf-system", "system.refinement=true",
            "system.material_type=sd-latent-adapter-material", "system.material!={}",
            "data.width=16", "data.height=16", "system.guidance.width=16",
            "system.guidance.height=16"]
    _, _, tsys, _ = one_step(tmp_path, over, "latentnerf-system", _plain_draws(32))
    assert tsys.n_render_ch == 3 and tsys.background.cfg.n_output_dims == 3


def test_sjc_step_with_volume_grid_and_textured_background_matches_jax(tmp_path):
    over = ["system.geometry_type=volume-grid",
            "system.geometry!={grid_size: [12, 12, 12], n_feature_dims: 4}",
            "system.background_type=textured-background",
            "system.background!={n_output_dims: 4, height: 8, width: 8, color_activation: none}",
            "system.guidance.use_sjc=false"]
    _, _, tsys, _ = one_step(tmp_path, over, "sjc-system", _plain_draws(32))
    # the SJC estimator is forced on where the config leaves it out; here it
    # is set, and stays as set
    assert not tsys.guidance.cfg.use_sjc
    text = open(os.path.join(tmp_path, "torch", "logs", "metrics.csv")).read()
    assert "loss_emptiness" in text and "loss_depth" in text


@pytest.mark.parametrize("name", ["launch_torch", "latentnerf-system", "sjc-system",
                                  "volume-grid", "textured-background", "patch-renderer",
                                  "neural-radiance-material"])
def test_latent_entry_points_need_cuda_unless_cpu_is_asked_for(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    if name == "launch_torch":
        import launch_torch

        argv = ["--config", SJC, "--train", *PROMPT, "exp_root_dir=outputs/never_written"]
        with pytest.raises(RuntimeError, match="CUDA"):
            launch_torch.main(argv)
        return
    cfg = tload(SJC, PROMPT)
    find = dreammat_tpu_torch.find
    cpu = find("sjc-system")(cfg.system, device="cpu")
    build = {
        "latentnerf-system": lambda **kw: find(name)(cfg.system, **kw),
        "sjc-system": lambda **kw: find(name)(cfg.system, **kw),
        "volume-grid": lambda **kw: find(name)({}, **kw),
        "textured-background": lambda **kw: find(name)({}, **kw),
        "patch-renderer": lambda **kw: find(name)({}, cpu.geometry, cpu.material, cpu.background,
                                                  **kw),
        "neural-radiance-material": lambda **kw: find(name)({}, **kw),
    }[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        build()
    assert build(device="cpu").device.type == "cpu"
