"""Port parity: TextMesh (the implicit SDF and NeuS) against JAX, and main path 9.

Every case feeds the same numpy inputs, and the JAX package's random draws
by name, to both packages on the CPU at tiny size, with the weights carried
across by the weight bridge (``geometry_params_from_numpy``,
``volume_scene_from_numpy``):

- ``implicit-sdf``: the SDF with the ellipsoid and a constant bias, the
  features, the analytic normals, ``sdf_grad`` and the gradient of an
  eikonal loss on it to relative 1e-4 (the sphere bias and the
  finite-difference normals, which divide by eps = 0.01, in the NeuS
  test);
- its shape init, ``sphere`` and ``mesh:`` (a torus OBJ), 4 Adam steps
  on the JAX draws: the fitted field's moves to relative L2 1e-3;
- NeuS (occupancy grid, annealed cosine) and VolSDF (importance estimator)
  renders, every output key to relative 1e-4 and the gradient of the
  field, background and variance to relative 1e-4;
- one ``textmesh-system`` step (``configs/textmesh.yaml`` cut to tiny
  size): losses to relative 1e-4, the scene's and the variance's moves to
  relative L2 0.05 (Adam with eps 1e-15 turns rounding-level gradients
  into whole lr-sized steps); its level-0 export;
- the entry points need CUDA unless the CPU is asked for;
- main path 9's CPU tiny form (``chip_smoke.drive_volume_rest``).
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
from test_torch_latentnerf import fast_pair
from test_torch_volume import (
    SEED, TINY_GRID, GivenDraws, _close, _rays,
)
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401

RTOL_FD = 1e-4
SDF_CFG = {"radius": 1.0, "pos_encoding_config": TINY_GRID,
           "mlp_network_config": {"n_neurons": 16, "n_hidden_layers": 1}}


def _sdfs(**over):
    cfg = {**SDF_CFG, **over}
    jg = dreammat_tpu.find("implicit-sdf")(cfg)
    tg = dreammat_tpu_torch.find("implicit-sdf")(cfg, device="cpu")
    params = _np(jg.init(jax.random.PRNGKey(0)))
    params["table"] = np.random.RandomState(1).normal(0, 0.3, params["table"].shape).astype(
        np.float32)
    field = tg.init(torch.Generator().manual_seed(0))
    field.load_state_dict(geometry_params_from_numpy(params), strict=True)
    return jg, tg, jax.tree_util.tree_map(jnp.asarray, params), field


def test_implicit_sdf_and_its_normals_match_jax():
    """The ellipsoid bias and the analytic normals here; the sphere bias and
    the finite-difference normals are the NeuS test's."""
    jg, tg, jp, tf = _sdfs(sdf_bias="ellipsoid", sdf_bias_params=[0.4, 0.5, 0.6],
                           normal_type="analytic")
    pts = np.random.RandomState(2).uniform(-0.95, 0.95, (6, 8, 3)).astype(np.float32)

    def jloss(p):
        out = jg.apply(p, jnp.asarray(pts), output_normal=True)
        return jnp.mean((jnp.linalg.norm(out["sdf_grad"], axis=-1) - 1.0) ** 2), out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    jgrad = _np(jgrad)
    tout = tg.apply(tf, torch.from_numpy(pts), output_normal=True)
    torch.mean((torch.linalg.norm(tout["sdf_grad"], dim=-1) - 1.0) ** 2).backward()
    for key in ("sdf", "features", "sdf_grad", "normal", "shading_normal"):
        _close(tout[key].detach(), jout[key], rtol=RTOL_FD, what=key)
    assert np.abs(np.linalg.norm(np.asarray(jout["sdf_grad"]), axis=-1) - 1).max() > 1e-2
    ref = geometry_params_from_numpy(jgrad)
    last_bias = f"sdf_mlp.{len(tf.sdf_mlp) - 1}.bias"
    scale = max(np.abs(v.numpy()).max() for v in ref.values())
    for name, p in tf.named_parameters():
        if name.startswith("feature_mlp"):
            continue  # no part in the SDF
        if name == last_bias:  # the SDF's last bias cancels in its gradient
            assert np.abs(ref[name].numpy()).max() <= 1e-5 * scale
            continue
        assert _rel(p.grad.numpy(), ref[name].numpy()) < RTOL_FD, name
    _close(tg.forward_sdf(tf, torch.from_numpy(pts)).detach(),
           jg.forward_sdf(jp, jnp.asarray(pts)), rtol=1e-5, what="forward_sdf")
    _close(tg.export(tf, torch.from_numpy(pts))["features"].detach(),
           jg.apply(jp, jnp.asarray(pts))["features"], rtol=1e-5, what="export")
    jc, tc, jpc, tfc = _sdfs(sdf_bias=0.1)  # and a constant bias
    _close(tc.forward_sdf(tfc, torch.from_numpy(pts)).detach(),
           jax.jit(jc.forward_sdf)(jpc, jnp.asarray(pts)), rtol=1e-5, what="constant bias")


@pytest.mark.parametrize("target", ["sphere", "mesh"])
def test_implicit_sdf_shape_init_matches_jax(tmp_path, target):
    from dreammat_tpu_torch.models.mesh import torus_arrays, write_obj

    steps = 4
    init = ("sphere" if target == "sphere"
            else "mesh:" + write_obj(str(tmp_path / "t.obj"), *torus_arrays(nu=12, nv=6)))
    jg, tg, jp, tf = _sdfs(shape_init=init, shape_init_params=0.6, shape_init_steps=steps)
    k = jax.random.PRNGKey(3)
    j1 = _np(jg.initialize_shape(jp, k))
    pts = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(k, i), (4096, 3)))
                    for i in range(steps)])
    p0 = {n: p.detach().clone() for n, p in tf.named_parameters()}
    tg.initialize_shape(tf, GivenDraws({"shape_init": pts}))
    ref = geometry_params_from_numpy(j1)
    for name, p in tf.named_parameters():
        moved_t, moved_j = (p.detach() - p0[name]).numpy(), ref[name].numpy() - p0[name].numpy()
        if name.startswith("feature_mlp"):
            assert not moved_t.any() and not moved_j.any(), name
            continue
        assert np.abs(moved_j).max() > 0 and _rel(moved_t, moved_j) < 1e-3, name


# -- NeuS ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def neus_rig():
    jg, tg, jp, tf = _sdfs(sdf_bias="sphere", sdf_bias_params=0.5)
    mcfg = {"ambient_only_steps": 0, "soft_shading": True}
    jm = dreammat_tpu.find("diffuse-with-point-light-material")(mcfg)
    tm = dreammat_tpu_torch.find("diffuse-with-point-light-material")(mcfg, device="cpu")
    jb = dreammat_tpu.find("neural-environment-map-background")({})
    tb = dreammat_tpu_torch.find("neural-environment-map-background")({}, device="cpu")
    bp = _np(jb.init(jax.random.PRNGKey(4)))
    bfield = tb.init(torch.Generator().manual_seed(0))
    bfield.load_state_dict(geometry_params_from_numpy(bp), strict=True)
    return dict(jg=jg, tg=tg, jp=jp, tf=tf, jm=jm, tm=tm, jb=jb, tb=tb, bfield=bfield,
                bp=jax.tree_util.tree_map(jnp.asarray, bp))


def neus_draws(k, N, S, Sc):
    k_strat, k_coarse, k_imp, k_mat = jax.random.split(k, 4)
    k_soft, k_shading = jax.random.split(k_mat)
    return {"ray_strat": jax.random.uniform(k_strat, (N, S)),
            "ray_coarse": jax.random.uniform(k_coarse, (N, Sc)),
            "ray_importance": jax.random.uniform(k_imp, (N, S)),
            "soft_shading": jax.random.uniform(k_soft, ()),
            "shading_mode": jax.random.uniform(k_shading, (2,))}


@pytest.mark.parametrize("estimator,volsdf,anneal", [("occgrid", False, 10),
                                                     ("importance", True, 0)])
def test_neus_and_volsdf_renders_and_gradients_match_jax(neus_rig, estimator, volsdf, anneal):
    r = neus_rig
    rcfg = {"radius": 1.0, "num_samples_per_ray": 16, "grid_resolution": 8,
            "num_samples_per_ray_importance": 12, "estimator": estimator, "use_volsdf": volsdf,
            "cos_anneal_end_steps": anneal, "learned_variance_init": 0.2}
    jr = dreammat_tpu.find("neus-volume-renderer")(rcfg, r["jg"], r["jm"], r["jb"])
    tr = dreammat_tpu_torch.find("neus-volume-renderer")(rcfg, r["tg"], r["tm"], r["tb"],
                                                         device="cpu")
    k_occ = jax.random.PRNGKey(11)
    state = jr.update_occ(r["jp"], {"occ": jnp.zeros((8, 8, 8))}, k_occ)
    occ = tr.update_occ(r["tf"], tr.init_state(),
                        GivenDraws({"occ_jitter": jax.random.uniform(k_occ, (512, 3))}))
    _close(occ, state["occ"], rtol=1e-5, what="occ")
    o, d, light = _rays()
    c = np.random.RandomState(15).normal(size=(len(o), 3)).astype(np.float32)
    k = jax.random.PRNGKey(16)
    jvar = {"_inv_std": jnp.float32(0.2)}

    def jrender(gp, bp, vp):
        return jr.render_rays(gp, bp, state, jnp.asarray(o), jnp.asarray(d), jnp.asarray(light),
                              k, step=4, is_train=True, var_params=vp)

    def jloss(gp, bp, vp):
        out = jrender(gp, bp, vp)
        return jnp.sum(out["comp_rgb"] * c) + jnp.sum(out["depth"]), out

    (_, jout), (jgeo, jbg, jv) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                                            has_aux=True))(r["jp"], r["bp"], jvar)
    var = tr.init_variance()
    for p in list(r["tf"].parameters()) + list(r["bfield"].parameters()):
        p.grad = None
    tout = tr.render_rays(r["tf"], r["bfield"], occ, torch.from_numpy(o), torch.from_numpy(d),
                          torch.from_numpy(light), GivenDraws(neus_draws(k, len(o), 16, 12)),
                          step=4, is_train=True, var=var)
    assert sorted(tout) == sorted(jout)
    for key in jout:
        _close(tout[key].detach(), jout[key], rtol=RTOL_FD, what=key)
    assert float(jout["opacity"].max()) > 0.5
    (torch.sum(tout["comp_rgb"] * torch.from_numpy(c)) + tout["depth"].sum()).backward()
    for ref, module in ((geometry_params_from_numpy(_np(jgeo)), r["tf"]),
                        (geometry_params_from_numpy(_np(jbg)), r["bfield"])):
        for name, p in module.named_parameters():
            if p.grad is None:  # the feature MLP: the material takes no features
                assert not np.abs(ref[name].numpy()).any(), name
                continue
            assert _rel(p.grad.numpy(), ref[name].numpy()) < RTOL_FD, name
    assert abs(float(var._inv_std.grad) - float(jv["_inv_std"])) <= RTOL_FD * abs(
        float(jv["_inv_std"])) and float(jv["_inv_std"]) != 0
    # evaluation in chunks hands the variance through: the chunks of
    # render_image are render_rays of the same rays
    img = tr.render_image(r["tf"], r["bfield"], occ, torch.from_numpy(o[:, None]),
                          torch.from_numpy(d[:, None]), torch.from_numpy(light[0]),
                          GivenDraws({"ray_importance": jax.random.uniform(k, (len(o), 16))}),
                          step=4, var=var)
    with torch.no_grad():
        rays = tr.render_rays(r["tf"], r["bfield"], occ, torch.from_numpy(o),
                              torch.from_numpy(d), torch.from_numpy(light),
                              GivenDraws({"ray_importance": jax.random.uniform(k, (len(o), 16))}),
                              step=4, var=var)
    for key in img:
        assert torch.equal(img[key][:, 0], rays[key]), key


# -- the system and main path 9 ---------------------------------------------------
def textmesh_tiny():
    import chip_smoke

    return chip_smoke.VOLUME_REST_RUNS["textmesh"][2]


def test_textmesh_step_matches_jax(tmp_path):
    over = ["system.prompt_processor.prompt=a red apple", *textmesh_tiny(),
            "data.width=16", "data.height=16", "system.renderer.num_samples_per_ray=16"]
    jsys, jdm, tsys, tdm, state0 = fast_pair("configs/textmesh.yaml", over, "textmesh-system")
    jstate = jsys.fit(jdm, max_steps=1, state=jax.tree_util.tree_map(jnp.asarray, state0),
                      seed=SEED, trial_dir=str(tmp_path / "jax"), val_check_interval=0,
                      checkpoint_every=0, log_every=1)
    tsys.init_state(SEED)
    tsys.field.load_state_dict(volume_scene_from_numpy(
        state0["geo"], state0["bg"], state0["render"]["occ"], state0["var"]), strict=True)
    h, w, f = tdm.cfg.height, tdm.cfg.width, tsys.guidance.vae_factor
    rng = jax.random.split(jax.random.PRNGKey(SEED), 3)[2]
    _, k = jax.random.split(rng)
    k_render, k_guide = jax.random.split(k)
    d = neus_draws(k_render, h * w, 16, 64)
    d["occ_jitter"] = jax.random.uniform(jax.random.fold_in(k, 0x0CC), (8 ** 3, 3))
    nchw = lambda x: np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1))
    keys = jax.random.split(k_guide, 3)
    latents = (1, h // f, w // f, 4)
    d.update(vae_eps=nchw(jax.random.normal(keys[0], latents)),
             t=jax.random.uniform(keys[1], (1,)), noise=nchw(jax.random.normal(keys[2], latents)))
    tsys.fit(tdm, max_steps=1, seed=SEED, trial_dir=str(tmp_path / "torch"), log_every=1,
             val_check_interval=0, checkpoint_every=0, draws=GivenDraws([d]))
    jl = _csv_losses(os.path.join(tmp_path, "jax", "logs", "metrics.csv"))
    tl = _csv_losses(os.path.join(tmp_path, "torch", "logs", "metrics.csv"))
    assert len(jl) == len(tl) == 1 and np.allclose(tl, jl, rtol=1e-4, atol=0), (tl, jl)
    assert "loss_eikonal" in open(os.path.join(tmp_path, "torch", "logs", "metrics.csv")).read()
    j1 = volume_scene_from_numpy(_np(jstate["geo"]), _np(jstate["bg"]),
                                 jstate["render"]["occ"], _np(jstate["var"]))
    j0 = volume_scene_from_numpy(state0["geo"], state0["bg"], state0["render"]["occ"],
                                 state0["var"])
    for name, p in tsys.field.named_parameters():
        moved_t, moved_j = (p.detach() - j0[name]).numpy(), (j1[name] - j0[name]).numpy()
        if not np.abs(moved_j).any():  # a tensor the step leaves as it was
            assert not np.abs(moved_t).any(), name
            continue
        assert _rel(moved_t, moved_j) < 0.05, name
    assert float(tsys.field.var._inv_std) != 0.3
    obj = tsys.export(str(tmp_path / "torch"))
    with open(obj) as fh:
        assert sum(ln.startswith("f ") for ln in fh) > 100


@pytest.mark.parametrize("name", ["textmesh-system", "implicit-sdf", "neus-volume-renderer"])
def test_textmesh_entry_points_need_cuda_unless_cpu_is_asked_for(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    cfg = tload("configs/textmesh.yaml", ["system.prompt_processor.prompt=x", *textmesh_tiny()])
    find = dreammat_tpu_torch.find
    cpu = find("textmesh-system")(cfg.system, device="cpu")
    build = {
        "textmesh-system": lambda **kw: find(name)(cfg.system, **kw),
        "implicit-sdf": lambda **kw: find(name)(cfg.system["geometry"], **kw),
        "neus-volume-renderer": lambda **kw: find(name)(cfg.system["renderer"], cpu.geometry,
                                                        cpu.material, cpu.background, **kw),
    }[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        build()
    assert build(device="cpu").device.type == "cpu"


def test_main_path_9_cpu_tiny_form(tmp_path):
    import chip_smoke

    res = chip_smoke.drive_volume_rest(str(tmp_path / "work"), device="cpu", size="tiny",
                                       steps=2)
    runs = res["runs"]
    assert list(runs) == ["latentnerf", "latentnerf_refine", "sjc", "textmesh"]
    assert [r["system"] for r in runs.values()] == ["LatentNeRF", "LatentNeRF",
                                                    "ScoreJacobianChaining", "TextMesh"]
    assert [r["renderer"] for r in runs.values()] == ["PatchRenderer"] * 3 + [
        "NeuSVolumeRenderer"]
    assert runs["sjc"]["geometry"] == "VolumeGrid"
    assert runs["latentnerf"]["guide_vs_cpu"]["indicator_flips"] == 0
    for r in runs.values():
        assert r["occ_refreshes"] == 2 and r["obj_f"] > 0 and len(r["losses"]) == 2
