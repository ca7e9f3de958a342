"""Port parity: LoRA, the VSD guidance and the ProlificDreamer coarse stage.

Both packages run the tiny diffusion stack on the CPU with the same weights
(the weight bridge; the JAX guidance fills its random weights from numpy)
and the JAX package's draws by name:

- the LoRA sites (``to_q``, ``to_k``, ``to_v``, ``to_out.0`` of every
  ``attn1`` and ``attn2``), their count, the init (down N(0,1)/r, up 0)
  and the merge (fp32 weights to relative 1e-6; bf16 weights bit for bit,
  the delta cast to bf16 before the add), and the UNet through merged
  weights, to relative 1e-5;
- the UNet's class embedding (``class_labels``) to relative 1e-5;
- the VSD guidance at batch 2 with one camera dropped: ``loss_vsd``,
  ``loss_lora``, ``grad_norm`` and the gradients with respect to the
  render and to the LoRA state (factors and camera embedding), to
  relative 1e-4 (three passes through the UNet, whose sums run in another
  order in the two frameworks); the gradients stay apart (``loss_vsd``
  reaches only the render, ``loss_lora`` only the LoRA state) and nothing
  reaches the frozen UNet;
- two ``configs/prolificdreamer_tiny.yaml`` steps with both optimizers
  (``fit``): losses to relative 1e-4, the scene's and the LoRA state's
  moves to relative L2 0.05 (Adam with eps 1e-15, as in
  ``test_torch_volume.py``). The JAX guidance also returns ``loss_sds``,
  an alias of ``loss_vsd``, and the JAX system weighs every ``loss_*``, so
  its loss counts ``loss_vsd`` twice (``lambda_sds`` defaults to 1): the
  port returns no alias, and the JAX run here sets ``lambda_sds=0``;
- ``configs/prolificdreamer.yaml`` does not load in either package (its
  background's ``random_aug`` is no key of the background's config), and
  loads in both with the background block replaced;
- main path 7 of ``chip_smoke.py`` in its CPU tiny form.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

import dreammat_tpu
import dreammat_tpu.models  # noqa: F401
import dreammat_tpu.systems  # noqa: F401
import dreammat_tpu_torch
import dreammat_tpu_torch.models  # noqa: F401
import dreammat_tpu_torch.systems  # noqa: F401
from dreammat_tpu.models.diffusion import convert as jconvert
from dreammat_tpu.models.diffusion import lora as jlora_lib
from dreammat_tpu.models.diffusion.unet import UNet2DCondition as JUNet
from dreammat_tpu.models.diffusion.unet import UNetConfig as JUNetConfig
from dreammat_tpu.models.prompt import PromptEmbeddings as JPE
from dreammat_tpu.utils.config import load_config as jload
from dreammat_tpu_torch.models.diffusion import lora as lora_lib
from dreammat_tpu_torch.models.diffusion.convert import (
    flax_to_torch_state_dict, lora_layers_from_numpy, lora_site_name, lora_state_from_numpy,
    volume_scene_from_numpy,
)
from dreammat_tpu_torch.models.diffusion.unet import UNet2DCondition, UNetConfig
from dreammat_tpu_torch.models.prompt import PromptEmbeddings as TPE
from dreammat_tpu_torch.utils.config import load_config as tload

from test_torch_dreammat_step import _csv_losses, _np, _numpy_random_init, _rel
from test_torch_volume import GivenDraws, scene_moves, step_draws, volume_pair
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401

HW = 32
VSD_CFG = {"model_size": "tiny", "half_precision_weights": False, "width": HW, "height": HW,
           "cache_dir": None, "guidance_scale": 7.5, "lora_rank": 2}


def _nhwc_to_nchw(x):
    return np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1))


@pytest.fixture(scope="module")
def unets():
    """A tiny UNet in both packages, numpy-random weights, the class slot on."""
    ju = JUNet(JUNetConfig.tiny())
    s, t, ctx = jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 4, 64))
    p = _numpy_random_init(jax.random.PRNGKey(3), lambda: ju.init(
        jax.random.PRNGKey(0), s, t, ctx, class_labels=jnp.zeros((1, 16))))
    p = _np(p)
    tu = UNet2DCondition(UNetConfig.tiny(), class_embed_dim=16).eval().requires_grad_(False)
    tu.load_state_dict(flax_to_torch_state_dict(p, "unet"), strict=True)
    rng = np.random.RandomState(4)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    tt = np.float32([50.0, 700.0])
    ctx = rng.normal(size=(2, 6, 64)).astype(np.float32)
    cam = rng.normal(size=(2, 16)).astype(np.float32)
    return ju, p, tu, (x, tt, ctx, cam)


def _run_both(ju, jp, tu, tparams, inputs, class_labels=True):
    x, tt, ctx, cam = inputs
    kw = {"class_labels": jnp.asarray(cam)} if class_labels else {}
    je = jax.jit(ju.apply)(jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x),
                           jnp.asarray(tt), jnp.asarray(ctx), **kw)
    tkw = {"class_labels": torch.from_numpy(cam)} if class_labels else {}
    te = functional_call(tu, tparams, (torch.from_numpy(_nhwc_to_nchw(x)),
                                       torch.from_numpy(tt), torch.from_numpy(ctx)), tkw)
    return _nhwc_to_nchw(je), te.detach().numpy()


def test_unet_class_embedding_matches_jax(unets):
    ju, p, tu, inputs = unets
    je, te = _run_both(ju, p, tu, {}, inputs)
    assert _rel(te, je) < 1e-5
    je0, te0 = _run_both(ju, {"params": {k: v for k, v in p["params"].items()
                                         if k != "class_embedding"}}, tu, {}, inputs,
                         class_labels=False)
    assert _rel(te0, je0) < 1e-5 and _rel(te, te0) > 1e-3  # the camera moves the output
    plain = UNet2DCondition(UNetConfig.tiny())
    assert not any(k.startswith("class_embedding") for k in plain.state_dict())


def test_lora_sites_init_and_merge_match_jax(unets):
    ju, p, tu, inputs = unets
    jl = _np(jlora_lib.init_lora_params(jax.random.PRNGKey(1), p, rank=4))
    tl = lora_lib.init_lora_params(tu, rank=4, seed=1)
    assert sorted(tl.sites) == sorted(lora_site_name(k) for k in jl)
    assert len(tl.sites) == 32 and {s.split(".")[-1] for s in tl.sites} == {
        "to_q", "to_k", "to_v", "0"}
    assert all(".attn1." in s or ".attn2." in s for s in tl.sites)
    assert lora_lib.lora_param_count(tl) == jlora_lib.lora_param_count(jl)
    # the init: up 0, down N(0, 1)/rank (4352 samples), one draw per site
    downs = np.concatenate([f.down.detach().numpy().ravel() for f in tl.layers])
    assert all(float(f.up.detach().abs().max()) == 0.0 for f in tl.layers)
    assert abs(downs.std() * 4 - 1.0) < 0.05 and abs(downs.mean()) < 0.02
    assert not torch.equal(tl.layers[0].down[:4, 0], tl.layers[1].down[:4, 0])
    again = lora_lib.init_lora_params(tu, rank=4, seed=1)
    assert all(torch.equal(a.down, b.down) for a, b in zip(tl.layers, again.layers))

    # factors away from zero in both packages, then merged
    jl2 = jax.tree_util.tree_map(lambda a: a + 0.05, jl)
    tl.load_state_dict(lora_layers_from_numpy(jl2, tl.sites), strict=True)
    jm = _np(jlora_lib.merge_lora(jax.tree_util.tree_map(jnp.asarray, p), jl2, 1.0))
    tm = lora_lib.merge_lora(tu, tl, 1.0)
    ref = flax_to_torch_state_dict(jm, "unet")
    for name, w in tm.items():
        assert _rel(w.detach().numpy(), ref[name].numpy()) < 1e-6, name
    je, te = _run_both(ju, jm, tu, tm, inputs)
    je0, _ = _run_both(ju, p, tu, {}, inputs)
    assert _rel(te, je) < 1e-5 and _rel(je, je0) > 1e-3

    # bf16 weights: the delta is cast to bf16 before the add, in both
    tb = UNet2DCondition(UNetConfig.tiny(), class_embed_dim=16).to(torch.bfloat16)
    tb.load_state_dict(flax_to_torch_state_dict(p, "unet"), strict=True)
    pb = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    jmb = jlora_lib.merge_lora(pb, jax.tree_util.tree_map(jnp.asarray, jl2), 1.0)
    jmb = jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)), jmb)
    refb = flax_to_torch_state_dict(jmb, "unet")
    for name, w in lora_lib.merge_lora(tb, tl, 1.0).items():
        assert w.dtype == torch.bfloat16 and torch.equal(w.float(), refb[name]), name
        # rounding the sum in fp32 (the delta uncast) would differ
        exact = (tb.get_parameter(name).float() + lora_delta_t(tl, name)).to(torch.bfloat16)
        assert not torch.equal(exact.float(), refb[name]), name


def lora_delta_t(lora, weight_name):
    f = lora.layers[lora.sites.index(weight_name[:-len(".weight")])]
    return (f.down @ f.up).detach().t()


@pytest.fixture(scope="module")
def vsd_pair():
    jg = dreammat_tpu.find("stable-diffusion-vsd-guidance")(VSD_CFG)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconvert, "fast_random_init", _numpy_random_init)
        jg.init_params(jax.random.PRNGKey(0))
    jl = _np(jg.init_lora(jax.random.PRNGKey(1)))
    jl = jax.tree_util.tree_map(lambda a: a + 0.03, jl)  # the LoRA branch differs from SD
    tg = dreammat_tpu_torch.find("stable-diffusion-vsd-guidance")(VSD_CFG, device="cpu")
    tg.init_params()
    gp = _np(jg.params)
    missing, unused = tg.unet.load_state_dict(flax_to_torch_state_dict(gp["unet"], "unet"),
                                              strict=False)
    assert sorted(missing) == sorted("class_embedding." + k for k in (
        "linear_1.weight", "linear_1.bias", "linear_2.weight", "linear_2.bias")) and not unused
    tg.vae.load_state_dict(flax_to_torch_state_dict(gp["vae"], "vae"), strict=True)
    tl = tg.init_lora(torch.Generator().manual_seed(1))
    tl.load_state_dict(lora_state_from_numpy(jl, tl.layers.sites), strict=True)
    rng = np.random.RandomState(1)
    N, D = 16, 64
    shapes = {"text_vd": (4, N, D), "uncond_vd": (4, N, D), "text": (N, D), "uncond": (N, D),
              "null": (N, D)}
    emb = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    return jg, jl, tg, tl, emb


def _key_with_one_drop(B=2):
    """A key whose camera-drop draw drops exactly one of the ``B`` cameras."""
    for i in range(200):
        k = jax.random.PRNGKey(i)
        drop = np.asarray(jax.random.uniform(jax.random.split(k, 6)[5], (B, 1))) < 0.1
        if drop.sum() == 1:
            return k
    raise AssertionError("no key")


def test_vsd_guidance_matches_jax(vsd_pair):
    jg, jl, tg, tl, emb = vsd_pair
    B = 2
    rng = np.random.RandomState(3)
    rgb = rng.uniform(size=(B, HW, HW, 3)).astype(np.float32)
    c2w = rng.normal(size=(B, 4, 4)).astype(np.float32)
    elev, azim, dist = np.float32([10.0, 50.0]), np.float32([30.0, 170.0]), np.float32([1.5, 2.0])
    k, step = _key_with_one_drop(B), 300
    je = JPE(**{n: jnp.asarray(v) for n, v in emb.items()})
    te = TPE(**{n: torch.from_numpy(v) for n, v in emb.items()})

    def jfn(x, lora):
        out = jg(jg.params, x, je, jnp.asarray(elev), jnp.asarray(azim), jnp.asarray(dist),
                 c2w=jnp.asarray(c2w), lora_params=lora, step=jnp.int32(step), rng=k)
        return out["loss_vsd"] + out["loss_lora"], out

    (_, jout), (jg_rgb, jg_lora) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1),
                                                              has_aux=True))(
        jnp.asarray(rgb), jax.tree_util.tree_map(jnp.asarray, jl))
    f = tg.vae_factor
    lat = (B, HW // f, HW // f, 4)
    keys = jax.random.split(k, 6)
    draws = GivenDraws({"vae_eps": _nhwc_to_nchw(jax.random.normal(keys[0], lat)),
                        "t": jax.random.uniform(keys[1], (B,)),
                        "noise": _nhwc_to_nchw(jax.random.normal(keys[2], lat)),
                        "t2": jax.random.randint(keys[3], (B,), 0, 1000),
                        "noise2": _nhwc_to_nchw(jax.random.normal(keys[4], lat)),
                        "camera_drop": jax.random.uniform(keys[5], (B, 1))})
    x = torch.from_numpy(_nhwc_to_nchw(rgb)).requires_grad_(True)
    tl.zero_grad(set_to_none=True)
    out = tg(x, te, torch.from_numpy(elev), torch.from_numpy(azim), torch.from_numpy(dist),
             c2w=torch.from_numpy(c2w), lora=tl, step=step, draws=draws)
    assert "loss_sds" in jout and "loss_sds" not in out
    for name in ("loss_vsd", "loss_lora", "grad_norm"):
        got, want = float(out[name].detach()), float(jout[name])
        assert abs(got - want) <= 1e-4 * abs(want), name
    assert (out["min_step"], out["max_step"]) == (int(jout["min_step"]), int(jout["max_step"]))
    (out["loss_vsd"] + out["loss_lora"]).backward()
    assert _rel(x.grad.numpy(), _nhwc_to_nchw(jg_rgb)) < 1e-4
    ref = lora_state_from_numpy(_np(jg_lora), tl.layers.sites)
    for name, p in tl.named_parameters():
        assert _rel(p.grad.numpy(), ref[name].numpy()) < 1e-4, name
    assert float(np.abs(np.asarray(jg_lora["camera_embedding"]["linear_1"]["kernel"])).max()) > 0


def test_vsd_gradients_stay_apart(vsd_pair):
    """``loss_vsd`` moves only the render, ``loss_lora`` only the LoRA state;
    the frozen UNet and VAE get nothing."""
    jg, jl, tg, tl, emb = vsd_pair
    te = TPE(**{n: torch.from_numpy(v) for n, v in emb.items()})
    from dreammat_tpu_torch.utils.rng import TorchDraws

    for loss_name, render_grad, lora_grad in (("loss_vsd", True, False),
                                              ("loss_lora", False, True)):
        x = torch.rand(1, 3, HW, HW, generator=torch.Generator().manual_seed(2),
                       requires_grad=True)
        tl.zero_grad(set_to_none=True)
        out = tg(x, te, torch.zeros(1), torch.zeros(1), torch.full((1,), 1.5),
                 c2w=torch.eye(4)[None], lora=tl, step=0, draws=TorchDraws(5, "cpu"))
        out[loss_name].backward()
        assert (x.grad is not None and float(x.grad.abs().max()) > 0) == render_grad
        grads = [p.grad for p in tl.parameters()]
        assert all((g is not None and float(g.abs().max()) > 0) == lora_grad
                   for g in grads if g is not None or lora_grad), loss_name
        if lora_grad:
            assert all(g is not None for g in grads)
    for module in (tg.unet, tg.vae):
        assert all(not p.requires_grad and p.grad is None for p in module.parameters())


# -- the system --------------------------------------------------------------
PD_OVERRIDES = ["system.prompt_processor.prompt=a red apple",
                "system.prompt_processor.use_cache=false"]


def _pd_run(tmp_path, n_steps: int):
    over = PD_OVERRIDES + ["system.loss.lambda_sds=0.0"]
    jsys, jdm, tsys, tdm, state0 = volume_pair("configs/prolificdreamer_tiny.yaml", over,
                                               "prolificdreamer-system")
    jlora0 = state0["lora"]
    tsys.lora.load_state_dict(lora_state_from_numpy(jlora0, tsys.lora.layers.sites),
                              strict=True)
    jstate = jsys.fit(jdm, max_steps=n_steps, seed=0, trial_dir=str(tmp_path / "jax"),
                      val_check_interval=0, checkpoint_every=0, log_every=1)
    tsys.init_state(0)
    tsys.field.load_state_dict(volume_scene_from_numpy(state0["geo"], state0["bg"],
                                                       state0["render"]["occ"]), strict=True)
    f = tsys.guidance.vae_factor
    h, w = tdm.cfg.height, tdm.cfg.width
    draws = GivenDraws(step_draws(jsys, n_steps, h * w, tsys.renderer.cfg.num_samples_per_ray,
                                  (h // f, w // f), vsd=True))
    tsys.fit(tdm, max_steps=n_steps, seed=0, trial_dir=str(tmp_path / "torch"), log_every=1,
             val_check_interval=0, checkpoint_every=0, draws=draws)
    return jsys, jstate, state0, tsys


def test_prolificdreamer_two_steps_match_jax(tmp_path):
    jsys, jstate, state0, tsys = _pd_run(tmp_path, n_steps=2)
    assert type(tsys.guidance).__name__ == "StableDiffusionVSDGuidance"
    assert tsys.global_step == 2 and type(tsys.optimizer_lora).__name__ == "Adam"
    jl = _csv_losses(os.path.join(tmp_path, "jax", "logs", "metrics.csv"))
    tl = _csv_losses(os.path.join(tmp_path, "torch", "logs", "metrics.csv"))
    assert len(jl) == len(tl) == 2 and np.allclose(tl, jl, rtol=1e-4, atol=0), (tl, jl)
    # the JAX guidance's alias, weighed by the JAX system unless lambda_sds = 0
    with open(os.path.join(tmp_path, "jax", "logs", "metrics.csv")) as fh:
        rows = list(csv.DictReader(fh))
    assert all(float(r["loss_sds"]) == float(r["loss_vsd"]) > 0 for r in rows)
    for name, (moved_t, moved_j) in scene_moves(jstate, state0, tsys).items():
        assert np.abs(moved_t).max() > 0 and _rel(moved_t, moved_j) < 0.05, name
    # the LoRA state moved with its own optimizer as in the JAX step: the up
    # factors off zero after the first step, the camera embedding too
    l0 = lora_state_from_numpy(state0["lora"], tsys.lora.layers.sites)
    l1 = lora_state_from_numpy(_np(jstate["lora"]), tsys.lora.layers.sites)
    for name, p in tsys.lora.named_parameters():
        moved_t, moved_j = (p.detach() - l0[name]).numpy(), (l1[name] - l0[name]).numpy()
        assert np.abs(moved_t).max() > 0 and _rel(moved_t, moved_j) < 0.05, name
    assert all(not p.requires_grad for p in tsys.guidance.unet.parameters())


def test_prolificdreamer_config_random_aug_fault_and_replaced_background():
    over = ["system.prompt_processor.prompt=a red apple", "system.guidance.cache_dir=null"]
    for load, pkg, kw in ((jload, dreammat_tpu, {}), (tload, dreammat_tpu_torch,
                                                      {"device": "cpu"})):
        cfg = load("configs/prolificdreamer.yaml", over)
        with pytest.raises(ValueError, match="random_aug"):
            pkg.find(cfg.system_type)(cfg.system, **kw)
        cfg = load("configs/prolificdreamer.yaml",
                   over + ["system.background!={color_activation: sigmoid}"])
        system = pkg.find(cfg.system_type)(cfg.system, **kw)
        assert type(system.background).__name__ == "NeuralEnvironmentMapBackground"
        assert type(system.material).__name__ == "NoMaterial"
        assert system.cfg.stage == "coarse" and dict(cfg.data)["width"] == 512


def test_prolificdreamer_refinement_stages_raise():
    """The refinement stages switch to DMTet and the rasterizer, whose strict
    config parse refuses the volume's geometry block of the tiny config, as
    the JAX package's does (tests/test_torch_dmtet_systems.py runs them with
    the blocks replaced)."""
    cfg = tload("configs/prolificdreamer_tiny.yaml", PD_OVERRIDES + ["system.stage=geometry"])
    with pytest.raises(ValueError, match="unknown config key 'normal_type'"):
        dreammat_tpu_torch.find("prolificdreamer-system")(cfg.system, device="cpu")


@pytest.mark.parametrize("entry", ["prolificdreamer_system", "vsd_guidance"])
def test_vsd_entry_points_need_cuda_unless_cpu_is_asked_for(entry):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    cfg = tload("configs/prolificdreamer_tiny.yaml", PD_OVERRIDES)
    build = {
        "prolificdreamer_system": lambda **kw: dreammat_tpu_torch.find(
            "prolificdreamer-system")(cfg.system, **kw),
        "vsd_guidance": lambda **kw: dreammat_tpu_torch.find("stable-diffusion-vsd-guidance")(
            VSD_CFG, **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        build()
    assert build(device="cpu").device.type == "cpu"


def test_main_path_7_cpu_tiny_form(tmp_path):
    from chip_smoke import drive_volume

    res = drive_volume(str(tmp_path / "volume"), device="cpu", size="tiny")
    runs = res["runs"]
    assert [runs[r]["system"] for r in ("dreamfusion", "prolificdreamer")] == [
        "DreamFusion", "ProlificDreamer"]
    assert runs["prolificdreamer"]["guidance"] == "StableDiffusionVSDGuidance"
    for r in runs.values():
        assert len(r["losses"]) == 3 and r["occ_refreshes"] == 3
        assert r["test_png"] > 100 and r["gif"] > 100 and r["obj_v"] > 0 and r["obj_f"] > 0
    pd = runs["prolificdreamer"]
    assert min(pd["lora_moved"].values()) > 0 and pd["unet_changed"] == 0
