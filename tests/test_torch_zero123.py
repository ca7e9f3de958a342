"""Port parity: Zero123 (the image tower, both guidances, the unified names,
the single-image data module and the volume systems) against JAX.

Every case feeds the same numpy inputs, and the JAX package's random draws
by name, to both packages on the CPU at tiny size, with the weights carried
across by the port's weight bridge (``flax_to_torch_state_dict`` with the
``clip_vision`` key map, ``lora_state_from_numpy``):

- the CLIP vision tower, from the flax tree and from the HF-layout state
  dict the JAX package's converter writes, to 1e-5 (relative to the
  largest value), at an input that is upsampled and one that is
  antialiased down;
- ``zero123-guidance``: ``c_crossattn``, the unscaled ``c_concat`` and
  ``get_cond`` (its zeroed uncond rows) to 1e-5; ``loss_sds`` and its image
  gradient to relative 1e-4, with and without ``grad_clip``;
- ``zero123-vsd-guidance`` (with the camera drop): ``loss_vsd`` and
  ``loss_lora`` to relative 1e-4 (extrinsics and spherical cameras); for
  extrinsics the image gradient to relative 1e-4 and the LoRA and
  camera-embedding gradient of ``loss_lora`` to relative L2 1e-3:
  ``loss_vsd`` reaches the image and no LoRA tensor, ``loss_lora`` the LoRA
  state and not the image;
- both unified factories, SDS and VSD: the guidance built and its
  translated keys those of the JAX factory;
- ``single-image-datamodule``: the reference rays (jittered by the JAX
  draw), RGB, mask, depth and normal, the random-camera sub-batch and an
  eval view, to 1e-6 (float32 camera maths in two frameworks);
- one ``zero123-system`` step (``configs/zero123_tiny.yaml`` with the depth
  and normal side files, the 3D normal smoothness on) and one
  ``zero123-simple-system`` step: every loss term to relative 1e-4, the
  scene's moves to relative L2 0.05 (Adam with eps 1e-15 turns
  rounding-level gradients into whole lr-sized steps).
"""

import csv
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
from dreammat_tpu.models.diffusion import convert as jconvert
from dreammat_tpu_torch.models.diffusion.convert import (
    flax_to_torch_state_dict, load_diffusers_weights, lora_state_from_numpy,
    volume_scene_from_numpy,
)

from test_torch_dreammat_step import _np, _rel
from test_torch_dreammat_step import _numpy_random_init
from test_torch_latentnerf import fast_pair
from test_torch_volume import (
    SEED, GivenDraws, _close, _render_draws,
)
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401

Z123_TINY = "configs/zero123_tiny.yaml"
RTOL = 1e-4
nchw = lambda x: np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1))


def numpy_params(module, *inputs, seed: int, noise: float):
    """Parameters of the flax ``module`` at ``inputs`` from a numpy
    generator, without compiling its init: kernels at fan-in scale, norm
    scales 1 + noise, every other leaf noise (normal)."""
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        n = rs.normal(0.0, 1.0, s.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return jnp.asarray(n / np.sqrt(np.prod(s.shape[:-1])))
        return jnp.asarray(n * noise + (name == "scale" or name.endswith("layer_norm")))

    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs))


def write_inputs(d, size=24):
    """An RGBA image (opaque square, transparent border) and its
    ``_depth.png`` and ``_normal.png`` side files; the RGBA path."""
    from PIL import Image

    rng = np.random.RandomState(0)
    rgba = np.zeros((size, size, 4), np.uint8)
    rgba[4:-4, 4:-4, :3] = rng.randint(80, 255, (size - 8, size - 8, 3))
    rgba[4:-4, 4:-4, 3] = 255
    path = os.path.join(str(d), "cond_rgba.png")
    Image.fromarray(rgba, "RGBA").save(path)
    yy, xx = np.mgrid[:size, :size]
    Image.fromarray((40 + 4 * (xx + yy)).astype(np.uint8), "L").save(
        path.replace("_rgba", "_depth"))
    Image.fromarray(rng.randint(0, 255, (size, size, 3)).astype(np.uint8), "RGB").save(
        path.replace("_rgba", "_normal"))
    return path


@pytest.fixture(scope="module")
def cond_png(tmp_path_factory):
    return write_inputs(tmp_path_factory.mktemp("z123"))


def carry_zero123(tg, jparams):
    """The JAX Zero123 guidance's weights into the port's guidance ``tg``,
    then its conditioning embedded again."""
    jp = _np(jparams)
    tg.unet.load_state_dict(flax_to_torch_state_dict(jp["unet"], "unet"),
                            strict=tg.unet_class_embed_dim is None)
    tg.vae.load_state_dict(flax_to_torch_state_dict(jp["vae"], "vae"), strict=True)
    tg.vision.load_state_dict(flax_to_torch_state_dict(jp["vision"], "clip_vision"), strict=True)
    tg.cc_w = torch.from_numpy(np.array(jp["cc_projection"]["w"]))
    tg.cc_b = torch.from_numpy(np.array(jp["cc_projection"]["b"]))
    tg.embed_condition(tg.cond_rgb)


def guidance_pair(name, cond_png, **over):
    cfg = {"model_size": "tiny", "half_precision_weights": False, "width": 24, "height": 24,
           "cond_image_path": cond_png, "cond_elevation_deg": 5.0, "cond_azimuth_deg": 10.0,
           "cond_camera_distance": 1.5, "guidance_scale": 5.0, "cache_dir": None, **over}
    jg = dreammat_tpu.find(name)(cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconvert, "fast_random_init", _numpy_random_init)
        jg.init_params(jax.random.PRNGKey(0))
    tg = dreammat_tpu_torch.find(name)(cfg, device="cpu")
    tg.init_params(torch.Generator().manual_seed(0))
    carry_zero123(tg, jg.params)
    return jg, tg


VIEW = (np.asarray([20.0], np.float32), np.asarray([100.0], np.float32),
        np.asarray([1.7], np.float32))


# -- the image tower ------------------------------------------------------------------
@pytest.mark.parametrize("size", [24, 48])
def test_clip_vision_and_both_key_map_directions_match_jax(size):
    from dreammat_tpu.models.diffusion.clip_vision import (
        CLIPVisionConfig as JCfg, CLIPVisionModel as JModel,
    )
    from dreammat_tpu_torch.models.diffusion.clip_vision import CLIPVisionConfig, CLIPVisionModel

    jm = JModel(JCfg.tiny())
    img = np.random.RandomState(3).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    params = numpy_params(jm, jnp.zeros((1, size, size, 3)), seed=9, noise=0.05)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(img)))
    tm = CLIPVisionModel(CLIPVisionConfig.tiny()).eval()
    tm.load_state_dict(flax_to_torch_state_dict(_np(params), "clip_vision"), strict=True)
    with torch.no_grad():
        _close(tm(torch.from_numpy(nchw(img))), ref, rtol=1e-5, what="flax tree")
    # an HF-layout checkpoint (as the JAX converter writes one) through the loader
    hf = {k: torch.from_numpy(np.array(v)) for k, v in
          jconvert.flax_to_torch_state_dict(params, "clip_vision").items()}
    assert "vision_model.pre_layrnorm.weight" in hf
    tm2 = CLIPVisionModel(CLIPVisionConfig.tiny()).eval()
    report = load_diffusers_weights(tm2, hf, "clip_vision", strict=True)
    assert not report["missing"] and not report["unused"]
    with torch.no_grad():
        _close(tm2(torch.from_numpy(nchw(img))), ref, rtol=1e-5, what="HF state dict")
    assert ref.shape == (2, 1, JCfg.tiny().projection_dim)


# -- zero123-guidance --------------------------------------------------------------------
@pytest.fixture(scope="module")
def z123(cond_png):
    return guidance_pair("zero123-guidance", cond_png)


def test_zero123_conditioning_matches_jax(z123):
    jg, tg = z123
    _close(tg.c_crossattn, jg.params["c_crossattn"], rtol=1e-5, what="c_crossattn")
    _close(tg.c_concat, nchw(jg.params["c_concat"]), rtol=1e-5, what="c_concat (unscaled)")
    jctx, jcat = jg.get_cond(jg.params, *(jnp.asarray(v) for v in VIEW))
    tctx, tcat = tg.get_cond(*(torch.from_numpy(v) for v in VIEW))
    _close(tctx, jctx, rtol=1e-5, what="context")
    _close(tcat, nchw(jcat), rtol=1e-5, what="concat")
    assert not tctx[0].abs().max() and not tcat[0].abs().max()
    assert tctx[1].abs().max() > 0 and tcat[1].abs().max() > 0


def zero123_draws(k, lat_hw, prefix=""):
    """The draws of the JAX Zero123 guidance's key ``k`` (split as there)."""
    k_t, k_noise, k_enc = jax.random.split(k, 3)
    lat = (1, *lat_hw, 4)
    return {prefix + "t": jax.random.uniform(k_t, (1,)),
            prefix + "noise": nchw(jax.random.normal(k_noise, lat)),
            prefix + "vae_eps": nchw(jax.random.normal(k_enc, lat))}


@pytest.mark.parametrize("render,grad_clip", [(24, None), (16, 0.05)])
def test_zero123_sds_loss_and_image_gradient_match_jax(z123, render, grad_clip):
    jg, tg = z123
    jg.cfg.grad_clip = tg.cfg.grad_clip = grad_clip
    rgb = np.random.RandomState(4).uniform(0, 1, (1, render, render, 3)).astype(np.float32)
    k = jax.random.PRNGKey(5)
    view = [jnp.asarray(v) for v in VIEW]
    loss_fn = lambda x: jg(jg.params, x, *view, step=0, rng=k)["loss_sds"]
    jl, jgrad = jax.jit(jax.value_and_grad(loss_fn))(jnp.asarray(rgb))
    x = torch.from_numpy(nchw(rgb)).requires_grad_(True)
    f = tg.vae_factor
    out = tg(x, *(torch.from_numpy(v) for v in VIEW), step=0,
             draws=GivenDraws(zero123_draws(k, (24 // f, 24 // f))))
    out["loss_sds"].backward()
    jg.cfg.grad_clip = tg.cfg.grad_clip = None
    assert abs(float(out["loss_sds"]) - float(jl)) <= RTOL * abs(float(jl)) and float(jl) > 0
    assert _rel(x.grad.numpy(), nchw(jgrad)) < RTOL and np.abs(np.asarray(jgrad)).max() > 0


# -- zero123-vsd-guidance ----------------------------------------------------------------
@pytest.mark.parametrize("camera", ["extrinsics", "spherical"])
def test_zero123_vsd_losses_and_what_they_reach_match_jax(cond_png, camera):
    over = {"lora_rank": 2, "camera_condition_type": camera, "lora_cfg_training": True,
            "guidance_scale": 3.0}
    jg, tg = guidance_pair("zero123-vsd-guidance", cond_png, **over)
    jl = _np(jg.init_lora(jax.random.PRNGKey(1)))
    rs = np.random.RandomState(6)
    for site in jl["layers"].values():  # the LoRA delta away from zero
        site["up"] = rs.normal(0, 0.05, site["up"].shape).astype(np.float32)
    lora = tg.init_lora(torch.Generator().manual_seed(1))
    lora.load_state_dict(lora_state_from_numpy(jl, lora.layers.sites), strict=True)
    rgb = rs.uniform(0, 1, (1, 24, 24, 3)).astype(np.float32)
    c2w = np.eye(4, dtype=np.float32)[None]
    c2w[0, :3, 3] = [1.0, -0.5, 0.8]
    k = jax.random.PRNGKey(7)
    view = [jnp.asarray(v) for v in VIEW]

    def both(x, lp):
        def fn(x, lp):
            o = jg(jg.params, x, *view, c2w=jnp.asarray(c2w), lora_params=lp, step=0, rng=k)
            return o["loss_vsd"], o["loss_lora"]
        if camera != "extrinsics":  # the losses only: one compile of the gradients is enough
            return fn(x, lp), None, None
        out, vjp = jax.vjp(fn, x, lp)
        return out, vjp((1.0, 0.0)), vjp((0.0, 1.0))

    (jvsd, jlora), g_vsd, g_lora = jax.jit(both)(jnp.asarray(rgb),
                                                 jax.tree_util.tree_map(jnp.asarray, jl))
    ks = jax.random.split(k, 6)
    f = tg.vae_factor
    lat = (1, 24 // f, 24 // f, 4)
    draws = GivenDraws({"t": jax.random.uniform(ks[0], (1,)),
                        "noise": nchw(jax.random.normal(ks[1], lat)),
                        "vae_eps": nchw(jax.random.normal(ks[2], lat)),
                        "t2": jax.random.randint(ks[3], (1,), 0, 1000),
                        "noise2": nchw(jax.random.normal(ks[4], lat)),
                        "camera_drop": jax.random.uniform(ks[5], (1, 1))})
    x = torch.from_numpy(nchw(rgb)).requires_grad_(True)
    out = tg(x, *(torch.from_numpy(v) for v in VIEW), c2w=torch.from_numpy(c2w), lora=lora,
             step=0, draws=draws)
    for key, ref in (("loss_vsd", jvsd), ("loss_lora", jlora)):
        assert abs(float(out[key]) - float(ref)) <= RTOL * abs(float(ref)) and float(ref) > 0, key
    if g_vsd is None:
        return
    out["loss_vsd"].backward(retain_graph=True)
    assert _rel(x.grad.numpy(), nchw(g_vsd[0])) < RTOL and x.grad.abs().max() > 0
    assert all(p.grad is None or not p.grad.abs().max() for p in lora.parameters())
    assert all(not np.abs(leaf).max() for leaf in jax.tree_util.tree_leaves(g_vsd[1]))
    x.grad = None
    out["loss_lora"].backward()
    assert x.grad is None and not np.abs(np.asarray(g_lora[0])).max()
    ref = lora_state_from_numpy(_np(g_lora[1]), lora.layers.sites)
    for name, p in lora.named_parameters():
        if not ref[name].abs().max():  # a factor whose partner is zero
            assert not p.grad.abs().max(), name
            continue
        assert _rel(p.grad.numpy(), ref[name].numpy()) < 1e-3, name
    assert ref["camera_embedding.linear_1.weight"].abs().max() > 0


def test_zero123_vsd_needs_the_lora_state(cond_png):
    tg = dreammat_tpu_torch.find("zero123-vsd-guidance")(
        {"model_size": "tiny", "width": 24, "height": 24, "cond_image_path": cond_png,
         "cache_dir": None}, device="cpu")
    tg.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="LoRA"):
        tg(torch.rand(1, 3, 24, 24), *(torch.from_numpy(v) for v in VIEW), c2w=torch.eye(4)[None],
           draws=GivenDraws({}))


# -- the unified names ----------------------------------------------------------------
@pytest.mark.parametrize("name,mode", [("stable-diffusion-unified-guidance", "sds"),
                                       ("stable-diffusion-unified-guidance", "vsd"),
                                       ("zero123-unified-guidance", "sds"),
                                       ("zero123-unified-guidance", "vsd")])
def test_unified_factories_match_jax(cond_png, name, mode):
    cfg = {"guidance_type": mode, "model_size": "tiny", "guidance_scale": 7.0,
           "half_precision_weights": False, "grad_clip": [0, 2.0, 8.0, 1000], "width": 24,
           "height": 24, "vsd_guidance_scale_phi": 2.0, "vsd_lora_cfg_training": False,
           "enable_memory_efficient_attention": True, "token_merging": False}
    if name.startswith("zero123"):
        cfg["cond_image_path"] = cond_png
    jg = dreammat_tpu.find(name)(cfg)
    tg = dreammat_tpu_torch.find(name)(cfg, device="cpu")
    assert type(tg).__name__ == type(jg).__name__
    assert type(tg).registry_name == type(jg).registry_name
    shared = set(jg.cfg.__dataclass_fields__) & set(tg.cfg.__dataclass_fields__)
    for field_name in shared:
        assert getattr(tg.cfg, field_name) == getattr(jg.cfg, field_name), field_name
    assert tg.cfg.guidance_scale == 7.0 and tg.cfg.width == 24
    if mode == "vsd":
        phi = "guidance_scale_phi" if name.startswith("zero123") else "guidance_scale_lora"
        assert getattr(tg.cfg, phi) == 2.0 and tg.cfg.lora_cfg_training is False


# -- the data module ------------------------------------------------------------------
@pytest.mark.parametrize("noise", [0.0, 1e-2])
def test_single_image_datamodule_matches_jax(cond_png, noise):
    cfg = {"height": 24, "width": 24, "image_path": cond_png, "default_elevation_deg": 10.0,
           "default_azimuth_deg": 30.0, "default_camera_distance": 1.5,
           "rays_noise_scale": noise, "n_test_views": 3, "requires_depth": True,
           "requires_normal": True,
           "random_camera": {"camera_distance_range": [1.2, 1.8], "fovy_range": [40, 70]}}
    jdm = dreammat_tpu.find("single-image-datamodule")(cfg, None, None)
    jdm.setup()
    draws = GivenDraws({"rays_noise": jax.random.normal(jax.random.PRNGKey(0), (24, 24, 3))})
    tdm = dreammat_tpu_torch.find("single-image-datamodule")(cfg, None, None, device="cpu",
                                                             draws=draws)
    tdm.setup()
    for step in range(2):
        jb, tb = jdm.collate(step), tdm.collate(step)
        for key in ("rays_o", "rays_d", "light_positions", "rgb", "mask", "ref_depth",
                    "ref_normal", "elevation", "azimuth", "camera_distances"):
            assert np.abs(tb[key].numpy() - np.asarray(jb[key])).max() <= 1e-6, key
        for key in ("rays_o", "rays_d", "light_positions", "elevation", "azimuth"):
            assert np.abs(tb["random_camera"][key].numpy()
                          - np.asarray(jb["random_camera"][key])).max() <= 1e-5, key
    assert tb["mask"][12, 12, 0] == 1 and tb["mask"][0, 0, 0] == 0
    je, te = jdm.eval_rays(1), tdm.eval_rays(1)
    assert np.abs(te["rays_d"].numpy() - np.asarray(je["rays_d"])).max() <= 1e-5


# -- the systems ----------------------------------------------------------------------
def image_overrides(cond_png, tmp, zero123: bool = True):
    """The image path (and, with ``zero123``, the guidance's) and the output root."""
    return [f"data.image_path={cond_png}", f"exp_root_dir={tmp}/outputs"] + (
        [f"system.guidance.cond_image_path={cond_png}"] if zero123 else [])


def loss_rows(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return [{k: float(v) for k, v in r.items() if k.startswith("loss") and v != ""}
            for r in rows]


def system_pair(config, overrides, system_type):
    """``fast_pair`` with every Zero123 guidance's weights carried across."""
    jsys, jdm, tsys, tdm, state0 = fast_pair(config, overrides, system_type)
    for name in ("guidance", "guidance_3d"):
        tg = getattr(tsys, name, None)
        if tg is not None and hasattr(tg, "cc_w"):
            carry_zero123(tg, getattr(jsys, name).params)
    return jsys, jdm, tsys, tdm, state0


def step_keys():
    """The key of step 0 of the JAX ``fit``."""
    rng = jax.random.split(jax.random.PRNGKey(SEED), 3)[2]
    return jax.random.split(rng)[1]


def compare_step(tmp_path, jsys, jdm, tsys, tdm, state0, draws, moves=True):
    """One ``fit`` step of both packages from ``state0``; every loss term to
    relative 1e-4 and (``moves``) the scene's moves to relative L2 0.05."""
    jstate = jsys.fit(jdm, max_steps=1, state=jax.tree_util.tree_map(jnp.asarray, state0),
                      seed=SEED, trial_dir=str(tmp_path / "jax"), val_check_interval=0,
                      checkpoint_every=0, log_every=1)
    tsys.init_state(SEED)
    occ = state0["render"].get("occ") if isinstance(state0.get("render"), dict) else None
    tsys.field.load_state_dict(volume_scene_from_numpy(state0["geo"], state0["bg"], occ),
                               strict=True)
    tsys.fit(tdm, max_steps=1, seed=SEED, trial_dir=str(tmp_path / "torch"), log_every=1,
             val_check_interval=0, checkpoint_every=0, draws=GivenDraws([draws]))
    jl = loss_rows(os.path.join(tmp_path, "jax", "logs", "metrics.csv"))
    tl = loss_rows(os.path.join(tmp_path, "torch", "logs", "metrics.csv"))
    assert len(jl) == len(tl) == 1 and sorted(jl[0]) == sorted(tl[0]), (jl, tl)
    off = {key: (tl[0][key], ref) for key, ref in jl[0].items()
           if abs(tl[0][key] - ref) > RTOL * max(abs(ref), 1e-6)}
    assert not off, (off, jl[0])
    if moves:
        j1 = volume_scene_from_numpy(_np(jstate["geo"]), _np(jstate["bg"]), occ)
        j0 = volume_scene_from_numpy(state0["geo"], state0["bg"], occ)
        for name, p in tsys.field.named_parameters():
            moved_t, moved_j = (p.detach() - j0[name]).numpy(), (j1[name] - j0[name]).numpy()
            if not np.abs(moved_j).any():
                assert not np.abs(moved_t).any(), name
                continue
            assert _rel(moved_t, moved_j) < 0.05, name
    return jstate, jl[0]


def volume_draws(jsys, tdm, k_render, k_it, n_rays):
    """The renderer's draws of ``k_render`` for ``n_rays`` rays and the
    occupancy refresh's of step key ``k_it``."""
    r = jsys.renderer.cfg
    d = _render_draws(k_render, n_rays, r.num_samples_per_ray, r.num_samples_per_ray_importance,
                      perturb=True)
    d["occ_jitter"] = jax.random.uniform(jax.random.fold_in(k_it, 0x0CC),
                                         (r.grid_resolution ** 3, 3))
    return d


ZERO123_STEP = ["data.requires_depth=true", "data.requires_normal=true",
                "system.loss.lambda_depth=0.5", "system.loss.lambda_depth_rel=0.2",
                "system.loss.lambda_normal=0.3", "system.loss.lambda_3d_normal_smooth=0.4",
                "system.renderer.return_normal_perturb=true"]


def test_zero123_system_step_matches_jax(tmp_path, cond_png):
    pair = system_pair(Z123_TINY, image_overrides(cond_png, tmp_path) + ZERO123_STEP,
                       "zero123-system")
    jsys, jdm, tsys, tdm, state0 = pair
    assert type(tsys.guidance).__name__ == "Zero123Guidance"
    k = step_keys()
    k_ref, _, k_guide = jax.random.split(k, 3)
    n = tdm.cfg.height * tdm.cfg.width
    d = volume_draws(jsys, tdm, k_ref, k, 2 * n)
    f = tsys.guidance.vae_factor
    d.update(zero123_draws(k_guide, (24 // f, 24 // f)))
    _, losses = compare_step(tmp_path, *pair, d)
    for key in ("loss_rgb", "loss_mask", "loss_depth", "loss_depth_rel", "loss_normal",
                "loss_sds", "loss_normal_smooth", "loss_3d_normal_smooth", "loss_orient"):
        assert key in losses and losses[key] != 0, key


def test_zero123_simple_system_step_matches_jax(tmp_path, cond_png):
    over = image_overrides(cond_png, tmp_path) + [
        "system_type=zero123-simple-system",
        "system.loss!={lambda_sds: 0.1, lambda_orient: 1.0, lambda_normal_smoothness_2d: 0.3, "
        "lambda_sparsity: 0.5, lambda_opaque: 0.5}"]
    pair = system_pair(Z123_TINY, over, "zero123-simple-system")
    jsys, jdm, tsys, tdm, state0 = pair
    k = step_keys()
    k_render, k_guide = jax.random.split(k)
    d = volume_draws(jsys, tdm, k_render, k, tdm.cfg.height * tdm.cfg.width)
    f = tsys.guidance.vae_factor
    d.update(zero123_draws(k_guide, (24 // f, 24 // f)))
    _, losses = compare_step(tmp_path, *pair, d)
    assert losses["loss_normal_smoothness_2d"] != 0 and "loss_rgb" not in losses
