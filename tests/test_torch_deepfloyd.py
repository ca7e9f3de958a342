"""Port parity: DeepFloyd IF (T5, its prompt processor, the pixel-space
guidance, one DreamFusion-IF step) against JAX, the new entry points'
devices, and main path 10's CPU form.

Every case feeds the same numpy inputs, and the JAX package's random draws
by name, to both packages on the CPU at tiny size, with the weights carried
across by the port's weight bridge (the ``t5`` key map):

- the T5 encoder with its shared relative position bias, from the flax
  tree and from the HF-layout state dict the JAX converter writes, to 1e-5
  (relative to the largest value); the bucketing exactly;
- ``deep-floyd-prompt-processor``'s byte-level tokens exactly and its
  embeddings to 1e-5; ``dummy-prompt-processor``'s to 1e-5;
- ``deep-floyd-guidance`` at B = 1, plain (``sds`` weighting) and with
  Perp-Neg (``fantasia3d`` weighting, ``grad_clip``): ``loss_sds`` and the
  image gradient to relative 1e-4. At B = 2 with Perp-Neg (``uniform``,
  scale 2000, two front-side views, whose negatives differ) the port runs
  each sample's two negatives on its own latent (the prompt embeddings
  interleave them): its loss is the mean of the JAX guidance's B = 1 losses
  of the two samples, to relative 1e-4, and the JAX B = 2 loss, which
  reads the negatives in blocks, is off it by more than 1e-3 (ROADMAP,
  queue 3); the port's SD guidance likewise at B = 2 against its own
  B = 1 losses;
- one ``configs/dreamfusion_if_tiny.yaml`` step: the loss to relative
  1e-4, the scene's moves to relative L2 0.05 (Adam with eps 1e-15);
- the new entry points need CUDA unless the CPU is asked for; Zero123's
  UNet, VAE and image tower, IF's UNet and T5 load from a ``cache_dir``
  written in the diffusers / transformers layout, every key;
- ``chip_smoke.drive_single_image`` on the CPU at tiny size (main path 10's
  eight runs through ``launch_torch.main`` and the VSD phase).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreammat_tpu
import dreammat_tpu.models  # noqa: F401
import dreammat_tpu_torch
from dreammat_tpu.models.diffusion import convert as jconvert
from dreammat_tpu.models.prompt import PromptEmbeddings as JPromptEmbeddings
from dreammat_tpu.utils.config import load_config as jload
from dreammat_tpu_torch.models.diffusion.convert import (
    flax_to_torch_state_dict, load_diffusers_weights, volume_scene_from_numpy,
)
from dreammat_tpu_torch.models.prompt import PromptEmbeddings
from dreammat_tpu_torch.utils.config import load_config as tload

from test_torch_dreammat_step import _csv_losses, _np, _rel
from test_torch_dreammat_step import _numpy_random_init
from test_torch_zero123 import numpy_params, write_inputs
from test_torch_volume import (
    SEED, GivenDraws, _close, _given_prompt_embeddings, _render_draws,
)
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401

RTOL = 1e-4
nchw = lambda x: np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1))


# -- T5 --------------------------------------------------------------------------------
def test_t5_encoder_and_both_key_map_directions_match_jax():
    from dreammat_tpu.models.diffusion.t5 import T5Config as JCfg, T5Encoder as JT5
    from dreammat_tpu_torch.models.diffusion.t5 import T5Config, T5Encoder

    jm = JT5(JCfg.tiny())
    ids = np.random.RandomState(0).randint(0, 512, (2, 16)).astype(np.int32)
    params = numpy_params(jm, jnp.asarray(ids), seed=2, noise=0.3)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(ids)))
    tm = T5Encoder(T5Config.tiny()).eval()
    tm.load_state_dict(flax_to_torch_state_dict(_np(params), "t5"), strict=True)
    with torch.no_grad():
        _close(tm(torch.from_numpy(ids).long()), ref, rtol=1e-5, what="flax tree")
    hf = {k: torch.from_numpy(np.array(v)) for k, v in
          jconvert.flax_to_torch_state_dict(params, "t5").items()}
    tm2 = T5Encoder(T5Config.tiny()).eval()
    report = load_diffusers_weights(tm2, hf, "t5", strict=True)
    assert not report["missing"] and not report["unused"]
    with torch.no_grad():
        _close(tm2(torch.from_numpy(ids).long()), ref, rtol=1e-5, what="HF state dict")
    # the bias matters: without it the encoding moves
    with torch.no_grad():
        tm2.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight.zero_()
        assert np.abs(tm2(torch.from_numpy(ids).long()).numpy() - ref).max() > 1e-3


def test_t5_relative_position_buckets_match_jax():
    from dreammat_tpu.models.diffusion.t5 import relative_position_bucket as jbucket
    from dreammat_tpu_torch.models.diffusion.t5 import relative_position_bucket

    rel = np.arange(-300, 301)[None, :] - np.arange(0, 77)[:, None]
    assert np.array_equal(relative_position_bucket(rel, 32, 128), jbucket(rel, 32, 128))


# -- the prompt processors ---------------------------------------------------------------
@pytest.mark.parametrize("name", ["deep-floyd-prompt-processor", "dummy-prompt-processor"])
def test_prompt_processor_embeddings_match_jax(name, tmp_path):
    cfg = {"model_size": "tiny", "prompt": "a red apple", "negative_prompt": "ugly",
           "use_cache": False, "pretrained_model_cache_dir": str(tmp_path / "none")}
    if name == "dummy-prompt-processor":
        cfg = {"pretrained_model_cache_dir": str(tmp_path / "none")}
    jpp = dreammat_tpu.find(name)(cfg)
    model, params, jtok = jpp._get_encoder()
    tpp = dreammat_tpu_torch.find(name)(cfg, device="cpu")
    tmodel, ttok = tpp.get_encoder()
    kind = "t5" if name.startswith("deep") else "clip"
    tmodel.load_state_dict(flax_to_torch_state_dict(_np(params), kind), strict=True)
    prompts = [tpp.prompt, "", *tpp.prompts_vd]
    assert np.array_equal(ttok.batch(prompts), jtok.batch(prompts))
    jemb, temb = jpp(), tpp()
    for key in ("text", "uncond", "null", "text_vd", "uncond_vd"):
        _close(getattr(temb, key), getattr(jemb, key), rtol=1e-5, what=key)
    if kind == "t5":
        assert type(ttok).__name__ == "T5ByteFallbackTokenizer"
        assert tpp.text_encoder is None  # dropped once the embeddings are made
        assert temb.text.shape == (16, 64)


# -- deep-floyd-guidance ---------------------------------------------------------------
def _embeddings(perp_neg, scale=1.0):
    emb = {k: v * scale for k, v in _given_prompt_embeddings().items()}
    return (JPromptEmbeddings(**{k: jnp.asarray(v) for k, v in emb.items()},
                              use_perp_neg=perp_neg),
            PromptEmbeddings(**{k: torch.from_numpy(v) for k, v in emb.items()},
                             use_perp_neg=perp_neg))


@pytest.fixture(scope="module")
def if_pair():
    cfg = {"model_size": "tiny", "half_precision_weights": False, "resolution": 16,
           "guidance_scale": 20.0, "cache_dir": None}
    jg = dreammat_tpu.find("deep-floyd-guidance")(cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconvert, "fast_random_init", _numpy_random_init)
        jg.init_params(jax.random.PRNGKey(0))
    tg = dreammat_tpu_torch.find("deep-floyd-guidance")(cfg, device="cpu")
    tg.init_params()
    tg.unet.load_state_dict(flax_to_torch_state_dict(_np(jg.params["unet"]), "unet"),
                            strict=True)
    return jg, tg


def _if_draws(k, B, R):
    k_t, k_noise = jax.random.split(k)
    return {"t": jax.random.uniform(k_t, (B,)),
            "noise": nchw(jax.random.normal(k_noise, (B, R, R, 3)))}


def _views(B):
    return (np.asarray([20.0, 35.0][:B], np.float32), np.asarray([30.0, 60.0][:B], np.float32),
            np.asarray([1.5, 1.8][:B], np.float32))


@pytest.mark.parametrize("perp_neg,weighting,grad_clip", [(False, "sds", None),
                                                          (True, "fantasia3d", 0.5)])
def test_deep_floyd_guidance_matches_jax(if_pair, perp_neg, weighting, grad_clip):
    jg, tg = if_pair
    for g in (jg, tg):
        g.cfg.weighting_strategy, g.cfg.grad_clip = weighting, grad_clip
    jpu, tpu = _embeddings(perp_neg)
    rgb = np.random.RandomState(1).uniform(0, 1, (1, 24, 24, 3)).astype(np.float32)
    k = jax.random.PRNGKey(3)
    view = [jnp.asarray(v) for v in _views(1)]
    jl, jgrad = jax.jit(jax.value_and_grad(
        lambda x: jg(jg.params, x, jpu, *view, step=0, rng=k)["loss_sds"]))(jnp.asarray(rgb))
    x = torch.from_numpy(nchw(rgb)).requires_grad_(True)
    out = tg(x, tpu, *(torch.from_numpy(v) for v in _views(1)), None, step=0,
             draws=GivenDraws(_if_draws(k, 1, 16)))
    out["loss_sds"].backward()
    for g in (jg, tg):
        g.cfg.weighting_strategy, g.cfg.grad_clip = "sds", None
    assert abs(float(out["loss_sds"].detach()) - float(jl)) <= RTOL * abs(float(jl))
    assert float(jl) > 0 and _rel(x.grad.numpy(), nchw(jgrad)) < RTOL


def test_deep_floyd_perp_neg_pairs_each_sample_with_its_negatives(if_pair):
    jg, tg = if_pair
    for g in (jg, tg):  # a scale at which the guidance term outweighs the noise
        g.cfg.weighting_strategy, g.cfg.guidance_scale = "uniform", 2000.0
    jpu, tpu = _embeddings(True)
    rgb = np.random.RandomState(2).uniform(0, 1, (2, 24, 24, 3)).astype(np.float32)
    draws = _if_draws(jax.random.PRNGKey(4), 2, 16)
    tl = float(tg(torch.from_numpy(nchw(rgb)), tpu, *(torch.from_numpy(v) for v in _views(2)),
                  None, draws=GivenDraws(draws))["loss_sds"])

    def jax_loss(params, x, elevation, azimuth, dist, t, noise):
        """The JAX guidance with its draws replaced by ``t`` and ``noise`` (NHWC)."""
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "uniform", lambda *a, **kw: t)
            mp.setattr(jax.random, "normal", lambda *a, **kw: noise)
            return jg(params, x, jpu, elevation, azimuth, dist, step=0,
                      rng=jax.random.PRNGKey(0))["loss_sds"]

    jitted = jax.jit(jax_loss)
    run = lambda x, views, d: float(jitted(jg.params, jnp.asarray(x),
                                           *(jnp.asarray(v) for v in views),
                                           jnp.asarray(d["t"]),
                                           jnp.asarray(np.moveaxis(d["noise"], 1, -1))))
    per_sample = [run(rgb[i:i + 1], [v[i:i + 1] for v in _views(2)],
                      {"t": draws["t"][i:i + 1], "noise": draws["noise"][i:i + 1]})
                  for i in range(2)]
    block = run(rgb, _views(2), draws)
    for g in (jg, tg):
        g.cfg.weighting_strategy, g.cfg.guidance_scale = "sds", 20.0
    assert abs(tl - np.mean(per_sample)) <= RTOL * abs(np.mean(per_sample))
    assert abs(block - np.mean(per_sample)) > 1e-3 * abs(np.mean(per_sample))


def test_sds_perp_neg_runs_each_negative_on_its_own_sample():
    """The SD guidance with Perp-Neg at B = 2 equals the mean of its B = 1
    losses on each sample (with the same draws): each negative runs on its
    own sample's latent (before this was fixed, the latents were replicated
    in blocks while the negatives are interleaved, and sample 1's first
    negative ran on sample 0's latent)."""
    g = dreammat_tpu_torch.find("stable-diffusion-guidance")(
        {"model_size": "tiny", "half_precision_weights": False, "cache_dir": None,
         "guidance_scale": 50.0}, device="cpu")
    g.init_params()
    _, tpu = _embeddings(True)
    rs = np.random.RandomState(5)
    rgb = rs.uniform(0, 1, (2, 3, 24, 24)).astype(np.float32)
    f = g.vae_factor
    d = {"vae_eps": rs.normal(size=(2, 4, 24 // f, 24 // f)).astype(np.float32),
         "t": np.asarray([0.3, 0.8], np.float32),
         "noise": rs.normal(size=(2, 4, 24 // f, 24 // f)).astype(np.float32)}
    views = [torch.from_numpy(v) for v in _views(2)]
    both = float(g(torch.from_numpy(rgb), tpu, *views, None, step=0,
                   draws=GivenDraws(d))["loss_sds"])
    each = [float(g(torch.from_numpy(rgb[i:i + 1]), tpu, *(v[i:i + 1] for v in views), None,
                    step=0, draws=GivenDraws({k: v[i:i + 1] for k, v in d.items()}))["loss_sds"])
            for i in range(2)]
    assert abs(both - np.mean(each)) <= RTOL * np.mean(each) and min(each) > 0


def test_deep_floyd_schedule_is_the_cosine_one(if_pair):
    jg, tg = if_pair
    _close(tg.schedule["alphas_cumprod"], jg.schedule["alphas_cumprod"], rtol=1e-6,
           what="alphas_cumprod")
    assert tg.unet.cfg.out_channels == 6 and tg.unet.cfg.in_channels == 3


# -- one DreamFusion-IF step -------------------------------------------------------------
def test_dreamfusion_if_step_matches_jax(tmp_path):
    from dreammat_tpu.models.volume_renderer import NeRFVolumeRenderer as JNeRF

    config = "configs/dreamfusion_if_tiny.yaml"
    over = ["system.prompt_processor.prompt=a red apple", f"exp_root_dir={tmp_path}/outputs"]
    jcfg, tcfg = jload(config, over), tload(config, over)
    k_init, k_guidance, _ = jax.random.split(jax.random.PRNGKey(SEED), 3)
    jsys = dreammat_tpu.find("dreamfusion-system")(jcfg.system)
    jdm = dreammat_tpu.find(jcfg.data_type)(jcfg.data, jsys.renderer, jsys.material)
    jdm.setup()
    jpu, tpu = _embeddings(False)
    jsys.prompt_processor, jsys.prompt_utils = "given", jpu
    jitted = jax.jit(JNeRF.update_occ, static_argnums=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconvert, "fast_random_init", _numpy_random_init)
        mp.setattr(JNeRF, "update_occ", lambda self, *a: jitted(self, *a))
        jsys.on_fit_start(k_guidance)
        state0 = _np(jsys.init_state(k_init))
        tsys = dreammat_tpu_torch.find("dreamfusion-system")(tcfg.system, device="cpu")
        tdm = dreammat_tpu_torch.find(tcfg.data_type)(tcfg.data, tsys.renderer, tsys.material,
                                                      device="cpu")
        tdm.setup()
        tsys.prompt_processor, tsys.prompt_utils = "given", tpu
        tsys.on_fit_start(SEED)
        tsys.guidance.unet.load_state_dict(
            flax_to_torch_state_dict(_np(jsys.guidance.params["unet"]), "unet"), strict=True)
        jstate = jsys.fit(jdm, max_steps=1, state=jax.tree_util.tree_map(jnp.asarray, state0),
                          seed=SEED, trial_dir=str(tmp_path / "jax"), val_check_interval=0,
                          checkpoint_every=0, log_every=1)
    assert type(tsys.guidance).__name__ == "DeepFloydGuidance"
    tsys.init_state(SEED)
    tsys.field.load_state_dict(volume_scene_from_numpy(state0["geo"], state0["bg"],
                                                       state0["render"]["occ"]), strict=True)
    rng = jax.random.split(jax.random.PRNGKey(SEED), 3)[2]
    k = jax.random.split(rng)[1]
    k_render, k_guide = jax.random.split(k)
    r = jsys.renderer.cfg
    d = _render_draws(k_render, tdm.cfg.height * tdm.cfg.width, r.num_samples_per_ray,
                      r.num_samples_per_ray_importance)
    d["occ_jitter"] = jax.random.uniform(jax.random.fold_in(k, 0x0CC),
                                         (r.grid_resolution ** 3, 3))
    d.update(_if_draws(k_guide, 1, tsys.guidance.cfg.resolution))
    tsys.fit(tdm, max_steps=1, seed=SEED, trial_dir=str(tmp_path / "torch"), log_every=1,
             val_check_interval=0, checkpoint_every=0, draws=GivenDraws([d]))
    jl = _csv_losses(os.path.join(tmp_path, "jax", "logs", "metrics.csv"))
    tl = _csv_losses(os.path.join(tmp_path, "torch", "logs", "metrics.csv"))
    assert len(jl) == len(tl) == 1 and np.allclose(tl, jl, rtol=RTOL, atol=0), (tl, jl)
    j1 = volume_scene_from_numpy(_np(jstate["geo"]), _np(jstate["bg"]), jstate["render"]["occ"])
    j0 = volume_scene_from_numpy(state0["geo"], state0["bg"], state0["render"]["occ"])
    for name, p in tsys.field.named_parameters():
        moved_t, moved_j = (p.detach() - j0[name]).numpy(), (j1[name] - j0[name]).numpy()
        if not np.abs(moved_j).any():
            assert not np.abs(moved_t).any(), name
            continue
        assert _rel(moved_t, moved_j) < 0.05, name


# -- devices and main path 10 -----------------------------------------------------------
@pytest.mark.parametrize("name", ["zero123-guidance", "zero123-vsd-guidance",
                                  "deep-floyd-guidance", "deep-floyd-prompt-processor",
                                  "single-image-datamodule", "zero123-system", "magic123-system"])
def test_new_entry_points_need_cuda_unless_cpu_is_asked_for(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    cfg = {"model_size": "tiny"} if "guidance" in name or "prompt" in name else {}
    if name.endswith("-system"):
        cfg = dict(tload("configs/zero123_tiny.yaml", ["data.image_path=x"]).system)
        if name == "magic123-system":
            cfg["guidance_type"] = "stable-diffusion-guidance"
            cfg["guidance"] = {"model_size": "tiny"}
    find = dreammat_tpu_torch.find
    args = (None, None) if name.endswith("datamodule") else ()
    with pytest.raises(RuntimeError, match="CUDA"):
        find(name)(cfg, *args)
    obj = find(name)(cfg, *args, device="cpu")
    assert obj.device.type == "cpu"


@pytest.mark.parametrize("name", ["zero123-guidance", "deep-floyd-guidance",
                                  "deep-floyd-prompt-processor"])
def test_weights_load_from_a_cache_dir(tmp_path, name):
    """Checkpoints written under ``cache_dir`` in the diffusers /
    transformers layout (the port's modules carry those key names) load
    into a fresh guidance or prompt processor, every key, none unused."""
    from dreammat_tpu_torch.utils.safetensors_io import save_file

    find = dreammat_tpu_torch.find
    cache = str(tmp_path / "cache")
    if name == "deep-floyd-prompt-processor":
        cfg = {"model_size": "tiny", "use_cache": False, "pretrained_model_cache_dir": cache}
        src = find(name)(cfg, device="cpu").get_encoder(torch.Generator().manual_seed(3))[0]
        modules = {"text_encoder": src}
    else:
        cfg = {"model_size": "tiny", "half_precision_weights": False, "cache_dir": cache}
        if name == "zero123-guidance":
            cfg.update(cond_image_path=write_inputs(tmp_path), width=24, height=24)
        src = find(name)(cfg, device="cpu")
        src.init_params(torch.Generator().manual_seed(3))
        modules = {"unet": src.unet}
        if name == "zero123-guidance":
            modules.update(vae=src.vae, vision=src.vision)
    for sub, module in modules.items():
        os.makedirs(os.path.join(cache, sub))
        save_file(module.state_dict(), os.path.join(cache, sub, "model.safetensors"))
    dst = find(name)(cfg, device="cpu")
    if name == "deep-floyd-prompt-processor":
        dst.get_encoder()
        reports, got = {"text_encoder": dst.loaded}, {"text_encoder": dst.text_encoder}
    else:
        dst.init_params()
        reports, got = dst.loaded, {sub: getattr(dst, sub) for sub in modules}
    assert sorted(reports) == sorted(modules)
    for sub, module in modules.items():
        assert not reports[sub]["missing"] and not reports[sub]["unused"], sub
        for (k, a), b in zip(module.state_dict().items(), got[sub].state_dict().values()):
            assert torch.equal(a, b), (sub, k)


def test_main_path_10_cpu_tiny_form(tmp_path):
    import chip_smoke

    res = chip_smoke.drive_single_image(str(tmp_path / "work"), device="cpu", size="tiny",
                                        steps=2)
    runs = res["runs"]
    assert list(runs) == list(chip_smoke.SINGLE_IMAGE_RUNS)
    assert [r["system"] for r in runs.values()] == [
        "Zero123", "Zero123Simple", "ImageConditionDreamFusion", "Zero123", "Magic123",
        "Magic123", "DreamFusion", "DreamFusion"]
    assert runs["zero123_refine"]["renderer"] == "MeshRasterizer"
    assert runs["magic123"]["guidance_3d"] == "Zero123Guidance"
    assert runs["dreamfusion_if"]["guidance"] == "DeepFloydGuidance"
    for r in runs.values():
        assert r["obj_f"] > 0 and len(r["losses"]) == 2
    vsd = res["zero123_vsd"]
    assert min(vsd["lora_moved"].values()) > 0 and vsd["unet_changed"] == 0
    assert 0.05 < res["input_image"]["hit_share"] < 0.9
