"""Port parity: the Instruct-NeRF2NeRF family against the JAX package.

The same numpy-seeded inputs, and the JAX package's random draws by name,
go through both packages on the CPU at tiny size, the weights carried
across by the weight bridge:

- the multiview datamodule on a capture the test writes: batches, eval
  rays and the slerped eval path, to 1e-6 absolute (float32 camera maths
  in two frameworks);
- the VGG16 perceptual distance and its gradient, to relative 1e-5, and a
  torchvision-layout checkpoint loaded strictly by both;
- the InstructPix2Pix guidance: the three-replica eps, one edit (the JAX
  noise injected) and the SDS loss and image gradient, to relative 1e-4
  (the tiny UNet in fp32; sums run in another order);
- one Instruct-NeRF2NeRF ``fit`` step with an edit, against the jitted JAX
  step: the edit to 1e-4 absolute, the loss to relative 1e-4, the scene's
  moves to relative L2 0.05 (Adam with eps 1e-15);
- the JAX package's fault at full width: its IP2P UNet refuses the SD 2.1
  prompt processor's 1024-wide embeddings (``jax.eval_shape``), and the
  port's runs with the 768-wide IP2P text tower (on the meta device).
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
from dreammat_tpu.models.prompt import PromptEmbeddings as JPromptEmbeddings
from dreammat_tpu.utils import perceptual as jperceptual
from dreammat_tpu_torch.models.diffusion.convert import (
    flax_to_torch_state_dict, vgg16_state_dict_from_flax, volume_scene_from_numpy,
)
from dreammat_tpu_torch.models.prompt import PromptEmbeddings
from dreammat_tpu_torch.utils import perceptual as tperceptual

from test_torch_dreammat_step import _csv_losses, _np, _rel
from test_torch_dreammat_step import _numpy_random_init
from test_torch_latentnerf import fast_pair
from test_torch_volume import (
    SEED, GivenDraws, _close, _given_prompt_embeddings, _render_draws, scene_moves,
)
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401
from tests.test_in2n import _make_scene

RTOL = 1e-4
nchw = lambda x: np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return _make_scene(str(tmp_path_factory.mktemp("mv")), n_frames=3, hw=32)


# -- the multiview datamodule --------------------------------------------------------------
def _datamodules(scene, **over):
    cfg = {"dataroot": scene, "train_downsample_resolution": 2, **over}
    jdm = dreammat_tpu.find("multiview-camera-datamodule")(cfg, None, None)
    tdm = dreammat_tpu_torch.find("multiview-camera-datamodule")(cfg, None, None, device="cpu")
    jdm.setup(), tdm.setup()
    return jdm, tdm


def _same(a, b, what, atol=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.abs(a - b).max() <= atol, (what, a.shape, b.shape)


def test_multiview_batches_and_eval_rays_match_jax(scene):
    jdm, tdm = _datamodules(scene)
    assert tdm.n_frames == jdm.n_frames == 3 and (tdm.H, tdm.W) == (16, 16)
    assert tdm.cfg.n_test_views == 3
    seen = set()
    for step in range(4):
        jb, tb = jdm.collate(step), tdm.collate(step)
        assert tb["index"] == jb["index"] and (tb["height"], tb["width"]) == (16, 16)
        seen.add(tb["index"])
        for key in ("rays_o", "rays_d", "light_positions", "gt_rgb", "elevation", "azimuth",
                    "camera_distances"):
            _same(tb[key], jb[key], (step, key))
    assert len(seen) > 1
    for i in range(3):
        jv, tv = jdm.eval_rays(i), tdm.eval_rays(i)
        for key in ("rays_o", "rays_d", "light_position", "elevation", "azimuth"):
            _same(tv[key], jv[key], (i, key))


def test_multiview_slerp_path_and_front_layout_match_jax(scene):
    jdm, tdm = _datamodules(scene, eval_interpolation=(0, 1, 4))
    for i in range(4):
        jv, tv = jdm.eval_rays(i), tdm.eval_rays(i)
        for key in ("rays_o", "rays_d", "light_position"):
            _same(tv[key], jv[key], (i, key), atol=1e-5)
    # the ends of the path are frames a and b
    _same(tdm.eval_rays(3)["rays_o"][0, 0], tdm.rays_o[1][0], "end", atol=1e-5)
    jdm, tdm = _datamodules(scene, camera_layout="front", camera_distance=1.5)
    for key in ("rays_o", "rays_d", "light_positions"):
        _same(tdm.frame_batch(2)[key], jdm.frame_batch(2)[key], key)


# -- the perceptual distance ---------------------------------------------------------------
def numpy_vgg16(seed: int = 0):
    """A VGG16 tree in the JAX package's layout (``init_vgg16``'s He-normal
    kernels) from numpy: the JAX package's own init draws op by op, eagerly,
    for seconds."""
    rs, c_in, params = np.random.RandomState(seed), 3, {"w": [], "b": []}
    for c_out, _ in jperceptual.VGG16_CONVS:
        params["w"].append(rs.normal(0, np.sqrt(2.0 / (9 * c_in)), (3, 3, c_in, c_out)).astype(
            np.float32))
        params["b"].append(rs.normal(0, 0.05, (c_out,)).astype(np.float32))
        c_in = c_out
    return params


_jdistance = jax.jit(jperceptual.perceptual_distance)


@pytest.fixture(scope="module")
def vgg_pair():
    jp = numpy_vgg16()
    tv = tperceptual.init_vgg16(torch.Generator().manual_seed(0), cache_dir=None, device="cpu")
    tv.load_state_dict(vgg16_state_dict_from_flax(jp), strict=True)
    return jp, tv


def test_perceptual_distance_and_gradient_match_jax(vgg_pair):
    jp, tv = vgg_pair
    rng = np.random.RandomState(1)
    x = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    y = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    jd, jg = jax.jit(jax.value_and_grad(_jdistance, argnums=1))(jp, x, y)
    xt = torch.from_numpy(x).requires_grad_()
    td = tperceptual.perceptual_distance(tv, xt, torch.from_numpy(y))
    td.backward()
    assert abs(td.item() - float(jd)) <= 1e-5 * abs(float(jd)), (td.item(), float(jd))
    assert _rel(xt.grad.numpy(), jg) <= 1e-5 and np.abs(np.asarray(jg)).max() > 0
    assert tperceptual.perceptual_distance(tv, xt, xt).item() < 1e-6


def test_vgg_torchvision_checkpoint_loads_strictly(vgg_pair, tmp_path):
    """A torchvision ``vgg16`` state dict (features and classifier) written
    as ``model.bin`` loads into the tower strictly: its distance is the JAX
    package's with the same weights."""
    jp, _ = vgg_pair
    sd = {k: v * 1.5 for k, v in vgg16_state_dict_from_flax(jp).items()}
    sd["classifier.0.weight"] = torch.zeros(4, 3)
    torch.save(sd, str(tmp_path / "model.bin"))
    tv = tperceptual.init_vgg16(torch.Generator().manual_seed(3), str(tmp_path), device="cpu")
    for k, v in tv.state_dict().items():
        assert torch.equal(v, sd[k]), k
    x = np.random.RandomState(4).uniform(size=(2, 16, 16, 3)).astype(np.float32)
    y = x[:, ::-1].copy()
    jd = float(_jdistance({"w": [w * 1.5 for w in jp["w"]], "b": [b * 1.5 for b in jp["b"]]},
                          x, y))
    td = tperceptual.perceptual_distance(tv, torch.from_numpy(x), torch.from_numpy(y)).item()
    assert abs(td - jd) <= 1e-5 * jd


# -- the InstructPix2Pix guidance ----------------------------------------------------------
IP2P_TINY = {"model_size": "tiny", "half_precision_weights": False, "diffusion_steps": 4,
             "fixed_size": 16, "cache_dir": None}


@pytest.fixture(scope="module")
def ip2p_pair():
    jg = dreammat_tpu.find("stable-diffusion-instructpix2pix-guidance")(IP2P_TINY)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconvert, "fast_random_init", _numpy_random_init)
        jg.init_params(jax.random.PRNGKey(0))
    tg = dreammat_tpu_torch.find("stable-diffusion-instructpix2pix-guidance")(IP2P_TINY,
                                                                           device="cpu")
    tg.init_params(torch.Generator().manual_seed(0))
    gp = _np(jg.params)
    tg.unet.load_state_dict(flax_to_torch_state_dict(gp["unet"], "unet"), strict=True)
    tg.vae.load_state_dict(flax_to_torch_state_dict(gp["vae"], "vae"), strict=True)
    emb = _given_prompt_embeddings(seed=9)
    je = JPromptEmbeddings(**{k: jnp.asarray(v) for k, v in emb.items()})
    te = PromptEmbeddings(**{k: torch.from_numpy(v) for k, v in emb.items()})
    return jg, tg, je, te


def test_ip2p_eps3_matches_jax(ip2p_pair):
    jg, tg, je, te = ip2p_pair
    rng = np.random.RandomState(2)
    lat = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    cond3 = rng.normal(size=(6, 8, 8, 4)).astype(np.float32)
    cond3[4:] = 0.0
    emb3 = rng.normal(size=(6, 16, 64)).astype(np.float32)
    t = np.asarray([150, 700], np.int32)
    jeps = jax.jit(jg._eps3)(jg.params, lat, cond3, t, emb3)
    teps = tg.eps3(torch.from_numpy(nchw(lat)), torch.from_numpy(nchw(cond3)),
                   torch.from_numpy(t).long(), torch.from_numpy(emb3))
    _close(teps.permute(0, 2, 3, 1), jeps, rtol=RTOL, what="eps3")


def _images(seed, B=1, hw=16):
    rng = np.random.RandomState(seed)
    return (rng.uniform(size=(B, hw, hw, 3)).astype(np.float32),
            rng.uniform(size=(B, hw, hw, 3)).astype(np.float32))


def ip2p_draws(key, B, lat_hw, prefix=""):
    """The draws of the JAX guidance's call from its key, by the port's names."""
    k_enc, k_t, k_sds = jax.random.split(key, 3)
    lat = (B, *lat_hw, 4)
    return {prefix + "vae_eps": nchw(jax.random.normal(k_enc, lat)),
            prefix + "t": np.asarray(jax.random.uniform(k_t, (B,))),
            prefix + "noise": nchw(jax.random.normal(k_sds, lat))}


def test_ip2p_edit_matches_jax(ip2p_pair):
    """One edit (DDIM from the drawn t down the ladder) of a 24^2 render,
    resized to the guidance's 16^2 (antialiased) and back (the system
    test edits at the guidance's own size)."""
    jg, tg, je, te = ip2p_pair
    hw = 24
    rgb, cond = _images(3, hw=hw)
    key = jax.random.PRNGKey(5 + hw)
    jout = jax.jit(lambda p, a, b: jg(p, a, b, je, step=0, rng=key)["edit_images"])(
        jg.params, rgb, cond)
    draws = GivenDraws(ip2p_draws(key, 1, (8, 8)))
    tout = tg(torch.from_numpy(rgb), torch.from_numpy(cond), te, step=0, draws=draws)
    assert tout["edit_images"].shape == (1, hw, hw, 3)
    _close(tout["edit_images"], jout, rtol=RTOL, what="edit")
    # the edit is neither the render nor the condition
    assert np.abs(np.asarray(jout) - rgb).max() > 1e-2


def test_ip2p_sds_loss_and_gradient_match_jax(ip2p_pair):
    jg, tg, je, te = ip2p_pair
    rgb, cond = _images(6, B=2)
    key = jax.random.PRNGKey(7)
    jg.cfg.use_sds = tg.cfg.use_sds = True
    jg.cfg.grad_clip = tg.cfg.grad_clip = 0.5
    try:
        jl, jgrad = jax.jit(jax.value_and_grad(
            lambda x: jg(jg.params, x, cond, je, step=0, rng=key)["loss_sds"]))(rgb)
        x = torch.from_numpy(rgb).requires_grad_()
        out = tg(x, torch.from_numpy(cond), te, step=0,
                 draws=GivenDraws(ip2p_draws(key, 2, (8, 8))))
        out["loss_sds"].backward()
    finally:
        jg.cfg.use_sds = tg.cfg.use_sds = False
        jg.cfg.grad_clip = tg.cfg.grad_clip = None
    assert abs(out["loss_sds"].item() - float(jl)) <= RTOL * abs(float(jl))
    assert _rel(x.grad.numpy(), jgrad) <= RTOL and np.abs(np.asarray(jgrad)).max() > 0


# -- the system ------------------------------------------------------------------------------
IN2N_OVERRIDES = [
    "system_type=instructnerf2nerf-system",
    "data_type=multiview-camera-datamodule",
    "system.prompt_processor.prompt=make it a painting",
    "system.guidance_type=stable-diffusion-instructpix2pix-guidance",
    "system.guidance!={model_size: tiny, half_precision_weights: false, diffusion_steps: 2, "
    "fixed_size: 16, cache_dir: null}",
    "system.per_editing_step=1", "system.start_editing_step=-1",
    "system.loss!={lambda_l1: 10.0, lambda_p: 1.0, lambda_orient: 0.0, lambda_sparsity: 1.0, "
    "lambda_opaque: 0.1}",
]


def test_in2n_step_with_edit_matches_jax(scene, vgg_pair, tmp_path):
    """Step 0 of ``fit`` in both packages: the frame's edit (rendered in
    evaluation from the field, IP2P with the JAX edit key's draws), then
    the train step on it."""
    over = IN2N_OVERRIDES + [f"data!={{dataroot: {scene}, train_downsample_resolution: 2}}"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jperceptual, "init_vgg16", lambda *a, **k: vgg_pair[0])
        jsys, jdm, tsys, tdm, state0 = fast_pair("configs/dreamfusion_tiny.yaml", over,
                                                 "instructnerf2nerf-system")
    assert type(tsys.guidance).__name__ == "InstructPix2PixGuidance"
    tsys.vgg.load_state_dict(vgg16_state_dict_from_flax(vgg_pair[0]), strict=True)
    jstate = jsys.fit(jdm, max_steps=1, state=jax.tree_util.tree_map(jnp.asarray, state0),
                      seed=SEED, trial_dir=str(tmp_path / "jax"), val_check_interval=0,
                      checkpoint_every=0, log_every=1)
    tsys.init_state(SEED)
    tsys.field.load_state_dict(volume_scene_from_numpy(state0["geo"], state0["bg"],
                                                       state0["render"]["occ"]), strict=True)
    rng = jax.random.split(jax.random.PRNGKey(SEED), 3)[2]
    _, k = jax.random.split(rng)
    H = W = 16
    G = jsys.renderer.cfg.grid_resolution
    d = _render_draws(k, H * W, tsys.renderer.cfg.num_samples_per_ray,
                      tsys.renderer.cfg.num_samples_per_ray_importance)
    d["occ_jitter"] = jax.random.uniform(jax.random.fold_in(k, 0x0CC), (G ** 3, 3))
    d.update(ip2p_draws(jax.random.PRNGKey(1000), 1, (8, 8), prefix="edit/"))
    tsys.fit(tdm, max_steps=1, seed=SEED, trial_dir=str(tmp_path / "torch"), log_every=1,
             val_check_interval=0, checkpoint_every=0, draws=GivenDraws([d]))
    (idx, edit), = tsys.edit_frames.items()
    assert list(jsys.edit_frames) == [idx] and len(tsys.edit_seconds) == 1
    assert np.abs(edit.numpy() - jsys.edit_frames[idx]).max() <= 1e-4
    assert np.abs(edit.numpy() - tdm.imgs[idx].numpy()).max() > 1e-2
    jl = _csv_losses(os.path.join(tmp_path, "jax", "logs", "metrics.csv"))
    tl = _csv_losses(os.path.join(tmp_path, "torch", "logs", "metrics.csv"))
    assert np.allclose(tl, jl, rtol=1e-4, atol=0), (tl, jl)
    for name, (moved_t, moved_j) in scene_moves(jstate, state0, tsys).items():
        assert np.abs(moved_t).max() > 0, name
        assert _rel(moved_t, moved_j) < 0.05, name


# -- the full-width fault ----------------------------------------------------------------------
def test_jax_ip2p_refuses_sd21_embeddings_and_port_runs_ip2p_tower():
    """The JAX IP2P UNet's parameters are 768 wide in cross-attention; its
    only text prompt processor gives SD 2.1's 1024-wide embeddings (and its
    ``model_size: ip2p`` falls to the tiny tower). The port's ``ip2p`` text
    tower is 768 wide, and the full-width UNet runs on its output."""
    from flax.errors import ScopeParamShapeError

    from dreammat_tpu.models.diffusion.clip_text import CLIPTextConfig as JClip
    from dreammat_tpu.models.diffusion.unet import UNet2DCondition as JUNet
    from dreammat_tpu.models.guidance_ip2p import ip2p_unet_config as jcfg
    from dreammat_tpu_torch.models.diffusion.clip_text import CLIPTextModel
    from dreammat_tpu_torch.models.diffusion.unet import UNet2DCondition
    from dreammat_tpu_torch.models.guidance_ip2p import ip2p_unet_config

    junet = JUNet(jcfg())
    x, t = jnp.zeros((3, 8, 8, 8)), jnp.zeros((3,))
    params = jax.eval_shape(junet.init, jax.random.PRNGKey(0), x[:1], t[:1],
                            jnp.zeros((1, 4, 768)))
    assert JClip.sd21().hidden_size == 1024
    with pytest.raises(ScopeParamShapeError, match="attn2/to_k"):
        jax.eval_shape(junet.apply, params, x, t, jnp.zeros((3, 77, 1024)))

    pp = dreammat_tpu_torch.find("stable-diffusion-prompt-processor")(
        {"model_size": "ip2p", "prompt": "make it a painting", "use_cache": False},
        device="cpu")
    ccfg = pp.clip_config()
    assert (ccfg.hidden_size, ccfg.num_layers, ccfg.num_heads, ccfg.intermediate_size,
            ccfg.max_length, ccfg.hidden_act) == (768, 12, 12, 3072, 77, "quick_gelu")
    with torch.device("meta"):
        emb = CLIPTextModel(ccfg)(torch.zeros(3, 77, dtype=torch.long))
        unet = UNet2DCondition(ip2p_unet_config())
        out = unet(torch.zeros(3, 8, 8, 8), torch.zeros(3, dtype=torch.long), emb)
        assert emb.shape == (3, 77, 768) and out.shape == (3, 4, 8, 8)
        with pytest.raises(RuntimeError):
            unet(torch.zeros(3, 8, 8, 8), torch.zeros(3, dtype=torch.long),
                 torch.zeros(3, 77, 1024))


def test_prompt_cache_key_of_the_ip2p_tower_is_its_own(tmp_path):
    """The embedding cache shares the JAX package's keys for ``sd21`` and
    ``tiny``; under ``model_size: ip2p`` the JAX package encodes with its
    tiny tower (64 wide), so the port's 768-wide ``ip2p`` tower keys its
    files apart and neither package reads the other's width."""
    prompt = "make it a painting"
    keys = {}
    for size in ("tiny", "sd21", "ip2p"):
        cfg = {"model_size": size, "prompt": prompt, "use_cache": True, "cache_dir": str(tmp_path)}
        jpp = dreammat_tpu.find("stable-diffusion-prompt-processor")(cfg)
        tpp = dreammat_tpu_torch.find("stable-diffusion-prompt-processor")(cfg, device="cpu")
        keys[size] = (jpp._cache_key(prompt), tpp._cache_key(prompt))
    assert keys["tiny"][0] == keys["tiny"][1] and keys["sd21"][0] == keys["sd21"][1]
    assert keys["ip2p"][0] != keys["ip2p"][1]
    assert len({k for pair in keys.values() for k in pair}) == 4
