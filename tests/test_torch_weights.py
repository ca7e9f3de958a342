"""Port parity: SD weights from ``cache_dir`` reach the port's models.

- At SD2.1 size, built on the meta device, the port's UNet, VAE, CLIP text
  encoder and 22-channel ControlNet hold exactly the keys and shapes of the
  diffusers / transformers manifests of ``dreammat_tpu/models/diffusion/
  manifest.py`` (written from those libraries' architectures, not from
  either package's modules): a checkpoint in the diffusers layout then
  fills every parameter.
- Tiny random checkpoints in the diffusers layout (fp16 safetensors, the
  VAE's attention under its old names, CLIP's position embedding without
  ``.weight`` and a ``position_ids`` buffer) are written into a temporary
  ``cache_dir`` and loaded by both packages' guidance and prompt
  processor; one ControlNet + UNet noise prediction agrees to relative L2
  2e-3 and one prompt embedding to 1e-4.
- The loader's report: a renamed key is missing (and the checkpoint's key
  unused), a file that matches no key raises, a shape mismatch raises,
  ``strict`` raises on a missing key, and old [C, C, 1, 1] VAE attention
  weights load into [C, C].
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
import dreammat_tpu_torch.models  # noqa: F401
from dreammat_tpu.models.diffusion import convert as jconvert
from dreammat_tpu.models.diffusion import manifest
from dreammat_tpu_torch.models.diffusion import convert
from dreammat_tpu_torch.models.diffusion.clip_text import CLIPTextConfig, CLIPTextModel
from dreammat_tpu_torch.models.diffusion.controlnet import ControlNet, ControlNetConfig
from dreammat_tpu_torch.models.diffusion.unet import UNet2DCondition, UNetConfig
from dreammat_tpu_torch.models.diffusion.vae import AutoencoderKL, VAEConfig
from dreammat_tpu_torch.utils.safetensors_io import save_file
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


SD21 = {
    "unet": (lambda: UNet2DCondition(UNetConfig.sd21()), manifest.unet_manifest),
    "vae": (lambda: AutoencoderKL(VAEConfig.sd()), manifest.vae_manifest),
    "clip": (lambda: CLIPTextModel(CLIPTextConfig.sd21()), manifest.clip_text_manifest),
    "controlnet": (lambda: ControlNet(ControlNetConfig(unet=UNetConfig.sd21(),
                                                       conditioning_channels=22)),
                   manifest.controlnet_manifest),
}


@pytest.mark.parametrize("kind", sorted(SD21))
def test_sd21_models_match_the_diffusers_manifests(kind):
    build, man = SD21[kind]
    with torch.device("meta"):
        model = build()
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = {k: tuple(v) for k, v in man().items()}
    assert sorted(set(want) - set(got)) == []
    assert sorted(set(got) - set(want)) == []
    assert {k: s for k, s in got.items() if want[k] != s} == {}


def _old_vae_names(sd, conv_shape=False):
    """The VAE attention under the old diffusers names (query, key, value,
    proj_attn), optionally as 1x1 convolutions."""
    out = {}
    for k, v in sd.items():
        for new, old in convert._VAE_ALIASES:
            if f".{new}." in k:
                k = k.replace(new, old)
                if conv_shape and v.dim() == 2:
                    v = v[:, :, None, None]
        out[k] = v
    return out


def _tiny_models(seed=0):
    g = torch.Generator().manual_seed(seed)
    models = {
        "unet": UNet2DCondition(UNetConfig.tiny()),
        "vae": AutoencoderKL(VAEConfig.tiny()),
        "text_encoder": CLIPTextModel(CLIPTextConfig.tiny()),
        "controlnet": ControlNet(ControlNetConfig(unet=UNetConfig.tiny(),
                                                  conditioning_embedding_channels=(16, 32))),
    }
    return {k: convert.random_init_(m, g, std=0.05).eval() for k, m in models.items()}


def _write_cache_dir(root, models):
    """Diffusers-layout fp16 safetensors of ``models`` under ``root``."""
    for sub, m in models.items():
        sd = {k: v.half() for k, v in m.state_dict().items()}
        if sub == "vae":
            sd = _old_vae_names(sd)
        if sub == "text_encoder":
            sd["text_model.embeddings.position_embedding"] = sd.pop(
                "text_model.embeddings.position_embedding.weight")
            sd["text_model.embeddings.position_ids"] = torch.arange(16)[None]
        name = "model" if sub == "text_encoder" else "diffusion_pytorch_model"
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        save_file(sd, os.path.join(root, sub, f"{name}.safetensors"))
    return root


def _numpy_random_init(rng, init_fn):
    """``fast_random_init``'s fill from numpy (every leaf is overwritten by
    the checkpoint; this only skips jax.random's per-leaf compiles)."""
    shapes = jax.eval_shape(init_fn)
    gen = np.random.RandomState(0)
    return jax.tree_util.tree_map(lambda s: jnp.asarray(gen.normal(0, 0.02, s.shape), s.dtype),
                                  shapes)


GUIDANCE = {"model_size": "tiny", "half_precision_weights": False, "width": 32, "height": 32}


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sd"))
    models = _tiny_models()
    _write_cache_dir(root, models)
    cfg = dict(GUIDANCE, cache_dir=root, controlnet_path=os.path.join(root, "controlnet"))
    jg = dreammat_tpu.find("stable-diffusion-dreammat-guidance")(cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconvert, "fast_random_init", _numpy_random_init)
        jg.init_params(jax.random.PRNGKey(0))
    tg = dreammat_tpu_torch.find("stable-diffusion-dreammat-guidance")(cfg, device="cpu")
    tg.init_params()
    return root, models, jg, tg


def test_guidance_holds_the_cache_dir_weights(loaded):
    _, models, _, tg = loaded
    for name in ("unet", "vae"):
        report = tg.loaded[name]
        assert report["missing"] == [] and report["unused"] == [], name
        own = getattr(tg, name).state_dict()
        assert len(report["loaded"]) == len(own), name
        for k, v in models[name].state_dict().items():
            assert torch.equal(own[k], v.half().float()), (name, k)


def test_noise_prediction_matches_jax(loaded):
    _, _, jg, tg = loaded
    rng = np.random.RandomState(1)
    B, h = 2, 16
    lat = rng.normal(size=(B, h, h, 4)).astype(np.float32)
    t = np.array([50, 700], np.int32)
    ctx = rng.normal(size=(3 * B, 16, 64)).astype(np.float32)
    cond = rng.uniform(size=(1, 2 * h, 2 * h, 22)).astype(np.float32)
    scales = [1.0]
    # jitted: eagerly the JAX UNet and ControlNet compile op by op
    j = jax.jit(jg.noise_pred, static_argnums=6)(
        jg.params, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx), [jnp.asarray(cond)],
        [jnp.float32(1.0)], 3)
    nchw = lambda x: torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))
    with torch.no_grad():
        got = tg.noise_pred(nchw(lat), torch.from_numpy(t).long(), torch.from_numpy(ctx),
                            [nchw(cond)], scales, 3)
    assert _rel(got.permute(0, 2, 3, 1).numpy(), np.asarray(j)) < 2e-3


def test_prompt_embedding_matches_jax(loaded):
    root = loaded[0]
    cfg = {"model_size": "tiny", "pretrained_model_cache_dir": root, "use_cache": False,
           "prompt": "a red apple"}
    jp = dreammat_tpu.find("stable-diffusion-prompt-processor")(cfg)
    tp = dreammat_tpu_torch.find("stable-diffusion-prompt-processor")(cfg, device="cpu")
    prompts = ["a red apple, front view", ""]
    j = jp._encode_uncached(prompts)
    got = tp.encode_prompts(prompts).numpy()
    assert tp.loaded["missing"] == [] and tp.loaded["unused"] == []
    assert _rel(got, j) < 1e-4


def test_renamed_key_is_counted_missing_and_unused():
    m = AutoencoderKL(VAEConfig.tiny())
    sd = dict(m.state_dict())
    sd["encoder.conv_in.weight_renamed"] = sd.pop("encoder.conv_in.weight")
    report = convert.load_diffusers_weights(m, sd, "vae")
    assert report["missing"] == ["encoder.conv_in.weight"]
    assert report["unused"] == ["encoder.conv_in.weight_renamed"]
    assert len(report["loaded"]) == len(sd) - 1
    with pytest.raises(KeyError, match="1 missing"):
        convert.load_diffusers_weights(m, sd, "vae", strict=True)


def test_a_file_that_loads_no_key_raises(tmp_path):
    m = CLIPTextModel(CLIPTextConfig.tiny())
    os.makedirs(tmp_path / "text_encoder")
    save_file({"something.else": torch.zeros(3)}, str(tmp_path / "text_encoder" / "model.safetensors"))
    with pytest.raises(ValueError, match="no key matches"):
        convert.load_model_dir(m, str(tmp_path / "text_encoder"), "clip")
    assert convert.load_model_dir(m, str(tmp_path / "absent"), "clip") is None


def test_shape_mismatch_raises():
    m = CLIPTextModel(CLIPTextConfig.tiny())
    sd = dict(m.state_dict())
    sd["text_model.final_layer_norm.weight"] = torch.ones(65)
    with pytest.raises(ValueError, match="final_layer_norm"):
        convert.load_diffusers_weights(m, sd, "clip")


def test_old_conv_shaped_vae_attention_loads():
    src = convert.random_init_(AutoencoderKL(VAEConfig.tiny()), torch.Generator().manual_seed(3))
    sd = _old_vae_names(src.state_dict(), conv_shape=True)
    assert any(v.dim() == 4 and k.endswith("query.weight") for k, v in sd.items())
    dst = AutoencoderKL(VAEConfig.tiny()).to(torch.bfloat16)
    report = convert.load_diffusers_weights(dst, sd, "vae", strict=True)
    assert report["missing"] == [] and report["unused"] == []
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v.to(torch.bfloat16)), k
