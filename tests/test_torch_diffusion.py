"""Port parity: the tiny diffusion stack with weights carried over.

Random flax parameters of the JAX models go through the port's weight
bridge (``dreammat_tpu_torch.models.diffusion.convert``) into the torch
models, which must load them strictly and give the same outputs on the
same numpy inputs (relative L2 1e-4; fp32 on the CPU). The JAX side runs
jitted, and its random weights are filled from numpy
(``_numpy_random_init``): op by op, the draws and the forwards compile
once per shape for tens of seconds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreammat_tpu.models.diffusion.clip_text import CLIPTextConfig as JCLIPCfg
from dreammat_tpu.models.diffusion.clip_text import CLIPTextModel as JCLIP
from dreammat_tpu.models.diffusion.controlnet import ControlNet as JControlNet
from dreammat_tpu.models.diffusion.controlnet import ControlNetConfig as JCNCfg
from dreammat_tpu.models.diffusion.unet import UNet2DCondition as JUNet
from dreammat_tpu.models.diffusion.unet import UNetConfig as JUNetCfg
from dreammat_tpu.models.diffusion.vae import AutoencoderKL as JVAE
from dreammat_tpu.models.diffusion.vae import VAEConfig as JVAECfg
from dreammat_tpu_torch.models.diffusion import convert
from dreammat_tpu_torch.models.diffusion.clip_text import CLIPTextConfig, CLIPTextModel
from dreammat_tpu_torch.models.diffusion.controlnet import ControlNet, ControlNetConfig
from dreammat_tpu_torch.models.diffusion.unet import UNet2DCondition, UNetConfig
from dreammat_tpu_torch.models.diffusion.vae import AutoencoderKL, VAEConfig
from test_torch_dreammat_step import _numpy_random_init
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401

B, h, w = 3, 8, 8


TOL = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _t(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x_nhwc), -1, 1)))


def _load(model, params, kind):
    sd = convert.flax_to_torch_state_dict(_np_tree(params), kind)
    model.load_state_dict(sd, strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    return {
        "sample": rng.normal(size=(B, h, w, 4)).astype(np.float32),
        "t": np.array([10, 500, 999], np.int32),
        "ctx": rng.normal(size=(B, 16, 64)).astype(np.float32),
        "cond": rng.uniform(size=(1, 2 * h, 2 * w, 22)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def unet_pair(inputs):
    jm = JUNet(JUNetCfg.tiny())
    params = _numpy_random_init(jax.random.PRNGKey(1), lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(inputs["sample"]), jnp.asarray(inputs["t"]),
        jnp.asarray(inputs["ctx"])))
    return jm, params, _load(UNet2DCondition(UNetConfig.tiny()), params, "unet")


@pytest.mark.parametrize("with_residuals", [False, True])
def test_unet_matches_jax(inputs, unet_pair, with_residuals):
    jm, params, tm = unet_pair
    rng = np.random.RandomState(3)
    res = mid = None
    tres = tmid = None
    if with_residuals:
        shapes = [(B, 8, 8, 32)] * 2 + [(B, 4, 4, 32), (B, 4, 4, 64)]
        res = [rng.normal(size=s).astype(np.float32) * 0.1 for s in shapes]
        mid = rng.normal(size=(B, 4, 4, 64)).astype(np.float32) * 0.1
        tres, tmid = [_t(r) for r in res], _t(mid)
        res, mid = [jnp.asarray(r) for r in res], jnp.asarray(mid)
    ref = jax.jit(jm.apply)(params, jnp.asarray(inputs["sample"]), jnp.asarray(inputs["t"]),
                            jnp.asarray(inputs["ctx"]), down_block_additional_residuals=res,
                            mid_block_additional_residual=mid)
    with torch.no_grad():
        got = tm(_t(inputs["sample"]), torch.from_numpy(inputs["t"]).long(),
                 torch.from_numpy(inputs["ctx"]), tres, tmid)
    assert _rel(got.permute(0, 2, 3, 1).numpy(), ref) < TOL


def test_controlnet_matches_jax(inputs):
    jm = JControlNet(JCNCfg(unet=JUNetCfg.tiny(), conditioning_embedding_channels=(16, 32)))
    args = [jnp.asarray(inputs[k]) for k in ("sample", "t", "ctx", "cond")]
    params = _numpy_random_init(jax.random.PRNGKey(2),
                                lambda: jm.init(jax.random.PRNGKey(0), *args))
    tm = _load(ControlNet(ControlNetConfig(unet=UNetConfig.tiny(),
                                           conditioning_embedding_channels=(16, 32))),
               params, "controlnet")
    down, mid = jax.jit(jm.apply)(params, *args, 0.8)
    with torch.no_grad():
        tdown, tmid = tm(_t(inputs["sample"]), torch.from_numpy(inputs["t"]).long(),
                         torch.from_numpy(inputs["ctx"]), _t(inputs["cond"]), 0.8)
    assert len(tdown) == len(down)
    for a, b in zip(tdown, down):
        assert _rel(a.permute(0, 2, 3, 1).numpy(), b) < TOL
    assert _rel(tmid.permute(0, 2, 3, 1).numpy(), mid) < TOL


def test_vae_encode_matches_jax():
    jm = JVAE(JVAECfg.tiny())
    x = np.random.RandomState(5).uniform(-1, 1, size=(2, 16, 16, 3)).astype(np.float32)
    params = _numpy_random_init(jax.random.PRNGKey(3),
                                lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tm = _load(AutoencoderKL(VAEConfig.tiny()), params, "vae")
    mean, logvar = jax.jit(lambda p, x: jm.apply(p, x, method=jm.encode_moments))(
        params, jnp.asarray(x))
    key = jax.random.PRNGKey(7)
    z = jax.jit(lambda p, x, k: jm.apply(p, x, k, method=jm.encode))(params, jnp.asarray(x), key)
    eps = np.asarray(jax.random.normal(key, mean.shape))
    with torch.no_grad():
        tmean, tlogvar = tm.encode_moments(_t(x))
        tz = tm.encode(_t(x), _t(eps))
    assert _rel(tmean.permute(0, 2, 3, 1).numpy(), mean) < TOL
    assert _rel(tlogvar.permute(0, 2, 3, 1).numpy(), logvar) < TOL
    assert _rel(tz.permute(0, 2, 3, 1).numpy(), z) < TOL


def test_clip_text_matches_jax():
    jm = JCLIP(JCLIPCfg.tiny())
    ids = np.random.RandomState(6).randint(0, 1024, size=(2, 16)).astype(np.int32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(4), jnp.asarray(ids))
    tm = _load(CLIPTextModel(CLIPTextConfig.tiny()), params, "clip")
    ref = jax.jit(jm.apply)(params, jnp.asarray(ids))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long())
    assert _rel(got.numpy(), ref) < TOL


def test_random_init_statistics():
    g = torch.Generator().manual_seed(0)
    m = convert.random_init_(UNet2DCondition(UNetConfig.tiny()), g)
    assert torch.all(m.conv_norm_out.weight == 1) and torch.all(m.conv_in.bias == 0)
    w = m.conv_in.weight
    assert 0.015 < float(w.detach().std()) < 0.025
