"""Port parity: one DreamMat train step, and ``fit``, against the JAX system.

The tiny config (icosphere level 2, 32^2 renders, condition maps at 16^2 so
the guidance upsamples them, prefiltered light tables, no static field
maps, no fast-path check) is set up in both packages. The port is then
given everything that is random in the JAX package: the diffusion weights
(through the weight bridge), the field's initial
parameters, the baked visibility table (see ``test_torch_prerender.py``)
and the draws of each step, which the test makes with ``jax.random`` from
the keys the JAX system splits (``dreammat.py:122``, ``renderer.py:479,527``,
``guidance.py:282``). Both get the same prompt embeddings, made from a
numpy seed (the CLIP text encoder is compared in ``test_torch_diffusion.py``;
running it through JAX here would cost half a minute of compile). For the
same reason the JAX guidance fills its random weights from numpy rather
than leaf by leaf with ``jax.random``.

Tolerances: the loss to relative 1e-4 and the field gradient to relative
L2 1e-3 (fp32 on the CPU; sums run in another order in the two
frameworks). The first Adam update with eps = 1e-15 is lr * sign(g), so it
is compared only where |g| > 1e-6 max|g|: below that the sign is rounding.
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
from dreammat_tpu.models.diffusion.unet import UNetConfig as JUNetConfig
from dreammat_tpu.models.prompt import PromptEmbeddings as JPromptEmbeddings
from dreammat_tpu.systems.optimizers import parse_optimizer
from dreammat_tpu.utils.config import load_config as jload
from dreammat_tpu.utils.schedule import C_jax
from dreammat_tpu_torch.models.diffusion.convert import (
    flax_to_torch_state_dict, geometry_params_from_numpy,
)
from dreammat_tpu_torch.models.prompt import PromptEmbeddings
from dreammat_tpu_torch.ops.visibility import BakedVisibility
from dreammat_tpu_torch.utils.config import load_config as tload

SEED = 0
OVERRIDES = [
    "system.prompt_processor.prompt=a red apple",
    "system.geometry.shape_init=procedural:sphere",
    "system.geometry.shape_init_params=2",
    "system.material.use_prefiltered=true",
    "data.fix_view_num=2",
    "data.cond_height=16",
    "data.cond_width=16",
    "data.fastpath_check=false",
    "data.static_field_maps=false",
]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


class GivenDraws:
    """The port's draws interface, serving arrays made by the test."""

    def __init__(self, per_step):
        self.per_step = per_step
        self.step = 0

    def _get(self, name, shape):
        x = self.per_step[self.step][name]
        assert tuple(x.shape) == tuple(shape), (name, x.shape, shape)
        return torch.from_numpy(np.array(x))

    def uniform(self, name, shape):
        return self._get(name, shape)

    def normal(self, name, shape):
        return self._get(name, shape)


def _numpy_random_init(rng, init_fn):
    """``fast_random_init``'s fill (normal(0, 0.02), norm scales 1, biases 0)
    from a numpy generator."""
    seed = int(np.asarray(jax.random.key_data(rng)).ravel()[-1]) % (2 ** 31)
    gen = np.random.RandomState(seed)
    shapes = jax.eval_shape(init_fn)

    def fill(path, s):
        name = path[-1].key if hasattr(path[-1], "key") else str(path[-1])
        if name == "scale":
            return jnp.ones(s.shape, s.dtype)
        if name == "bias":
            return jnp.zeros(s.shape, s.dtype)
        return jnp.asarray(gen.normal(0.0, 0.02, s.shape).astype(s.dtype))

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _step_keys(n_steps):
    """The per-step keys of ``DreamMat.fit``, and its init/guidance keys."""
    k_init, k_guidance, rng = jax.random.split(jax.random.PRNGKey(SEED), 3)
    keys = []
    for _ in range(n_steps):
        rng, k = jax.random.split(rng)
        keys.append(k)
    return k_init, k_guidance, keys


def _draws_for(k, P, B, lat_hw):
    """The draws the JAX train step makes from its key ``k``, in the port's
    layout (latent draws NHWC -> NCHW)."""
    k_render, k_guide = jax.random.split(k)
    k_jit, _ = jax.random.split(k_render)
    ka, ke = jax.random.split(k_jit)
    k_enc, k_t, k_noise = jax.random.split(k_guide, 3)
    lat = (B, *lat_hw, 4)
    nchw = lambda x: np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1))
    return {
        "jitter_angle": np.asarray(jax.random.uniform(ka, (P, 1))),
        "jitter_eps": np.asarray(jax.random.normal(ke, (P, 1))),
        "vae_eps": nchw(jax.random.normal(k_enc, lat)),
        "t": np.asarray(jax.random.uniform(k_t, (B,))),
        "noise": nchw(jax.random.normal(k_noise, lat)),
    }


@pytest.fixture(scope="module")
def pair():
    jcfg = jload("configs/dreammat_tiny.yaml", OVERRIDES)
    tcfg = tload("configs/dreammat_tiny.yaml", OVERRIDES)
    k_init, k_guidance, _ = _step_keys(0)
    jsys = dreammat_tpu.find("dreammat-system")(jcfg.system)
    jdm = dreammat_tpu.find("random-camera-datamodule")(jcfg.data, jsys.renderer, jsys.material)
    jdm.setup()
    rng = np.random.RandomState(7)
    N, D = 16, JUNetConfig.tiny().cross_attention_dim
    emb = {"text_vd": (4, N, D), "uncond_vd": (4, N, D), "text": (N, D), "uncond": (N, D),
           "null": (N, D)}
    emb = {k: rng.normal(size=s).astype(np.float32) for k, s in emb.items()}
    jsys.prompt_processor = "given"  # on_fit_start then builds only the guidance
    jsys.prompt_utils = JPromptEmbeddings(**{k: jnp.asarray(v) for k, v in emb.items()})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconvert, "fast_random_init", _numpy_random_init)
        jsys.on_fit_start(k_guidance)

    tsys = dreammat_tpu_torch.find("dreammat-system")(tcfg.system, device="cpu")
    jb = jsys.material.baked_visibility
    tsys.material.set_baked_visibility(BakedVisibility(_t(jb.table).half(), jb.oct_res))
    tdm = dreammat_tpu_torch.find("random-camera-datamodule")(
        tcfg.data, tsys.renderer, tsys.material, device="cpu")
    tdm.setup()
    tsys.prompt_processor = "given"
    tsys.prompt_utils = PromptEmbeddings(**{k: torch.from_numpy(v) for k, v in emb.items()})
    tsys.on_fit_start(SEED)
    g, gp = tsys.guidance, _np(jsys.guidance.params)
    g.unet.load_state_dict(flax_to_torch_state_dict(gp["unet"], "unet"), strict=True)
    g.vae.load_state_dict(flax_to_torch_state_dict(gp["vae"], "vae"), strict=True)
    for cn, p in zip(g.controlnets, gp["controlnets"]):
        cn.load_state_dict(flax_to_torch_state_dict(p, "controlnet"), strict=True)
    geo0 = jsys.init_state(k_init)["geo"]
    return jsys, jdm, tsys, tdm, geo0


def _fresh_port_state(tsys, geo0):
    tsys.init_state(SEED)
    tsys.field.load_state_dict(geometry_params_from_numpy(_np(geo0)), strict=True)


def _latent_hw(jsys):
    f = jsys.guidance.vae_factor
    return (jsys.guidance.cfg.height // f, jsys.guidance.cfg.width // f)


def test_one_train_step(pair):
    jsys, jdm, tsys, tdm, geo0 = pair
    _, _, (k,) = _step_keys(1)
    jdm.rng = np.random.RandomState(3)
    tdm.rng = np.random.RandomState(3)
    jb, tb = jdm.collate(0), tdm.collate(0)
    assert (jb["view_id"], int(jb["env_id"])) == (tb["view_id"], tb["env_id"])

    loss_cfg = dict(jsys.cfg.loss)

    def jloss(geo):
        # the loss of DreamMat.make_train_step, on the same batch and key
        k_render, k_guide = jax.random.split(k)
        out = jsys.renderer.shade_view(geo, jb["gbuffer"], jb["env_id"], k_render,
                                       is_train=True, light_table=jb["light_table"])
        g = jsys.guidance(jsys.guidance.params, out["comp_rgb"][None], jsys.prompt_utils,
                          jb["elevation"], jb["azimuth"], jb["camera_distances"],
                          jb["condition_map"], step=jnp.int32(0), rng=k_guide)
        return (C_jax(loss_cfg["lambda_sds"], 0) * g["loss_sds"]
                + C_jax(loss_cfg["lambda_mat_reg"], 0) * out["loss_mat_reg"])

    jl, jgrad = jax.jit(jax.value_and_grad(jloss))(geo0)
    opt = parse_optimizer(jsys.cfg.optimizer)
    jupd, _ = opt.update(jgrad, opt.init(geo0), geo0)

    _fresh_port_state(tsys, geo0)
    before = {n: p.detach().clone() for n, p in tsys.field.named_parameters()}
    P = tb["gbuffer"].fg_pos.shape[0]
    draws = GivenDraws([_draws_for(k, P, 1, _latent_hw(jsys))])
    m = tsys.train_step(tb, draws)

    assert abs(float(m["loss"]) - float(jl)) <= 1e-4 * abs(float(jl))
    gref = geometry_params_from_numpy(_np(jgrad))
    uref = geometry_params_from_numpy(_np(jupd))
    for name, p in tsys.field.named_parameters():
        g, gr = p.grad.numpy(), gref[name].numpy()
        assert _rel(g, gr) < 1e-3, name
        big = np.abs(gr) > 1e-6 * np.abs(gr).max()
        upd = (p.detach() - before[name]).numpy()
        assert np.abs(upd - uref[name].numpy())[big].max() <= 1e-6, name
    assert float(jnp.abs(jgrad["table"]).max()) > 0  # the step reaches the table


def _csv_losses(path):
    with open(path) as f:
        return [float(r["loss"]) for r in csv.DictReader(f)]


def test_fit_two_steps(pair, tmp_path):
    jsys, jdm, tsys, tdm, geo0 = pair
    _, _, keys = _step_keys(2)
    jdm.rng = np.random.RandomState(5)
    jstate = jsys.fit(jdm, max_steps=2, seed=SEED, trial_dir=str(tmp_path / "jax"),
                      val_check_interval=0, checkpoint_every=0, log_every=1)

    _fresh_port_state(tsys, geo0)
    P = tdm.data.gbuffers[0].fg_pos.shape[0]
    draws = GivenDraws([_draws_for(k, P, 1, _latent_hw(jsys)) for k in keys])
    tdm.rng = np.random.RandomState(5)
    out = tsys.fit(tdm, max_steps=2, seed=SEED, trial_dir=str(tmp_path / "torch"),
                   log_every=1, draws=draws)
    assert out["step"] == 2

    jl = _csv_losses(os.path.join(tmp_path, "jax", "logs", "metrics.csv"))
    tl = _csv_losses(os.path.join(tmp_path, "torch", "logs", "metrics.csv"))
    assert len(jl) == len(tl) == 2
    assert np.allclose(tl, jl, rtol=1e-4, atol=0)
    # both moved the field the same way: compare where the JAX update is
    # not a rounding-level sign flip of the first step
    jgeo = geometry_params_from_numpy(_np(jstate["geo"]))
    g0 = geometry_params_from_numpy(_np(geo0))
    for name, p in tsys.field.named_parameters():
        moved_j = (jgeo[name] - g0[name]).numpy()
        moved_t = (p.detach() - g0[name]).numpy()
        assert np.abs(moved_t).max() > 0
        assert _rel(moved_t, moved_j) < 0.05, name
