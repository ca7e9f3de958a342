"""Port parity: the triple guidance (``stable-diffusion-triple-guidance``).

The JAX package and the port run the DreamMat CSD estimator through the
tiny UNet, VAE and one ControlNet per control type, with the same weights
(the weight bridge; the JAX weights filled from numpy) and the JAX draws
handed to the port, on a 32^2 render and a live condition stack (depth,
normal). Cases: ``[depth, canny]``, ``[depth, hed]``, ``[self-normal]`` and
``[normal]``; the loss and its gradient with respect to the rendered image
agree to relative 1e-4 in fp32 (the gradient as a relative L2 norm).

The HED and NormalBae detectors of both packages get the same numpy
weights (the JAX loaders are handed them in place of their random init);
NormalBae runs at a ``detect_resolution`` of 32 in both (the port's
``normalbae_detect_resolution``; the JAX class attribute), instead of 512,
to keep the JAX compile and the CPU forward short (the resize itself is
compared in ``test_torch_detectors.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreammat_tpu
import dreammat_tpu.models  # noqa: F401
import dreammat_tpu_torch
import dreammat_tpu_torch.models  # noqa: F401
from dreammat_tpu.models import detectors as jdet
from dreammat_tpu.models.diffusion import convert as jconvert
from dreammat_tpu.models.prompt import PromptEmbeddings as JPE
from dreammat_tpu_torch.models import detectors as tdet
from dreammat_tpu_torch.models.diffusion.convert import flax_to_torch_state_dict
from dreammat_tpu_torch.models.prompt import PromptEmbeddings as TPE

from test_torch_detectors import _hed_tree, _normalbae_tree
from test_torch_sds_guidance import GivenDraws, _embeddings, _nchw, _numpy_random_init, _rel
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401

RTOL = 1e-4
HW = 32


@pytest.fixture(scope="module")
def detector_trees():
    return _hed_tree(), _normalbae_tree()


def _pair(control_types, trees, monkeypatch):
    hed_tree, nb_tree = trees
    cfg = {"model_size": "tiny", "half_precision_weights": False, "width": HW, "height": HW,
           "cache_dir": None, "controlnet_path": None, "use_controlnet": True,
           "control_types": control_types, "condition_scales": [1.0] * len(control_types),
           "condition_scales_anneal": [1.0] * len(control_types),
           "cond_scale": 1.0, "uncond_scale": -0.5, "null_scale": -1.0, "noise_scale": 0.2}
    jcfg, cfg = cfg, {**cfg, "normalbae_detect_resolution": 32}
    monkeypatch.setattr(jdet, "load_hed", lambda path=None: jdet.HEDdetector(
        jax.tree_util.tree_map(jnp.asarray, hed_tree)))
    monkeypatch.setattr(jdet, "load_normalbae", lambda path=None: jdet.NormalBaeDetector(
        {k: (v if k == "architecture" else jax.tree_util.tree_map(jnp.asarray, v))
         for k, v in nb_tree.items()}))
    monkeypatch.setattr(jdet.NormalBaeDetector, "detect_resolution", 32)
    jg = dreammat_tpu.find("stable-diffusion-triple-guidance")(jcfg)
    monkeypatch.setattr(jconvert, "fast_random_init", _numpy_random_init)
    jg.init_params(jax.random.PRNGKey(0))
    tg = dreammat_tpu_torch.find("stable-diffusion-triple-guidance")(cfg, device="cpu")
    tg.init_params()
    gp = jax.tree_util.tree_map(np.asarray, jg.params)
    tg.unet.load_state_dict(flax_to_torch_state_dict(gp["unet"], "unet"), strict=True)
    tg.vae.load_state_dict(flax_to_torch_state_dict(gp["vae"], "vae"), strict=True)
    for cn, p in zip(tg.controlnets, gp["controlnets"]):
        cn.load_state_dict(flax_to_torch_state_dict(p, "controlnet"), strict=True)
    if tg._hed is not None:
        tg._hed.load_state_dict(tdet.hed_state_dict_from_numpy(hed_tree), strict=True)
    if tg._normalbae is not None:
        tg._normalbae.load_state_dict(tdet.normalbae_state_dict_from_numpy(nb_tree),
                                      strict=True)
    return jg, tg


@pytest.mark.parametrize("control_types", [["depth", "canny"], ["depth", "hed"],
                                           ["self-normal"], ["normal"]],
                         ids=lambda c: "+".join(c))
def test_triple_guidance_matches_jax(control_types, detector_trees, monkeypatch):
    jg, tg = _pair(control_types, detector_trees, monkeypatch)
    assert len(tg.controlnets) == len(control_types)
    assert (tg._hed is not None) == ("hed" in control_types)
    assert (tg._normalbae is not None) == ("normal" in control_types)
    emb = _embeddings()
    je = JPE(**{k: jnp.asarray(v) for k, v in emb.items()})
    te = TPE(**{k: torch.from_numpy(v) for k, v in emb.items()})
    rs = np.random.RandomState(11)
    rgb = rs.uniform(size=(1, HW, HW, 3)).astype(np.float32)
    rgb[:, :, HW // 2:] *= 0.3  # an edge for canny
    cond = rs.uniform(size=(1, HW // 2, HW // 2, 4)).astype(np.float32)
    elev, azim, dist = np.float32([15.0]), np.float32([-60.0]), np.float32([3.5])
    key, step = jax.random.PRNGKey(9), 50

    # the detectors' weights enter the jitted function as arguments: closed
    # over, XLA constant-folds NormalBae's weight standardization for minutes
    hed_tree, nb_tree = detector_trees
    dets = {"hed": hed_tree, "normal": {k: v for k, v in nb_tree.items() if k != "architecture"}}

    def jloss(x, dets):
        jg._hed = jdet.HEDdetector(dets["hed"])
        jg._normalbae = jdet.NormalBaeDetector({**dets["normal"], "architecture": "GN"})
        return jg(jg.params, x, je, jnp.asarray(elev), jnp.asarray(azim), jnp.asarray(dist),
                  jnp.asarray(cond), jnp.int32(step), key)["loss_sds"]

    j_loss, j_grad = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(rgb), dets)

    k_enc, k_t, k_noise = jax.random.split(key, 3)
    lat = (1, HW // tg.vae_factor, HW // tg.vae_factor, 4)
    draws = GivenDraws({"vae_eps": _nchw(jax.random.normal(k_enc, lat)),
                        "t": np.asarray(jax.random.uniform(k_t, (1,))),
                        "noise": _nchw(jax.random.normal(k_noise, lat))})
    x = torch.from_numpy(_nchw(rgb)).requires_grad_(True)
    out = tg(x, te, torch.from_numpy(elev), torch.from_numpy(azim), torch.from_numpy(dist),
             torch.from_numpy(_nchw(cond)), step=step, draws=draws)
    out["loss_sds"].backward()
    t_loss = float(out["loss_sds"].detach())
    assert np.isfinite(t_loss) and abs(t_loss - float(j_loss)) <= RTOL * abs(float(j_loss))
    assert _rel(np.moveaxis(x.grad.numpy(), 1, -1), np.asarray(j_grad)) <= RTOL
    assert float(jnp.abs(j_grad).max()) > 0
