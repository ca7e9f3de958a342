"""Port parity: the texcraft system, its command line and main path 6's CPU form.

- Two steps of ``texcraft-system`` (``configs/texcraft.yaml`` cut to the
  tiny widths, the SDS guidance, live depth and normal conditions) in both
  packages, in the manner of ``test_torch_dreammat_step.py``: the port gets
  the JAX package's diffusion weights (weight bridge), initial field, baked
  visibility, prompt embeddings and the draws of each step. The per-step
  losses agree to relative 1e-4 and the field's moves after 2 steps to
  relative L2 0.05 (Adam with eps 1e-15 turns rounding-level gradients
  into whole steps).
- ``launch_torch.main`` of ``configs/texcraft.yaml`` at tiny size on the
  CPU: the system, its guidance, finite losses, the files.
- Main path 6 of ``chip_smoke.py`` in its CPU tiny form
  (``drive_texcraft(..., device="cpu", size="tiny")``): SDS, the triple
  guidance with depth, canny, HED and NormalBae ControlNets, Perp-Neg SDS
  and the 2D playground.
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
from chip_smoke import TEXCRAFT_TINY, drive_texcraft
from dreammat_tpu.models.diffusion import convert as jconvert
from dreammat_tpu.models.prompt import PromptEmbeddings as JPromptEmbeddings
from dreammat_tpu.utils.config import load_config as jload
from dreammat_tpu_torch.models.diffusion.convert import (
    flax_to_torch_state_dict, geometry_params_from_numpy,
)
from dreammat_tpu_torch.models.prompt import PromptEmbeddings
from dreammat_tpu_torch.ops.visibility import BakedVisibility
from dreammat_tpu_torch.utils.config import load_config as tload

from test_torch_dreammat_step import (
    GivenDraws, _csv_losses, _draws_for, _np, _numpy_random_init, _rel, _step_keys, _t,
)
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401

SEED = 0
OVERRIDES = TEXCRAFT_TINY + [
    "system.prompt_processor.prompt=a red apple",
    "system.prompt_processor.use_cache=false",
    "system.geometry.shape_init=procedural:sphere",
    "system.geometry.shape_init_params=2",
    "system.guidance.cache_dir=null",
    "system.guidance.guidance_scale=7.5",
    "system.material.environment_texture=/nonexistent",
    "system.material.n_environments=2",
    "data.fix_view_num=2",
    "data.fix_env_num=2",
    "data.cond_height=16",
    "data.cond_width=16",
    "data.fastpath_check=false",
    "data.static_field_maps=false",
    "data.prerender_cache_dir=null",
]


@pytest.fixture(scope="module")
def pair():
    jcfg = jload("configs/texcraft.yaml", OVERRIDES)
    tcfg = tload("configs/texcraft.yaml", OVERRIDES)
    k_init, k_guidance, _ = _step_keys(0)
    jsys = dreammat_tpu.find("texcraft-system")(jcfg.system)
    jdm = dreammat_tpu.find("random-camera-datamodule")(jcfg.data, jsys.renderer, jsys.material)
    jdm.setup()
    rng = np.random.RandomState(7)
    N, D = 16, 64
    emb = {"text_vd": (4, N, D), "uncond_vd": (4, N, D), "text": (N, D), "uncond": (N, D),
           "null": (N, D)}
    emb = {k: rng.normal(size=s).astype(np.float32) for k, s in emb.items()}
    jsys.prompt_processor = "given"
    jsys.prompt_utils = JPromptEmbeddings(**{k: jnp.asarray(v) for k, v in emb.items()})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconvert, "fast_random_init", _numpy_random_init)
        jsys.on_fit_start(k_guidance)

    tsys = dreammat_tpu_torch.find("texcraft-system")(tcfg.system, device="cpu")
    jb = jsys.material.baked_visibility
    tsys.material.set_baked_visibility(BakedVisibility(_t(jb.table).half(), jb.oct_res))
    tdm = dreammat_tpu_torch.find("random-camera-datamodule")(
        tcfg.data, tsys.renderer, tsys.material, device="cpu")
    tdm.setup()
    tsys.prompt_processor = "given"
    tsys.prompt_utils = PromptEmbeddings(**{k: torch.from_numpy(v) for k, v in emb.items()})
    tsys.on_fit_start(SEED)
    g, gp = tsys.guidance, _np(jsys.guidance.params)
    assert type(g).__name__ == "StableDiffusionGuidance" and not g.controlnets
    g.unet.load_state_dict(flax_to_torch_state_dict(gp["unet"], "unet"), strict=True)
    g.vae.load_state_dict(flax_to_torch_state_dict(gp["vae"], "vae"), strict=True)
    geo0 = jsys.init_state(k_init)["geo"]
    return jsys, jdm, tsys, tdm, geo0


def test_texcraft_two_steps_match_jax(pair, tmp_path):
    jsys, jdm, tsys, tdm, geo0 = pair
    _, _, keys = _step_keys(2)
    jdm.rng = np.random.RandomState(5)
    jstate = jsys.fit(jdm, max_steps=2, seed=SEED, trial_dir=str(tmp_path / "jax"),
                      val_check_interval=0, checkpoint_every=0, log_every=1)

    tsys.init_state(SEED)
    tsys.field.load_state_dict(geometry_params_from_numpy(_np(geo0)), strict=True)
    P = tdm.data.gbuffers[0].fg_pos.shape[0]
    lat = (jsys.guidance.cfg.height // jsys.guidance.vae_factor,) * 2
    tdm.rng = np.random.RandomState(5)
    out = tsys.fit(tdm, max_steps=2, seed=SEED, trial_dir=str(tmp_path / "torch"),
                   log_every=1, val_check_interval=0, checkpoint_every=0,
                   draws=GivenDraws([_draws_for(k, P, 1, lat) for k in keys]))
    assert out["step"] == 2

    jl = _csv_losses(os.path.join(tmp_path, "jax", "logs", "metrics.csv"))
    tl = _csv_losses(os.path.join(tmp_path, "torch", "logs", "metrics.csv"))
    assert len(jl) == len(tl) == 2 and all(np.isfinite(tl))
    assert np.allclose(tl, jl, rtol=1e-4, atol=0), (tl, jl)
    jgeo = geometry_params_from_numpy(_np(jstate["geo"]))
    g0 = geometry_params_from_numpy(_np(geo0))
    for name, p in tsys.field.named_parameters():
        moved_j = (jgeo[name] - g0[name]).numpy()
        moved_t = (p.detach() - g0[name]).numpy()
        assert np.abs(moved_t).max() > 0
        assert _rel(moved_t, moved_j) < 0.05, name


def test_launch_torch_texcraft_tiny_on_cpu(tmp_path):
    import launch_torch

    out = launch_torch.main([
        "--config", "configs/texcraft.yaml", "--train", "--device", "cpu", *TEXCRAFT_TINY,
        "system.prompt_processor.prompt=a red apple", "system.prompt_processor.use_cache=false",
        "system.geometry.shape_init=procedural:sphere", "system.geometry.shape_init_params=2",
        "system.guidance.cache_dir=null", "system.material.environment_texture=/nonexistent",
        "system.exporter.texture_size=64", "data.fix_view_num=2", "data.n_test_views=1",
        "data.prerender_cache_dir=null", "trainer.max_steps=2",
        f"exp_root_dir={tmp_path}", "use_timestamp=false"])
    system, trial = out["system"], out["trial_dir"]
    assert type(system).__name__ == "TexCraft"
    assert type(system.guidance).__name__ == "StableDiffusionGuidance"
    assert len(system.step_losses) == 2 and all(np.isfinite(system.step_losses))
    save = os.path.join(trial, "save")
    for rel in ("it2-test/0.png", "it2-test.gif", "export/model.obj", "export/model.mtl"):
        assert os.path.getsize(os.path.join(save, rel)) > 0, rel
    assert os.path.exists(os.path.join(trial, "parsed.yaml"))


def test_main_path_6_cpu_tiny_form(tmp_path):
    res = drive_texcraft(str(tmp_path / "texcraft"), device="cpu", size="tiny",
                         torus=(24, 12), playground_size=32)
    runs = res["runs"]
    assert runs["sds"]["guidance"] == runs["perp_neg"]["guidance"] == "StableDiffusionGuidance"
    assert runs["triple"]["guidance"] == "StableDiffusionTripleGuidance"
    assert [len(runs[r]["losses"]) for r in ("sds", "triple", "perp_neg")] == [3, 2, 1]
    assert all(r["moved"] > 0 and r["test_png"] > 100 for r in runs.values())
    assert len(res["playground"]["losses"]) == 3 and res["playground"]["final_png"] > 100
