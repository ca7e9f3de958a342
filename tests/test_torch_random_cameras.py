"""Port parity: random-camera mode, the UV-space field and ``visibility_subdiv``.

One tiny DreamMat config runs the three options together in both packages:
random cameras (``data.use_fix_views=false``, ``progressive_until`` and
the camera, centre and up perturbs on), the UV-space field
(``system.geometry.n_input_dims=2``) and one level of ``visibility_subdiv``,
on a torus (12 x 6 quads) written with its natural (u, v)
parameterisation, at 32^2 with condition maps at 16^2, two environments
and 8 x 8 visibility bins. The train step runs twice: through the light
tables and through the split-sum environment (``use_raytracing=false``,
switched on both materials).

- ``_sample_camera``: 20 steps from equal seeds give the same draws and
  cameras (the angles, distance and fovy 1e-6 relative; the position, the
  matrices and the rays 1e-5 absolute: float32 camera maths in two
  frameworks), and the same pixel budget.
- The subdivided mesh is the JAX package's, array for array. Its
  per-vertex visibility bake may differ only in bins whose ray passes
  exactly through an edge or a vertex of the torus (it is symmetric, so
  some rays do): there the port's caster hits, on the edge (smallest
  barycentric coordinate 0), and the JAX package's dense caster lets the
  ray through the crack between the two triangles. The port is then
  handed the JAX package's table.
- ``_collate_random``: the environment draw, the G-buffer's mask, pixel
  indices and faces equal, its valid lanes (positions, normals, view
  directions, barycentrics, texture coordinates), the 22-channel
  condition map and the light table at relative L2 1e-4.
- One train step with the JAX draws injected (the UV jitter noise, the
  VAE posterior, the timestep and the latent noise), through the tables
  and through the split-sum path: loss 1e-4 relative, field gradient 1e-3
  relative L2.
- An eval view: the G-buffer at the shared budget and the light table
  from the mesh bakes, as above.
"""

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
from dreammat_tpu.ops import envmap as jenvmap
from dreammat_tpu.utils.config import load_config as jload
from dreammat_tpu.utils.schedule import C_jax
from dreammat_tpu_torch.models.diffusion.convert import (
    flax_to_torch_state_dict, geometry_params_from_numpy,
)
from dreammat_tpu_torch.models.mesh import torus_arrays, torus_uv_arrays, write_obj
from dreammat_tpu_torch.models.prompt import PromptEmbeddings
from dreammat_tpu_torch.ops import bvh as tbvh
from dreammat_tpu_torch.ops import visibility as tvis
from dreammat_tpu_torch.ops.visibility import BakedVisibility
from dreammat_tpu_torch.utils.config import load_config as tload
from test_torch_dreammat_step import GivenDraws, _numpy_random_init
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401

SEED = 0
GB_FIELDS = ("fg_pos", "fg_normal", "fg_viewdir", "fg_bary", "fg_uv")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def overrides(obj):
    return [
        "system.prompt_processor.prompt=a torus",
        f"system.geometry.shape_init=mesh:{obj}",
        "system.geometry.shape_init_params=1.0",
        "system.geometry.n_input_dims=2",
        "system.material.use_prefiltered=true",
        "system.material.splitsum_height=16",
        "system.material.splitsum_width=32",
        "system.renderer.visibility_oct_res=8",
        "system.renderer.visibility_subdiv=1",
        "data.use_fix_views=false",
        "data.progressive_until=10",
        "data.camera_perturb=0.1",
        "data.center_perturb=0.05",
        "data.up_perturb=0.02",
        "data.cond_height=16",
        "data.cond_width=16",
    ]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    v, f = torus_arrays(nu=12, nv=6)
    vt, ft = torus_uv_arrays(12, 6)
    obj = write_obj(str(tmp_path_factory.mktemp("torus") / "torus_uv.obj"), v, f, vt, ft)
    jcfg, tcfg = jload("configs/dreammat_tiny.yaml", overrides(obj)), \
        tload("configs/dreammat_tiny.yaml", overrides(obj))
    k_init, k_guidance, _ = jax.random.split(jax.random.PRNGKey(SEED), 3)
    jsys = dreammat_tpu.find("dreammat-system")(jcfg.system)
    jdm = dreammat_tpu.find("random-camera-datamodule")(jcfg.data, jsys.renderer, jsys.material)
    jdm.setup()
    rng = np.random.RandomState(7)
    N, D = 16, JUNetConfig.tiny().cross_attention_dim
    emb = {k: rng.normal(size=(4, N, D) if k.endswith("_vd") else (N, D)).astype(np.float32)
           for k in ("text_vd", "uncond_vd", "text", "uncond", "null")}
    jsys.prompt_processor = "given"
    jsys.prompt_utils = JPromptEmbeddings(**{k: jnp.asarray(x) for k, x in emb.items()})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconvert, "fast_random_init", _numpy_random_init)
        jsys.on_fit_start(k_guidance)

    tsys = dreammat_tpu_torch.find("dreammat-system")(tcfg.system, device="cpu")
    own_table = tsys.material.baked_visibility.table.clone()
    jb = jsys.material.baked_visibility
    tsys.material.set_baked_visibility(BakedVisibility(torch.from_numpy(np.array(jb.table)),
                                                       jb.oct_res))
    tdm = dreammat_tpu_torch.find("random-camera-datamodule")(
        tcfg.data, tsys.renderer, tsys.material, device="cpu")
    tdm.setup()
    tsys.prompt_processor = "given"
    tsys.prompt_utils = PromptEmbeddings(**{k: torch.from_numpy(x) for k, x in emb.items()})
    tsys.on_fit_start(SEED)
    g, gp = tsys.guidance, jax.tree_util.tree_map(np.asarray, jsys.guidance.params)
    g.unet.load_state_dict(flax_to_torch_state_dict(gp["unet"], "unet"), strict=True)
    g.vae.load_state_dict(flax_to_torch_state_dict(gp["vae"], "vae"), strict=True)
    for cn, p in zip(g.controlnets, gp["controlnets"]):
        cn.load_state_dict(flax_to_torch_state_dict(p, "controlnet"), strict=True)
    geo0 = jax.tree_util.tree_map(np.asarray, jsys.init_state(k_init)["geo"])
    return jsys, jdm, tsys, tdm, geo0, own_table


def test_sample_camera_matches_jax(pair):
    _, jdm, _, tdm, _, _ = pair
    jdm.rng, tdm.rng = np.random.RandomState(11), np.random.RandomState(11)
    for step in range(20):
        jc, tc = jdm._sample_camera(step), tdm._sample_camera(step)
        for k in ("elevation", "azimuth", "dist", "fovy_deg"):
            assert abs(float(tc[k]) - float(jc[k])) <= 1e-6 * max(1.0, abs(float(jc[k]))), k
        for k in ("pos", "c2w", "w2c", "rays_o", "rays_d"):
            assert np.abs(_np(tc[k]) - np.asarray(jc[k])).max() <= 1e-5, (step, k)
    assert jdm.rng.rand() == tdm.rng.rand()  # the same number of draws


def test_pixel_budget_and_subdivided_bake(pair):
    jsys, jdm, tsys, tdm, _, own_table = pair
    assert tdm._random_budget == jdm._random_budget > 0
    jm, tm = jsys.renderer.mesh, tsys.renderer.mesh
    assert tm.v_pos.shape[0] == 72 + 216  # one new vertex per edge
    for k in ("v_pos", "t_pos_idx", "v_nrm", "v_tex", "t_tex_idx"):
        assert np.array_equal(_np(getattr(tm, k)), np.asarray(getattr(jm, k))), k
    jt = np.asarray(jsys.material.baked_visibility.table).astype(np.float32)
    tt = _np(own_table).astype(np.float32)
    assert tt.shape == jt.shape
    vi, bi = np.nonzero(tt != jt)
    assert len(vi) <= 0.01 * tt.size
    dirs = tvis._grid_dirs(8, "cpu")[bi]
    o = tm.v_pos[vi] + tm.v_nrm[vi] * 1e-3 + dirs * 1e-3
    r = tbvh.cast_rays_plain(tsys.renderer.bvh, o, dirs)
    edge = torch.minimum(torch.minimum(r["u"], r["v"]), 1 - r["u"] - r["v"])
    assert bool(r["hit"].all()) and float(edge.abs().max()) <= 1e-6
    assert (jt[vi, bi] == 1).all() and (tt[vi, bi] == 0).all()


def _collate_both(jdm, tdm, seed, step):
    jdm.rng, tdm.rng = np.random.RandomState(seed), np.random.RandomState(seed)
    return jdm.collate(step), tdm.collate(step)


def _check_gbuffer(jg, tg):
    for k in ("mask", "fg_idx", "fg_valid", "fg_tri"):
        assert np.array_equal(_np(getattr(tg, k)), np.asarray(getattr(jg, k))), k
    valid = np.asarray(jg.fg_valid)
    for k in GB_FIELDS:
        assert _rel(_np(getattr(tg, k))[valid], np.asarray(getattr(jg, k))[valid]) < 1e-4, k
    assert np.abs(np.asarray(jg.fg_uv)[valid]).max() > 0.1  # the torus has UVs


def test_collate_random_matches_jax(pair):
    _, jdm, _, tdm, _, _ = pair
    jb, tb = _collate_both(jdm, tdm, 5, 3)
    assert int(jb["env_id"]) == tb["env_id"] and tb["view_id"] == -1
    _check_gbuffer(jb["gbuffer"], tb["gbuffer"])
    assert _rel(_np(tb["condition_map"][0].permute(1, 2, 0)), jb["condition_map"][0]) < 1e-4
    assert _rel(_np(tb["light_table"]), jb["light_table"]) < 1e-4
    for k in ("elevation", "azimuth", "camera_distances"):
        assert np.allclose(_np(tb[k]), np.asarray(jb[k]), rtol=1e-6), k


@pytest.fixture(params=["tables", "splitsum"])
def shading(request, pair):
    """The materials' shading path for one test: the light tables, or the
    split-sum environment. The JAX stacks are built before the step is
    traced, each by a jitted ``build_splitsum`` (as ``ensure_splitsum``
    builds them, without its op-by-op compiles); the FG LUT is the one the
    material holds."""
    jsys, _, tsys, _, _, _ = pair
    jm = jsys.material
    if request.param == "splitsum" and jm.splitsum is None:
        build = jax.jit(jenvmap.build_splitsum, static_argnums=(1, 2))
        ss = [build(jm.envs[i], jm.cfg.splitsum_height, jm.cfg.splitsum_width)
              for i in range(jm.envs.shape[0])]
        jm.splitsum = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *ss)
    for m in (jsys.material, tsys.material):
        m.cfg.use_raytracing = request.param == "tables"
    yield request.param
    for m in (jsys.material, tsys.material):
        m.cfg.use_raytracing = True


def test_random_mode_train_step_matches_jax(pair, shading):
    """Random camera, UV field with its jitter noise, subdivided bake; the
    tables or the split-sum environment."""
    jsys, jdm, tsys, tdm, geo0, _ = pair
    jb, tb = _collate_both(jdm, tdm, 9, 2)
    k = jax.random.PRNGKey(21)
    loss_cfg = dict(jsys.cfg.loss)

    def jloss(geo):
        k_render, k_guide = jax.random.split(k)
        out = jsys.renderer.shade_view(geo, jb["gbuffer"], jb["env_id"], k_render,
                                       is_train=True, light_table=jb["light_table"])
        g = jsys.guidance(jsys.guidance.params, out["comp_rgb"][None], jsys.prompt_utils,
                          jb["elevation"], jb["azimuth"], jb["camera_distances"],
                          jb["condition_map"], step=jnp.int32(0), rng=k_guide)
        return (C_jax(loss_cfg["lambda_sds"], 0) * g["loss_sds"]
                + C_jax(loss_cfg["lambda_mat_reg"], 0) * out["loss_mat_reg"])

    jl, jgrad = jax.jit(jax.value_and_grad(jloss))(geo0)

    k_render, k_guide = jax.random.split(k)
    k_jit, _ = jax.random.split(k_render)
    k_enc, k_t, k_noise = jax.random.split(k_guide, 3)
    P = tb["gbuffer"].fg_pos.shape[0]
    f = jsys.guidance.vae_factor
    lat = (1, jsys.guidance.cfg.height // f, jsys.guidance.cfg.width // f, 4)
    nchw = lambda x: np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1))
    draws = GivenDraws([{
        "jitter_uv": np.asarray(jax.random.normal(jax.random.fold_in(k_jit, 1), (P, 2))),
        "vae_eps": nchw(jax.random.normal(k_enc, lat)),
        "t": np.asarray(jax.random.uniform(k_t, (1,))),
        "noise": nchw(jax.random.normal(k_noise, lat)),
    }])
    tsys.init_state(SEED)
    tsys.field.load_state_dict(geometry_params_from_numpy(geo0), strict=True)
    m = tsys.train_step(tb, draws)
    assert abs(float(m["loss"]) - float(jl)) <= 1e-4 * abs(float(jl))
    gref = geometry_params_from_numpy(jax.tree_util.tree_map(np.asarray, jgrad))
    for name, p in tsys.field.named_parameters():
        assert _rel(p.grad.numpy(), gref[name].numpy()) < 1e-3, name
    assert float(jnp.abs(jgrad["table"]).max()) > 0


def test_random_mode_eval_view_matches_jax(pair):
    _, jdm, _, tdm, _, _ = pair
    jb, tb = jdm.eval_view(1), tdm.eval_view(1)
    assert tb["gbuffer"].fg_idx.shape[0] == jb["gbuffer"].fg_idx.shape[0]  # the shared budget
    _check_gbuffer(jb["gbuffer"], tb["gbuffer"])
    assert _rel(_np(tb["light_table"]), jb["light_table"]) < 1e-4
