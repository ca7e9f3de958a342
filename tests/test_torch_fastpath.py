"""Port parity: the fast-path gate against the JAX package.

Both packages set up the tiny DreamMat config on a small self-occluding
torus (24 x 12 quads) with prefiltered tables, one fixed view and 8 x 8
octahedral visibility bins; the port's material is handed the JAX
package's per-vertex table before its prerender (see
``test_torch_prerender.py``). The gate's colour RMSE and gradient cosine
must be within 1e-3 of the JAX package's (the cosine with the JAX
package's weights W handed to the port as the draw ``gate_w``). The gate's
decisions are those of the JAX package's ``tests/test_data.py``,
and after a drop a train step shades through the MC estimator.

The JAX gate's MC estimator and its gradients run jitted (eagerly, op by
op, they take half a minute of XLA compiles).

The decision cases share one sphere rig (geometry, material with its FG
LUT, renderer with its visibility bake) and set up a data module of their
own on it; the gate restores the material's visibility source. The tests
that run the port alone do so on one intra-op thread: when several pytest
workers share the CPU, torch's default thread pool stalls on small ops.
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
from dreammat_tpu.data import prerender as jpr
from dreammat_tpu.utils.config import load_config as jload
from dreammat_tpu_torch.data import prerender as tpr
from dreammat_tpu_torch.models.mesh import torus_arrays, write_obj
from dreammat_tpu_torch.ops.visibility import BakedVisibility
from dreammat_tpu_torch.utils.config import load_config as tload
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401


def setup_pair(tmp_path_factory, extra=()):
    """The JAX and the port's systems and set-up data modules on the torus."""
    obj = write_obj(str(tmp_path_factory.mktemp("torus") / "torus.obj"), *torus_arrays())
    overrides = [
        "system.prompt_processor.prompt=a torus",
        f"system.geometry.shape_init=mesh:{obj}",
        "system.material.use_prefiltered=true",
        "data.fix_view_num=1",
        "system.renderer.visibility_oct_res=8",
        "data.fastpath_check=false",
        "data.static_field_maps=false",
    ] + list(extra)
    jcfg = jload("configs/dreammat_tiny.yaml", overrides)
    tcfg = tload("configs/dreammat_tiny.yaml", overrides)
    jsys = dreammat_tpu.find("dreammat-system")(jcfg.system)
    jdm = dreammat_tpu.find("random-camera-datamodule")(jcfg.data, jsys.renderer, jsys.material)
    jdm.setup()
    tsys = dreammat_tpu_torch.find("dreammat-system")(tcfg.system, device="cpu")
    jb = jsys.material.baked_visibility
    tsys.material.set_baked_visibility(
        BakedVisibility(torch.as_tensor(np.asarray(jb.table)), jb.oct_res))
    tdm = dreammat_tpu_torch.find("random-camera-datamodule")(
        tcfg.data, tsys.renderer, tsys.material, device="cpu")
    tdm.setup()
    return jsys, jdm, tsys, tdm


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return setup_pair(tmp_path_factory)


class GivenDraws:
    def __init__(self, arrays):
        self.arrays = arrays

    def uniform(self, name, shape):
        x = self.arrays[name]
        assert tuple(x.shape) == tuple(shape), (name, x.shape, shape)
        return torch.from_numpy(np.array(x))


def test_gate_measures_match_jax(pair):
    jsys, jdm, tsys, tdm = pair
    # the JAX gate runs eagerly, op by op (hundreds of XLA compiles): its MC
    # estimator and its gradients run jitted here, the same functions
    mat_cls, grad = type(jsys.material), jax.grad
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mat_cls, "shade_raytracing", jax.jit(
            mat_cls.shade_raytracing, static_argnums=(0, 9)))
        mp.setattr(jax, "grad", lambda f, *a, **k: jax.jit(grad(f, *a, **k)))
        rmse_j = jpr.fastpath_residual(jsys.renderer, jsys.material, jdm.data)
        gc_j = jpr.fastpath_grad_cos(jsys.renderer, jsys.material, jdm.data)
    rmse_t = tpr.fastpath_residual(tsys.renderer, tsys.material, tdm.data)
    assert abs(rmse_t - rmse_j) <= 1e-3, (rmse_t, rmse_j)
    GP = min(4096, tdm.data.gbuffers[0].fg_pos.shape[0])
    W = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (GP, 3)))
    gc_t = tpr.fastpath_grad_cos(tsys.renderer, tsys.material, tdm.data,
                                 draws=GivenDraws({"gate_w": W}))
    assert abs(gc_t - gc_j) <= 1e-3, (gc_t, gc_j)
    assert tsys.material.ray_trace_fun is None  # the gate restores the visibility source


@pytest.fixture(scope="module")
def sphere_parts():
    """A level-1 icosphere with a tiny field and material and the renderer
    on them (the rig of the JAX package's gate tests)."""
    find = dreammat_tpu_torch.find
    geo = find("dreammat-mesh")({
        "shape_init": "procedural:sphere", "shape_init_params": 1,
        "pos_encoding_config": {"otype": "HashGrid", "n_levels": 2, "n_features_per_level": 2,
                                "log2_hashmap_size": 8, "base_resolution": 4,
                                "per_level_scale": 1.5}}, device="cpu")
    mat = find("dreammat-material")({
        "environment_texture": "/nonexistent", "n_environments": 1, "env_height": 16,
        "env_width": 32, "diffuse_sample_num": 32, "specular_sample_num": 32,
        "use_prefiltered": True}, device="cpu")
    return find("raytracing-renderer")({}, geo, mat, device="cpu"), mat


def _sphere_rig(parts, **data_over):
    """A data module on the shared sphere rig, set up."""
    ren, mat = parts
    base = {"width": 24, "height": 24, "fix_view_num": 1, "fix_env_num": 1, "cond_height": 24,
            "cond_width": 24, "prerender_cache_dir": None, "static_field_maps": False}
    dm = dreammat_tpu_torch.find("random-camera-datamodule")(dict(base, **data_over), ren, mat,
                                                             device="cpu")
    dm.setup()
    return dm


@pytest.mark.parametrize("over, kept", [
    ({"fastpath_check": True}, True),
    ({"fastpath_check": True, "fastpath_rmse_threshold": 1e-6}, False),
    ({"fastpath_check": True, "fastpath_grad_cos_threshold": 1.1}, False),
    ({"fastpath_check": "auto", "fastpath_rmse_threshold": 1e-9}, True),
    ({"fastpath_check": "auto", "fastpath_rmse_threshold": 1e-9,
      "fastpath_occlusion_threshold": 0.0}, False),
], ids=["sphere-kept", "rmse-drop", "gradcos-drop", "auto-convex-skips", "auto-forced-drop"])
def test_gate_decisions(sphere_parts, over, kept):
    dm = _sphere_rig(sphere_parts, **over)
    assert (dm.data.table_spec is not None) == kept, dm.gate
    ran = dm.gate["rmse"] is not None
    assert ran == (over["fastpath_check"] is True or over.get("fastpath_occlusion_threshold") == 0)


def test_after_a_drop_training_shades_through_mc(tmp_path):
    cfg = tload("configs/dreammat_tiny.yaml", [
        "system.prompt_processor.prompt=a red apple",
        "system.geometry.shape_init=procedural:sphere",
        "system.geometry.shape_init_params=1",
        "system.material.use_prefiltered=true",
        "data.fix_view_num=1",
        "data.fastpath_check=true",
        "data.fastpath_rmse_threshold=1.0e-6",
    ])
    find = dreammat_tpu_torch.find
    system = find("dreammat-system")(cfg.system, device="cpu")
    dm = find("random-camera-datamodule")(cfg.data, system.renderer, system.material,
                                          device="cpu")
    dm.setup()
    assert dm.data.table_spec is None and dm.gate["decision"].startswith("dropped")
    assert dm.collate(0)["light_table"] is None
    system.init_state(0)
    before = {n: p.detach().clone() for n, p in system.field.named_parameters()}
    system.fit(dm, max_steps=1, trial_dir=str(tmp_path), log_every=1)
    assert system.step_kinds == ["mc"] and np.isfinite(system.step_losses).all()
    assert any((p.detach() - before[n]).abs().max() > 0 for n, p in system.field.named_parameters())
