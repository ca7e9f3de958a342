"""Port parity: ``subdivide_mesh``, the UV-space field, its export, and the
five DreamMat options through ``launch_torch.py`` on the CPU.

- ``subdivide_mesh`` on a torus with its (u, v) parameterisation: faces
  and texture faces equal to the JAX package's, vertices, normals and
  texture coordinates within 1e-6, two levels, and the stop before a level
  that would pass ``max_verts``.
- The UV-space field (``n_input_dims: 2``): the JAX package's initial
  parameters in the port's field give the same features at texture
  coordinates in and around the unit square (clamped), within 1e-5.
- The export of a UV-space field: the JAX package's exporter fails where
  it queries the field at 3D texel positions (a reference fault), and the
  port's raises ``UVFieldExportError`` before any work.
- ``launch_torch.py --train --device cpu`` with random cameras, the
  split-sum path, the UV field, ``visibility_subdiv=1`` and prompt
  debiasing at once: finite losses, the test renders and the gif written,
  the export skipped with a warning; ``--export --resume`` of that run
  raises.

The G-buffer's texture coordinates, the subdivided bake and a train step
of the UV field are compared in ``test_torch_random_cameras.py``.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreammat_tpu
import dreammat_tpu.models  # noqa: F401
import dreammat_tpu_torch
from dreammat_tpu.models import mesh as jmesh
from dreammat_tpu.models.exporter import MeshExporter as JExporter
from dreammat_tpu_torch.models import mesh as tmesh
from dreammat_tpu_torch.models.diffusion.convert import geometry_params_from_numpy
from dreammat_tpu_torch.models.exporter import UVFieldExportError
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401

GEO = {"shape_init": "procedural:sphere", "shape_init_params": 1, "n_input_dims": 2,
       "pos_encoding_config": {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
                               "log2_hashmap_size": 8, "base_resolution": 4,
                               "per_level_scale": 1.5}}
MAT = {"environment_texture": "/nonexistent", "n_environments": 1, "env_height": 8,
       "env_width": 16, "diffuse_sample_num": 4, "specular_sample_num": 4}


def _meshes():
    v, f = tmesh.torus_arrays(nu=12, nv=6)
    vt, ft = tmesh.torus_uv_arrays(12, 6)
    t = tmesh.Mesh.from_numpy(v, f, vt, ft, device="cpu")
    j = jmesh.Mesh(v_pos=jnp.asarray(v), t_pos_idx=jnp.asarray(f, jnp.int32),
                   v_nrm=jnp.asarray(t.v_nrm.numpy()), v_tex=jnp.asarray(vt),
                   t_tex_idx=jnp.asarray(ft, jnp.int32))
    return j, t


@pytest.mark.parametrize("levels, max_verts, want_levels", [(2, 1 << 20, 2), (3, 1000, 1)])
def test_subdivide_mesh_matches_jax(levels, max_verts, want_levels):
    jm, tm = _meshes()
    js = jmesh.subdivide_mesh(jm, levels, max_verts=max_verts)
    ts = tmesh.subdivide_mesh(tm, levels, max_verts=max_verts)
    assert ts.t_pos_idx.shape[0] == 144 * 4 ** want_levels
    assert ts.v_pos.shape[0] <= max_verts
    for k in ("t_pos_idx", "t_tex_idx"):
        assert np.array_equal(getattr(ts, k).numpy(), np.asarray(getattr(js, k))), k
    for k in ("v_pos", "v_nrm", "v_tex"):
        assert np.abs(getattr(ts, k).numpy() - np.asarray(getattr(js, k))).max() <= 1e-6, k
    assert np.allclose(np.linalg.norm(ts.v_nrm.numpy(), axis=-1), 1.0, atol=1e-5)


def test_uv_field_apply_matches_jax():
    jgeo = dreammat_tpu.find("dreammat-mesh")(GEO)
    tgeo = dreammat_tpu_torch.find("dreammat-mesh")(GEO, device="cpu")
    params = jgeo.init(jax.random.PRNGKey(4))
    params["table"] = params["table"] * 1e3  # features that vary across the square
    field = tgeo.init(torch.Generator().manual_seed(0))
    field.load_state_dict(geometry_params_from_numpy(jax.tree_util.tree_map(np.asarray, params)))
    uv = np.random.RandomState(2).uniform(-0.1, 1.1, (512, 2)).astype(np.float32)
    jf = np.asarray(jax.jit(jgeo.apply)(params, jnp.asarray(uv)))
    with torch.no_grad():
        tf = tgeo.apply(field, torch.from_numpy(uv)).numpy()
    assert tf.shape == jf.shape == (512, 5)
    assert np.abs(tf - jf).max() <= 1e-5
    assert jf.std(0).min() > 1e-3


def test_uv_field_export_fails_in_both_packages(tmp_path):
    jgeo = dreammat_tpu.find("dreammat-mesh")(GEO)
    jmat = dreammat_tpu.find("dreammat-material")(MAT)
    with pytest.raises((TypeError, ValueError)):
        JExporter({"texture_size": 16}, jgeo, jmat).export_obj_with_mtl(
            jgeo.init(jax.random.PRNGKey(0)), str(tmp_path / "jax"))
    tgeo = dreammat_tpu_torch.find("dreammat-mesh")(GEO, device="cpu")
    tmat = dreammat_tpu_torch.find("dreammat-material")(MAT, device="cpu")
    exporter = dreammat_tpu_torch.find("mesh-exporter")({"texture_size": 16}, tgeo, tmat,
                                                        device="cpu")
    with pytest.raises(UVFieldExportError, match="3D texel positions"):
        exporter.export_obj_with_mtl(tgeo.init(torch.Generator().manual_seed(0)),
                                     str(tmp_path / "torch"))
    assert not os.path.exists(tmp_path / "torch")


def test_launch_torch_runs_every_option_on_the_cpu(tmp_path, caplog):
    import launch_torch

    v, f = tmesh.torus_arrays(nu=12, nv=6)
    obj = tmesh.write_obj(str(tmp_path / "torus.obj"), v, f, *tmesh.torus_uv_arrays(12, 6))
    args = ["--config", "configs/dreammat_tiny.yaml", "--device", "cpu",
            "system.prompt_processor.prompt=a small glazed ring",
            f"system.geometry.shape_init=mesh:{obj}", "system.geometry.shape_init_params=1.0",
            "data.use_fix_views=false", "data.progressive_until=2",
            "system.material.use_raytracing=false", "system.material.splitsum_height=8",
            "system.material.splitsum_width=16", "system.geometry.n_input_dims=2",
            "system.renderer.visibility_subdiv=1", "system.renderer.visibility_oct_res=4",
            "system.prompt_processor.use_prompt_debiasing=true", "data.n_test_views=1",
            "trainer.max_steps=2", "checkpoint.every_n_train_steps=2",
            f"exp_root_dir={tmp_path}/runs", "use_timestamp=false"]
    with caplog.at_level(logging.INFO):
        out = launch_torch.main(["--train", *args])
    system, dm, trial = out["system"], out["datamodule"], out["trial_dir"]
    assert len(system.step_losses) == 2 and np.isfinite(system.step_losses).all()
    assert dm.data is None and dm._random_budget > 0
    assert system.renderer.mesh.v_pos.shape[0] == 72 + 216
    assert system.material.splitsum is not None
    assert len(system.prompt_processor.debiased) == 4
    assert "Debiased prompt of the side view" in caplog.text
    assert "export skipped" in caplog.text
    save = os.path.join(trial, "save")
    for name in ("it2-test/0.png", "it2-test.gif"):
        assert os.path.getsize(os.path.join(save, name)) > 100, name
    assert not os.path.exists(os.path.join(save, "export"))
    with pytest.raises(UVFieldExportError):
        launch_torch.main(["--export", "--resume",
                           os.path.join(trial, "ckpts", "step000002.pt"), *args])
