"""Port parity: ControlNet training-data generation for one mesh.

``generate_dataset_for_mesh`` of both packages renders a level-2 icosphere
given as a .glb file, under two HDR environment maps written here, at
32^2 for two fixed cameras, with the tiny material's direction counts; the
constant ground-truth material is drawn from the seed in both. The port
is handed the JAX package's baked visibility table (see
``test_torch_prerender.py`` for the grazing rays where the two bakes may
differ). The colour targets are shaded with ``is_train=False``: the
estimator draws nothing, so there are no draws to hand over.

The JAX function passes ``seed`` to a prerender that takes none; the test
drops that argument on the JAX side (a fault of the reference, noted in
ROADMAP.md), and changes nothing else of it.

Tolerances: the f32 colours agree to 1e-4 (``test_torch_mc_shading.py``),
so the stored f16 values are equal or one f16 step apart where the f32
colours fall on either side of a rounding boundary (at least 99% equal);
the depth, normal and probe maps to relative L2 1e-4
(``test_torch_prerender.py``). The result loads through the port's
``ControlNetDataset``; the command line writes the same files.
"""

import json
import os

import numpy as np
import pytest
import torch

import dreammat_tpu
import dreammat_tpu.models  # noqa: F401
import dreammat_tpu_torch
from dreammat_tpu.data import controlnet_dataset as jcd
from dreammat_tpu.data import prerender as jpr
from dreammat_tpu.ops import visibility as jvis
from dreammat_tpu_torch.data import controlnet_dataset as tcd
from dreammat_tpu_torch.models.mesh import icosphere_arrays
from dreammat_tpu_torch.ops import envmap as tenv
from dreammat_tpu_torch.ops import visibility as tvis
from test_torch_user_inputs import _radiance, _write_glb_simple
from torch_threads import jax_compiles_cached, jax_fg_lut_once, one_thread  # noqa: F401

N_VIEWS, N_ENVS, RES = 2, 2, 32


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("datagen")
    v, f = icosphere_arrays(2)
    os.makedirs(root / "meshes")
    _write_glb_simple(str(root / "meshes" / "ball.glb"), v, f, 5123)
    for i in range(N_ENVS):
        os.makedirs(root / "env" / f"map{i + 1}")
        tenv.write_hdr(str(root / "env" / f"map{i + 1}" / f"map{i + 1}.hdr"),
                       _radiance(16, 32, seed=10 + i))
    material = {"environment_texture": str(root / "env"), "n_environments": N_ENVS,
                "env_height": 16, "env_width": 32, "diffuse_sample_num": 16,
                "specular_sample_num": 8}
    return root, material


@pytest.fixture(scope="module")
def generated(inputs):
    root, material = inputs
    mesh = str(root / "meshes" / "ball.glb")
    tables = []
    real_jbake, real_jprerender = jvis.bake_vertex_visibility, jpr.prerender
    with pytest.MonkeyPatch.context() as mp:
        def jbake(*a, **k):
            tables.append(real_jbake(*a, **k))
            return tables[-1]

        mp.setattr(jvis, "bake_vertex_visibility", jbake)
        mp.setattr(jpr, "prerender", lambda *a, seed=None, **k: real_jprerender(*a, **k))
        jcd.generate_dataset_for_mesh(mesh, str(root / "jax"), material_cfg=material,
                                      n_views=N_VIEWS, n_envs=N_ENVS, resolution=RES, seed=3)
        mp.setattr(tvis, "bake_vertex_visibility", lambda *a, **k: tvis.BakedVisibility(
            torch.as_tensor(np.array(tables[0].table)), tables[0].oct_res))
        tcd.generate_dataset_for_mesh(mesh, str(root / "port"), material_cfg=material,
                                      n_views=N_VIEWS, n_envs=N_ENVS, resolution=RES, seed=3,
                                      device="cpu")
    assert len(tables) == 1
    return np.load(root / "jax" / "data.npz"), np.load(root / "port" / "data.npz")


def test_colour_targets_match_jax(generated):
    j, t = generated
    a, b = t["colors"], j["colors"]
    assert a.shape == b.shape == (N_VIEWS, N_ENVS, RES, RES, 3) and a.dtype == np.float16
    a32, b32 = a.astype(np.float32), b.astype(np.float32)
    step = np.maximum(np.abs(b32), 2.0 ** -14) * 2.0 ** -10  # one f16 step
    assert np.all(np.abs(a32 - b32) <= step)
    assert np.mean(a == b) >= 0.99
    assert np.all(np.isfinite(a32)) and (a32 < 1).any() and (a32 == 1).any()  # object on white


@pytest.mark.parametrize("name", ["depths", "normals", "lightmaps"])
def test_condition_maps_match_jax(generated, name):
    j, t = generated
    assert t[name].shape == j[name].shape and t[name].dtype == np.float16
    assert _rel(t[name].astype(np.float32), j[name].astype(np.float32)) < 1e-4


def test_command_line_writes_a_dataset_the_port_reads(inputs, tmp_path):
    import generate_controlnet_data_torch as cli

    root, _ = inputs
    prompts = tmp_path / "prompts.json"
    prompts.write_text(json.dumps({"ball": "a glossy ball"}))
    out = cli.main(["--meshes-dir", str(root / "meshes"), "--prompts", str(prompts),
                    "--out", str(tmp_path / "data"), "--views", "2", "--envs", "2",
                    "--resolution", "16", "--env-dir", str(root / "env"), "--device", "cpu"])
    assert out["prompts"] == {"ball": "a glossy ball"} and len(out["written"]) == 1
    ds = tcd.ControlNetDataset(str(tmp_path / "data"), str(tmp_path / "data" / "prompts.json"),
                               resolution=16, env_num=2, view_num=2)
    assert len(ds) == 4
    ex = ds[3]
    assert ex.target.shape == (16, 16, 3) and ex.condition.shape == (16, 16, 22)
    assert np.isfinite(ex.target).all() and np.isfinite(ex.condition).all()
    assert ex.prompt == "a glossy ball"
