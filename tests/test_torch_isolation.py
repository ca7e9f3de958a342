"""The port stands alone: no JAX, no JAX package, no CPU fallback, no SDPA.

- A fresh interpreter imports every module of ``dreammat_tpu_torch``;
  afterwards no ``jax``, ``jaxlib``, ``flax``, ``optax`` or
  ``dreammat_tpu`` module may be in ``sys.modules``.
- The entry points (system, datamodule, guidance, prompt processor,
  renderer, ControlNet trainer, mesh exporter, the texcraft system, the
  SDS and triple guidances, ``launch_torch.py``,
  ``generate_controlnet_data_torch.py``, ``playground_2d_torch.py``) and
  the public functions that place tensors (schedule, meshes, BVH, FG LUT,
  eval-camera rays, the texel rasterizer, the debiasing BERT, the
  ControlNet dataset generator, the HED and NormalBae loaders) take
  ``device``, default to
  CUDA, and raise without a GPU unless the caller passes ``device="cpu"``
  (``--device cpu``).
- ``launch_torch.py``, ``generate_controlnet_data_torch.py``,
  ``playground_2d_torch.py`` and ``webapp_torch.py`` import nothing of JAX
  either.
- No source file of the port calls PyTorch's fused attention.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import dreammat_tpu_torch
from dreammat_tpu_torch.utils.config import load_config

PKG = os.path.dirname(dreammat_tpu_torch.__file__)
ROOT = os.path.dirname(PKG)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dreammat_tpu")


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")] if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_imports_nothing_of_jax():
    mods = _port_modules()
    assert "dreammat_tpu_torch.ops.attention" in mods and "dreammat_tpu_torch.ops.bvh" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(repr(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _tiny_cfg():
    return load_config("configs/dreammat_tiny.yaml", [
        "system.prompt_processor.prompt=a red apple",
        "system.geometry.shape_init=procedural:sphere",
        "system.geometry.shape_init_params=1",
        "system.material.use_prefiltered=true",
    ])


@pytest.fixture(scope="module")
def cpu_system():
    """The tiny config and a DreamMat system built on the CPU (its geometry
    and material feed the datamodule, renderer and exporter cases)."""
    cfg = _tiny_cfg()
    return cfg, dreammat_tpu_torch.find("dreammat-system")(cfg.system, device="cpu")


@pytest.mark.parametrize("entry", ["system", "datamodule", "guidance", "renderer", "exporter",
                                   "prompt_processor", "texcraft_system", "sds_guidance",
                                   "triple_guidance"])
def test_entry_points_need_cuda_unless_cpu_is_asked_for(entry, cpu_system):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    cfg, sys_cpu = cpu_system
    find = dreammat_tpu_torch.find
    build = {
        "system": lambda **kw: find("dreammat-system")(cfg.system, **kw),
        "datamodule": lambda **kw: find("random-camera-datamodule")(
            cfg.data, sys_cpu.renderer, sys_cpu.material, **kw),
        "guidance": lambda **kw: find("stable-diffusion-dreammat-guidance")(
            cfg.system["guidance"], **kw),
        "renderer": lambda **kw: find("raytracing-renderer")(
            cfg.system.get("renderer", {}), sys_cpu.geometry, sys_cpu.material, **kw),
        "exporter": lambda **kw: find("mesh-exporter")(
            {"texture_size": 8}, sys_cpu.geometry, sys_cpu.material, **kw),
        "prompt_processor": lambda **kw: find("stable-diffusion-prompt-processor")(
            cfg.system["prompt_processor"], **kw),
        "texcraft_system": lambda **kw: find("texcraft-system")(
            {**cfg.system, "guidance_type": "stable-diffusion-guidance"}, **kw),
        "sds_guidance": lambda **kw: find("stable-diffusion-guidance")(
            {"model_size": "tiny", "cache_dir": None}, **kw),
        "triple_guidance": lambda **kw: find("stable-diffusion-triple-guidance")(
            {"model_size": "tiny", "cache_dir": None, "use_controlnet": True,
             "control_types": ["hed", "normal"], "normalbae_detect_resolution": 32}, **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        build()
    assert build(device="cpu").device.type == "cpu"


def _default_device_calls(tmp_path):
    from dreammat_tpu_torch.data import cameras, controlnet_dataset
    from dreammat_tpu_torch.models import debias, detectors, exporter, mesh
    from dreammat_tpu_torch.models.diffusion import scheduler
    from dreammat_tpu_torch.ops import bvh, envmap

    obj = tmp_path / "tri.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nf 1 3 2\nf 1 2 4\nf 1 4 3\nf 2 3 4\n")
    v, f = mesh.icosphere_arrays(0)
    return {
        "controlnet_trainer": lambda **kw: dreammat_tpu_torch.find("controlnet-trainer")(
            {"model_size": "tiny"}, **kw),
        "make_schedule": lambda **kw: scheduler.make_schedule(**kw),
        "make_icosphere": lambda **kw: mesh.make_icosphere(0, **kw),
        "mesh_from_numpy": lambda **kw: mesh.Mesh.from_numpy(v, f, **kw),
        "load_mesh": lambda **kw: mesh.load_mesh(str(obj), **kw),
        "build_bvh": lambda **kw: bvh.build_bvh(v, f, **kw),
        "compute_fg_lut": lambda **kw: envmap.compute_fg_lut(res=4, n_samples=8, **kw),
        "camera_rays_and_matrices": lambda **kw: cameras.camera_rays_and_matrices(
            cameras.make_eval_cameras(2), 0, 4, 4, **kw),
        "rasterize_uv_texels": lambda **kw: exporter.rasterize_uv_texels(
            np.float32([[0, 0], [1, 0], [0, 1]]), np.int64([[0, 1, 2]]), 4, **kw),
        "build_bert_mlm": lambda **kw: debias.build_bert_mlm(None, size="tiny", **kw),
        "load_hed": lambda **kw: detectors.load_hed(None, **kw),
        "load_normalbae": lambda **kw: detectors.load_normalbae(None, **kw),
        "generate_dataset_for_mesh": lambda **kw: controlnet_dataset.generate_dataset_for_mesh(
            str(obj), str(tmp_path / "data"), n_views=1, n_envs=1, resolution=4,
            material_cfg={"environment_texture": str(tmp_path / "none"), "n_environments": 1,
                          "env_height": 4, "env_width": 8, "diffuse_sample_num": 4,
                          "specular_sample_num": 4}, **kw),
    }


@pytest.mark.parametrize("name", ["controlnet_trainer", "make_schedule", "make_icosphere",
                                  "mesh_from_numpy", "load_mesh", "build_bvh",
                                  "compute_fg_lut", "camera_rays_and_matrices",
                                  "rasterize_uv_texels", "build_bert_mlm",
                                  "generate_dataset_for_mesh", "load_hed", "load_normalbae"])
def test_functions_default_to_cuda(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    call = _default_device_calls(tmp_path)[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    assert call(device="cpu") is not None


def test_launch_torch_needs_cuda_and_imports_nothing_of_jax():
    """``launch_torch.main`` without ``--device cpu`` raises for want of a
    GPU (also with ``--gpu 0``), after importing the port: no JAX module is
    loaded by then."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    code = (
        "import sys\n"
        "import launch_torch\n"
        "args = ['--config', 'configs/dreammat_tiny.yaml', '--train',\n"
        "        'system.prompt_processor.prompt=a red apple',\n"
        "        'system.geometry.shape_init=procedural:sphere']\n"
        "for extra in ([], ['--gpu', '0']):\n"
        "    try:\n"
        "        launch_torch.main(args + extra)\n"
        "        print('ran')\n"
        "    except RuntimeError as e:\n"
        "        print('raised', 'CUDA' in str(e))\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print('dreammat_tpu_torch' in sys.modules, repr(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-3:] == ["raised True", "raised True", "True []"]


def test_generate_controlnet_data_torch_needs_cuda_and_imports_nothing_of_jax(tmp_path):
    """The dataset generator's command line without ``--device cpu`` raises
    for want of a GPU, after importing the port: no JAX module is loaded."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    code = (
        "import sys\n"
        "import generate_controlnet_data_torch as cli\n"
        "try:\n"
        f"    cli.main(['--meshes-dir', {str(tmp_path)!r}, '--out', {str(tmp_path / 'out')!r}])\n"
        "    print('ran')\n"
        "except RuntimeError as e:\n"
        "    print('raised', 'CUDA' in str(e))\n"
        "import dreammat_tpu_torch.data.controlnet_dataset\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(repr(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-2:] == ["raised True", "[]"]


@pytest.mark.parametrize("script", ["playground_2d_torch", "webapp_torch"])
def test_new_root_scripts_import_nothing_of_jax(script):
    """The playground and the web app import no module of JAX; the
    playground's ``main`` without ``--device cpu`` raises for want of a GPU,
    after importing the port."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    code = f"import sys\nimport {script} as app\n"
    if script == "playground_2d_torch":
        code += ("try:\n"
                 "    app.main(['--prompt', 'x', '--steps', '1', '--out', 'outputs/none'])\n"
                 "    print('ran')\n"
                 "except RuntimeError as e:\n"
                 "    print('raised', 'CUDA' in str(e), 'dreammat_tpu_torch' in sys.modules)\n")
    code += f"print(repr(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})))\n"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "[]"
    if script == "playground_2d_torch":
        assert lines[-2] == "raised True True"


def test_no_fused_attention_call():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(dirpath, f)) as fh:
                    assert "scaled_dot_product_attention" not in fh.read(), f
