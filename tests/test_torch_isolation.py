"""The port stands alone: no JAX, no JAX package, no CPU fallback, no SDPA.

- A fresh interpreter imports every module of ``dreammat_tpu_torch``;
  afterwards no ``jax``, ``jaxlib``, ``flax``, ``optax`` or
  ``dreammat_tpu`` module may be in ``sys.modules``.
- The entry points (system, datamodule, guidance, renderer) take
  ``device``, default to CUDA, and raise without a GPU unless the caller
  passes ``device="cpu"``.
- No source file of the port calls PyTorch's fused attention.
"""

import os
import subprocess
import sys

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


@pytest.mark.parametrize("entry", ["system", "datamodule", "guidance", "renderer"])
def test_entry_points_need_cuda_unless_cpu_is_asked_for(entry):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    cfg = _tiny_cfg()
    find = dreammat_tpu_torch.find
    sys_cpu = find("dreammat-system")(cfg.system, device="cpu")
    build = {
        "system": lambda **kw: find("dreammat-system")(cfg.system, **kw),
        "datamodule": lambda **kw: find("random-camera-datamodule")(
            cfg.data, sys_cpu.renderer, sys_cpu.material, **kw),
        "guidance": lambda **kw: find("stable-diffusion-dreammat-guidance")(
            cfg.system["guidance"], **kw),
        "renderer": lambda **kw: find("raytracing-renderer")(
            cfg.system.get("renderer", {}), sys_cpu.geometry, sys_cpu.material, **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        build()
    assert build(device="cpu").device.type == "cpu"


def test_no_fused_attention_call():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(dirpath, f)) as fh:
                    assert "scaled_dot_product_attention" not in fh.read(), f
