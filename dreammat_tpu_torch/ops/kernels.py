"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded through ``ctypes`` (no PyTorch
headers, so a build takes seconds). Builds happen at first use, into
``build/dreammat_tpu_torch/`` at the repository root (git-ignored), keyed by
a hash of the source and the shared headers (``csrc/*.cuh``): an edited
kernel is rebuilt, an unchanged one is reused. ``build()`` starts one
``nvcc`` per missing library, all at once. ``sass_opcodes`` reads what was
compiled (``cuobjdump -sass``), so a caller can check which instructions a
kernel uses.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import subprocess
import time
from typing import Dict, Iterable, Optional, Set

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "dreammat_tpu_torch")

SOURCES = {
    "flash_attn_fwd": "flash_attn_fwd.cu",
    "flash_attn_bwd": "flash_attn_bwd.cu",
    "ray_cast": "ray_cast.cu",
    "bvh_traverse": "bvh_traverse.cu",
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[str, ctypes._CFuncPtr] = {}


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, SOURCES[name])] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library among ``names`` (default: all), one
    ``nvcc`` process per source started together. Returns the wall seconds
    per built library (0.0 for a cached one); raises if a build fails."""
    from dreammat_tpu_torch.utils.hw import find_nvcc

    names = list(SOURCES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.time()
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        nvcc = nvcc or find_nvcc()
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    seconds = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.time() - t0
        with open(out[:-3] + ".log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[name]} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def build_log(name: str) -> str:
    """nvcc's output for the current build of ``name`` (ptxas register and
    shared-memory report), or '' if the library came from an earlier run."""
    path = _lib_path(name)[:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        import torch

        from dreammat_tpu_torch.utils.hw import require_sm90

        require_sm90(torch.device("cuda", torch.cuda.current_device()))
        build([name])
        lib = ctypes.CDLL(_lib_path(name))
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of library ``name`` with its argument
    types set and an int return (the CUDA error code), built and loaded
    at first use and cached."""
    fn = _FUNCS.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[symbol] = fn
    return fn


def sass_opcodes(text: str) -> Dict[str, Set[str]]:
    """The opcodes of each function in ``cuobjdump -sass`` output: function
    name (mangled, as cuobjdump prints it) -> set of opcodes without their
    modifiers (``HGMMA.64x128x16.F32.BF16`` counts as ``HGMMA``)."""
    out: Dict[str, Set[str]] = {}
    current = None
    for line in text.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            current = out.setdefault(m.group(1), set())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and current is not None:
            current.add(m.group(1))
    return out


def sass(name: str) -> str:
    """``cuobjdump -sass`` of the built library ``name`` (building it if
    needed); cuobjdump is taken from nvcc's directory."""
    from dreammat_tpu_torch.utils.hw import find_nvcc

    build([name])
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", _lib_path(name)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
