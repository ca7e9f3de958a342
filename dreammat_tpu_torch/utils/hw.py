"""Device resolution and CUDA toolchain probes.

Entry points take ``device`` (default ``"cuda"``) and never fall back to the
CPU on their own: without a GPU, only an explicit ``device="cpu"`` runs.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional, Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """``device`` as a torch.device; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dreammat_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run on the CPU (plain PyTorch versions of the kernels)"
        )
    return dev


def require_sm90(device: torch.device) -> None:
    """The kernels are compiled for sm_90a (Hopper) only."""
    major, minor = torch.cuda.get_device_capability(device)
    if (major, minor) != (9, 0):
        raise RuntimeError(
            f"the CUDA kernels target sm_90a (H100/H200); this card is sm_{major}{minor}"
        )


def find_nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then /usr/local/cuda/bin, then PATH."""
    candidates = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(os.path.join(os.environ[env], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.exists(c):
            return c
    found: Optional[str] = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found
