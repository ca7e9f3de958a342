"""Checkpoint IO: a module's state dict, its optimizer's state and the step.

Counterpart of ``dreammat_tpu/utils/ckpt.py``. The JAX package writes an npz
of pytree leaves beside a pickled JAX treedef, which only JAX can read, so
the port keeps its own torch-native format instead: one ``<path>.pt`` file
written by ``torch.save`` (tensors moved to the host), read back with
``torch.load(weights_only=True)``. The two formats do not read each other;
weights cross between the packages through the diffusers-layout
safetensors export. Under a process group rank 0 writes and every rank
then waits at a barrier, as the JAX package's ``save_checkpoint`` does.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch

from dreammat_tpu_torch.parallel import distributed as dist


def _host(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    return tree


def save_checkpoint(path: str, state_dict: Dict[str, torch.Tensor],
                    optimizer_state: Optional[Dict[str, Any]], step: int) -> str:
    """Write ``{"state_dict", "optimizer", "step"}`` to ``<path>.pt`` (rank 0;
    every rank returns once the file is complete)."""
    path = path if path.endswith(".pt") else path + ".pt"
    if dist.is_rank_zero():
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        torch.save({"state_dict": _host(state_dict), "optimizer": _host(optimizer_state),
                    "step": int(step)}, tmp)
        os.replace(tmp, path)
    dist.barrier(f"ckpt:{os.path.basename(path)}")
    return path


def load_checkpoint(path: str, device="cpu") -> Tuple[Dict[str, torch.Tensor],
                                                      Optional[Dict[str, Any]], int]:
    """(state_dict, optimizer_state, step) from ``<path>.pt``, tensors on ``device``."""
    path = path if path.endswith(".pt") else path + ".pt"
    ckpt = torch.load(path, map_location=device, weights_only=True)
    return ckpt["state_dict"], ckpt["optimizer"], ckpt["step"]
