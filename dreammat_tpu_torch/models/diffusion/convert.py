"""Weight bridge: flax-layout parameter trees (as numpy) -> torch state dicts.

The port's own copy of the flax -> torch direction of
``dreammat_tpu/models/diffusion/convert.py`` (``flax_to_torch_state_dict``):
the same key mangling (flat flax module names such as ``down_blocks_0`` to
diffusers' dotted ``down_blocks.0``) and kernel transposes
(conv HWIO -> OIHW, dense IO -> OI). It works on nested dicts of numpy
arrays, so no JAX is needed to run it. Covers ``unet``, ``controlnet``,
``vae`` and ``clip``. Also holds the random initialization the port uses
when no checkpoint is present, and ``geometry_params_from_numpy`` for the
material field.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn


def _walk(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    else:
        yield path, tree


def _clip_rename(name: str) -> str:
    if name.startswith("token_embedding") or name.startswith("position_embedding"):
        return "text_model.embeddings." + name
    if name == "final_layer_norm":
        return "text_model.final_layer_norm"
    m = re.match(r"layers\.(\d+)\.(.*)", name)
    if m:
        idx, rest = m.group(1), m.group(2)
        if rest in ("q_proj", "k_proj", "v_proj", "out_proj"):
            rest = "self_attn." + rest
        elif rest in ("fc1", "fc2"):
            rest = "mlp." + rest
        return f"text_model.encoder.layers.{idx}.{rest}"
    return name


def flax_path_to_torch_key(path: Tuple[str, ...], model_type: str) -> str:
    *mods, leaf = path
    if model_type == "clip" and leaf == "position_embedding" and not mods:
        return "text_model.embeddings.position_embedding.weight"
    name = ".".join(mods)
    name = name.replace("linear_1", "linear<1>").replace("linear_2", "linear<2>")
    name = re.sub(r"_(\d+)", r".\1", name)
    name = name.replace("linear<1>", "linear_1").replace("linear<2>", "linear_2")
    name = re.sub(r"(\.\d+)_", r"\1.", name)
    name = name.replace("mid_block_", "mid_block.")
    if model_type == "clip":
        name = _clip_rename(name)
    suffix = "weight" if leaf in ("kernel", "scale", "embedding") else leaf
    return suffix if name == "" else f"{name}.{suffix}"


def _to_torch_array(leaf_name: str, value: np.ndarray) -> np.ndarray:
    if leaf_name == "kernel":
        if value.ndim == 4:  # conv: HWIO -> OIHW
            return np.transpose(value, (3, 2, 0, 1))
        if value.ndim == 2:  # dense: IO -> OI
            return np.transpose(value)
    return value


def flax_to_torch_state_dict(flax_params: Mapping, model_type: str = "unet") -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (flax layout) -> torch state dict with
    diffusers / transformers key names."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _walk(flax_params):
        if path and path[0] == "params":
            path = path[1:]
        key = flax_path_to_torch_key(path, model_type)
        arr = np.array(_to_torch_array(path[-1], np.asarray(leaf, dtype=np.float32)))
        out[key] = torch.from_numpy(arr)
    return out


def geometry_params_from_numpy(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX material field ``{"table": [L,T,F], "mlp": {"w": [[in,out]...],
    "b": [[out]...]}}`` (numpy) -> a state dict of the port's ``MaterialField``."""
    sd = {"table": torch.from_numpy(np.array(params["table"], dtype=np.float32))}
    for i, (w, b) in enumerate(zip(params["mlp"]["w"], params["mlp"]["b"])):
        sd[f"mlp.{i}.weight"] = torch.from_numpy(np.ascontiguousarray(np.asarray(w, np.float32).T))
        sd[f"mlp.{i}.bias"] = torch.from_numpy(np.array(b, dtype=np.float32))
    return sd


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator, std: float = 0.02) -> nn.Module:
    """Fill a module's parameters like the JAX package's ``fast_random_init``:
    norm weights 1, biases 0, every other tensor normal(0, std)."""
    for mod in module.modules():
        for name, p in mod.named_parameters(recurse=False):
            if isinstance(mod, (nn.GroupNorm, nn.LayerNorm)) and name == "weight":
                p.fill_(1.0)
            elif name == "bias":
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                                    dtype=torch.float32).to(p.dtype) * std)
    return module


def build_on(cls_fn, device: torch.device, dtype: torch.dtype) -> nn.Module:
    """Construct a module on the meta device and materialize it, uninitialized,
    on ``device`` in ``dtype`` (no host-side init of SD-sized weights)."""
    with torch.device("meta"):
        module = cls_fn()
    return module.to(dtype=dtype).to_empty(device=device)
