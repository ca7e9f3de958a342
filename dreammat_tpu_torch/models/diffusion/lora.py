"""LoRA factors for the UNet's attention projections, merged functionally.

Counterpart of ``dreammat_tpu/models/diffusion/lora.py``. The sites are
``to_q``, ``to_k``, ``to_v`` and ``to_out.0`` of every ``attn1`` and
``attn2`` (diffusers' ``LoRAAttnProcessor`` set). Each site holds a rank-r
pair in the JAX package's layout, ``down`` [in, r] and ``up`` [r, out], and
the effective weight of the ``nn.Linear`` (torch layout [out, in]) is

    W_eff = W + scale * ((down @ up) cast to W's dtype)^T

computed by ``merge_lora`` as a dict of tensors for
``torch.func.functional_call``: the UNet module, its frozen weights and its
attention (kernels A, C and D on the card) stay as they are, and autograd
through the merge gives the factors' gradients. The cast comes before the
add, as in the JAX package (in bf16 it rounds the delta). Init as the JAX
package's: down ~ N(0, 1) / r, up = 0, so the first delta is exactly zero;
each site's generator is seeded from the base seed and the crc32 of its
module name.
"""

from __future__ import annotations

import zlib
from typing import Dict, List

import torch
import torch.nn as nn

TARGET_LEAVES = ("to_q", "to_k", "to_v", "to_out.0")
ATTN_MODULES = ("attn1", "attn2")


def lora_sites(unet: nn.Module) -> List[str]:
    """Module names of the LoRA sites of ``unet``, in module order."""
    sites = []
    for name, mod in unet.named_modules():
        if not isinstance(mod, nn.Linear):
            continue
        parts = name.split(".")
        leaf = ".".join(parts[-2:]) if parts[-2:-1] == ["to_out"] else parts[-1]
        if leaf in TARGET_LEAVES and any(p in ATTN_MODULES for p in parts):
            sites.append(name)
    if not sites:
        raise ValueError("no attention projections found in the UNet")
    return sites


class LoRAFactors(nn.Module):
    def __init__(self, d_in: int, d_out: int, rank: int):
        super().__init__()
        self.down = nn.Parameter(torch.zeros(d_in, rank))
        self.up = nn.Parameter(torch.zeros(rank, d_out))


class LoRALayers(nn.Module):
    """One ``LoRAFactors`` per site; ``sites[i]`` names the Linear of ``layers[i]``."""

    def __init__(self, unet: nn.Module, rank: int):
        super().__init__()
        self.sites = lora_sites(unet)
        self.layers = nn.ModuleList([
            LoRAFactors(unet.get_submodule(s).in_features, unet.get_submodule(s).out_features,
                        rank) for s in self.sites])


def init_lora_params(unet: nn.Module, rank: int = 4, seed: int = 0) -> LoRALayers:
    """Factors for every site of ``unet`` on its device: down N(0, 1) / rank,
    up 0."""
    device = next(unet.parameters()).device
    lora = LoRALayers(unet, rank).to(device)
    with torch.no_grad():
        for site, f in zip(lora.sites, lora.layers):
            gen = torch.Generator(device=device).manual_seed(
                ((seed & 0x7FFFFFFF) << 32) | (zlib.crc32(site.encode()) & 0x7FFFFFFF))
            f.down.copy_(torch.randn(f.down.shape, generator=gen, device=device) / rank)
    return lora


def merge_lora(unet: nn.Module, lora: LoRALayers, scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """``{"<site>.weight": W + scale * delta^T}`` for every site, W from
    ``unet``; differentiable in the factors."""
    merged = {}
    for site, f in zip(lora.sites, lora.layers):
        w = unet.get_parameter(site + ".weight")
        delta = (f.down @ f.up).to(w.dtype)
        merged[site + ".weight"] = w + scale * delta.t()
    return merged


def lora_param_count(lora: LoRALayers) -> int:
    return sum(p.numel() for f in lora.layers for p in (f.down, f.up))
