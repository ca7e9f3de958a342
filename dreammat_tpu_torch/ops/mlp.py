"""Small MLPs (counterpart of ``dreammat_tpu/ops/mlp.py``): the reference's
VanillaMLP sizing, ReLU between layers, no output activation, and the
Kaiming-uniform init of ``init_mlp`` (weights and biases U(+-1/sqrt(fan_in)))."""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def vanilla_mlp_dims(n_input: int, n_output: int, n_neurons: int = 64,
                     n_hidden_layers: int = 1) -> List[int]:
    return [n_input] + [n_neurons] * n_hidden_layers + [n_output]


def make_mlp(dims: Sequence[int]) -> nn.ModuleList:
    return nn.ModuleList([nn.Linear(dims[i], dims[i + 1]) for i in range(len(dims) - 1)])


@torch.no_grad()
def init_mlp_(layers: nn.ModuleList, generator: torch.Generator) -> None:
    for lin in layers:
        bound = 1.0 / math.sqrt(lin.in_features)
        for p in (lin.weight, lin.bias):
            p.copy_((torch.rand(p.shape, generator=generator, device=p.device) * 2 - 1) * bound)


def apply_mlp(layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    h = x
    for i, lin in enumerate(layers):
        h = lin(h)
        if i < len(layers) - 1:
            h = F.relu(h)
    return h
