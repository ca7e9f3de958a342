"""Multiresolution hash-grid encoding (instant-ngp style) in PyTorch.

Counterpart of ``hashgrid_encode`` in ``dreammat_tpu/ops/hashgrid.py``, with
the same x-additive spatial hash (h = (y*p2 ^ z*p3) + x mod T, wrapping in
uint32 like the JAX code: computed in int64 and masked after each
multiply) and the same paired-row gather (the odd-x corner of a cell sits at
row i+1 mod T of the even one). The table backward is autograd's
scatter-add: the view-static sort maps of the JAX package worked around the
TPU's slow scatter and are not needed here. The rows are read with
``index_select``, whose backward is ``index_add_`` (atomic adds on the
card); advanced indexing (``table[idx]``) backpropagates through a sort of
the indices instead, which took most of an SD2.1-width train step on the
H100 (``PERF.md``, Findings).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class HashGridConfig:
    n_input_dims: int = 3
    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 1.447269237440378

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level

    def level_resolutions(self) -> np.ndarray:
        return np.floor(
            self.base_resolution * self.per_level_scale ** np.arange(self.n_levels)
        ).astype(np.int64)


def _hash_corners(coords: torch.Tensor, table_size: int) -> torch.Tensor:
    h = torch.zeros(coords.shape[:-1], dtype=torch.int64, device=coords.device)
    for d in range(1, coords.shape[-1]):
        h = h ^ ((coords[..., d] * _PRIMES[d]) & _U32)
    h = (h + coords[..., 0]) & _U32
    return h & (table_size - 1)


def _dense_index(coords: torch.Tensor, res: int, table_size: int) -> torch.Tensor:
    idx = coords[..., 0].clone()
    stride = 1
    for d in range(1, coords.shape[-1]):
        stride *= res + 1
        idx = idx + coords[..., d] * stride
    return (idx & _U32) % table_size


@functools.lru_cache(maxsize=None)
def _corner_offsets(D: int, device: torch.device) -> torch.Tensor:
    """[2^D, D] float32 0/1 offsets of a cell's corners, bit d of corner c
    on axis d (put on ``device`` once)."""
    return torch.tensor([[(c >> d) & 1 for d in range(D)] for c in range(1 << D)],
                        dtype=torch.float32, device=device)


def hashgrid_encode(table: torch.Tensor, points: torch.Tensor, cfg: HashGridConfig) -> torch.Tensor:
    """table [L,T,F], points in [0,1]^D [..., D] -> features [..., L*F]."""
    D = cfg.n_input_dims
    T = cfg.table_size
    lead = points.shape[:-1]
    x = points.reshape(-1, D).float()
    C = 1 << D
    offs = _corner_offsets(D, x.device)
    outs = []
    for lvl, res in enumerate(cfg.level_resolutions()):
        res = int(res)
        xs = x * res
        x0 = torch.floor(xs)
        w = xs - x0
        corners = torch.clamp(x0[:, None, :] + offs[None], 0, res).long()  # [P,C,D]
        even = corners[:, 0::2]                                              # x-bit 0
        if (res + 1) ** D <= T:
            idx = _dense_index(even, res, T)
        else:
            idx = _hash_corners(even, T)
        wc = torch.ones(x.shape[0], C, device=x.device)
        for d in range(D):
            bit = offs[None, :, d]
            wc = wc * (bit * w[:, d:d + 1] + (1 - bit) * (1 - w[:, d:d + 1]))
        tl = table[lvl]
        rows = torch.stack([idx, (idx + 1) % T], dim=2).reshape(-1)         # [P*C]
        feats = tl.index_select(0, rows).reshape(x.shape[0], C, -1)
        outs.append(torch.sum(feats * wc[..., None], dim=1))
    return torch.cat(outs, dim=-1).reshape(*lead, cfg.n_output_dims)


def frequency_encode(x: torch.Tensor, n_frequencies: int, include_input: bool = True) -> torch.Tensor:
    """NeRF positional encoding: [x,] sin(2^k x), cos(2^k x) for k < n,
    concatenated on the last axis in the JAX package's order."""
    outs = [x] if include_input else []
    for f in 2.0 ** np.arange(n_frequencies, dtype=np.float32):
        outs.append(torch.sin(x * float(f)))
        outs.append(torch.cos(x * float(f)))
    return torch.cat(outs, dim=-1)


def frequency_encoding_dims(n_input: int, n_frequencies: int, include_input: bool = True) -> int:
    return n_input * (2 * n_frequencies + (1 if include_input else 0))
