"""Rank mesh, batch and ray sharding, and tensor parallelism.

Counterpart of ``dreammat_tpu/parallel/mesh.py``. The JAX package names a
``(data, model)`` grid of devices and lets XLA insert the collectives; here
each process is one rank of such a grid, and the collectives are explicit:

- ``data``: the batch axis. The trainable ControlNet is wrapped in
  ``DistributedDataParallel``, whose gradient all-reduce averages over the
  ranks (the reference's DDP).
- ``model``: the tensor-parallel axis of the frozen diffusion networks.
  ``tp_shard_params`` splits the attention and feed-forward projections
  Megatron-style: column-parallel ``q, k, v`` and GEGLU ``proj`` (by whole
  heads and matching value and gate slices), row-parallel outputs whose
  partial sums are all-reduced (in fp32) inside autograd.

``shard_rays`` is the JAX package's "sequence-parallel slot": the pixel or
ray axis split over every rank. Its gather is an all-reduce of a
zero-padded buffer, which gloo also runs on CUDA tensors (gloo runs only
all-reduce, broadcast and barrier there). Without a process group the mesh
is 1 x 1 and every helper is the identity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from dreammat_tpu_torch.parallel import distributed as pdist


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``(data, model)`` grid of ranks (data-major:
    rank = data_index * n_model + model_index, as the JAX package reshapes
    its devices) and the groups along each axis (None where the axis has
    one rank)."""
    ranks: np.ndarray                  # [n_data, n_model] rank ids
    rank: int
    data_group: Any = None             # the ranks of this rank's model index
    model_group: Any = None            # the ranks of this rank's data index

    @property
    def shape(self) -> dict:
        return {"data": self.ranks.shape[0], "model": self.ranks.shape[1]}

    @property
    def n_data(self) -> int:
        return self.ranks.shape[0]

    @property
    def n_model(self) -> int:
        return self.ranks.shape[1]

    @property
    def size(self) -> int:
        return self.ranks.size

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model


def _axis_group(members, world: int):
    """The group of ``members`` (every rank calls this for every group, in
    the same order, as ``new_group`` requires)."""
    if len(members) == 1:
        return None
    if len(members) == world:
        return dist.group.WORLD
    return dist.new_group([int(r) for r in members])


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The ``(data, model)`` grid of the process group's ranks; ``n_data``
    defaults to world // n_model."""
    world, rank = pdist.process_count(), pdist.process_index()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world or n_data < 1:
        raise ValueError(f"a {n_data} x {n_model} (data x model) mesh needs "
                         f"{n_data * n_model} ranks; the process group has {world}")
    ranks = np.arange(world).reshape(n_data, n_model)
    data_group = model_group = None
    if world > 1:
        for j in range(n_model):
            g = _axis_group(ranks[:, j], world)
            if rank in ranks[:, j]:
                data_group = g
        for i in range(n_data):
            g = _axis_group(ranks[i], world)
            if rank in ranks[i]:
                model_group = g
    return Mesh(ranks=ranks, rank=rank, data_group=data_group, model_group=model_group)


def _map(fn, tree):
    """``fn`` on every leaf; dicts and tuples are containers, anything else
    (a tensor, an array, a list of prompts) is a leaf with a leading axis."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Optional[Mesh], tree):
    """This rank's rows of the data axis: the leading axis of every leaf cut
    into ``n_data`` equal blocks, block ``data_index``."""
    if mesh is None or mesh.n_data == 1:
        return tree

    def rows(x):
        n = len(x)
        if n % mesh.n_data:
            raise ValueError(f"a leading axis of {n} does not split over {mesh.n_data} ranks")
        per = n // mesh.n_data
        return x[mesh.data_index * per:(mesh.data_index + 1) * per]

    return _map(rows, tree)


def replicated(mesh: Optional[Mesh], tree):
    """Every tensor of ``tree`` broadcast in place from rank 0, so that all
    ranks hold rank 0's values (the JAX package's replicated sharding)."""
    if mesh is None or mesh.size == 1:
        return tree

    def bcast(x):
        if isinstance(x, torch.Tensor):
            dist.broadcast(x, src=0)
        return x

    return _map(bcast, tree)


# ---------------------------------------------------------------------------
# autograd-aware collectives (Megatron's f and g)
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group, as a new tensor: floating point
    summed in at least fp32 (one rounding of the partial sums; gloo lacks
    some half types), booleans as bytes."""
    if x.dtype == torch.bool:
        return _all_reduce(x.to(torch.uint8), group).bool()
    wide = torch.promote_types(x.dtype, torch.float32) if x.is_floating_point() else x.dtype
    y = x.to(wide, copy=True).contiguous()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward sums the input gradient over the group
    (each rank holds the gradient through its own shard only)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Sum over the group forward; identity backward (every rank goes on
    with the same replicated value)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def shard_rays(mesh: Optional[Mesh], fn, *args):
    """``fn`` with the leading (pixel or ray) axis of ``args`` split over
    every rank of the mesh. The axis is padded to a multiple of the mesh
    size by repeating its last row, this rank runs ``fn`` on its block, and
    the blocks are gathered back (cut to R) on every rank. Gradients flow to
    ``args`` whole; parameters that ``fn`` closes over get this rank's share
    of theirs."""
    if mesh is None or mesh.size == 1:
        return fn(*args)
    R = args[0].shape[0]
    if any(a.shape[0] != R for a in args):
        raise ValueError(f"shard_rays: leading axes {[a.shape[0] for a in args]} differ")
    pad = (-R) % mesh.size
    per = (R + pad) // mesh.size
    lo, hi = mesh.rank * per, (mesh.rank + 1) * per
    group = dist.group.WORLD

    def block(x):
        if pad:
            x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
        if x.requires_grad:
            x = _CopyToGroup.apply(x, group)
        return x[lo:hi]

    def gather(y):
        zeros = lambda n: y.new_zeros((n, *y.shape[1:]))
        full = torch.cat([zeros(lo), y, zeros(R + pad - hi)])
        return _ReduceFromGroup.apply(full, group)[:R]

    return _map(gather, fn(*[block(a) for a in args]))


# ---------------------------------------------------------------------------
# tensor parallelism of the UNet and the ControlNet
# ---------------------------------------------------------------------------

class ColumnParallelLinear(nn.Module):
    """The output features ``rows`` of a ``nn.Linear`` (an index tensor):
    the input is replicated over the group, each rank computes its slice."""

    def __init__(self, linear: nn.Linear, rows: torch.Tensor, group):
        super().__init__()
        self.group = group
        self.weight = nn.Parameter(linear.weight.detach()[rows].clone(),
                                   requires_grad=linear.weight.requires_grad)
        self.bias = None if linear.bias is None else nn.Parameter(
            linear.bias.detach()[rows].clone(), requires_grad=linear.bias.requires_grad)

    def forward(self, x):
        return F.linear(_CopyToGroup.apply(x, self.group), self.weight, self.bias)


class RowParallelLinear(nn.Module):
    """The input features ``cols`` of a ``nn.Linear``: each rank multiplies
    its slice of the input, the partial sums are all-reduced, and the bias is
    added once after."""

    def __init__(self, linear: nn.Linear, cols: torch.Tensor, group):
        super().__init__()
        self.group = group
        self.weight = nn.Parameter(linear.weight.detach()[:, cols].clone(),
                                   requires_grad=linear.weight.requires_grad)
        self.bias = None if linear.bias is None else nn.Parameter(
            linear.bias.detach().clone(), requires_grad=linear.bias.requires_grad)

    def forward(self, x):
        y = _ReduceFromGroup.apply(F.linear(x, self.weight), self.group)
        return y if self.bias is None else y + self.bias


def _block(n: int, parts: int, index: int, device) -> torch.Tensor:
    per = n // parts
    return torch.arange(index * per, (index + 1) * per, device=device)


def tp_shard_params(mesh: Optional[Mesh], module: nn.Module) -> int:
    """Split ``module``'s (a UNet's or a ControlNet's) projections over the
    mesh's model axis, in place, where they divide: the layers of the JAX
    package's ``_tp_spec_for`` (attention ``to_q, to_k, to_v`` / ``to_out``,
    GEGLU ``proj`` / ``ff.net.2``, the time embedding's ``linear_1`` /
    ``linear_2``). An attention is split by whole heads, so one whose head
    count does not divide stays replicated (SD2.1's 5-head blocks under
    ``n_model = 2``), and each rank reshapes into the heads it holds.
    Convolutions, norms and embeddings stay replicated. Returns the number
    of layers split."""
    from dreammat_tpu_torch.models.diffusion.layers import (
        Attention, FeedForward, TimestepEmbedding,
    )

    if mesh is None or mesh.n_model == 1:
        return 0
    n, r, group = mesh.n_model, mesh.model_index, mesh.model_group
    split = 0
    for m in list(module.modules()):
        if isinstance(m, Attention) and m.num_heads % n == 0:
            # heads are contiguous blocks of head_dim features: whole heads a rank
            cols = _block(m.num_heads * m.head_dim, n, r, m.to_q.weight.device)
            m.to_q = ColumnParallelLinear(m.to_q, cols, group)
            m.to_k = ColumnParallelLinear(m.to_k, cols, group)
            m.to_v = ColumnParallelLinear(m.to_v, cols, group)
            m.to_out[0] = RowParallelLinear(m.to_out[0], cols, group)
            split += 1
        elif isinstance(m, FeedForward) and m.net[2].in_features % n == 0:
            inner = m.net[2].in_features
            cols = _block(inner, n, r, m.net[2].weight.device)
            # GEGLU's proj holds [value | gate]: a rank takes matching slices of both
            m.net[0].proj = ColumnParallelLinear(m.net[0].proj, torch.cat([cols, inner + cols]),
                                                 group)
            m.net[2] = RowParallelLinear(m.net[2], cols, group)
            split += 1
        elif isinstance(m, TimestepEmbedding) and m.linear_1.out_features % n == 0:
            cols = _block(m.linear_1.out_features, n, r, m.linear_1.weight.device)
            m.linear_1 = ColumnParallelLinear(m.linear_1, cols, group)
            m.linear_2 = RowParallelLinear(m.linear_2, cols, group)
            split += 1
    return split
