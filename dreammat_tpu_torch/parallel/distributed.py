"""Process group of the port: initialization and host synchronization.

Counterpart of ``dreammat_tpu/parallel/distributed.py``. The reference
trains its ControlNet with DDP over NCCL and keeps shared files (prompt
embeddings, checkpoints) behind a rank-0 write and a barrier; the port does
the same with ``torch.distributed``.

Activation (either):

- torchrun's variables: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR`` and ``MASTER_PORT`` (``init_method="env://"``);
- ``DREAMMAT_MULTIHOST=1`` under SLURM without them: ``SLURM_PROCID``,
  ``SLURM_NTASKS`` and ``SLURM_LOCALID`` give the rank, the world size and
  the local rank; ``MASTER_ADDR`` (and ``MASTER_PORT``, default 29500)
  must be set by the job script.

The backend is NCCL when the device is CUDA and gloo only when the caller
asks for the CPU. An NCCL init that fails raises: nothing falls back to
gloo or to one process. A group the caller made already is left as it is.
Without a group every helper is a no-op, so a one-process run is unchanged.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Optional, Tuple, Union

import torch
import torch.distributed as dist

import dreammat_tpu_torch
from dreammat_tpu_torch.utils.hw import resolve_device

# Set inside ``independent()``: the process runs work of its own, so the
# helpers act as in a one-process run.
_independent = False


def _cluster_env() -> Optional[Tuple[int, int, int]]:
    """(rank, world, local rank) from torchrun's or SLURM's variables, or
    None when the environment asks for no process group."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        rank = int(env["RANK"])
        return rank, int(env["WORLD_SIZE"]), int(env.get("LOCAL_RANK", rank))
    if env.get("DREAMMAT_MULTIHOST") == "1" and "SLURM_PROCID" in env:
        if "MASTER_ADDR" not in env:
            raise RuntimeError("DREAMMAT_MULTIHOST=1 under SLURM needs MASTER_ADDR "
                               "(the address of rank 0's host)")
        rank, world = int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"])
        local = int(env.get("SLURM_LOCALID", 0))
        env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(local))
        env.setdefault("MASTER_PORT", "29500")
        return rank, world, local
    return None


def local_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """This rank's device: a bare ``cuda`` becomes ``cuda:LOCAL_RANK`` when
    the environment names a local rank; an explicit ``cuda:N`` and the CPU
    stay as they are. Raises when CUDA is asked for and absent."""
    dev = resolve_device(device)
    env = _cluster_env()
    if dev.type == "cuda" and dev.index is None and env is not None:
        dev = torch.device("cuda", env[2])
    return dev


def maybe_initialize(device: Union[str, torch.device, None] = "cuda") -> Tuple[int, int]:
    """Initialize the process group iff the environment asks for one;
    returns (rank, world size). Idempotent. On CUDA it selects the rank's
    device (``local_device``) and uses NCCL; on the CPU gloo."""
    if _independent:
        return 0, 1
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = _cluster_env()
    if env is None:
        return 0, 1
    rank, world, _ = env
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method="env://", rank=rank, world_size=world,
                                device_id=dev)
    else:
        dist.init_process_group("gloo", init_method="env://", rank=rank, world_size=world)
    dreammat_tpu_torch.info("process group: rank %d of %d, %s, device %s", rank, world,
                            dist.get_backend(), dev)
    return rank, world


def _active() -> bool:
    return not _independent and dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _active() else 0


def process_count() -> int:
    return dist.get_world_size() if _active() else 1


def is_rank_zero() -> bool:
    return process_index() == 0


def barrier(name: str) -> None:
    """Block until every rank reaches this point (the reference's
    ``barrier()``, utils/misc.py:104-111). No-op without a group."""
    if not _active():
        return
    dreammat_tpu_torch.logger.debug("barrier %s", name)
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def rank_zero_fill(path: str, fill_fn: Callable[[], object], name: str = "cache") -> bool:
    """The reference's rank-0 cache pattern (prompt_processors/base.py:
    364-416): ``fill_fn()`` runs only on rank 0 and only where ``path`` does
    not exist, then every rank waits at a barrier and may read it. Returns
    whether ``path`` exists."""
    if is_rank_zero() and not os.path.exists(path):
        fill_fn()
    barrier(f"rank_zero_fill:{name}")
    return os.path.exists(path)


@contextlib.contextmanager
def rank_zero_first(name: str):
    """The body on rank 0 first, then on the other ranks, which wait at a
    barrier until rank 0 has left it: rank 0 fills a shared cache that the
    others then read. No-op without a group."""
    if not is_rank_zero():
        barrier(name)
    yield
    if is_rank_zero():
        barrier(name)


@contextlib.contextmanager
def independent():
    """Run the body as a one-process run whatever the group: no barrier,
    every rank its own rank 0. For ranks that run different jobs
    (``batch_generate_torch.py``), whose files no other rank shares and
    whose barriers would not pair up."""
    global _independent
    before, _independent = _independent, True
    try:
        yield
    finally:
        _independent = before
