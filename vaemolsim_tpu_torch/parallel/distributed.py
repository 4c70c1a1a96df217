"""The multi-process runtime over ``torch.distributed`` (port of
``vaemolsim_tpu/parallel/distributed.py``).

The JAX package runs one process per host that drives every device of
the host; PyTorch runs one process per device.  This module brings up
that process group and supplies the host-side coordination the rest of
the port uses:

- :func:`initialize_distributed` — ``init_process_group`` with NCCL on
  CUDA and gloo on the CPU, idempotent.  Under ``torchrun`` (which sets
  ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE``) call it
  with no arguments.
- :func:`local_to_global` / :func:`global_to_local` — between each
  rank's local shard and a global ``DTensor`` (``Shard`` along the
  sharded mesh dimension).
- :func:`process_allmean`, :func:`broadcast_from_coordinator`,
  :func:`sync_processes` — mean over ranks, a broadcast from rank 0 and
  a barrier.
- :func:`mesh_dim` — a mesh dimension's process group, size and this
  rank's index on it; :func:`all_sum` and :func:`all_gather_cat` — a
  sum and a concatenation over a group's ranks, moved to the group's
  collective device and back; :func:`rank_generator` — a stream of this
  rank's own, split off a replicated generator.
- :func:`sum_over` and :func:`replicated` — the two autograd-aware
  collectives of a sharded computation whose result every rank holds:
  a partial sum made whole (its gradient passes through unchanged) and
  a replicated input (its gradient summed over the ranks).

Every helper works without a process group as the one-process case.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from vaemolsim_tpu_torch._tree import tree_map

__all__ = ["initialize_distributed", "shutdown_distributed",
           "process_count", "process_index", "is_coordinator",
           "local_to_global", "global_to_local", "process_allmean",
           "broadcast_from_coordinator", "sync_processes", "sum_over",
           "replicated", "collective_device", "mesh_dim", "all_sum",
           "all_gather_cat", "rank_generator"]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           local_device_ids: Optional[Sequence[int]] = None,
                           cpu_collectives: str = "gloo",
                           timeout: float = 600.0) -> None:
    """Initialize the default process group (a no-op once it exists).

    ``coordinator_address``: ``"host:port"`` of rank 0 (a TCP
    rendezvous), or a full init method (``"tcp://..."``,
    ``"file:///path"``); without it the standard ``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE`` variables are read
    (``env://``).  ``num_processes`` and ``process_id`` are the world
    size and this rank.  The backend is NCCL when CUDA is available or
    ``local_device_ids`` names a card, else ``cpu_collectives`` (gloo).
    With NCCL this process binds ``local_device_ids[0]``, else
    ``LOCAL_RANK``, else its rank modulo the card count.  A failed initialization raises: nothing falls back
    to another backend.  ``timeout`` (seconds) bounds every collective.
    """
    if dist.is_initialized():
        return
    backend = ("nccl" if local_device_ids is not None
               or torch.cuda.is_available() else cpu_collectives)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    world = (num_processes if num_processes is not None
             else int(os.environ.get("WORLD_SIZE", 1)))
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", 0)))
    device_id = None
    if backend == "nccl":
        if local_device_ids is not None:
            local = int(list(local_device_ids)[0])
        elif "LOCAL_RANK" in os.environ:
            local = int(os.environ["LOCAL_RANK"])
        else:
            local = rank % max(torch.cuda.device_count(), 1)
        torch.cuda.set_device(local)
        device_id = torch.device("cuda", local)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout),
                            device_id=device_id)


def shutdown_distributed() -> None:
    """Destroy the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    return process_index() == 0


def collective_device(group=None) -> torch.device:
    """The device a collective of ``group`` takes its tensors on: this
    rank's card under NCCL, the CPU otherwise."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def mesh_dim(mesh, axis: str):
    """(process group, size, this rank's index) of ``mesh``'s dimension
    ``axis``; raises for anything but a ``DeviceMesh`` with that
    dimension."""
    if not hasattr(mesh, "mesh_dim_names"):
        raise TypeError(f"mesh must be a DeviceMesh (parallel.make_mesh); "
                        f"got {type(mesh).__name__}")
    names = mesh.mesh_dim_names
    if axis not in names:
        raise ValueError(f"mesh has dimensions {names}; expected {axis!r} "
                         "(pass mesh_axis=...)")
    return (mesh.get_group(axis), mesh.size(names.index(axis)),
            mesh.get_local_rank(axis))


def all_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over ``group``'s ranks, on ``t``'s device (``t``
    itself is left as it was)."""
    out = t.to(collective_device(group)).clone()
    dist.all_reduce(out, group=group)
    return out.to(t.device)


def all_gather_cat(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all of them) concatenated along
    axis 0 in rank order, on ``t``'s device."""
    local = t.to(collective_device(group)).contiguous()
    parts = [torch.empty_like(local)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts).to(t.device)


def rank_generator(generator: torch.Generator, rank: int
                   ) -> torch.Generator:
    """A stream of rank ``rank``'s own, seeded from one draw of a copy of
    the replicated ``generator`` (the same draw on every rank; the
    generator itself is not advanced) and the rank."""
    probe = torch.Generator(device=generator.device)
    probe.set_state(generator.get_state())
    seed = int(torch.randint(2 ** 62, (1,), generator=probe,
                             device=generator.device))
    return torch.Generator(device=generator.device).manual_seed(
        (seed + 0x9E3779B97F4A7C15 * (rank + 1)) % 2 ** 63)


def local_to_global(local_data: Any, sharding) -> Any:
    """Each rank's local shards as global ``DTensor``s.

    ``sharding`` is a :class:`~vaemolsim_tpu_torch.parallel.sharding.
    Sharding` (``chain_sharding(mesh, ndim)``) or a callable ``tensor ->
    Sharding`` for per-leaf specs; ``local_data`` a tensor, array or tree
    of them holding this rank's slice.  Shards are even (the JAX
    package's arrays are too), so a leaf's global leading size is the
    local one times the sharded dimension's size."""
    from torch.distributed.tensor import DTensor

    def put(a):
        t = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
        s = sharding(t) if callable(sharding) else sharding
        return DTensor.from_local(t.to(s.mesh.device_type), s.mesh,
                                  s.placements, run_check=False)

    return tree_map(put, local_data)


def global_to_local(global_tree: Any) -> Any:
    """This rank's shard of each global ``DTensor``, as numpy."""
    return tree_map(lambda a: a.to_local().detach().cpu().numpy(), global_tree)


def process_allmean(tree: Any) -> Any:
    """Mean over ranks of a tree of host numbers or arrays (per-rank
    metrics), as float64 numpy on every rank."""
    n = process_count()

    def mean(a):
        a = np.asarray(a, np.float64)
        if n == 1:
            return a
        t = torch.as_tensor(a, device=collective_device())
        dist.all_reduce(t)
        return (t / n).cpu().numpy()

    return tree_map(mean, tree)


def broadcast_from_coordinator(tree: Any) -> Any:
    """Rank 0's values of a tree of tensors or arrays, on every rank
    (tensors keep their device, arrays come back as numpy)."""
    if process_count() == 1:
        return tree

    def bcast(a):
        was_tensor = torch.is_tensor(a)
        t = torch.as_tensor(a) if was_tensor else torch.as_tensor(
            np.asarray(a))
        home = t.device
        t = t.to(collective_device()).contiguous()
        dist.broadcast(t, src=0)
        return t.to(home) if was_tensor else t.cpu().numpy()

    return tree_map(bcast, tree)


def sync_processes(name: str = "sync") -> None:
    """Barrier across ranks (checkpoint commit points and the like);
    ``name`` is kept for the JAX package's interface."""
    del name
    if process_count() > 1:
        dist.barrier()


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) whose backward is the identity: every rank
    holds the same sum and the same gradient of it."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    """Identity whose backward sums the gradient over the ranks: the
    entry of a replicated input into a sharded computation."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_over(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ``group``'s ranks of each rank's partial ``t``,
    differentiable: pair it with :func:`replicated` on the inputs."""
    return _SumOver.apply(t, group)


def replicated(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` unchanged, its gradient summed over ``group``'s ranks."""
    return _Replicated.apply(t, group)
