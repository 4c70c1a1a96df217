"""Device meshes and the chain-parallel layout of the MC state (port of
``vaemolsim_tpu/parallel/sharding.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the default process group (one process per device), its dimension
names the JAX axis names (``"chain"``, ``"replica"``, ``"batch"``,
``"cells"``, ``"atoms"``).  A sharded state holds, on each rank, its own
slice as plain local tensors; every collective is explicit, over a mesh
dimension's process group (the kernels launched through ``ctypes`` have
no DTensor rules).  ``chain_sharding`` describes a global ``DTensor``
layout for :func:`~vaemolsim_tpu_torch.parallel.distributed.
local_to_global`.

:func:`shard_chain_state` slices an ``MCMCState`` (or an ``REMCState``)
to this rank's chains and records where they sit in the global state
(:class:`ChainShard`).  The steps follow that record: the acceptance
counters are all-reduced every step, so any rank reads the global
statistics, as the JAX package's global arrays give them.
"""

from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from vaemolsim_tpu_torch.parallel.distributed import (
    all_sum, broadcast_from_coordinator, mesh_dim, rank_generator)

__all__ = ["make_mesh", "make_hybrid_mesh", "chain_sharding",
           "shard_chain_state", "replicate", "mesh_shape",
           "hybrid_mesh_shape", "ChainShard", "Sharding"]


def _resolve(sizes: dict, total: int) -> dict:
    vals = list(sizes.values())
    known = math.prod(s for s in vals if s != -1)
    return dict(zip(sizes, [total // known if s == -1 else s
                            for s in vals]))


def mesh_shape(axis_sizes: Optional[dict], n: int) -> dict:
    """The axis sizes :func:`make_mesh` gives ``axis_sizes`` over ``n``
    ranks (a ``-1`` absorbs the remainder); raises ``ValueError`` for a
    mesh that does not use all ``n``."""
    sizes = _resolve(dict(axis_sizes or {"chain": n}), n)
    if math.prod(sizes.values()) != n:
        raise ValueError(f"Mesh {sizes} does not use all {n} devices")
    return sizes


def hybrid_mesh_shape(dcn_axis_sizes: dict, ici_axis_sizes: dict, n: int,
                      hosts: int = 1) -> dict:
    """The axis sizes of :func:`make_hybrid_mesh`, DCN axes first.  With
    several ``hosts`` the DCN axes resolve against the host count and
    the ICI axes against the ranks of a host; on one host the layout is
    emulated by factoring the ``n`` ranks, a single ``-1`` absorbing the
    remainder over every explicit axis (the JAX package's rule)."""
    if hosts > 1:
        dcn = _resolve(dcn_axis_sizes, hosts)
        ici = _resolve(ici_axis_sizes, n // hosts)
    else:
        every = (*dcn_axis_sizes.values(), *ici_axis_sizes.values())
        explicit = math.prod(s for s in every if s != -1)
        if explicit == 0 or n % max(explicit, 1):
            raise ValueError(
                f"explicit hybrid axes "
                f"{dict(**dcn_axis_sizes, **ici_axis_sizes)} do not divide "
                f"the {n} devices")
        if sum(s == -1 for s in every) <= 1:
            dcn = {k: (n // explicit if s == -1 else s)
                   for k, s in dcn_axis_sizes.items()}
            ici = {k: (n // explicit if s == -1 else s)
                   for k, s in ici_axis_sizes.items()}
        else:
            dcn = _resolve(dcn_axis_sizes, n)
            ici = _resolve(ici_axis_sizes,
                           n // max(math.prod(dcn.values()), 1))
    sizes = {**dcn, **ici}
    if math.prod(sizes.values()) != n:
        raise ValueError(f"Hybrid mesh {sizes} does not use all {n} "
                         "devices")
    return sizes


def _ranks(devices: Optional[Sequence[int]]) -> list:
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh spans the ranks of a process group: call "
            "parallel.initialize_distributed() first")
    return list(devices if devices is not None
                else range(dist.get_world_size()))


def _device_mesh(sizes: dict, ranks: list):
    from torch.distributed.device_mesh import DeviceMesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type,
                      torch.tensor(ranks).reshape(list(sizes.values())),
                      mesh_dim_names=tuple(sizes))


def make_mesh(axis_sizes: Optional[dict] = None,
              devices: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` over ``devices`` (ranks; by default every rank of
    the default process group), ``axis_sizes`` mapping dimension names
    to sizes (one may be -1); by default a 1-D ``("chain",)`` mesh."""
    ranks = _ranks(devices)
    return _device_mesh(mesh_shape(axis_sizes, len(ranks)), ranks)


def make_hybrid_mesh(dcn_axis_sizes: dict, ici_axis_sizes: dict,
                     devices: Optional[Sequence[int]] = None):
    """A mesh whose DCN axes (the JAX package's slow links across pod
    slices) run across hosts and whose ICI axes run over the cards of a
    host.  Hosts are ``WORLD_SIZE / LOCAL_WORLD_SIZE`` (``torchrun``
    numbers ranks host by host, so the flat reshape keeps each ICI block
    on one host); on one host the layout is emulated, as in the JAX
    package."""
    ranks = _ranks(devices)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", len(ranks)))
    hosts = max(len(ranks) // max(local, 1), 1)
    return _device_mesh(hybrid_mesh_shape(dcn_axis_sizes, ici_axis_sizes,
                                          len(ranks), hosts), ranks)


class Sharding(NamedTuple):
    """A global layout over a mesh: one DTensor placement per mesh
    dimension (``Shard(axis)`` or ``Replicate()``)."""

    mesh: Any
    placements: tuple


def chain_sharding(mesh, ndim: int, chain_axis: int = 0,
                   mesh_axis: str = "chain") -> Sharding:
    """Array axis ``chain_axis`` split over ``mesh_axis``, the rest
    replicated.  ``ndim`` is kept for the JAX package's interface."""
    from torch.distributed.tensor import Replicate, Shard

    del ndim
    return Sharding(mesh, tuple(
        Shard(chain_axis) if name == mesh_axis else Replicate()
        for name in mesh.mesh_dim_names))


@dataclass
class ChainShard:
    """Where this rank's slice of a sharded chain state sits.

    ``dims[k]`` names the mesh dimension that splits state axis ``k``
    (axis 0 the chains of an ``MCMCState``; axes 0 and 1 the replicas
    and chains of an ``REMCState``), ``starts[k]`` is this rank's first
    global index on it and ``totals[k]`` the global size.  ``generator``
    is this rank's own stream, seeded apart from every other rank's: the
    generic VAE proposal draws from it (the chains of different ranks
    must not share draws), while draws that must equal the one-device
    run's (the fused proposal's Philox key, the local moves' normals,
    accept and swap uniforms) come from the state's replicated generator
    in the global shape, this rank taking its slice."""

    mesh: Any = field(metadata={"checkpoint": False})
    dims: Tuple[Optional[str], ...]
    starts: Tuple[int, ...]
    totals: Tuple[int, ...]
    generator: torch.Generator

    def group(self, dim: str):
        return self.mesh.get_group(dim)

    def local(self, global_t: torch.Tensor) -> torch.Tensor:
        """This rank's block of a tensor in the global shape."""
        for k, (d, s, tot) in enumerate(zip(self.dims, self.starts,
                                            self.totals)):
            if d is not None:
                n = tot // self.mesh.size(self.mesh.mesh_dim_names.index(d))
                global_t = global_t.narrow(k, s, n)
        return global_t

    def all_sum(self, t: torch.Tensor, dims=None) -> torch.Tensor:
        """``t`` summed over the ranks of the sharded dimensions (or of
        ``dims``), on ``t``'s device."""
        for d in (dims if dims is not None
                  else [d for d in self.dims if d is not None]):
            t = all_sum(t, self.group(d))
        return t


def shard_chain_state(state, mesh, mesh_axis: str = "chain"):
    """This rank's slice of a one-device chain state, on ``mesh``.

    An ``MCMCState`` splits its chain axis (axis 0 of ``configs`` and
    ``energies``) over ``mesh_axis``.  An ``REMCState`` (``(R, C, D)``)
    splits its replica axis over the mesh dimension ``"replica"``, where
    the mesh has one, its chain axis over ``mesh_axis`` and its
    ``betas`` with the replicas.  Counters, scalars and the generator
    are replicated: every rank must pass the same global state.  The
    rank's first global chain (and replica) is recorded in the returned
    state's ``shard``."""
    from vaemolsim_tpu_torch.parallel.replica import REMCState

    names = mesh.mesh_dim_names
    mesh_dim(mesh, mesh_axis)
    lead = 2 if isinstance(state, REMCState) else 1
    dims = (("replica" if "replica" in names else None, mesh_axis)
            if lead == 2 else (mesh_axis,))
    starts, totals = [], []
    for k, d in enumerate(dims):
        total = state.configs.shape[k]
        if d is None:
            starts.append(0)
            totals.append(total)
            continue
        _, size, index = mesh_dim(mesh, d)
        if total % size:
            raise ValueError(f"{total} along state axis {k} do not divide "
                             f"over the {size}-way {d!r} mesh dimension")
        starts.append(index * (total // size))
        totals.append(total)
    shard = ChainShard(mesh, dims, tuple(starts), tuple(totals),
                       rank_generator(state.generator, dist.get_rank()))
    changes = dict(configs=shard.local(state.configs),
                   energies=shard.local(state.energies), shard=shard)
    if lead == 2 and dims[0] is not None:
        changes["betas"] = state.betas.narrow(
            0, starts[0], totals[0] // mesh.size(names.index(dims[0])))
    return dataclasses.replace(state, **changes)


def replicate(tree, mesh):
    """Every rank's copy of ``tree`` (a module, tensor or tree of them)
    made equal to rank 0's: the counterpart of a replicated placement.
    Modules are updated in place (parameters and buffers) and returned."""
    del mesh
    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            for t in list(tree.parameters()) + list(tree.buffers()):
                t.copy_(broadcast_from_coordinator(t.detach()))
        return tree
    return broadcast_from_coordinator(tree)

