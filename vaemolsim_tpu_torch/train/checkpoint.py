"""Checkpoint and resume (port of ``vaemolsim_tpu/train/checkpoint.py``).

A checkpoint holds a tree (a dict, list or tuple, nested freely) of the
objects a run needs to go on: modules (their state dicts: parameters
and buffers, batch-norm running moments included), optimizers (their
state dicts), ``torch.Generator``s (their states) and chain states such
as ``MCMCState`` and ``REMCState`` (dataclasses, stored field by field),
beside plain tensors and numbers.  It is one ``torch.save`` file of
dicts, lists, tensors and numbers only, so it loads with
``torch.load(weights_only=True)``: no pickled code runs on restore.

Restoring takes a template of the same structure (build the model, its
optimizer and the generator first): modules, optimizers and generators
are loaded IN PLACE and returned; dataclasses come back as new
instances whose tensors sit on the template's devices and whose
generators are the template's, loaded.  The format is this package's
own: it does not read the JAX package's orbax checkpoints.

Under ``torch.distributed`` a :class:`CheckpointManager` is collective:
every rank writes its own shard of the tree (a sharded chain state holds
only the rank's chains) into ``ckpt_<step>.tmp/rank<r>.pt``, and after a
barrier rank 0 commits the step by renaming the directory to
``ckpt_<step>/``; a restore gives every rank its own shard back.  A
dataclass field marked ``metadata={"checkpoint": False}`` (a shard's
mesh) is not saved; a restore keeps the template's.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
from typing import Any, Dict, Optional

import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "CheckpointManager"]

_KIND = "__checkpoint_kind__"


def _encode(obj: Any) -> Any:
    if isinstance(obj, torch.nn.Module):
        return {_KIND: "module", "state": {k: v.detach().cpu() for k, v in
                                           obj.state_dict().items()}}
    if isinstance(obj, torch.optim.Optimizer):
        return {_KIND: "optimizer", "state": obj.state_dict()}
    if isinstance(obj, torch.Generator):
        return {_KIND: "generator", "state": obj.get_state()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {_KIND: "dataclass", "name": type(obj).__name__,
                "fields": {f.name: _encode(getattr(obj, f.name))
                           for f in _saved_fields(obj)}}
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_encode(v) for v in obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"cannot checkpoint a {type(obj).__name__}")


def _saved_fields(obj: Any) -> list:
    return [f for f in dataclasses.fields(obj)
            if f.metadata.get("checkpoint", True)]


def _kind(saved: Any) -> Optional[str]:
    return saved.get(_KIND) if isinstance(saved, dict) else None


def _decode(template: Any, saved: Any) -> Any:
    kind = _kind(saved)
    if isinstance(template, torch.nn.Module):
        _expect(kind, "module", template)
        template.load_state_dict(saved["state"])
        return template
    if isinstance(template, torch.optim.Optimizer):
        _expect(kind, "optimizer", template)
        template.load_state_dict(saved["state"])
        return template
    if isinstance(template, torch.Generator):
        _expect(kind, "generator", template)
        template.set_state(saved["state"])
        return template
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        _expect(kind, "dataclass", template)
        if saved["name"] != type(template).__name__:
            raise ValueError(f"checkpoint holds a {saved['name']}, the "
                             f"template a {type(template).__name__}")
        return dataclasses.replace(template, **{
            f.name: _decode(getattr(template, f.name),
                            saved["fields"][f.name])
            for f in _saved_fields(template)})
    if torch.is_tensor(template):
        return saved.to(template.device)
    if isinstance(template, dict):
        if set(template) != set(saved):
            raise ValueError(f"checkpoint keys {sorted(saved)} differ from "
                             f"the template's {sorted(template)}")
        return {k: _decode(v, saved[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if len(template) != len(saved):
            raise ValueError(f"checkpoint holds {len(saved)} entries, the "
                             f"template {len(template)}")
        return type(template)(_decode(t, s) for t, s in zip(template, saved))
    return saved


def _expect(kind: Optional[str], want: str, template: Any) -> None:
    if kind != want:
        raise ValueError(f"checkpoint holds a {kind or 'plain value'} where "
                         f"the template has a {type(template).__name__}")


def save_checkpoint(path: str, tree: Any) -> None:
    """Write ``tree`` to ``path`` (one file; its directory is made)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(_encode(tree), tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, template: Any) -> Any:
    """The tree saved at ``path``, restored into ``template`` (see the
    module docstring)."""
    saved = torch.load(os.path.abspath(path), map_location="cpu",
                       weights_only=True)
    return _decode(template, saved)


class CheckpointManager:
    """Step-numbered checkpoints in ``directory``, the newest
    ``max_to_keep`` kept.  Collective, one shard a rank, while a
    ``torch.distributed`` process group exists (the module docstring):
    every rank then calls ``save`` and ``restore`` with its own shard,
    and ``directory`` is on a file system every rank sees."""

    _NAME = re.compile(r"^ckpt_(\d+)(\.pt)?$")

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError("max_to_keep must be at least 1")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        import torch.distributed as dist
        self._dist = dist if dist.is_initialized() else None
        if self._dist is None or self._dist.get_rank() == 0:
            os.makedirs(self.directory, exist_ok=True)
        self._barrier()

    def _barrier(self) -> None:
        if self._dist is not None:
            self._dist.barrier()

    def _path(self, step: int) -> str:
        if self._dist is not None:
            return os.path.join(self.directory, f"ckpt_{int(step)}",
                                f"rank{self._dist.get_rank()}.pt")
        return os.path.join(self.directory, f"ckpt_{int(step)}.pt")

    def all_steps(self) -> list:
        steps = []
        for name in os.listdir(self.directory):
            m = self._NAME.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def save(self, step: int, tree: Any) -> None:
        if self._dist is None:
            save_checkpoint(self._path(step), tree)
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self._path(old))
            return
        final = os.path.join(self.directory, f"ckpt_{int(step)}")
        staging = final + ".tmp"
        if self._dist.get_rank() == 0:
            shutil.rmtree(staging, ignore_errors=True)
            os.makedirs(staging)
        self._barrier()
        save_checkpoint(os.path.join(
            staging, f"rank{self._dist.get_rank()}.pt"), tree)
        self._barrier()
        if self._dist.get_rank() == 0:
            shutil.rmtree(final, ignore_errors=True)
            os.replace(staging, final)
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, f"ckpt_{old}"))
        self._barrier()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        step = self.latest_step() if step is None else step
        if step is None:
            raise ValueError(f"no checkpoints found in {self.directory}")
        return restore_checkpoint(self._path(step), template)

    def close(self) -> None:
        """Nothing stays open between calls; kept for the JAX package's
        interface."""
