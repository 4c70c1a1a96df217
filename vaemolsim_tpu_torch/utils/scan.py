"""Shared run-loop scaffolding: :func:`scan_collect` (port of
``vaemolsim_tpu/utils/scan.py``).

JAX runs a sampler or integrator as one ``lax.scan``.  The port runs the
same loop two ways, chosen by where the state lives:

* on the CPU (and inside an enclosing CUDA-graph capture or its
  warm-up), the plain Python loop over ``step_fn``;
* on a CUDA state, in chunks: one chunk of steps is warmed up on a side
  stream, captured once as a CUDA graph that reads and writes static
  state buffers, and replayed for every later chunk.  Snapshots are
  copied out after each replay.  Generators passed in ``generators`` are
  registered with the graph, so each replay draws exactly what the eager
  loop would draw from the same state.

A step function that cannot be captured (a host synchronisation such as
``.item()`` or ``bool(tensor)``, a data-dependent shape such as
``torch.nonzero``, a port kernel, whose launches are counted on the
host) raises on the card; it is never run eagerly there instead.  The
captured chunk lives for one call only: nothing is cached across calls.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from vaemolsim_tpu_torch import _build

__all__ = ["scan_collect", "chunk_size", "eager"]

MAX_CHUNK = 50


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a state (a tensor, tuple, NamedTuple, list, dict or
    dataclass of them), in a fixed order; other values are static."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for c in tree for t in _leaves(c)]
    if isinstance(tree, dict):
        return [t for c in tree.values() for t in _leaves(c)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in _leaves(getattr(tree, f.name))]
    return []


def _rebuild(tree, it):
    """``tree`` with its tensors replaced, in :func:`_leaves` order, by
    the items of ``it``."""
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(c, it) for c in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(c, it) for c in tree)
    if isinstance(tree, dict):
        return {k: _rebuild(c, it) for k, c in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), it)
            for f in dataclasses.fields(tree)})
    return tree


def _stack(trees: Sequence[Any], cat: bool = False):
    """Stack (or concatenate) a list of same-structured states leaf by
    leaf."""
    join = torch.cat if cat else torch.stack
    cols = zip(*(_leaves(t) for t in trees))
    return _rebuild(trees[0], iter([join(list(c)) for c in cols]))


def chunk_size(n_steps: int, collect_every: int = 0,
               step_cost: int = 1) -> int:
    """Steps per captured chunk: the most steps, up to ``MAX_CHUNK //
    step_cost`` (at least 1), that divide ``n_steps`` and are a multiple
    or a divisor of ``collect_every``.  ``step_cost``: inner steps per
    step, for a step that is itself a run of steps."""
    cap = max(MAX_CHUNK // step_cost, 1)
    k = collect_every
    if k and k <= cap:
        return k * max(m for m in range(1, cap // k + 1)
                       if n_steps % (k * m) == 0)
    period = k or n_steps
    return max(d for d in range(1, min(period, cap) + 1)
               if period % d == 0)


def _check_chunk(n_steps: int, k: int, chunk: int) -> None:
    if chunk < 1 or n_steps % chunk or (k and chunk % k and k % chunk):
        raise ValueError(
            f"chunk={chunk} must divide n_steps={n_steps} and be a "
            f"multiple or a divisor of collect_every={k}")


_EAGER = contextvars.ContextVar("scan_collect_eager", default=False)


@contextlib.contextmanager
def eager():
    """Within this context :func:`scan_collect` runs the plain Python
    loop on every device: the eager reference a replay is checked
    against on the card."""
    token = _EAGER.set(True)
    try:
        yield
    finally:
        _EAGER.reset(token)


def _loop(step_fn, state, n_steps: int, k: int, snap):
    outs = []
    for i in range(1, n_steps + 1):
        state = step_fn(state)
        if k and i % k == 0:
            outs.append(snap(state))
    return state, (_stack(outs) if k else None)


def _aliases(t: torch.Tensor, static: Sequence[torch.Tensor]) -> bool:
    ptr = t.untyped_storage().data_ptr()
    return any(s.untyped_storage().data_ptr() == ptr for s in static)


def _replayed(step_fn, state, n_steps: int, k: int, snap, c: int,
              generators: Sequence[torch.Generator]):
    init = _leaves(state)
    dev = next(t.device for t in init if t.is_cuda)
    static = [t.clone() for t in init]
    per = c // k if k and k <= c else 0      # snapshots inside a chunk

    def run_chunk():
        s = _rebuild(state, iter(static))
        snaps = []
        for i in range(1, c + 1):
            s = step_fn(s)
            if per and i % k == 0:
                snaps.append(snap(s))
        out = _leaves(s)
        if [(o.shape, o.dtype) for o in out] != [(t.shape, t.dtype)
                                                  for t in static]:
            raise ValueError("scan_collect: step_fn must return a state of "
                             "the same structure, shapes and dtypes")
        # A state leaf that reads another static buffer (a swap) is
        # copied first, so no buffer is overwritten before it is read.
        out = [o if o is t or not _aliases(o, static) else o.clone()
               for o, t in zip(out, static)]
        for t, o in zip(static, out):
            if o is not t:
                t.copy_(o)
        return _stack(snaps) if per else None

    with torch.cuda.device(dev):
        before = _build.launch_counts()
        saved = [g.get_state() for g in generators]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        # A loop nested in the step (a shooting run, a WE segment) runs
        # plain in the warm-up, as it will inside the capture.
        with torch.cuda.stream(side), eager():
            run_chunk()
        torch.cuda.current_stream().wait_stream(side)
        for t, t0 in zip(static, init):
            t.copy_(t0)
        for g, st in zip(generators, saved):
            g.set_state(st)
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        try:
            with torch.cuda.graph(graph):
                snap_buf = run_chunk()
        except RuntimeError as err:
            raise RuntimeError(
                "scan_collect: step_fn cannot be captured as a CUDA graph "
                "(a host synchronisation such as .item() or bool(tensor), "
                "or a data-dependent shape); it is not run eagerly on the "
                f"card instead: {err}") from err
        if _build.launch_counts() != before:
            raise RuntimeError(
                "scan_collect: step_fn launched a port kernel, whose "
                "launches are counted on the host and would go uncounted "
                "in a replayed graph")
        outs = []
        for r in range(1, n_steps // c + 1):
            graph.replay()
            if per:
                outs.append(_rebuild(snap_buf, iter(
                    [t.clone() for t in _leaves(snap_buf)])))
            elif k and (r * c) % k == 0:
                outs.append(_stack([snap(_rebuild(state, iter(
                    [t.clone() for t in static])))]))
        final = _rebuild(state, iter([t.clone() for t in static]))
    return final, (_stack(outs, cat=True) if k else None)


def scan_collect(step_fn: Callable[[Any], Any], state: Any,
                 n_steps: int, *, collect_every: int = 0,
                 snapshot_fn: Optional[Callable[[Any], Any]] = None,
                 chunk: Optional[int] = None,
                 generators: Sequence[torch.Generator] = ()
                 ) -> Tuple[Any, Optional[Any]]:
    """Apply ``step_fn`` ``n_steps`` times.

    With ``collect_every = k > 0``, also return ``snapshot_fn(state)``
    (default: the state itself) stacked after every k-th step, as
    ``(n_steps // k, ...)`` leaf by leaf; ``n_steps`` must then divide
    evenly.  The state is a tensor or a tuple, NamedTuple, list, dict or
    dataclass of tensors (non-tensor fields are static).

    On a CUDA state the loop replays a captured chunk of ``chunk`` steps
    (default: the most steps up to 50 that divide ``n_steps`` and fit
    ``collect_every``); ``generators`` are the generators ``step_fn``
    draws from, registered with the graph so that the replay equals the
    eager loop.  ``step_fn`` must be functional (return a new state) and
    free of host synchronisation."""
    if collect_every and n_steps % collect_every != 0:
        raise ValueError("n_steps must be a multiple of collect_every")
    snap = snapshot_fn if snapshot_fn is not None else (lambda s: s)
    if chunk is not None:
        _check_chunk(n_steps, collect_every, chunk)
    on_card = any(t.is_cuda for t in _leaves(state))
    if (not on_card or n_steps == 0 or _EAGER.get()
            or torch.cuda.is_current_stream_capturing()):
        return _loop(step_fn, state, n_steps, collect_every, snap)
    c = chunk or chunk_size(n_steps, collect_every)
    return _replayed(step_fn, state, n_steps, collect_every, snap, c,
                     generators)
