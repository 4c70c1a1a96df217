"""Profiling and step-timing utilities (port of
``vaemolsim_tpu/utils/profiling.py``).

``trace(logdir)`` wraps ``torch.profiler`` for TensorBoard-viewable
traces; ``StepTimer`` collects per-phase wall times, fenced on the
device of the work the phase produced, so the numbers mean what they
say under asynchronous launches; ``benchmark_fn`` times a call with CUDA
events on the card; ``count_params`` counts a model's elements.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch

__all__ = ["trace", "StepTimer", "benchmark_fn", "count_params"]


@contextlib.contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` trace of the block (CPU and, with a card,
    CUDA activity), written to ``logdir`` for TensorBoard's profiler
    plugin.  Kernels the port launches through ``ctypes`` are recorded
    by CUPTI like any other, though late in a long process a window of
    such launches has recorded only some of them: count launches with
    ``_build.launch_counts()``, not from the trace."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def _sync(result) -> None:
    """Wait for the devices of every tensor in ``result``."""
    leaves = []

    def walk(x):
        if torch.is_tensor(x):
            leaves.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif hasattr(x, "__dataclass_fields__"):
            for name in x.__dataclass_fields__:
                walk(getattr(x, name))

    walk(result)
    for dev in {t.device for t in leaves if t.is_cuda}:
        torch.cuda.synchronize(dev)


class _PhaseHandle:
    """Set ``handle.result = <output>`` inside the phase so the timer can
    fence on the work the body actually produced."""

    result = None


class StepTimer:
    """Named phase timer with device fencing::

        with timer.phase("mc_step") as ph:
            state = step(state)
            ph.result = state      # the card is synchronised on exit

    Without ``ph.result`` the time is the host's enqueue time only (CUDA
    launches return at once); set it whenever the body runs on the card.
    """

    def __init__(self):
        self.times: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        handle = _PhaseHandle()
        t0 = time.perf_counter()
        try:
            yield handle
        finally:
            if handle.result is not None:
                _sync(handle.result)
            self.times.setdefault(name, []).append(
                time.perf_counter() - t0)

    def mean(self, name: str) -> float:
        return sum(self.times[name]) / len(self.times[name])

    def summary(self) -> Dict[str, float]:
        return {k: self.mean(k) for k in self.times}


def benchmark_fn(fn, *args, warmup: int = 1, iters: int = 10) -> float:
    """Mean seconds per call of ``fn(*args)`` after ``warmup`` calls: on
    the card by CUDA events around ``iters`` calls back to back (the
    device time of the run, host gaps included), on the CPU by the wall
    clock."""
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    _sync(out)
    cuda = torch.cuda.is_available() and any(
        torch.is_tensor(a) and a.is_cuda for a in args)
    if cuda:
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        for _ in range(iters):
            out = fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / iters


def count_params(tree) -> int:
    """Total elements of a model's parameters AND buffers (the port keeps
    some of the JAX package's parameters, a static base's loc and scale
    for one, as buffers), less the buffers a module derives from its
    configuration (``derived_buffers``: a MADE's masks), or of a tensor
    or tree of tensors: the JAX package's count of the same model."""
    if isinstance(tree, torch.nn.Module):
        n = sum(t.numel() for t in tree.parameters())
        for m in tree.modules():
            skip = getattr(m, "derived_buffers", ())
            n += sum(b.numel() for name, b in m.named_buffers(recurse=False)
                     if name not in skip)
        return int(n)
    if torch.is_tensor(tree):
        return tree.numel()
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_params(v) for v in tree)
    return 0
