"""Host-to-device input pipeline: prefetch, background IO, epoch streams
(port of ``vaemolsim_tpu/data/pipeline.py``).

Two latencies sit in front of a training or serving step:

- **transfer**: the copy of the *next* batch to the card should overlap
  the step on the current one.  :func:`prefetch_to_device` stages each
  batch in pinned host memory and copies it with ``non_blocking=True``
  on a side CUDA stream; the consumer's stream waits on an event of
  that copy, so the copy runs while the card computes;
- **read / decode**: frames pulled off disk (the native DCD reader)
  should overlap both, which takes a background thread
  (:class:`BackgroundReader`).

:func:`epoch_stream` composes them with chunk-wise shuffled batching over
an out-of-core frame source.  Items are tensors, arrays or trees
(tuple / list / dict) of them.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from vaemolsim_tpu_torch.config import default_device
from vaemolsim_tpu_torch._tree import leaves, tree_map

__all__ = ["prefetch_to_device", "BackgroundReader", "epoch_stream"]


def _rank_slice(sharding):
    """``t -> this rank's block of t`` for a ``parallel.Sharding`` (each
    ``Shard(axis)`` placement narrows ``axis`` to the rank's share) or a
    bare ``DeviceMesh`` (the leading axis over its first dimension)."""
    from torch.distributed.tensor import Shard

    from vaemolsim_tpu_torch.parallel.sharding import Sharding

    if not isinstance(sharding, Sharding):
        sharding = Sharding(sharding, (Shard(0),) + tuple(
            None for _ in sharding.mesh_dim_names[1:]))
    mesh = sharding.mesh

    def take(t):
        for d, pl in enumerate(sharding.placements):
            if isinstance(pl, Shard):
                size = mesh.size(d)
                share = t.shape[pl.dim] // size
                t = t.narrow(pl.dim, mesh.get_local_rank(d) * share, share)
        return t

    return take


def prefetch_to_device(it: Iterator[Any], size: int = 2, sharding=None,
                       device=None) -> Iterator[Any]:
    """Yield the items of ``it`` on ``device`` (by default the card),
    ``size`` of them copied ahead of consumption (double buffering at
    the default 2).

    On a CUDA device every leaf is staged in pinned host memory (the host
    caching allocator hands the same pinned blocks back item after item
    and call after call, so only a first call allocates) and copied on a
    side stream with ``non_blocking=True``; an event of that copy is
    recorded, and the item is yielded only after the consumer's current
    stream has been made to wait on it (and the tensors marked as used
    there, ``record_stream``), so the copy overlaps whatever the card is
    running.  The staging runs on the consumer's thread while the card
    works through the steps already enqueued: a staging thread measured
    slower on an H100 host (the thread handoffs cost more than the
    pinned copies of 2.2-MB batches; ``tools/prefetch_staging.py``).  ``sharding``
    (``parallel.chain_sharding(...)`` or a ``DeviceMesh``) places only
    this rank's slice of each leaf.  On the CPU the leaves are plain
    tensors."""
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    dev = default_device(device)
    take = _rank_slice(sharding) if sharding is not None else (lambda t: t)
    cuda = dev.type == "cuda"
    side = torch.cuda.Stream(dev) if cuda else None

    def put(item):
        def leaf(a):
            t = take(a if torch.is_tensor(a) else torch.as_tensor(
                np.asarray(a)))
            if not cuda:
                return t.to(dev)
            t = t.contiguous()
            if not t.is_cuda:
                t = t.pin_memory()
            with torch.cuda.stream(side):
                return t.to(dev, non_blocking=True)

        out = tree_map(leaf, item)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(side)
        return out, event

    def ready(entry):
        out, event = entry
        if event is not None:
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(event)
            for t in leaves(out):
                t.record_stream(stream)
        return out

    buf = []
    for item in it:
        buf.append(put(item))
        if len(buf) > size:
            yield ready(buf.pop(0))
    while buf:
        yield ready(buf.pop(0))


class BackgroundReader:
    """Run a blocking reader callable in a daemon thread, buffering up
    to ``capacity`` items: disk IO and decoding overlap host and device
    work.  Iterate to consume; the producer's exception is raised at the
    point of consumption; ``close()`` (or garbage collection) stops the
    thread and ends a consumer that is waiting.

    >>> reader = DCDReader("traj.dcd")
    >>> bg = BackgroundReader(lambda: reader.iter_batches(512))
    >>> for batch in prefetch_to_device(bg):
    ...     step(batch)
    """

    _DONE = object()

    def __init__(self, make_iter: Callable[[], Iterator[Any]],
                 capacity: int = 4):
        self._q: "queue.Queue" = queue.Queue(maxsize=capacity)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None

        def work():
            try:
                for item in make_iter():
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
            except BaseException as e:  # noqa: BLE001 - raised when consumed
                self._exc = e
            finally:
                while not self._stop.is_set():
                    try:
                        self._q.put(self._DONE, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def __iter__(self):
        while True:
            try:
                # A timed get, so a close() with no sentinel in flight
                # (the stopped producer enqueues none) cannot strand a
                # waiting consumer.
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            if item is self._DONE:
                if self._exc is not None:
                    raise self._exc
                return
            yield item

    def close(self):
        self._stop.set()

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:  # noqa: BLE001 - nothing to report at teardown
            pass


def epoch_stream(read_fn: Callable[[int, int], Any], n_samples: int,
                 batch_size: int, *, key=None,
                 drop_remainder: bool = True,
                 io_chunk: Optional[int] = None,
                 prefetch: int = 2, sharding=None,
                 device=None) -> Iterator[Any]:
    """One shuffled epoch of device batches from an out-of-core source,
    background IO and device prefetch composed.

    ``read_fn(start, count)`` returns ``count`` consecutive samples from
    ``start`` (e.g. ``lambda s, c: DCDReader(p).read(s, c)[0]``).  The
    epoch is cut into ``io_chunk``-sized runs (default ``8 *
    batch_size``) whose ORDER is shuffled, and the samples shuffle within
    each run: reads stay sequential and memory bounded.  ``key``: an
    integer seed of ``np.random.default_rng`` (the same batches, in the
    same order, as the JAX package's stream on that integer), a
    ``torch.Generator`` (one seed drawn from it), or None for the
    sequential order (inference, serving)."""
    io_chunk = io_chunk or 8 * batch_size
    io_chunk = max(io_chunk // batch_size, 1) * batch_size
    starts = np.arange(0, n_samples, io_chunk)
    rng = None
    if key is not None:
        if isinstance(key, torch.Generator):
            key = int(torch.randint(2 ** 62, (1,), generator=key,
                                    device=key.device))
        rng = np.random.default_rng(int(key))
        rng.shuffle(starts)

    def batches():
        for start in starts:
            chunk = read_fn(int(start), int(min(io_chunk,
                                                n_samples - start)))
            n = np.asarray(leaves(chunk)[0]).shape[0]
            order = rng.permutation(n) if rng is not None else np.arange(n)
            for b in range(0, n, batch_size):
                idx = order[b:b + batch_size]
                if len(idx) < batch_size and drop_remainder:
                    continue
                yield tree_map(lambda a: np.asarray(a)[idx], chunk)

    bg = BackgroundReader(batches)
    try:
        yield from prefetch_to_device(iter(bg), size=prefetch,
                                      sharding=sharding, device=device)
    finally:
        bg.close()
