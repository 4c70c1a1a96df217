"""Where ``data.prefetch_to_device`` should stage its host batches in
pinned memory, timed on the card: on the consumer's thread (the port's
``prefetch_to_device``), on a staging thread of its own (a
``data.BackgroundReader`` that pins each batch), or in a ring of pinned
buffers that the consumer's thread reuses.  Each feeds a loop of a
five-layer MLP over ``chip_smoke.pipeline_utils_path``'s 8 batches of
8192 x 66 float32 (2.2 MB each); the loop's compute with the batches
already on the card and the pinned copies alone are timed beside them.

    PYTHONPATH=. python tools/prefetch_staging.py

prints the card's name and power limit, the first (cold) call of each
variant, then three rounds of five host wall times (ms, each a loop
ended by a device sync) per variant with their least.
"""

import subprocess
import time

import numpy as np
import torch

from vaemolsim_tpu_torch import data
from vaemolsim_tpu_torch._tree import leaves, tree_map

DEV = torch.device("cuda:0")


def _ready(entry):
    out, event = entry
    stream = torch.cuda.current_stream(DEV)
    stream.wait_event(event)
    for t in leaves(out):
        t.record_stream(stream)
    return out


def _ahead(it, put, size):
    buf = []
    for item in it:
        buf.append(put(item))
        if len(buf) > size:
            yield _ready(buf.pop(0))
    while buf:
        yield _ready(buf.pop(0))


def _copy(side, pinned):
    with torch.cuda.stream(side):
        out = tree_map(lambda t: t.to(DEV, non_blocking=True), pinned)
    event = torch.cuda.Event()
    event.record(side)
    return out, event


def staging_thread(it, size=2):
    """Batches pinned by a BackgroundReader thread, copied by the
    consumer's thread on a side stream."""
    side = torch.cuda.Stream(DEV)
    staged = data.BackgroundReader(
        lambda: (tree_map(lambda a: torch.as_tensor(a).pin_memory(), item)
                 for item in it), capacity=size)
    try:
        yield from _ahead(iter(staged), lambda p: _copy(side, p), size)
    finally:
        staged.close()


def pinned_ring(it, size=2):
    """Each batch copied into the next of size + 2 pinned buffers (after
    that buffer's last copy has ended), then on to the card."""
    side = torch.cuda.Stream(DEV)
    ring = [None] * (size + 2)
    count = [0]

    def put(a):
        src = torch.as_tensor(a)
        k = count[0] % len(ring)
        count[0] += 1
        if ring[k] is None or ring[k][0].shape != src.shape:
            ring[k] = [torch.empty(src.shape, dtype=src.dtype,
                                   pin_memory=True), None]
        if ring[k][1] is not None:
            ring[k][1].synchronize()
        ring[k][0].copy_(src)
        out, event = _copy(side, ring[k][0])
        ring[k][1] = event
        return out, event

    return _ahead(it, put, size)


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    frames = np.random.default_rng(14).normal(
        size=(65_536, 22, 3)).astype(np.float32)
    host = [frames[i:i + 8192].reshape(8192, -1)
            for i in range(0, 65_536, 8192)]
    gen = torch.Generator(device=DEV).manual_seed(15)
    w1 = torch.randn(66, 1024, generator=gen, device=DEV) * 0.1
    w2 = torch.randn(1024, 1024, generator=gen, device=DEV) * 0.03

    def loop(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc = torch.zeros((), device=DEV)
        for b in batches:
            h = torch.tanh(b @ w1)
            for _ in range(4):
                h = torch.tanh(h @ w2)
            acc = acc + h.sum()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    def copies_alone():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for h in host:
            torch.as_tensor(h).pin_memory().to(DEV, non_blocking=True)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    resident = [torch.as_tensor(h, device=DEV) for h in host]
    variants = {
        "compute alone": lambda: loop(resident),
        "pinned copies alone": copies_alone,
        "consumer's thread": lambda: loop(
            data.prefetch_to_device(iter(host), device=DEV)),
        "staging thread": lambda: loop(staging_thread(iter(host))),
        "pinned ring": lambda: loop(pinned_ring(iter(host))),
    }
    print("first calls (ms): " + ", ".join(
        f"{name} {fn():.3f}" for name, fn in variants.items()), flush=True)
    for _ in range(3):
        for name, fn in variants.items():
            ts = [fn() for _ in range(5)]
            print(f"{name:20s} least {min(ts):8.3f} ms  all "
                  + " ".join(f"{t:.3f}" for t in ts), flush=True)


if __name__ == "__main__":
    main()
