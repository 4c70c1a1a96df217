"""The port's input pipeline (``vaemolsim_tpu_torch/data/pipeline.py``)
against the JAX package's (tests/test_data.py's pipeline cases): prefetch
order and placement, the background reader's semantics, and epoch
streams whose batches, for an integer key, are the JAX stream's, value
for value and in the same order.  On the CPU the prefetch is a plain
placement; its side-stream copy runs in tests/test_torch_cuda.py.
"""

import itertools
import threading

import numpy as np
import pytest
import torch

from vaemolsim_tpu.data import epoch_stream as jepoch_stream
from vaemolsim_tpu.data import prefetch_to_device as jprefetch
from vaemolsim_tpu_torch.data import (BackgroundReader, DCDReader,
                                      epoch_stream, prefetch_to_device,
                                      write_dcd)


@pytest.fixture
def traj(tmp_path):
    rng = np.random.default_rng(0)
    coords = rng.normal(size=(12, 30, 3)).astype(np.float32)
    box = np.tile(np.array([20.0, 90.0, 20.0, 90.0, 90.0, 20.0]), (12, 1))
    path = str(tmp_path / "t.dcd")
    write_dcd(path, coords, box)
    return path, coords


def test_prefetch_preserves_order_and_matches_jax():
    items = [{"x": np.full((4, 2), i, np.float32), "i": np.int32(i)}
             for i in range(7)]
    out = list(prefetch_to_device(iter(items), size=3, device="cpu"))
    want = list(jprefetch(iter(items), size=3))
    assert len(out) == len(want) == 7
    for got, ref in zip(out, want):
        assert torch.is_tensor(got["x"]) and got["x"].device.type == "cpu"
        np.testing.assert_array_equal(got["x"].numpy(), np.asarray(ref["x"]))
        assert int(got["i"]) == int(ref["i"])


def test_prefetch_entry_point_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        next(prefetch_to_device(iter([np.zeros(2)])))


def test_prefetch_size_validation():
    with pytest.raises(ValueError, match="size"):
        list(prefetch_to_device(iter([]), size=0, device="cpu"))


def test_prefetch_places_the_ranks_slice():
    """With a sharding, only this rank's block of each leaf is placed
    (a one-rank stand-in for the mesh: rank 1 of a 4-way dimension)."""
    from torch.distributed.tensor import Replicate, Shard

    from vaemolsim_tpu_torch.parallel.sharding import Sharding

    class Mesh:
        mesh_dim_names = ("batch", "model")

        def size(self, d):
            return (4, 2)[d]

        def get_local_rank(self, d):
            return (1, 0)[d]

    items = [np.arange(32, dtype=np.float32).reshape(16, 2)]
    out = list(prefetch_to_device(iter(items), device="cpu",
                                  sharding=Sharding(Mesh(), (Shard(0),
                                                             Replicate()))))
    np.testing.assert_array_equal(out[0].numpy(), items[0][4:8])


def test_background_reader_yields_all():
    bg = BackgroundReader(lambda: iter(range(100)), capacity=3)
    assert list(bg) == list(range(100))


def test_background_reader_propagates_exception():
    def bad():
        yield 1
        raise RuntimeError("disk died")

    it = iter(BackgroundReader(bad))
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="disk died"):
        list(it)


def test_background_reader_close_stops_producer():
    bg = BackgroundReader(lambda: itertools.count(), capacity=2)
    it = iter(bg)
    assert next(it) == 0
    bg.close()


def test_background_reader_close_unblocks_consumer():
    bg = BackgroundReader(lambda: itertools.count(), capacity=2)
    it = iter(bg)
    next(it)
    bg.close()
    done = threading.Event()

    def drain():
        for _ in it:
            pass
        done.set()

    t = threading.Thread(target=drain, daemon=True)
    t.start()
    assert done.wait(timeout=5.0), "consumer hung after close()"
    t.join(timeout=5.0)
    assert not t.is_alive()


@pytest.mark.parametrize("key,io_chunk", [(0, 16), (7, 24), (123, None)])
def test_epoch_stream_batches_equal_jax_for_an_integer_key(key, io_chunk):
    data = np.arange(64, dtype=np.float32)[:, None]
    got = [b.numpy() for b in epoch_stream(
        lambda s, c: data[s:s + c], 64, 8, key=key, io_chunk=io_chunk,
        device="cpu")]
    want = [np.asarray(b) for b in jepoch_stream(
        lambda s, c: data[s:s + c], 64, 8, key=key, io_chunk=io_chunk)]
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    seen = np.concatenate(got).ravel().tolist()
    assert sorted(seen) == list(range(64)) and seen != list(range(64))


def test_epoch_stream_sequential_and_remainder():
    data = np.arange(20, dtype=np.float32)[:, None]
    for drop in (True, False):
        got = [b.numpy() for b in epoch_stream(
            lambda s, c: data[s:s + c], 20, 8, drop_remainder=drop,
            device="cpu")]
        want = [np.asarray(b) for b in jepoch_stream(
            lambda s, c: data[s:s + c], 20, 8, drop_remainder=drop)]
        assert [b.shape[0] for b in got] == ([8, 8] if drop else [8, 8, 4])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_epoch_stream_from_dcd_equals_jax(traj):
    """The advertised composition: a DCD file through the background
    reader into batches, the JAX stream's batches on the same key."""
    path, coords = traj
    reader = DCDReader(path)

    def read(s, c):
        return reader.read(s, c)[0].reshape(c, -1)

    got = [b.numpy() for b in epoch_stream(read, reader.n_frames, 4, key=3,
                                           device="cpu")]
    want = [np.asarray(b) for b in jepoch_stream(read, reader.n_frames, 4,
                                                 key=3)]
    assert len(got) == 3 and all(b.shape == (4, 90) for b in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(np.sort(np.concatenate(got).sum(1)),
                               np.sort(coords.reshape(12, -1).sum(1)),
                               rtol=1e-5)


def test_epoch_stream_takes_a_generator_key():
    data = np.arange(32, dtype=np.float32)[:, None]
    runs = [[b.numpy() for b in epoch_stream(
        lambda s, c: data[s:s + c], 32, 8, device="cpu",
        key=torch.Generator().manual_seed(5))] for _ in range(2)]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
