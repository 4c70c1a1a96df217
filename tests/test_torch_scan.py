"""The port's ``utils.scan_collect`` against the JAX package's on the CPU,
where it is the plain loop: the final state and the stacked snapshots of a
deterministic step equal JAX's to 1e-6 for ``collect_every`` 0, 1 and k,
with the default and a custom snapshot; a ``collect_every`` that does not
divide ``n_steps`` raises as in JAX.  Also the state containers it takes
and the chunk it picks for the card.  Inputs from numpy; float32."""

from dataclasses import dataclass
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu.utils import scan_collect as jscan
from vaemolsim_tpu_torch.utils import scan_collect
from vaemolsim_tpu_torch.utils.scan import chunk_size, eager


class Pair(NamedTuple):
    x: object
    v: object


def step_t(s):
    return Pair(s.x + 0.1 * torch.sin(s.v), 0.9 * s.v + 0.05 * s.x * s.x)


def step_j(s):
    return Pair(s.x + 0.1 * jnp.sin(s.v), 0.9 * s.v + 0.05 * s.x * s.x)


def start():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(4, 3)).astype(np.float32),
            rng.normal(size=(4, 3)).astype(np.float32))


@pytest.mark.parametrize("every,snap", [(0, False), (1, False), (4, False),
                                        (3, True)])
def test_scan_collect_matches_jax(every, snap):
    x, v = start()
    sn_t = (lambda s: s.x * s.v) if snap else None
    sn_j = (lambda s: s.x * s.v) if snap else None
    got, gtraj = scan_collect(step_t, Pair(torch.tensor(x), torch.tensor(v)),
                              12, collect_every=every, snapshot_fn=sn_t)
    want, wtraj = jscan(step_j, Pair(jnp.asarray(x), jnp.asarray(v)), 12,
                        collect_every=every, snapshot_fn=sn_j)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    if not every:
        assert gtraj is None and wtraj is None
        return
    if snap:
        gtraj, wtraj = (gtraj,), (wtraj,)
    for a, b in zip(gtraj, wtraj):
        assert a.shape == b.shape == (12 // every, 4, 3)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_collect_every_must_divide_n_steps():
    x, v = start()
    with pytest.raises(ValueError, match="multiple of collect_every"):
        jscan(step_j, Pair(jnp.asarray(x), jnp.asarray(v)), 10,
              collect_every=3)
    with pytest.raises(ValueError, match="multiple of collect_every"):
        scan_collect(step_t, Pair(torch.tensor(x), torch.tensor(v)), 10,
                     collect_every=3)
    with pytest.raises(ValueError, match="chunk"):
        scan_collect(step_t, Pair(torch.tensor(x), torch.tensor(v)), 12,
                     collect_every=4, chunk=3)


@dataclass
class Box:
    t: torch.Tensor
    scale: float


def test_dict_and_dataclass_states_keep_their_static_fields():
    state = {"a": torch.ones(2), "box": Box(torch.zeros(3), 2.0)}

    def step(s):
        b = s["box"]
        return {"a": s["a"] * b.scale,
                "box": Box(b.t + s["a"].sum(), b.scale)}

    out, traj = scan_collect(step, state, 3, collect_every=1,
                             snapshot_fn=lambda s: s["box"])
    np.testing.assert_allclose(out["a"].numpy(), [8.0, 8.0])
    np.testing.assert_allclose(out["box"].t.numpy(), [14.0] * 3)
    assert isinstance(traj, Box) and traj.scale == 2.0
    np.testing.assert_allclose(traj.t[:, 0].numpy(), [2.0, 6.0, 14.0])
    with eager():
        again, _ = scan_collect(step, state, 3)
    np.testing.assert_allclose(again["a"].numpy(), [8.0, 8.0])


@pytest.mark.parametrize("n,every,cost,want", [
    (400, 1, 1, 50), (1000, 0, 1, 50), (2400, 1, 25, 2), (15000, 200, 1, 50),
    (997, 0, 1, 1), (650, 10, 400, 1), (60, 0, 1, 30), (12, 4, 1, 12)])
def test_chunk_size(n, every, cost, want):
    c = chunk_size(n, every, cost)
    assert c == want
    assert n % c == 0 and (not every or c % every == 0 or every % c == 0)
