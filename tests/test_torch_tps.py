"""The port's transition path sampling against the JAX package's on the
CPU, on the quartic double well of ``tests/test_tps.py``: three one-way
and three two-way sweeps with JAX's own draws handed in (split from each
sweep's key as the JAX step splits it): paths, velocities and counters to
1e-4; the shooting run equal to ``md.baoab`` bit for bit on the same
draws; ``reactive_windows`` exactly; ``first_hitting_committor`` with
JAX's draws (q and the unresolved share to 1e-6); and the overdamped
1-D committor against quadrature, the check ``tests/test_tps.py`` pins
(0.07).  Inputs from numpy; float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import mcmc as jmcmc
from vaemolsim_tpu_torch import md
from vaemolsim_tpu_torch.convert import from_jax
from vaemolsim_tpu_torch.mcmc import (TPSState, first_hitting_committor,
                                      make_tps_step, reactive_windows,
                                      run_tps, tps_init)
from vaemolsim_tpu_torch.mcmc.tps import _BAOAB

H, KT, DT, FRICTION, N_FRAMES = 3.5, 1.0, 0.02, 0.5, 21


def dwell(x):
    return H * (x[..., 0, 0] ** 2 - 1.0) ** 2


def in_a(x):
    return x[..., 0, 0] < -0.7


def in_b(x):
    return x[..., 0, 0] > 0.7


def t(a):
    return torch.as_tensor(np.array(a))


def normals(key, n, shape):
    keys = jax.random.split(key, n)
    return t(jax.vmap(lambda k: jax.random.normal(k, shape))(keys))


def jax_draws(key, mode, w, shape):
    """The draws the JAX sweep takes from ``key``, as the port's dict."""
    t_ = N_FRAMES - 1
    if mode == "one_way":
        kj, kd, kn = jax.random.split(key, 3)
        return dict(j=t(jax.random.randint(kj, (w,), 1, t_)).long(),
                    forward=t(jax.random.bernoulli(kd, 0.5, (w,))),
                    noise=normals(kn, t_, (w,) + shape))
    kj, kv, kf, kb = jax.random.split(key, 4)
    return dict(j=t(jax.random.randint(kj, (w,), 1, t_)).long(),
                z_v=t(jax.random.normal(kv, (w,) + shape)),
                noise_f=normals(kf, t_, (w,) + shape),
                noise_b=normals(kb, t_, (w,) + shape))


@pytest.mark.parametrize("mode", ["one_way", "two_way"])
def test_sweeps_match_jax_with_its_draws(mode):
    w = 4
    line = jnp.linspace(-1.0, 1.0, N_FRAMES)[None, :, None, None]
    jstate = jmcmc.tps_init(jnp.tile(line, (w, 1, 1, 1)),
                            key=jax.random.PRNGKey(0), kt=KT)
    state = from_jax(jstate, "cpu")
    assert isinstance(state, TPSState) and state.n_acc.dtype == torch.int32
    kw = dict(in_a=in_a, in_b=in_b, dt=DT, kt=KT, friction=FRICTION,
              mode=mode)
    jstep = jax.jit(jmcmc.make_tps_step(dwell, **kw))
    step = make_tps_step(dwell, **kw)
    for k in jax.random.split(jax.random.PRNGKey(1), 3):
        jstate = jstep(jstate, k)
        state = step.move(state, jax_draws(k, mode, w, (1, 1)))
        np.testing.assert_allclose(state.path.numpy(),
                                   np.asarray(jstate.path), atol=1e-4)
        np.testing.assert_allclose(state.vel.numpy(),
                                   np.asarray(jstate.vel), atol=1e-4)
        np.testing.assert_array_equal(state.n_acc.numpy(),
                                      np.asarray(jstate.n_acc))
        np.testing.assert_array_equal(state.n_trials.numpy(),
                                      np.asarray(jstate.n_trials))
    assert int(state.n_trials[0]) == 3


def test_shooting_run_is_md_baoab_bit_for_bit():
    rng = np.random.default_rng(2)
    x0 = t(rng.normal(size=(3, 2, 2)).astype(np.float32))
    v0 = t(rng.normal(size=(3, 2, 2)).astype(np.float32))
    pot = lambda x: dwell(x) + 0.5 * (x[..., 1, :] ** 2).sum(-1)  # noqa
    kw = dict(dt=DT, friction=FRICTION, masses=[1.0, 4.0])
    _, (want_x, want_v) = md.baoab(pot, x0, v0,
                                   torch.Generator().manual_seed(3),
                                   n_steps=30, kT=KT, collect_every=1,
                                   collect_v=True, **kw)
    gen = torch.Generator().manual_seed(3)
    noise = torch.stack([md._normal(gen, v0) for _ in range(30)])
    got_x, got_v = _BAOAB(pot, kt=KT, **kw).run(x0, v0, 30, noise,
                                               collect_v=True)
    assert torch.equal(got_x, want_x) and torch.equal(got_v, want_v)


def test_run_tps_collects_and_keeps_paths_reactive():
    w = 3
    line = torch.linspace(-1.0, 1.0, N_FRAMES)[None, :, None, None]
    gen = torch.Generator().manual_seed(4)
    state = tps_init(line.repeat(w, 1, 1, 1), generator=gen, kt=KT)
    step = make_tps_step(dwell, in_a=in_a, in_b=in_b, dt=DT, kt=KT,
                         friction=FRICTION)
    state, coll = run_tps(step, state, gen, 6, collect_every=3)
    assert coll.shape == (2, w, N_FRAMES, 1, 1)
    assert bool(in_a(state.path[:, 0]).all() & in_b(state.path[:, -1]).all())
    assert state.n_trials.tolist() == [6] * w
    with pytest.raises(ValueError, match="pass seed velocities"):
        tps_init(line.repeat(w, 1, 1, 1))


def test_reactive_windows_match_jax():
    rng = np.random.default_rng(5)
    phase = 2 * np.pi * np.arange(120) / 16
    traj = (1.2 * np.sin(phase) + 0.1 * rng.normal(size=120)).astype(
        np.float32)[:, None, None]
    got, valid = reactive_windows(t(traj), n_frames=9, in_a=in_a,
                                  in_b=in_b, max_windows=60)
    want, jvalid = jmcmc.reactive_windows(jnp.asarray(traj), n_frames=9,
                                          in_a=in_a, in_b=in_b,
                                          max_windows=60)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(valid.sum()) < 60


def test_committor_matches_jax_with_its_draws():
    xs = np.array([-0.6, -0.2, 0.0, 0.3, 0.65], np.float32)[:, None, None]
    kw = dict(in_a=in_a, in_b=in_b, n_shots=6, max_steps=300, dt=0.01,
              kt=KT, friction=3.0)
    key = jax.random.PRNGKey(6)
    jq, junres = jmcmc.first_hitting_committor(dwell, jnp.asarray(xs),
                                               key=key, **kw)
    kx, kv = jax.random.split(key)
    draws = (t(jax.random.normal(kv, (30, 1, 1))),
             normals(kx, 300, (30, 1, 1)))
    q, unres = first_hitting_committor(dwell, t(xs), noise=draws, **kw)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=1e-6)
    np.testing.assert_allclose(unres.numpy(), np.asarray(junres), atol=1e-6)


def test_overdamped_committor_matches_quadrature():
    xs = torch.tensor([-0.5, -0.25, 0.0, 0.25, 0.5])[:, None, None]
    q, unres = first_hitting_committor(
        dwell, xs, in_a=in_a, in_b=in_b,
        generator=torch.Generator().manual_seed(0), n_shots=512,
        max_steps=4000, dt=0.005, kt=KT, friction=25.0)
    assert float(unres.max()) < 0.02, unres
    grid = np.linspace(-0.7, 0.7, 4001)
    wts = np.exp(H * (grid ** 2 - 1.0) ** 2 / KT)
    cum = np.concatenate([[0.0], np.cumsum(
        0.5 * (wts[1:] + wts[:-1]) * np.diff(grid))])
    q_exact = np.interp(xs[:, 0, 0].numpy(), grid, cum / cum[-1])
    np.testing.assert_allclose(q.numpy(), q_exact, atol=0.07)
    assert np.all(np.diff(q.numpy()) > -0.05)
