"""The port's replica-exchange MD and Hamiltonian replica exchange
against the JAX package, on the CPU.

Each round's draws are split from the JAX key exactly as the JAX step
splits it and handed to the port's ``step.move``, so both packages take
the same trajectories: positions, velocities and energies to 1e-5 after
each round, and the swap partners and trial / acceptance counts exactly.
Then each 4-rung ladder runs 200 rounds on its own random stream in
each package, and the swap acceptance rates agree to 0.05.  Inputs come
from ``numpy.random.default_rng``; float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu.mcmc.engine import log_uniform as jlog_uniform
from vaemolsim_tpu.parallel import hrex as jh
from vaemolsim_tpu.parallel import remd as jr
from vaemolsim_tpu_torch.parallel import (HREXState, REMDState,
                                          make_hrex_step, make_remd_step,
                                          run_hrex, run_remd)

torch.set_num_threads(1)

BETAS = np.array([1.0, 0.6, 0.35, 0.2], np.float32)


def t(a):
    return torch.as_tensor(np.array(a))


def count(c):
    """A JAX two-word counter as an int."""
    return int(c.lo) + (int(c.hi) << 30)


def well(lib):
    """Example 24's tilted double well on (..., 1, 2) walkers."""
    def potential(conf):
        q = conf[..., 0, :]
        x, y = q[..., 0], q[..., 1]
        return 8.0 * (x * x - 1.0) ** 2 + 0.5 * x + 2.0 * y * y
    return potential


def remd_draws(key, x, e, m):
    key, sub = jax.random.split(key)
    normals = [t(jax.random.normal(k, x.shape, x.dtype))
               for k in jax.random.split(sub, m)]
    _, k_u = jax.random.split(key)
    return dict(normals=normals, logu=t(jlog_uniform(k_u, e.shape, e.dtype)))


def remd_start(walkers, seed):
    rng = np.random.default_rng(seed)
    x = (np.array([-1.0, 0.0]) + 0.2 * rng.normal(
        size=(len(BETAS), walkers, 1, 2))).astype(np.float32)
    v = rng.normal(size=x.shape).astype(np.float32)
    return x, v


def test_remd_rounds_match_jax():
    """Four rounds (5 BAOAB steps each) of 4 rungs x 6 walkers."""
    x, v = remd_start(6, 0)
    kw = dict(dt=0.01, friction=2.0, md_steps_per_exchange=5)
    js = jr.REMDState.create(well(jnp), jnp.asarray(x), jnp.asarray(BETAS),
                             jax.random.PRNGKey(3), v=jnp.asarray(v))
    s = REMDState.create(well(torch), t(x), t(BETAS), torch.Generator(),
                         v=t(v))
    jstep = jax.jit(jr.make_remd_step(well(jnp), **kw))
    step = make_remd_step(well(torch), **kw)
    for _ in range(4):
        noise = remd_draws(js.key, js.x, js.energies, 5)
        with torch.no_grad():
            s = step.move(s, noise)
        js = jstep(js)
        np.testing.assert_allclose(s.x.numpy(), np.asarray(js.x), atol=1e-5)
        np.testing.assert_allclose(s.v.numpy(), np.asarray(js.v), atol=1e-5)
        np.testing.assert_allclose(s.energies.numpy(),
                                   np.asarray(js.energies), atol=1e-5,
                                   rtol=1e-5)
        assert s.exchange_index == int(js.exchange_index)
        assert int(s.num_swap_trials) == count(js.num_swap_trials)
        assert int(s.num_swap_acc) == count(js.num_swap_acc)
    assert 0 < int(s.num_swap_acc) < int(s.num_swap_trials)


def hrex_log_prob(lib):
    """A double well whose barrier grows with lambda, on (R, C, 2)."""
    def log_prob(x, lam):
        return -(lam * 6.0 * (x[..., 0] ** 2 - 1.0) ** 2
                 + 0.3 * x[..., 0] + x[..., 1] ** 2)
    return log_prob


LAMBDAS = np.array([1.0, 0.55, 0.25, 0.05], np.float32)


def hrex_draws(key, x, e, swap):
    key, sub = jax.random.split(key)
    k1, k2 = jax.random.split(sub)
    noise = dict(xi=t(jax.random.normal(k1, x.shape, x.dtype)),
                 log_u=t(jlog_uniform(k2, e.shape, e.dtype)))
    if swap:
        _, k_u = jax.random.split(key)
        noise["u"] = t(jax.random.uniform(k_u, e.shape, minval=1e-38))
    return noise


@pytest.mark.parametrize("kind,scale", [
    ("random_walk", np.array([0.3, 0.4, 0.6, 0.8], np.float32)),
    ("hmc", 0.15)])
def test_hrex_steps_match_jax(kind, scale):
    """Six steps of 4 rungs x 5 chains, exchanging every 2nd step (both
    parities), per-rung scales for the random walk."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 5, 2)).astype(np.float32)
    kw = dict(kind=kind, scale=scale, n_leapfrog=3, exchange_every=2)
    js = jh.HREXState.create(jnp.asarray(x), hrex_log_prob(jnp),
                             jnp.asarray(LAMBDAS), jax.random.PRNGKey(5))
    s = HREXState.create(t(x), hrex_log_prob(torch), t(LAMBDAS),
                         torch.Generator())
    jstep = jax.jit(jh.make_hrex_step(hrex_log_prob(jnp), **kw))
    step = make_hrex_step(hrex_log_prob(torch), **kw)
    for i in range(6):
        noise = hrex_draws(js.key, js.configs, js.energies, i % 2 == 1)
        with torch.no_grad():
            s = step.move(s, noise)
        js = jstep(js)
        np.testing.assert_allclose(s.configs.numpy(),
                                   np.asarray(js.configs), atol=1e-5)
        np.testing.assert_allclose(s.energies.numpy(),
                                   np.asarray(js.energies), atol=1e-5,
                                   rtol=1e-5)
    assert s.step_index == int(js.step_index) == 6
    assert [int(s.num_trials), int(s.num_acc), int(s.num_swap_trials),
            int(s.num_swap_acc)] == [count(js.num_trials), count(js.num_acc),
                                     count(js.num_swap_trials),
                                     count(js.num_swap_acc)]
    assert int(s.num_swap_acc) > 0


def test_remd_ladder_acceptance_matches_jax():
    """200 rounds of 4 rungs x 64 walkers on independent streams: the swap
    acceptance rates within 0.05; run_remd collects every 50th round."""
    x, v = remd_start(64, 2)
    kw = dict(dt=0.01, friction=2.0, md_steps_per_exchange=5)
    js = jr.REMDState.create(well(jnp), jnp.asarray(x), jnp.asarray(BETAS),
                             jax.random.PRNGKey(7), v=jnp.asarray(v))
    js, _ = jr.run_remd(jax.jit(jr.make_remd_step(well(jnp), **kw)), js, 200)
    s = REMDState.create(well(torch), t(x), t(BETAS),
                         torch.Generator().manual_seed(7))
    s, traj = run_remd(make_remd_step(well(torch), **kw), s, 200,
                       collect_every=50)
    assert traj.shape == (4,) + x.shape
    rate, jrate = float(s.swap_acceptance_rate), float(
        js.swap_acceptance_rate)
    assert 0.05 < rate < 0.99 and abs(rate - jrate) < 0.05, (rate, jrate)


def test_hrex_ladder_acceptance_matches_jax():
    """200 steps of 4 lambda rungs x 64 chains on independent streams:
    the swap acceptance rates within 0.05; run_hrex collects every 40th
    step."""
    x = np.random.default_rng(3).normal(size=(4, 64, 2)).astype(np.float32)
    kw = dict(scale=0.5, exchange_every=1)
    js = jh.HREXState.create(jnp.asarray(x), hrex_log_prob(jnp),
                             jnp.asarray(LAMBDAS), jax.random.PRNGKey(9))
    js, _ = jh.run_hrex(jax.jit(jh.make_hrex_step(hrex_log_prob(jnp), **kw)),
                        js, 200)
    s = HREXState.create(t(x), hrex_log_prob(torch), t(LAMBDAS),
                         torch.Generator().manual_seed(9))
    s, samples = run_hrex(make_hrex_step(hrex_log_prob(torch), **kw), s, 200,
                          collect_every=40)
    assert samples.shape == (5,) + x.shape
    rate, jrate = float(s.swap_acceptance_rate), float(
        js.swap_acceptance_rate)
    assert 0.05 < rate < 0.99 and abs(rate - jrate) < 0.05, (rate, jrate)
