"""The port's local moves, step-size tuner, move compositions, chain
diagnostics and the molecular restraint / adapter / minimizer against the
JAX package, on the CPU.

The random streams differ (threefry against Philox), so the trial core
is fed JAX's own draws: ``xi`` and ``log_u`` split from the key exactly
as ``vaemolsim_tpu.mcmc.moves._scaled_trial`` splits it.  Samplers are
otherwise held to their statistics.  Inputs are made from a seed with
numpy; float32 throughout, tolerances stated with each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import potentials as jpot
from vaemolsim_tpu.mcmc import diagnostics as jdiag
from vaemolsim_tpu.mcmc.engine import log_uniform as jlog_uniform
from vaemolsim_tpu.mcmc.moves import _scaled_trial as jtrial
from vaemolsim_tpu_torch import potentials as tpot
from vaemolsim_tpu_torch.mcmc import (MCMCState, cycle_moves, diagnostics,
                                      make_hmc_step, make_mala_step,
                                      make_random_walk_step, mix_moves,
                                      run_mcmc, tune_scale)
from vaemolsim_tpu_torch.mcmc.moves import scaled_trial_core

torch.set_num_threads(1)

A = np.array([[1.0, 0.4, 0.0], [0.4, 2.0, -0.3], [0.0, -0.3, 0.7]],
             np.float32)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def flat_target(lib):
    """A correlated Gaussian with a quartic wall, (chains, 3)."""
    a = lib.asarray(A) if lib is jnp else t(A)

    def log_p(x):
        return (-0.5 * ((x @ a) * x).sum(-1) - 0.1 * (x ** 4).sum(-1))

    return log_p


def lj7_target(pot, beta=2.0):
    if pot is jpot:
        return pot.as_log_prob(pot.composite(pot.lennard_jones(),
                                             pot.com_restraint(2.0)), beta)
    return pot.as_log_prob(pot.composite(pot.lennard_jones(device="cpu"),
                                         pot.com_restraint(2.0)), beta)


def lj7_starts(n=48):
    """LJ7 clusters relaxed by the JAX minimizer (near-minimum, moderate
    forces), as numpy."""
    rng = np.random.default_rng(5)
    x0 = (0.7 * rng.normal(size=(n, 7, 3))).astype(np.float32)
    pot = jpot.composite(jpot.lennard_jones(), jpot.com_restraint(2.0))
    return np.asarray(jpot.minimize_energy(pot, jnp.asarray(x0), steps=400,
                                           lr=0.1))


CASES = [  # kind, target, scale
    ("random_walk", "flat", 0.8), ("mala", "flat", 0.3),
    ("hmc", "flat", 0.25), ("random_walk", "lj7", 0.02),
    ("mala", "lj7", 0.002), ("hmc", "lj7", 0.02),
]


@pytest.mark.parametrize("kind,target,scale", CASES)
def test_trial_core_matches_jax_on_its_draws(kind, target, scale):
    """The core on JAX's xi and log_u: proposals and energies within 1e-5
    (absolute and relative) on every row whose decision agrees, and the
    decisions equal wherever |log_acc - log_u| > 1e-4 (a closer call may
    flip on float32 roundoff of the two packages' sums)."""
    if target == "flat":
        rng = np.random.default_rng(7)
        x1 = rng.normal(size=(64, 3)).astype(np.float32)
        jlp, tlp = flat_target(jnp), flat_target(torch)
    else:
        x1 = lj7_starts()
        jlp, tlp = lj7_target(jpot), lj7_target(tpot)
    e1 = np.asarray(jlp(jnp.asarray(x1)))
    key = jax.random.PRNGKey(11)
    jx, je, jacc = jtrial(kind, jlp, jnp.asarray(x1), jnp.asarray(e1),
                          scale, key, n_leapfrog=5)
    k1, k2 = jax.random.split(key)
    xi = jax.random.normal(k1, x1.shape, jnp.float32)
    log_u = jlog_uniform(k2, e1.shape, jnp.float32)
    tx, te, tacc, log_acc = scaled_trial_core(
        kind, tlp, t(x1), t(e1), scale, t(xi), t(log_u), n_leapfrog=5)
    jacc = torch.tensor(np.asarray(jacc))
    decisive = (log_acc - t(log_u)).abs() > 1e-4
    assert bool((tacc[decisive] == jacc[decisive]).all())
    same = tacc == jacc
    assert 0 < int(tacc.sum()) < tacc.numel()
    assert float(same.float().mean()) > 0.9
    torch.testing.assert_close(tx[same], t(jx)[same], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(te[same], t(je)[same], atol=1e-5, rtol=1e-5)


def test_mala_runs_under_run_mcmc_no_grad():
    """run_mcmc is under torch.no_grad(); MALA takes its gradients under
    enable_grad on a detached leaf and leaves no graph on the state."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2000, 4, generator=g)

    def log_p(y):
        return -0.5 * (y ** 2).sum(-1)

    st = MCMCState.create(x, log_p(x), g)
    st, traj = run_mcmc(make_mala_step(log_p, 0.4), st, 60, collect_every=20)
    assert st.configs.grad_fn is None and not st.configs.requires_grad
    assert st.energies.grad_fn is None
    assert traj.shape == (3, 2000, 4)
    assert 0.3 < float(st.acceptance_rate) < 0.99
    # N(0, I4) is kept: E[x^2] = 1 within 6 standard errors of 8000 terms.
    assert abs(float((st.configs ** 2).mean()) - 1.0) < 6 * (2 / 8000) ** 0.5


@pytest.mark.parametrize("make", [
    lambda lp: make_random_walk_step(lp, 0.5),
    lambda lp: make_mala_step(lp, 0.2),
    lambda lp: make_hmc_step(lp, 0.2, n_leapfrog=3),
])
def test_counters_are_exact(make):
    """num_trials counts every chain's trial, num_acc the accepted ones,
    as exact int64, also through a cycle of moves."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(300, 2, generator=g)

    def log_p(y):
        return -0.5 * (y ** 2).sum(-1)

    st = MCMCState.create(x, log_p(x), g)
    step = make(log_p)
    accepted = 0
    for _ in range(7):
        before = st.configs
        st = step(st)
        accepted += int((st.configs != before).any(-1).sum())
    assert st.num_trials.dtype == torch.int64
    assert int(st.num_trials) == 7 * 300
    assert int(st.num_acc) == accepted
    st, _ = run_mcmc(cycle_moves([step, step, step]), st, 4)
    assert int(st.num_trials) == 7 * 300 + 3 * 4 * 300


def test_cycle_and_mix_schedules():
    """cycle_moves applies every move in order each step; mix_moves picks
    one move a step with the given probabilities (frequencies within 5
    sigma over 3000 steps; a zero-probability move never runs)."""
    g = torch.Generator().manual_seed(2)
    st = MCMCState.create(torch.zeros(4, 2), torch.zeros(4), g)
    calls = []

    def tag(i):
        def step(s):
            calls.append(i)
            return s
        return step

    run_mcmc(cycle_moves([tag(0), tag(1), tag(2)]), st, 5)
    assert calls == [0, 1, 2] * 5
    calls.clear()
    n = 3000
    run_mcmc(mix_moves([tag(0), tag(1), tag(2)], [0.7, 0.3, 0.0]), st, n)
    freq = np.bincount(calls, minlength=3) / n
    assert freq[2] == 0.0
    assert abs(freq[0] - 0.7) < 5 * (0.7 * 0.3 / n) ** 0.5
    with pytest.raises(ValueError):
        mix_moves([tag(0)], [0.5, 0.5])


@pytest.mark.parametrize("kind,target", [("random_walk", 0.234),
                                         ("mala", 0.574), ("hmc", 0.651)])
def test_tune_scale_reaches_its_target(kind, target):
    """On N(0, I4) with 400 chains the tuned move accepts within 0.05 of
    its optimum; warm-up trials are not counted."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(400, 4, generator=g)

    def log_p(y):
        return -0.5 * (y ** 2).sum(-1)

    st = MCMCState.create(x, log_p(x), g)
    scale, st = tune_scale(log_p, st, kind=kind, n_leapfrog=3)
    assert int(st.num_trials) == 0 and int(st.num_acc) == 0
    step = {"random_walk": make_random_walk_step(log_p, scale),
            "mala": make_mala_step(log_p, scale),
            "hmc": make_hmc_step(log_p, scale, n_leapfrog=3)}[kind]
    st, _ = run_mcmc(step, st, 40)
    assert abs(float(st.acceptance_rate) - target) < 0.05
    with pytest.raises(ValueError):
        tune_scale(log_p, st, kind="gibbs")


def ar1_chains(T=512, C=8, rho=0.8, seed=9):
    rng = np.random.default_rng(seed)
    x = np.zeros((T, C), np.float32)
    noise = rng.normal(size=(T, C)).astype(np.float32)
    for i in range(1, T):
        x[i] = rho * x[i - 1] + noise[i]
    return x + rng.normal(size=C).astype(np.float32) * 0.05


@pytest.mark.parametrize("name,kw", [
    ("autocorrelation", {"max_lag": 50}),
    ("effective_sample_size", {}),
    ("potential_scale_reduction", {}),
    ("block_averaging_error", {}),
    ("statistical_inefficiency", {}),
])
def test_diagnostics_match_jax(name, kw):
    """The five diagnostics on (T, chains) AR(1) chains, odd T and a
    3-D (T, chains, dofs) trajectory: rtol 1e-5 (FFTs and reductions in
    another order; 1e-6 absolute for values near 0)."""
    for x in (ar1_chains(), ar1_chains(T=301)[:, :5],
              np.stack([ar1_chains(seed=1), ar1_chains(seed=2)], -1)):
        want = np.asarray(getattr(jdiag, name)(jnp.asarray(x), **kw))
        got = getattr(diagnostics, name)(x, **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_diagnostics_degenerate_chains_match_jax():
    """Stuck chains: ESS NaN; R-hat NaN for identical constants and +inf
    for distinct ones, as in JAX."""
    same = np.ones((40, 4), np.float32)
    distinct = np.tile(np.arange(4, dtype=np.float32), (40, 1))
    for x in (same, distinct):
        for name in ("effective_sample_size", "potential_scale_reduction"):
            want = np.asarray(getattr(jdiag, name)(jnp.asarray(x)))
            got = getattr(diagnostics, name)(torch.tensor(x)).numpy()
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            np.testing.assert_array_equal(got[~np.isnan(got)],
                                          want[~np.isnan(want)])


def test_restraint_and_log_prob_adapter_match_jax():
    """com_restraint and as_log_prob on a batch of LJ7 clusters: 1e-6
    relative (the same float32 operations)."""
    rng = np.random.default_rng(6)
    x = (1.2 * rng.normal(size=(5, 7, 3)) + 0.3).astype(np.float32)
    for center in (0.0, [0.5, -0.2, 0.1]):
        j = jpot.com_restraint(3.0, center)(jnp.asarray(x))
        g = tpot.com_restraint(3.0, center)(t(x))
        torch.testing.assert_close(g, t(j), atol=1e-6, rtol=1e-6)
    j = lj7_target(jpot, beta=1.7)(jnp.asarray(x))
    g = lj7_target(tpot, beta=1.7)(t(x))
    torch.testing.assert_close(g, t(j), atol=1e-5, rtol=1e-6)


def test_minimize_energy_matches_jax():
    """Two-phase clipped Adam on 16 LJ7 clusters from overlapping 0.7
    N(0, 1) starts at bench_molecular_hmc's 1000 steps and lr 0.1: final
    energies within 1e-3 of JAX's.  The coordinates agree to 1e-6 over
    the first steps; later float32 roundoff through the r^-12 walls moves
    the two trajectories apart (a cluster may end rotated), but both
    settle in the same minima.  polish_lbfgs raises."""
    rng = np.random.default_rng(8)
    x0 = (0.7 * rng.normal(size=(16, 7, 3))).astype(np.float32)
    jp = jpot.composite(jpot.lennard_jones(), jpot.com_restraint(2.0))
    tp = tpot.composite(tpot.lennard_jones(device="cpu"),
                        tpot.com_restraint(2.0))
    jx = jpot.minimize_energy(jp, jnp.asarray(x0), steps=1000, lr=0.1)
    tx = tpot.minimize_energy(tp, t(x0), steps=1000, lr=0.1)
    first = jpot.minimize_energy(jp, jnp.asarray(x0), steps=2, lr=0.1)
    torch.testing.assert_close(tpot.minimize_energy(tp, t(x0), steps=2,
                                                    lr=0.1),
                               t(first), atol=1e-5, rtol=1e-5)
    assert tx.grad_fn is None
    torch.testing.assert_close(tp(tx), t(jp(jx)), atol=1e-3, rtol=0.0)
    assert float(tp(tx).max()) < float(tp(t(x0)).min())
    with pytest.raises(NotImplementedError):
        tpot.minimize_energy(tp, t(x0), polish_lbfgs=5)
