"""The port's Markov state models against the JAX package's on the CPU, on
numpy-seeded inputs and on ``tests/test_msm.py``'s chains (the exact
3-state chain, the two-state chain, the symmetric random walk): count
matrices equal exactly (pooled batches and ``sliding=False`` too); the
transition matrix, stationary distribution, committor, MFPT, reactive
flux and TPT rate to rtol 1e-5; implied timescales to rtol 1e-4; TICA's
eigenvalues to rtol 1e-4 and its projections up to sign; ``kmeans`` with
JAX's seeding draw handed in, centers to 1e-5.  float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import msm as jmsm
from vaemolsim_tpu_torch import msm

T_TRUE = np.array([[0.90, 0.08, 0.02],
                   [0.16, 0.80, 0.04],
                   [0.08, 0.08, 0.84]], np.float32)
TWO_STATE = np.array([[0.9, 0.1], [0.2, 0.8]], np.float32)


def random_walk(n=6):
    """The unbiased birth-death chain of tests/test_msm.py."""
    T = np.zeros((n, n), np.float32)
    for i in range(n):
        T[i, max(i - 1, 0)] += 0.5
        T[i, min(i + 1, n - 1)] += 0.5
    return T


def sample_chain(T, n_steps, n_trajs, seed):
    """Exact trajectories of a discrete chain, drawn with numpy."""
    rng = np.random.default_rng(seed)
    cum = np.cumsum(T, 1)
    s = np.zeros(n_trajs, np.int64)
    out = np.empty((n_trajs, n_steps), np.int32)
    for t in range(n_steps):
        u = rng.random(n_trajs)
        s = np.minimum((u[:, None] > cum[s]).sum(1), len(T) - 1)
        out[:, t] = s
    return out


@pytest.fixture(scope="module")
def dtraj():
    return sample_chain(T_TRUE, 6000, 8, seed=0)


def t(a):
    return torch.as_tensor(np.array(a))


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("lag,sliding", [(1, True), (3, True), (3, False)])
def test_count_matrix_equals_jax_exactly(dtraj, lag, sliding):
    C = msm.count_matrix(t(dtraj), 3, lag=lag, sliding=sliding)
    want = np.asarray(jmsm.count_matrix(jnp.asarray(dtraj), 3, lag=lag,
                                        sliding=sliding))
    assert C.dtype == torch.float32
    np.testing.assert_array_equal(C.numpy(), want)
    # One trajectory and a pooled (2, 4, T) batch.
    np.testing.assert_array_equal(
        msm.count_matrix(t(dtraj[0]), 3, lag=lag, sliding=sliding).numpy(),
        np.asarray(jmsm.count_matrix(jnp.asarray(dtraj[0]), 3, lag=lag,
                                     sliding=sliding)))
    pooled = dtraj.reshape(2, 4, -1)
    np.testing.assert_array_equal(
        msm.count_matrix(t(pooled), 3, lag=lag, sliding=sliding).numpy(),
        want)
    with pytest.raises(ValueError, match="lag"):
        msm.count_matrix(t(dtraj), 3, lag=dtraj.shape[1])


@pytest.mark.parametrize("reversible", [True, False])
def test_transition_matrix_and_spectrum_match_jax(dtraj, reversible):
    C = np.asarray(jmsm.count_matrix(jnp.asarray(dtraj), 3, lag=1))
    T = msm.transition_matrix(t(C), reversible=reversible)
    jT = jmsm.transition_matrix(jnp.asarray(C), reversible=reversible)
    close(T, jT, 1e-5, 1e-7)
    close(msm.stationary_distribution(T), jmsm.stationary_distribution(jT),
          1e-5)
    if reversible:
        close(msm.implied_timescales(T, lag=2.0),
              jmsm.implied_timescales(jT, lag=2.0), 1e-4)
        close(msm.implied_timescales(T, k=1),
              jmsm.implied_timescales(jT, k=1), 1e-4)


def test_float64_counts_stay_float64():
    C = np.array([[5.0, 2.0], [3.0, 7.0]])
    T = msm.transition_matrix(torch.as_tensor(C))
    assert T.dtype == torch.float64
    jT = np.asarray(jmsm.transition_matrix(jnp.asarray(C, jnp.float32)))
    np.testing.assert_allclose(T.numpy(), jT, rtol=1e-5)


def test_implied_timescales_clip_below_one():
    """A degenerate unit eigenvalue stays finite: the clip is float32's
    largest value below 1 (1 - 2^-24), as the JAX package's epsneg."""
    assert msm._one_ulp(torch.float32) == float(jnp.finfo(
        jnp.float32).epsneg)
    T = np.eye(3, dtype=np.float32)
    pi = np.full(3, 1.0 / 3.0, np.float32)
    got = msm.implied_timescales(t(T), pi=t(pi))
    want = jmsm.implied_timescales(jnp.asarray(T), pi=jnp.asarray(pi))
    assert torch.isfinite(got).all()
    close(got, want, 1e-6)


@pytest.mark.parametrize("chain", ["true", "two_state", "random_walk"])
def test_committor_mfpt_and_tpt_match_jax(chain):
    T = {"true": T_TRUE, "two_state": TWO_STATE,
         "random_walk": random_walk()}[chain]
    n = len(T)
    src, snk = [0], [n - 1]
    jT = jnp.asarray(T)
    close(msm.committor(t(T), src, snk),
          jmsm.committor(jT, jnp.array(src), jnp.array(snk)), 1e-5, 1e-7)
    mask_src = np.arange(n) == 0
    close(msm.committor(t(T), t(mask_src), t(~mask_src)),
          jmsm.committor(jT, jnp.asarray(mask_src), jnp.asarray(~mask_src)),
          1e-5, 1e-7)
    close(msm.mean_first_passage_time(t(T), snk, lag=5.0),
          jmsm.mean_first_passage_time(jT, jnp.array(snk), lag=5.0), 1e-5)
    f, fnet = msm.reactive_flux(t(T), src, snk)
    jf, jfnet = jmsm.reactive_flux(jT, jnp.array(src), jnp.array(snk))
    close(f, jf, 1e-5, 1e-8)
    close(fnet, jfnet, 1e-5, 1e-8)
    close(msm.tpt_rate(t(T), src, snk, lag=2.0),
          jmsm.tpt_rate(jT, jnp.array(src), jnp.array(snk), lag=2.0), 1e-5)


def test_chapman_kolmogorov_matches_jax(dtraj):
    pred, est = msm.chapman_kolmogorov(t(dtraj), 3, lag=2)
    jpred, jest = jmsm.chapman_kolmogorov(jnp.asarray(dtraj), 3, lag=2)
    close(pred, jpred, 1e-5, 1e-7)
    close(est, jest, 1e-5, 1e-7)


def ou_features(seed, n_traj=3, T=4000):
    """tests/test_msm.py's TICA input: a slow and a fast OU process,
    rotated into two features (numpy draws)."""
    rng = np.random.default_rng(seed)
    taus = np.array([20.0, 1.0])
    a = np.exp(-1.0 / taus)
    z = np.zeros((n_traj, 2))
    out = np.empty((n_traj, T, 2))
    for k in range(T):
        z = a * z + np.sqrt(1 - a * a) * rng.normal(size=(n_traj, 2))
        out[:, k] = z
    mix = np.array([[0.8, 0.6], [-0.6, 0.8]])
    return (out @ mix + np.array([1.0, -2.0])).astype(np.float32)


def test_tica_matches_jax_up_to_sign():
    x = ou_features(1)
    ts, comps, lam = msm.tica(t(x), lag=5)
    jts, jcomps, jlam = jmsm.tica(jnp.asarray(x), lag=5)
    close(lam, jlam, 1e-4)
    close(ts, jts, 1e-4)
    flat = x.reshape(-1, 2)
    proj = (t(flat) - t(flat).mean(0)) @ comps
    jproj = (flat - flat.mean(0)) @ np.asarray(jcomps)
    for k in range(2):
        sign = np.sign(np.dot(proj[:, k].numpy(), jproj[:, k]))
        np.testing.assert_allclose(sign * proj[:, k].numpy(), jproj[:, k],
                                   rtol=1e-4, atol=1e-4)
    ts1, comps1, lam1 = msm.tica(t(x[0]), lag=5, k=1)
    assert ts1.shape == (1,) and comps1.shape == (2, 1)
    close(lam1, jmsm.tica(jnp.asarray(x[0]), lag=5, k=1)[2], 1e-4)
    with pytest.raises(ValueError, match="lag"):
        msm.tica(t(x), lag=4000)


def test_kmeans_with_jax_draw_matches_jax():
    rng = np.random.default_rng(3)
    means = np.array([[-3.0, 0.0], [3.0, 0.0], [0.0, 4.0]])
    x = (means[rng.integers(0, 3, 900)]
         + 0.5 * rng.normal(size=(900, 2))).astype(np.float32)
    key = jax.random.PRNGKey(5)
    first = int(jax.random.randint(key, (), 0, 900))
    c, inertia = msm.kmeans(first, t(x), 3, n_iter=20)
    jc, jinertia = jmsm.kmeans(key, jnp.asarray(x), 3, n_iter=20)
    close(c, jc, 1e-5, 1e-5)
    close(inertia, jinertia, 1e-5)
    # The port's own draw, and the labels it feeds assign_states.
    c2, _ = msm.kmeans(torch.Generator().manual_seed(0), t(x), 3)
    lbl = msm.assign_states(t(x), c2)
    np.testing.assert_array_equal(
        lbl.numpy(), np.asarray(jmsm.assign_states(jnp.asarray(x),
                                                   jnp.asarray(c2.numpy()))))
    with pytest.raises(ValueError, match="k must be"):
        msm.kmeans(0, t(x), 901)


def test_assign_states_matches_jax_1d_and_2d():
    rng = np.random.default_rng(4)
    x1 = rng.normal(size=(5, 7)).astype(np.float32)
    c1 = np.array([-1.0, 0.0, 1.0], np.float32)
    np.testing.assert_array_equal(
        msm.assign_states(t(x1), t(c1)).numpy(),
        np.asarray(jmsm.assign_states(jnp.asarray(x1), jnp.asarray(c1))))
    x2 = rng.normal(size=(4, 6, 2)).astype(np.float32)
    c2 = rng.normal(size=(5, 2)).astype(np.float32)
    got = msm.assign_states(t(x2), t(c2))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jmsm.assign_states(jnp.asarray(x2),
                                                   jnp.asarray(c2))))
