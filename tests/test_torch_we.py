"""The port's weighted ensemble against the JAX package's on the CPU, on
numpy-seeded walkers: with JAX's resampling offsets handed in (drawn from
its key as the JAX step draws them), the systematic resampling selects
the same walkers and gives the same weights as the compiled JAX function,
exactly, and every bin's
weight is conserved to 1e-6; a recycling step moves the same flux (rtol
1e-6); and ``run_we`` over several iterations of a deterministic
propagator matches JAX's ``run_we`` (walkers and weights exactly, flux to
rtol 1e-6), snapshots included.  The port's own draws, through ``md``'s
shared BAOAB runner, keep the total weight at 1.  float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import we as jwe
from vaemolsim_tpu_torch import we
from vaemolsim_tpu_torch.convert import from_jax
from vaemolsim_tpu_torch.md import _BAOAB

N_BINS, M = 10, 6
EDGES = np.linspace(-1.2, 1.0, N_BINS - 1).astype(np.float32)


def t(a):
    return torch.as_tensor(np.array(a))


def jax_u0(key):
    """The offsets the JAX step draws from ``key``'s resampling split."""
    return jax.random.uniform(key, (N_BINS, 1), minval=1e-6)


def jbin(walk):
    return jnp.searchsorted(jnp.asarray(EDGES), walk[0][..., 0, 0])


def tbin(walk):
    return torch.searchsorted(t(EDGES), walk[0][..., 0, 0].contiguous())


# A deterministic drift whose products are exact in float32 (powers of
# two), so that XLA's fused multiply-adds round as torch's separate ops.
def jprop(walk, key):
    x, v = walk
    return (x + 0.125 * v + 0.25, 0.5 * v - 0.125 * x)


def tprop(walk, generator):
    x, v = walk
    return (x + 0.125 * v + 0.25, 0.5 * v - 0.125 * x)


def recycle(walk):
    return (jnp.full_like(walk[0], -1.0), jnp.zeros_like(walk[1]))


def trecycle(walk):
    return (torch.full_like(walk[0], -1.0), torch.zeros_like(walk[1]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resampling_matches_jax_exactly(seed):
    """Weights spread over six decades and two empty bins: the selected
    walkers and the weights equal JAX's bit for bit."""
    rng = np.random.default_rng(seed)
    S = N_BINS * M
    x = rng.normal(size=(S, 1, 1)).astype(np.float32)
    v = rng.normal(size=(S, 1, 1)).astype(np.float32)
    w = (rng.random(S) ** 6).astype(np.float32)
    w /= w.sum()
    bins = rng.integers(0, N_BINS - 2, S).astype(np.int32)
    key = jax.random.PRNGKey(seed)
    # Compiled, as the JAX package's run_we runs it (XLA turns the
    # division by m_per_bin into a product with its reciprocal).
    (jx, jv), jw = jax.jit(jwe._systematic_resample, static_argnums=(3, 4))(
        (jnp.asarray(x), jnp.asarray(v)), jnp.asarray(w), jnp.asarray(bins),
        N_BINS, M, key)
    (gx, gv), gw = we._systematic_resample(
        (t(x), t(v)), t(w), t(bins), N_BINS, M, t(jax_u0(key)))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(gw.numpy(), np.asarray(jw))
    for b in range(N_BINS):
        np.testing.assert_allclose(gw.numpy()[b * M:(b + 1) * M].sum(),
                                   w[bins == b].sum(), atol=1e-6)


def test_xla_cumsum_order():
    """The prefix sum adds in XLA's order on the CPU (blocks of 16, then
    the block totals) at the slot counts WE runs."""
    rng = np.random.default_rng(7)
    for n in (7, 16, 60, 160, 240, 300):
        a = (rng.random((4, n)) * rng.random((4, n)) ** 8).astype(np.float32)
        np.testing.assert_array_equal(
            we._xla_cumsum(t(a)).numpy(),
            np.asarray(jnp.cumsum(jnp.asarray(a), axis=1)))


def test_init_and_recycling_steps_match_jax():
    rng = np.random.default_rng(3)
    x0 = (-1.0 + 0.1 * rng.normal(size=(4, 1, 1))).astype(np.float32)
    v0 = rng.normal(size=(4, 1, 1)).astype(np.float32)
    jstate = jwe.we_init((jnp.asarray(x0), jnp.asarray(v0)), N_BINS, M,
                         jax.random.PRNGKey(0))
    state = we.we_init((t(x0), t(v0)), N_BINS, M)
    conv = from_jax(jstate, "cpu")
    assert isinstance(conv, we.WEState) and conv.n_iters.dtype == torch.int32
    for a, b in zip(we._leaves(state), we._leaves(conv)):
        assert torch.equal(a, b)
    kw = dict(n_bins=N_BINS, m_per_bin=M, target_bin=N_BINS - 1)
    jstep = jax.jit(jwe.make_we_step(jprop, jbin, recycle_fn=recycle, **kw))
    step = we.make_we_step(tprop, tbin, recycle_fn=trecycle, **kw)
    for _ in range(12):
        _, _, k_res = jax.random.split(jstate.key, 3)
        jstate = jstep(jstate)
        state = step.move(state, t(jax_u0(k_res)))
        np.testing.assert_array_equal(state.x[0].numpy(),
                                      np.asarray(jstate.x[0]))
        np.testing.assert_array_equal(state.w.numpy(), np.asarray(jstate.w))
        np.testing.assert_allclose(float(state.flux), float(jstate.flux),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(state.w.sum()), 1.0, atol=1e-6)
    assert float(state.flux) > 0.0
    np.testing.assert_allclose(float(state.rate), float(jstate.rate),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="recycle_fn"):
        we.make_we_step(tprop, tbin, n_bins=N_BINS, m_per_bin=M,
                        target_bin=3)
    with pytest.raises(ValueError, match="slots"):
        we.we_init(torch.zeros(N_BINS * M + 1, 1, 1), N_BINS, M)


def test_run_we_matches_jax_run_we():
    """Ten iterations with JAX's offsets read by the iteration count,
    snapshots every fifth."""
    rng = np.random.default_rng(4)
    x0 = (-1.0 + 0.1 * rng.normal(size=(6, 1, 1))).astype(np.float32)
    v0 = rng.normal(size=(6, 1, 1)).astype(np.float32)
    # Integer seed weights: their sum, and so the normalized weights, are
    # exact whatever order the two packages add in.
    w0 = rng.integers(1, 9, 6).astype(np.float32)
    jstate = jwe.we_init((jnp.asarray(x0), jnp.asarray(v0)), N_BINS, M,
                         jax.random.PRNGKey(9), weights=jnp.asarray(w0))
    state = we.we_init((t(x0), t(v0)), N_BINS, M, weights=t(w0))
    kw = dict(n_bins=N_BINS, m_per_bin=M, target_bin=N_BINS - 1)
    jstep = jwe.make_we_step(jprop, jbin, recycle_fn=recycle, **kw)
    step = we.make_we_step(tprop, tbin, recycle_fn=trecycle, **kw)
    key, u0s = jstate.key, []
    for _ in range(10):
        key, _, k_res = jax.random.split(key, 3)
        u0s.append(np.asarray(jax_u0(k_res)))
    u0s = t(np.stack(u0s))

    def by_count(s, generator):
        return step.move(s, u0s.index_select(0, s.n_iters.long()[None])[0],
                         generator)

    jend, (jxs, jws) = jwe.run_we(jax.jit(jstep), jstate, 10,
                                  collect_every=5)
    end, (xs, ws) = we.run_we(by_count, state, torch.Generator(), 10,
                              collect_every=5)
    assert int(end.n_iters) == 10
    np.testing.assert_array_equal(end.x[0].numpy(), np.asarray(jend.x[0]))
    np.testing.assert_array_equal(end.w.numpy(), np.asarray(jend.w))
    np.testing.assert_allclose(float(end.flux), float(jend.flux), rtol=1e-6)
    np.testing.assert_array_equal(xs[0].numpy(), np.asarray(jxs[0]))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))


def test_langevin_segments_conserve_weight():
    """The port's own draws: 20-step BAOAB segments through md's shared
    runner on the double well, recycling at the last bin."""
    dyn = _BAOAB(lambda x: 2.0 * (x[..., 0, 0] ** 2 - 1.0) ** 2, dt=0.01,
                 kt=0.5, friction=1.0, masses=1.0)

    def propagate(walk, generator):
        s, _ = dyn.scan(dyn.start(*walk), 20, generator)
        return (s.x, s.v)

    gen = torch.Generator().manual_seed(0)
    state = we.we_init((-torch.ones(M, 1, 1), torch.zeros(M, 1, 1)),
                       N_BINS, M)
    step = we.make_we_step(propagate, tbin, n_bins=N_BINS, m_per_bin=M,
                           target_bin=N_BINS - 1, recycle_fn=trecycle)
    state, (xs, ws) = we.run_we(step, state, gen, 30, collect_every=10)
    assert xs[0].shape == (3, N_BINS * M, 1, 1) and ws.shape == (3, N_BINS * M)
    np.testing.assert_allclose(float(state.w.sum()), 1.0, atol=1e-5)
    assert int((state.w > 0).sum()) > M
