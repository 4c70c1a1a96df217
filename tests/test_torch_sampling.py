"""The port's replica exchange, simulated tempering and free-energy
estimators against the JAX package, on the CPU.

The random streams differ (threefry against Philox), so the exchange and
tempering steps are fed JAX's own draws, split from the state's key as
the JAX steps split it, and compared with the JAX steps' results; the
estimators take the same numpy work values in both packages; AIS and
the tempering weights are held to closed forms.  Float32 throughout,
tolerances stated with each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu.flows import RQSSplineRealNVP as JRealNVP
from vaemolsim_tpu.mcmc import STState as JST
from vaemolsim_tpu.mcmc import free_energy as jfe
from vaemolsim_tpu.mcmc import make_st_step as jmake_st
from vaemolsim_tpu.mcmc.engine import log_uniform as jlog_uniform
from vaemolsim_tpu.ops import distributions as jd
from vaemolsim_tpu.parallel import replica as jrep
from vaemolsim_tpu_torch.config import flagship_experiment_config
from vaemolsim_tpu_torch.convert import from_jax
from vaemolsim_tpu_torch.mcmc import free_energy as tfe
from vaemolsim_tpu_torch.mcmc import tempering as tst
from vaemolsim_tpu_torch.mcmc import vae_proposal_fns
from vaemolsim_tpu_torch.parallel import replica as trep

torch.set_num_threads(1)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def close(got, want, rtol=1e-4, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


# --- replica exchange --------------------------------------------------


@pytest.mark.parametrize("R", [1, 2, 3, 4, 5, 6])
def test_swap_partner_perm_matches_jax(R):
    for odd in (False, True):
        want = np.asarray(jrep._swap_partner_perm(R, jnp.asarray(odd)))
        assert trep._swap_partner_perm(R, odd).tolist() == want.tolist()


def _rejecting_vae_fns():
    """JAX proposal factories whose proposals land at 1e3 (always
    rejected on a Gaussian target), so a JAX REMC step is its exchange
    phase alone."""
    def enc(x):
        return jd.Independent(jd.Normal(jnp.zeros(x.shape[:-1] + (1,)),
                                        jnp.ones(x.shape[:-1] + (1,))), 1)

    def pri(z):
        return jd.Independent(jd.Normal(jnp.zeros(1), jnp.ones(1)), 1)

    def dec(z):
        loc = 1e3 + jnp.zeros(z.shape[:-1] + (2,))
        return jd.Independent(jd.Normal(loc, jnp.ones_like(loc)), 1)

    return enc, pri, dec


def _gauss(x):
    return -0.5 * (x ** 2).sum(-1)


@pytest.mark.parametrize("R", [2, 4, 5])
def test_remc_exchange_matches_jax_on_its_uniforms(R):
    """Two JAX REMC steps (even then odd pairing) whose MC phase rejects
    everything, against the port's exchange on the uniforms JAX drew:
    configurations, energies and swap counts equal."""
    C = 64
    rng = np.random.default_rng(R)
    x = (rng.normal(size=(R, C, 2)) * 1.5).astype(np.float32)
    betas = np.asarray(jrep.temperature_ladder(R))
    np.testing.assert_allclose(
        trep.temperature_ladder(R, device="cpu").numpy(), betas, rtol=1e-6)
    key = jax.random.PRNGKey(R)
    js = jrep.REMCState.create(jnp.asarray(x), _gauss, jnp.asarray(betas),
                               key)
    jstep = jrep.make_remc_step(*_rejecting_vae_fns(), _gauss)
    ts = trep.REMCState.create(t(x), _gauss, t(betas), torch.Generator())
    for phase in (False, True):
        key1, _ = jax.random.split(js.key)
        _, k_u = jax.random.split(key1)
        u = jax.random.uniform(k_u, (R, C), minval=1e-38)
        js = jstep(js)
        assert int(js.num_acc.to_float()) == 0
        ts = trep.remc_exchange_core(ts, t(u), phase)
        np.testing.assert_array_equal(ts.configs.numpy(),
                                      np.asarray(js.configs))
        np.testing.assert_array_equal(ts.energies.numpy(),
                                      np.asarray(js.energies))
        assert int(ts.num_swap_trials) == int(js.num_swap_trials.to_float())
        assert int(ts.num_swap_acc) == int(js.num_swap_acc.to_float())
    assert int(ts.num_swap_acc) > 0


def test_remc_on_the_flagship_counts_exactly():
    """The flagship VAE proposes for (R, C, 2) configurations at once;
    trials are R C a step, swap attempts pairs x C an exchange, and a
    mesh raises."""
    vae = flagship_experiment_config().build("cpu")
    g = torch.Generator().manual_seed(0)
    R, C, steps = 4, 40, 6
    st = trep.REMCState.create(torch.randn(R, C, 2, generator=g), _gauss,
                               trep.temperature_ladder(R, device="cpu"), g)
    step = trep.make_remc_step(*vae_proposal_fns(vae), _gauss)
    st = trep.run_remc(step, st, steps)
    assert int(st.num_trials) == R * C * steps
    # even pairing 2 pairs, odd pairing 1, alternating
    assert int(st.num_swap_trials) == (2 + 1) * (steps // 2) * C
    assert 0.0 < float(st.acceptance_rate) < 1.0
    assert 0.0 < float(st.swap_acceptance_rate) < 1.0
    assert bool(torch.isfinite(st.configs).all())
    assert st.step_index == steps
    with pytest.raises(NotImplementedError):
        trep.make_remc_step(*vae_proposal_fns(vae), _gauss, mesh="chains")


# --- simulated tempering ----------------------------------------------


def _double_well(x):
    q = x[..., 0]
    return -4.0 * (q * q - 1.0) ** 2


@pytest.mark.parametrize("kind", ["random_walk", "mala"])
def test_st_step_matches_jax_on_its_draws(kind):
    """Five adapting tempering steps, each fed the draws the JAX step
    splits from its key: configurations and energies within 1e-5, rung
    indices, counters and visit counts equal, weights within 1e-6."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(96, 1)).astype(np.float32)
    betas = np.asarray(jrep.temperature_ladder(4, beta_min=0.25))
    js = JST.create(jnp.asarray(x), _double_well, jnp.asarray(betas),
                    jax.random.PRNGKey(5))
    ts = tst.STState.create(t(x), _double_well, t(betas),
                            torch.Generator())
    jstep = jmake_st(_double_well, kind=kind, scale=0.4)
    for _ in range(5):
        _, k_move, k_dir, k_u = jax.random.split(js.key, 4)
        k1, k2 = jax.random.split(k_move)
        shape = js.energies.shape
        draws = (jax.random.normal(k1, js.x.shape, jnp.float32),
                 jlog_uniform(k2, shape, jnp.float32),
                 jax.random.uniform(k_dir, shape),
                 jlog_uniform(k_u, shape, jnp.float32))
        js = jstep(js)
        ts = tst.st_step_core(ts, _double_well, *(t(d) for d in draws),
                              kind=kind, scale=0.4)
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(ts.energies.numpy(),
                                   np.asarray(js.energies), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_array_equal(ts.temp_idx.numpy(),
                                      np.asarray(js.temp_idx))
        np.testing.assert_allclose(ts.log_weights.numpy(),
                                   np.asarray(js.log_weights), atol=1e-6)
        np.testing.assert_array_equal(ts.occupancy.numpy(),
                                      np.asarray(js.occupancy))
        for name in ("num_trials", "num_acc", "num_temp_trials",
                     "num_temp_acc"):
            assert int(getattr(ts, name)) == int(
                getattr(js, name).to_float())


def test_st_weights_recover_gaussian_free_energies():
    """Wang-Landau weights on a 2-D Gaussian ladder converge to the exact
    ``F_k - F_0 = 0.5 d ln(beta_k / beta_0)`` within 0.1; every rung is
    visited; frozen weights stay frozen."""
    d = 2
    g = torch.Generator().manual_seed(7)
    betas = trep.temperature_ladder(4, beta_min=0.25, device="cpu")
    st = tst.STState.create(torch.randn(400, d, generator=g), _gauss, betas,
                            g)
    st, (xs, ks) = tst.run_st(tst.make_st_step(_gauss, scale=0.8,
                                               wl_tau=100.0), st, 1500,
                              collect_every=50)
    exact = 0.5 * d * torch.log(betas / betas[0])
    assert float((st.free_energies - exact).abs().max()) < 0.1
    assert set(ks.unique().tolist()) == {0, 1, 2, 3}
    assert xs.shape == (30, 400, d)
    frozen = tst.make_st_step(_gauss, adapt=False)
    st2, none = tst.run_st(frozen, st, 20)
    assert none is None
    assert torch.equal(st2.log_weights, st.log_weights)
    assert int(st2.num_trials) == 400 * 1520


# --- free-energy estimators ---------------------------------------------


def _works(seed=0, n_f=3000, n_r=2500):
    rng = np.random.default_rng(seed)
    w_f = rng.normal(1.2, 1.1, n_f).astype(np.float32)
    w_r = rng.normal(-0.6, 0.9, n_r).astype(np.float32)
    return w_f, w_r


def test_exp_and_bar_match_jax():
    """EXP and BAR (value and error) on numpy works: rtol 1e-4."""
    w_f, w_r = _works()
    for w in (w_f, w_r, 40.0 + w_f):
        for got, want in zip(tfe.exp_free_energy(w),
                             jfe.exp_free_energy(jnp.asarray(w))):
            close(got, want)
    for got, want in zip(tfe.bar_free_energy(w_f, w_r),
                         jfe.bar_free_energy(jnp.asarray(w_f),
                                             jnp.asarray(w_r))):
        close(got, want)


def _ladder(seed=0, n=(2000, 1500, 1800, 0)):
    """A Gaussian ladder with an unsampled last state: (K, N) log
    densities and counts, as numpy."""
    mus, sigs = [0.0, 0.5, 1.0, 1.3], [1.0, 0.8, 0.6, 0.55]
    rng = np.random.default_rng(seed)
    xs = np.concatenate([m + s * rng.normal(size=k)
                         for m, s, k in zip(mus, sigs, n)]).astype(np.float32)
    L = np.stack([-0.5 * (xs - m) ** 2 / s ** 2
                  for m, s in zip(mus, sigs)]).astype(np.float32)
    return xs, L, np.asarray(n)


def test_mbar_and_its_reweighting_match_jax():
    """MBAR's free energies, errors, covariance and denominators; the
    perturbed free energy of a new state; expectations by index and by a
    log density: rtol 1e-4 (1e-5 absolute for values near 0)."""
    xs, L, counts = _ladder()
    tr = tfe.mbar_free_energy(L, counts)
    jr = jfe.mbar_free_energy(jnp.asarray(L), counts)
    for name in ("free_energies", "stderrs", "theta", "log_denominator",
                 "counts"):
        close(getattr(tr, name), getattr(jr, name), atol=1e-5)
    lnew = (-0.5 * (xs - 0.8) ** 2 / 0.7 ** 2).astype(np.float32)
    for got, want in zip(tfe.mbar_perturbed_free_energy(tr, lnew),
                         jfe.mbar_perturbed_free_energy(jr,
                                                        jnp.asarray(lnew))):
        close(got, want, atol=1e-5)
    for state in (0, 2, np.int64(1), lnew):
        jstate = jnp.asarray(state) if isinstance(state, np.ndarray) \
            else state
        for got, want in zip(tfe.mbar_expectation(tr, xs ** 2, state),
                             jfe.mbar_expectation(jr, jnp.asarray(xs ** 2),
                                                  jstate)):
            close(got, want, atol=1e-5)
    with pytest.raises(ValueError):
        tfe.mbar_free_energy(L, counts[:3])
    with pytest.raises(ValueError):
        tfe.mbar_expectation(tr, xs, lnew[:5])


def test_mbar_from_samples_matches_jax_and_reduces_to_bar():
    rng = np.random.default_rng(2)
    samples = [rng.normal(0.0, 1.0, (1500, 1)).astype(np.float32),
               rng.normal(0.7, 0.8, (1300, 1)).astype(np.float32)]

    # Both log densities take torch, JAX and numpy arrays alike.
    fns = [lambda x: -0.5 * (x ** 2).sum(-1),
           lambda x: -0.5 * ((x - 0.7) ** 2).sum(-1) / 0.64]
    tr = tfe.mbar_from_samples(fns, [t(s) for s in samples])
    jr = jfe.mbar_from_samples(fns, [jnp.asarray(s) for s in samples])
    close(tr.free_energies, jr.free_energies, atol=1e-5)
    close(tr.stderrs, jr.stderrs, atol=1e-5)
    f0, f1 = fns
    w_f = f0(samples[0]) - f1(samples[0])
    w_r = f1(samples[1]) - f0(samples[1])
    bar, _ = tfe.bar_free_energy(w_f, w_r)
    close(tr.free_energies[1], bar, rtol=1e-4, atol=1e-4)


def test_ti_matches_jax():
    rng = np.random.default_rng(4)
    dudl = rng.normal(size=(5, 300)).astype(np.float32) + \
        np.linspace(-1, 2, 5, dtype=np.float32)[:, None]
    nodes, weights = tfe.gauss_legendre_lambdas(5)
    jn, jw = jfe.gauss_legendre_lambdas(5)
    np.testing.assert_array_equal(nodes, jn)
    np.testing.assert_array_equal(weights, jw)
    for kw in ({"weights": weights},
               {"lambdas": np.linspace(0, 1, 5),
                "statistical_inefficiency": 2.5},
               {"weights": weights,
                "statistical_inefficiency": np.arange(1.0, 6.0)}):
        got = tfe.ti_free_energy(dudl, **kw)
        want = jfe.ti_free_energy(jnp.asarray(dudl), **kw)
        for g_, w_ in zip(got, want):
            close(g_, w_)
    with pytest.raises(ValueError):
        tfe.ti_free_energy(dudl)


def _shift_scale_map():
    """An affine map x -> 0.8 x + 0.3 with its log-det, per row (for
    torch and JAX arrays alike)."""
    def fwd(x):
        return 0.8 * x + 0.3, (0.0 * x[..., 0] + 2.0 * np.log(0.8))

    def inv(y):
        return (y - 0.3) / 0.8, (0.0 * y[..., 0] - 2.0 * np.log(0.8))

    return fwd, inv


def test_targeted_estimators_match_jax():
    """Targeted work, EXP and BAR through an affine map given as
    callables: rtol 1e-4."""
    rng = np.random.default_rng(5)
    xa = rng.normal(size=(2000, 2)).astype(np.float32)
    xb = (0.8 * rng.normal(size=(1800, 2)) + 0.3).astype(np.float32)

    def lp_a(x):
        return -0.5 * (x ** 2).sum(-1)

    def lp_b(x):
        return -0.5 * ((x - 0.3) ** 2).sum(-1) / 0.7

    fwd, inv = _shift_scale_map()
    tw = tfe.targeted_work_values(lp_a, lp_b, t(xa), map_and_log_det=fwd)
    jw = jfe.targeted_work_values(lp_a, lp_b, jnp.asarray(xa),
                                  map_and_log_det=fwd)
    close(tw, jw, atol=1e-5)
    for got, want in zip(tfe.exp_free_energy(tw), jfe.exp_free_energy(jw)):
        close(got, want)
    got = tfe.targeted_bar(lp_a, lp_b, t(xa), t(xb), map_and_log_det=fwd,
                           inverse_map_and_log_det=inv)
    want = jfe.targeted_bar(lp_a, lp_b, jnp.asarray(xa), jnp.asarray(xb),
                            map_and_log_det=fwd, inverse_map_and_log_det=inv)
    for g_, w_ in zip(got, want):
        close(g_, w_)
    with pytest.raises(ValueError):
        tfe.targeted_work_values(lp_a, lp_b, t(xa))
    with pytest.raises(ValueError):
        tfe.targeted_bar(lp_a, lp_b, t(xa), t(xb), map_and_log_det=fwd)


def _banana(x):
    x1, x2 = x[..., 0], x[..., 1]
    return -(x1 ** 2 / (2 * 0.64) + (x2 - 0.5 * x1 ** 2 - 1.0) ** 2
             / (2 * 0.35 ** 2))


def test_tfep_loss_and_its_gradient_through_realnvp_match_jax():
    """tfep_loss through a converted 2-D RQSSplineRealNVP's
    ``as_bijector()`` (example 40's map at small width), its value and
    every parameter's gradient: 1e-5 absolute and relative; targeted BAR
    through the same bijector at rtol 1e-4."""
    jflow = JRealNVP.create(jax.random.PRNGKey(2), 2, num_blocks=4,
                            rqs_params={"num_bins": 8, "hidden_dim": 16,
                                        "bin_range": [-8.0, 8.0]})
    flow = from_jax(jflow, "cpu")
    rng = np.random.default_rng(6)
    xa = rng.normal(size=(256, 2)).astype(np.float32)

    def lp_a(x):
        return -0.5 * (x ** 2).sum(-1)

    def jloss(fl):
        return jfe.tfep_loss(lp_a, _banana, jnp.asarray(xa),
                             bijector=fl.as_bijector())

    jl, jg = jax.value_and_grad(jloss)(jflow)
    tl = tfe.tfep_loss(lp_a, _banana, t(xa), bijector=flow.as_bijector())
    close(tl.detach(), jl, rtol=1e-5, atol=1e-5)
    params, want = [], []
    for b, jb in zip(flow.blocks, jg.blocks):
        for name in ("trunk", "w_head", "h_head", "s_head"):
            for leaf in ("kernel", "bias"):
                params.append(getattr(getattr(b.conditioner, name), leaf))
                want.append(getattr(getattr(jb.conditioner, name), leaf))
    for g_, w_ in zip(torch.autograd.grad(tl, params), want):
        torch.testing.assert_close(g_, t(w_), atol=1e-5, rtol=1e-5)
    xb = np.stack([0.8 * xa[:, 0], 0.5 * (0.8 * xa[:, 0]) ** 2 + 1.0
                   + 0.35 * xa[:, 1]], -1).astype(np.float32)
    with torch.no_grad():
        got = tfe.targeted_bar(lp_a, _banana, t(xa), t(xb),
                               bijector=flow.as_bijector())
    want = jfe.targeted_bar(lp_a, _banana, jnp.asarray(xa), jnp.asarray(xb),
                            bijector=jflow.as_bijector())
    for g_, w_ in zip(got, want):
        close(g_, w_)


def test_ais_recovers_a_gaussian_log_z():
    """AIS from N(0, 1) (normalized) to p~ = exp(-(x - 1)^2 / 0.5):
    ln Z = ln(0.5 sqrt(2 pi)), within 5 standard errors of the weights'
    delta-method error; also with SMC resampling and HMC transitions."""
    want = float(np.log(0.5 * np.sqrt(2 * np.pi)))

    def init(x):
        return -0.5 * (x ** 2).sum(-1) - 0.5 * np.log(2 * np.pi)

    def target(x):
        return -((x - 1.0) ** 2).sum(-1) / 0.5

    g = torch.Generator().manual_seed(3)
    for kw in ({"scale": 0.4}, {"scale": 0.4, "resample_threshold": 0.5},
               {"kind": "hmc", "n_leapfrog": 3, "scale": 0.2}):
        x0 = torch.randn(2000, 1, generator=g)
        res = tfe.ais(init, target, x0, g, n_stages=32, **kw)
        w = torch.exp(res.log_weights.double() - res.log_weights.max())
        se = float(torch.sqrt(w.var() / w.numel()) / w.mean())
        assert abs(float(res.log_z) - want) < 5 * se + 1e-3, (kw, se)
        assert 1.0 <= float(res.ess) <= 2000.0
        assert 0.0 < float(res.acceptance) < 1.0
        assert res.samples.shape == (2000, 1)


def test_systematic_resample_matches_jax_on_its_uniform(monkeypatch):
    """Ancestor indices from JAX's one uniform draw: equal."""
    rng = np.random.default_rng(8)
    logw = rng.normal(size=50).astype(np.float32) * 2.0
    lognorm = logw - np.log(np.exp(logw.astype(np.float64)).sum())
    key = jax.random.PRNGKey(4)
    want = np.asarray(jfe._systematic_resample(jnp.asarray(lognorm), key))
    u0 = jax.random.uniform(key, (), dtype=jnp.float32)
    monkeypatch.setattr(torch, "rand", lambda *a, **k: t(u0))
    got = tfe._systematic_resample(t(lognorm), torch.Generator())
    np.testing.assert_array_equal(got.numpy(), want)
