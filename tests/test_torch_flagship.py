"""The port's flagship slice against the JAX package, on the CPU.

A flagship-family VAE (normal FCDeepNN encoder 2->1 and decoder 1->2, a
2-block RQS-spline MAF prior over a 1-D standard-normal latent) is built
by the JAX package at a small width (hidden 32, 8 bins) and carried into
the port with ``convert.from_jax``.  Both packages then see the same
numpy-made inputs and noise.  Random streams differ between the two
(threefry vs Philox), so densities are pinned at shared samples and
samplers by statistics.  Float32 throughout; each tolerance is stated
with its reason.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import config as jconfig
from vaemolsim_tpu import losses
from vaemolsim_tpu.dists import IndependentBlockwise as JBlockwise
from vaemolsim_tpu.dists import StaticFlowedDistribution as JStatic
from vaemolsim_tpu.flows import RQSSplineMAF as JMAF
from vaemolsim_tpu.mcmc import fused as jmf
from vaemolsim_tpu.models import VAE as JVAE
from vaemolsim_tpu.models import MappingToDistribution as JM2D
from vaemolsim_tpu.ops import distributions as jd
from vaemolsim_tpu_torch import _build
from vaemolsim_tpu_torch import config as tconfig
from vaemolsim_tpu_torch.convert import from_jax
from vaemolsim_tpu_torch.mcmc import (MCMC, MCMCState, make_fused_vae_step,
                                      make_mcmc_step, mh_propose, run_mcmc,
                                      vae_proposal_fns)
from vaemolsim_tpu_torch.mcmc import fused as tmf

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def jax_flagship(key, hidden=32, num_bins=8):
    keys = jax.random.split(key, 3)
    encoder = JM2D.create(keys[0], JBlockwise.create(1, "normal"),
                          input_shape=2,
                          mapping_kwargs={"hidden_dim": hidden})
    decoder = JM2D.create(keys[1], JBlockwise.create(2, "normal"),
                          input_shape=1,
                          mapping_kwargs={"hidden_dim": hidden})
    prior = JStatic(
        flow=JMAF.create(keys[2], 1, num_blocks=2,
                         rqs_params={"num_bins": num_bins,
                                     "hidden_dim": hidden,
                                     "bin_range": [-5.0, 5.0]}),
        base=jd.Independent(jd.Normal(jnp.zeros(1), jnp.ones(1)), 1))
    return JVAE(encoder=encoder, decoder=decoder, prior=prior,
                regularizer=losses.KLDivergenceEstimate())


@pytest.fixture(scope="module")
def pair():
    """(JAX VAE, the port's copy) with the biases made non-zero, so that
    every weight the conversion carries is exercised."""
    vae = jax_flagship(jax.random.PRNGKey(0))
    leaves, tree = jax.tree_util.tree_flatten(vae)
    rng = np.random.default_rng(0)
    leaves = [leaf + 0.05 * rng.normal(size=leaf.shape).astype(np.float32)
              if leaf.ndim == 1 and leaf.size > 2 else leaf
              for leaf in leaves]
    vae = jax.tree_util.tree_unflatten(tree, leaves)
    return vae, from_jax(vae, "cpu")


def densities(vae, x1, z1, z2, x2, to, out):
    """(forward, reverse) log-densities of a proposal through a VAE's own
    distribution objects; ``to`` converts numpy to the package's arrays."""
    x1, z1, z2, x2 = (to(a) for a in (x1, z1, z2, x2))
    prior = vae._prior_dist(z1, False)
    fwd = (vae.encoder(x1).log_prob(z1) + prior.log_prob(z2)
           + vae.decoder(z2).log_prob(x2))
    rev = (vae.encoder(x2).log_prob(z2) + prior.log_prob(z1)
           + vae.decoder(z1).log_prob(x1))
    return out(fwd), out(rev)


def tnp(a):
    return a.detach().numpy()


# ---------------------------------------------------------------------------
# Modules after from_jax
# ---------------------------------------------------------------------------


def test_fcdeepnn_outputs_match(pair):
    """Dense stacks of width 32 in float32, products summed in another
    order by each framework: 1e-5."""
    jv, tv = pair
    rng = np.random.default_rng(1)
    x = rng.normal(size=(301, 2)).astype(np.float32)
    z = rng.normal(size=(301, 1)).astype(np.float32)
    for jm, tm, inp in ((jv.encoder.mapping, tv.encoder.mapping, x),
                        (jv.decoder.mapping, tv.decoder.mapping, z)):
        np.testing.assert_allclose(tnp(tm(t(inp))), np.asarray(jm(j(inp))),
                                   atol=1e-5, rtol=1e-5)


def test_fcdeepnn_periodic_expansion_matches_jax():
    """Periodic DOFs expand to (cos, sin) after the non-periodic ones,
    then a two-hidden-layer trunk (1e-5)."""
    from vaemolsim_tpu.nn import FCDeepNN
    jm = FCDeepNN.create(jax.random.PRNGKey(3), 3, (2, 2), hidden_dim=[16, 8],
                         periodic_dofs=[True, False, True],
                         activation="tanh")
    tm = from_jax(jm, "cpu")
    x = np.random.default_rng(13).uniform(-4, 4, size=(7, 5, 3))
    x = x.astype(np.float32)
    np.testing.assert_allclose(tnp(tm(t(x))), np.asarray(jm(j(x))),
                               atol=1e-5, rtol=1e-5)
    assert tm(t(x)).shape == (7, 5, 2, 2)


def test_constant_spline_shortcut_evaluates_one_row(pair):
    """A 1-D unconditional MAF block evaluates its conditioner on ONE row
    and broadcasts it (the JAX package's constant-spline shortcut): the
    spline parameters have batch shape (1, 1) whatever the input."""
    _, tv = pair
    block = tv.prior.flow.blocks[0]
    spline = block._spline(torch.zeros(4096, 1), None)
    assert spline.bin_widths.shape == (1, 1, 8)
    with pytest.raises(ValueError, match="non-conditional"):
        block._spline(torch.zeros(3, 1), torch.zeros(3, 2))


def test_encoder_decoder_prior_log_probs_match(pair):
    """Log-densities at shared points, tails of the spline range
    included: sums of O(10) float32 terms, 1e-4."""
    jv, tv = pair
    rng = np.random.default_rng(2)
    x = rng.normal(size=(301, 2)).astype(np.float32)
    z = rng.uniform(-7.0, 7.0, size=(301, 1)).astype(np.float32)
    np.testing.assert_allclose(tnp(tv.encoder(t(x)).log_prob(t(z))),
                               np.asarray(jv.encoder(j(x)).log_prob(j(z))),
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(tnp(tv.decoder(t(z)).log_prob(t(x))),
                               np.asarray(jv.decoder(j(z)).log_prob(j(x))),
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(
        tnp(tv._prior_dist(t(z), False).log_prob(t(z))),
        np.asarray(jv._prior_dist(j(z), False).log_prob(j(z))),
        atol=1e-4, rtol=1e-5)


def test_prior_forward_sampling_from_shared_base_noise(pair):
    """The prior's sampling map (the flow's forward through both blocks)
    from the same base draws: samples to 1e-5, log-dets to 1e-4."""
    jv, tv = pair
    u = np.random.default_rng(3).normal(size=(301, 1)).astype(np.float32)
    jy, jl = jv._prior_dist(j(u), False).bijector.forward_and_log_det(j(u))
    ty, tl = tv._prior_dist(t(u), False).bijector.forward_and_log_det(t(u))
    np.testing.assert_allclose(tnp(ty), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(tnp(tl), np.asarray(jl), atol=1e-4)


def test_mh_propose_matches_jax_densities_at_its_samples(pair):
    """Replay the port's mh_propose draws from a copy of its generator
    (encoder eps, base eps, decoder eps, then U), rebuild its samples,
    and hold its accept decisions to the JAX package's forward and
    reverse densities at those samples.  Decisions may differ only where
    log_acc lies within 1e-3 of log U (float32 roundoff of the sums)."""
    jv, tv = pair
    n = 301
    rng = np.random.default_rng(4)
    x1 = rng.normal(size=(n, 2)).astype(np.float32)

    def log_target(x):
        return -0.5 * (x ** 2).sum(-1)

    l1 = log_target(x1)
    gen = torch.Generator().manual_seed(5)
    replay = torch.Generator()
    replay.set_state(gen.get_state())
    with torch.no_grad():
        x2, l2, accept = mh_propose(*vae_proposal_fns(tv), log_target, t(x1),
                                    t(l1), gen)
        e1, e_u, e2 = (torch.randn(n, d, generator=replay)
                       for d in (1, 1, 2))
        log_u = torch.log(torch.rand(n, generator=replay).clamp_min(1e-38))
        enc = tv.encoder(t(x1)).families[0]
        z1 = enc.loc + enc.scale * e1
        z2 = tv._prior_dist(z1, False).bijector.forward(e_u)
        dec = tv.decoder(z2).families[0]
        np.testing.assert_allclose(tnp(x2), tnp(dec.loc + dec.scale * e2),
                                   atol=1e-6)
    fwd, rev = densities(jv, x1, tnp(z1), tnp(z2), tnp(x2), j, np.asarray)
    log_acc = (log_target(tnp(x2)) - l1) + rev - fwd
    sure = np.abs(log_acc - tnp(log_u)) > 1e-3
    assert sure.mean() > 0.99
    np.testing.assert_array_equal(tnp(accept)[sure],
                                  (log_acc >= tnp(log_u))[sure])
    np.testing.assert_allclose(tnp(l2), log_target(tnp(x2)), atol=1e-6)


@pytest.mark.parametrize("conditional", [False, True])
def test_made_masks_orders_and_d3_maf_match_jax(conditional):
    """A 3-DOF MAF (the flagship's prior is 1-D, where every MADE mask is
    zero): masks and input orders, the merged block-diagonal net, the
    optional conditional input, the one-pass density and the D-pass
    sampling map, inside a FlowedDistribution over an IndependentBlockwise
    base.  Float32 against float32: 1e-5 on values, 1e-4 on densities."""
    from vaemolsim_tpu.dists import FlowedDistribution as JFlowed
    rqs = {"num_bins": 6, "hidden_dim": 16, "bin_range": [-4.0, 4.0]}
    if conditional:
        rqs.update(conditional=True, conditional_event_shape=2)
    flow = JMAF.create(jax.random.PRNGKey(21), 3, num_blocks=3,
                       order_seed=4, rqs_params=rqs)
    jdist = JFlowed(flow=flow, base_layer=JBlockwise.create(3, "normal"))
    tdist = from_jax(jdist, "cpu")
    for jb, tb in zip(flow.blocks, tdist.flow.blocks):
        for jn, tn in zip((jb.conditioner.w_net, jb.conditioner.h_net,
                           jb.conditioner.s_net), tb.conditioner.nets):
            for jm, tm in zip(jn.masks, tn.masks):
                np.testing.assert_array_equal(tnp(tm), np.asarray(jm))
    rng = np.random.default_rng(22)
    raw = rng.normal(size=(65, 6)).astype(np.float32)
    y = rng.normal(size=(65, 3)).astype(np.float32) * 2.0
    ctx = rng.normal(size=(65, 2)).astype(np.float32)
    jkw = {"conditional_input": j(ctx)} if conditional else {}
    tkw = {"conditional_input": t(ctx)} if conditional else {}
    jd_, td_ = jdist(j(raw), **jkw), tdist(t(raw), **tkw)
    np.testing.assert_allclose(tnp(td_.log_prob(t(y))),
                               np.asarray(jd_.log_prob(j(y))), atol=1e-4,
                               rtol=1e-5)
    jy, jl = jd_.bijector.forward_and_log_det(j(y), context=jd_.context)
    ty, tl = td_.bijector.forward_and_log_det(t(y), context=td_.context)
    np.testing.assert_allclose(tnp(ty), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(tnp(tl), np.asarray(jl), atol=1e-4)
    jmade = flow.blocks[1].conditioner.w_net
    tmade = tdist.flow.blocks[1].conditioner.w_net
    np.testing.assert_allclose(
        tnp(tmade(t(y), t(ctx) if conditional else None)),
        np.asarray(jmade(j(y), j(ctx) if conditional else None)),
        atol=1e-5)


# ---------------------------------------------------------------------------
# The whole proposal (kernel 3's module)
# ---------------------------------------------------------------------------


def _proposal_args(jv, tv):
    jenc, jenc_act, _, d_z = jmf._extract_mlp(jv.encoder, "encoder")
    jdec, jdec_act, _, d_x = jmf._extract_mlp(jv.decoder, "decoder")
    jtables_fn, jbase = jmf._extract_prior(jv.prior)
    jtables, rm = jtables_fn()
    jspec = jmf._Spec(d_x, d_z, jenc_act, jdec_act, jtables[0].shape[-1],
                      float(rm))
    tenc, tenc_act, _, _ = tmf._extract_mlp(tv.encoder, "encoder")
    tdec, tdec_act, _, _ = tmf._extract_mlp(tv.decoder, "decoder")
    ttables_fn, tbase = tmf._extract_prior(tv.prior)
    with torch.no_grad():
        ttables, trm = ttables_fn()
    tspec = tmf._Spec(d_x, d_z, tenc_act, tdec_act, ttables[0].shape[-1],
                      float(trm))
    assert tspec == jspec
    return (jenc, jdec, jtables, jbase, jspec), (tenc, tdec, ttables, tbase,
                                                tspec)


def test_proposal_plain_matches_pallas_interpret(pair):
    """x2, forward, reverse, z1 and z2 of the port's plain proposal
    against the Pallas kernel in interpret mode, on the same normals
    (N = 77, not a tile multiple): samples to 1e-5, log-densities (sums
    of six O(10) terms) to 2e-4."""
    jv, tv = pair
    (jenc, jdec, jtab, jbase, jspec), (tenc, tdec, ttab, tbase, tspec) = \
        _proposal_args(jv, tv)
    rng = np.random.default_rng(6)
    x1 = rng.normal(size=(77, 2)).astype(np.float32)
    noise = rng.normal(size=(77, 4)).astype(np.float32)
    want = jmf.fused_vae_proposal(j(x1), jnp.asarray([7, 8], jnp.int32),
                                  jenc, jdec, jtab, jbase, jspec,
                                  noise=j(noise), interpret=True)
    with torch.no_grad():
        got = tmf.fused_vae_proposal(t(x1), torch.tensor([7, 8],
                                                         dtype=torch.int32),
                                     tenc, tdec, ttab, tbase, tspec,
                                     noise=t(noise))
    for name, g, w in zip(("x2", "fwd", "rev", "z1", "z2"), got, want):
        atol = 2e-4 if name in ("fwd", "rev") else 1e-5
        np.testing.assert_allclose(tnp(g), np.asarray(w), atol=atol,
                                   rtol=1e-5, err_msg=name)


def test_proposal_philox_draws_have_exact_densities(pair):
    """Without noise the proposal draws its own Philox normals; forward
    and reverse at its own samples equal the JAX distribution objects'
    (2e-4), and its z1 noise is standard normal (5 standard errors)."""
    jv, tv = pair
    _, (tenc, tdec, ttab, tbase, tspec) = _proposal_args(jv, tv)
    n = 2048
    x1 = np.random.default_rng(7).normal(size=(n, 2)).astype(np.float32)
    with torch.no_grad():
        x2, fwd, rev, z1, z2 = tmf.fused_vae_proposal(
            t(x1), torch.tensor([123, -456], dtype=torch.int32), tenc, tdec,
            ttab, tbase, tspec)
        enc = tv.encoder(t(x1)).families[0]
        eps = tnp((z1 - enc.loc) / enc.scale)
    want_fwd, want_rev = densities(jv, x1, tnp(z1), tnp(z2), tnp(x2), j,
                                   np.asarray)
    np.testing.assert_allclose(tnp(fwd), want_fwd, atol=2e-4, rtol=1e-5)
    np.testing.assert_allclose(tnp(rev), want_rev, atol=2e-4, rtol=1e-5)
    assert abs(eps.mean()) < 5 / np.sqrt(n)
    assert abs(eps.var() - 1) < 5 * np.sqrt(2 / n)


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


def test_flagship_json_from_jax_builds_same_architecture(tmp_path):
    """The JSON the JAX package writes for its flagship loads into the
    port's config classes, builds the same architecture (every parameter
    shape), and after from_jax both packages give the same densities."""
    path = str(tmp_path / "flagship.json")
    jcfg = jconfig.flagship_experiment_config()
    jconfig.save_json(jcfg, path)
    cfg = tconfig.load_json(path)
    assert cfg == tconfig.flagship_experiment_config()
    built = cfg.build("cpu")
    jvae = jcfg.build()
    carried = from_jax(jvae, "cpu")
    assert ({k: tuple(v.shape) for k, v in built.state_dict().items()}
            == {k: tuple(v.shape) for k, v in carried.state_dict().items()})
    # JAX leaves = the port's parameters + the static base's loc and
    # scale (buffers here: they are not trained).
    base = built.prior.base_loc.numel() + built.prior.base_scale.numel()
    assert sum(p.numel() for p in built.parameters()) + base == sum(
        leaf.size for leaf in jax.tree_util.tree_leaves(jvae))
    rng = np.random.default_rng(8)
    x = rng.normal(size=(64, 2)).astype(np.float32)
    z = rng.normal(size=(64, 1)).astype(np.float32)
    fwd, rev = densities(jvae, x, z, z[::-1].copy(), x[::-1].copy(), j,
                         np.asarray)
    with torch.no_grad():
        tfwd, trev = densities(carried, x, z, z[::-1].copy(),
                               x[::-1].copy(), t, tnp)
    # Width-200 stacks and 32-bin splines: 5e-4 on sums of six terms.
    np.testing.assert_allclose(tfwd, fwd, atol=5e-4, rtol=1e-5)
    np.testing.assert_allclose(trev, rev, atol=5e-4, rtol=1e-5)


# ---------------------------------------------------------------------------
# The slice as a whole: MC on the CPU
# ---------------------------------------------------------------------------


def log_target(x):
    return -0.5 * (x ** 2).sum(-1)


@pytest.mark.parametrize("path", ["generic", "fused"])
def test_mc_on_cpu(pair, path):
    """2000 chains x 50 steps on the 2-D standard-normal target, started
    at the target: acceptance strictly inside (0, 1), the chains' second
    moment E[x^2] = 1 within 6 standard errors (x^2 has variance 2 over
    2n coordinates: 1/sqrt(n)), exact int64 counters, and no kernel
    launch on the CPU."""
    _, tv = pair
    step = (make_mcmc_step(*vae_proposal_fns(tv), log_target)
            if path == "generic" else make_fused_vae_step(tv, log_target))
    n = 2000
    x0 = torch.randn(n, 2, generator=torch.Generator().manual_seed(9))
    _build.reset_launches()
    state = MCMCState.create(x0, log_target(x0),
                             torch.Generator().manual_seed(10))
    state, traj = run_mcmc(step, state, 50, collect_every=25)
    acc = float(state.acceptance_rate)
    assert 0.0 < acc < 1.0
    assert traj.shape == (2, n, 2)
    assert bool(torch.isfinite(state.energies).all())
    assert abs(float((state.configs ** 2).mean()) - 1.0) < 6 / np.sqrt(n)
    assert state.num_trials.dtype == torch.int64
    assert int(state.num_trials) == 50 * n
    assert 0 < int(state.num_acc) < 50 * n
    assert all(v == 0 for v in _build.launch_counts().values())


def test_counters_stay_exact_past_float32():
    """int64 counters: adding past 2^24 keeps every unit."""
    x = torch.zeros(3, 2)
    state = MCMCState.create(x, torch.zeros(3), torch.Generator())
    state.num_trials += 2 ** 24
    from vaemolsim_tpu_torch.mcmc import apply_mh
    state = apply_mh(state, x, torch.zeros(3),
                     torch.tensor([True, False, True]))
    assert int(state.num_trials) == 2 ** 24 + 3
    assert int(state.num_acc) == 2


def test_mcmc_reference_api(pair):
    _, tv = pair
    mc = MCMC(tv, log_target, random_seed=3)
    assert np.isnan(mc.acceptance_rate)
    x0 = torch.randn(256, 2, generator=torch.Generator().manual_seed(11))
    x, e = mc.single_step(x0)
    x, e = mc.run(x, e, n_steps=4)
    assert x.shape == (256, 2) and e.shape == (256,)
    assert 0.0 < mc.acceptance_rate < 1.0
    assert mc._num_trials == 5 * 256


def test_vae_forward_and_sample(pair):
    """The forward pass's KL regularizer is the JAX estimator at the
    port's own encoder sample (1e-4); sample() has the event shape."""
    jv, tv = pair
    x = np.random.default_rng(12).normal(size=(128, 2)).astype(np.float32)
    gen = torch.Generator().manual_seed(13)
    with torch.no_grad():
        out = tv(t(x), gen)
        draws = tv.sample(gen, (50,))
    z = tnp(out.encode_sample)
    want = float(jnp.mean(jv.encoder(j(x)).log_prob(j(z))
                          - jv._prior_dist(j(z), False).log_prob(j(z))))
    assert abs(float(out.regularizer_loss) - want) < 1e-4
    assert float(out.kl_div) == float(out.regularizer_loss)
    assert draws.shape == (50, 2)
    assert bool(torch.isfinite(draws).all())


def test_fused_step_refuses_models_outside_its_family():
    gen = torch.Generator().manual_seed(14)
    cfg = tconfig.VAEConfig(
        encoder=tconfig.MappingToDistConfig(
            input_shape=2, dist=tconfig.DistLayerConfig(num_dofs=2),
            mapping_kwargs={"hidden_dim": 8}),
        decoder=tconfig.MappingToDistConfig(
            input_shape=2, dist=tconfig.DistLayerConfig(num_dofs=2),
            mapping_kwargs={"hidden_dim": 8}),
        prior=tconfig.FlowedDistConfig(
            flow=tconfig.MAFConfig(data_dim=2, rqs=tconfig.RQSParams(
                num_bins=4, hidden_dim=8))),
        latent_dim=2)
    vae = cfg.build(gen, "cpu")
    with pytest.raises(tmf.UnsupportedModelError):
        make_fused_vae_step(vae, log_target)
    # The generic step takes it (a 2-D latent runs the MADE conditioner
    # per row through the dense stack).
    x0 = torch.randn(32, 2, generator=gen)
    state = MCMCState.create(x0, log_target(x0), gen)
    state, _ = run_mcmc(make_mcmc_step(*vae_proposal_fns(vae), log_target),
                        state, 2)
    assert int(state.num_trials) == 64


def test_port_imports_without_jax():
    code = ("import sys, vaemolsim_tpu_torch, vaemolsim_tpu_torch.mcmc; "
            "bad = [m for m in ('jax', 'vaemolsim_tpu', 'triton') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
