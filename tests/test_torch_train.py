"""The port's training slice against the JAX package, on the CPU: the
loss classes, the VAE's ELBO and IWAE losses with their gradients, the
optimizers, ``train.fit``'s semantics, the flow-model config, and the
entry points' device default.

Models are built by the JAX package at a small width and carried into
the port with ``convert.from_jax``.  The two packages draw different
random numbers, so the port's draws are replayed from a copy of its
generator and handed to the JAX side as numpy arrays.  Float32
throughout; each tolerance is stated with its reason.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vaemolsim_tpu import config as jconfig
from vaemolsim_tpu import losses as jlosses
from vaemolsim_tpu.dists import IndependentBlockwise as JBlockwise
from vaemolsim_tpu.dists import StaticFlowedDistribution as JStatic
from vaemolsim_tpu.flows import RQSSplineMAF as JMAF
from vaemolsim_tpu.models import VAE as JVAE
from vaemolsim_tpu.models import MappingToDistribution as JM2D
from vaemolsim_tpu.ops import distributions as jd
from vaemolsim_tpu_torch import config as tconfig
from vaemolsim_tpu_torch import losses as tlosses
from vaemolsim_tpu_torch.convert import from_jax
from vaemolsim_tpu_torch.ops import distributions as td
from vaemolsim_tpu_torch.train import fit, fit_ensemble

torch.set_num_threads(1)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def j(a):
    return jnp.asarray(np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# Entry points default to the card
# ---------------------------------------------------------------------------


def test_entry_points_build_on_the_card_by_default():
    """With no device, ExperimentConfig.build and from_jax build on CUDA;
    without a card they raise and name the CPU option."""
    cfg = tconfig.flagship_experiment_config()
    jobj = jd.Normal(jnp.zeros(2), jnp.ones(2))
    if torch.cuda.is_available():
        assert next(cfg.build().parameters()).is_cuda
        assert from_jax(jobj).loc.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cfg.build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax(jobj)
    assert not next(cfg.build("cpu").parameters()).is_cuda


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _dists(rng):
    la, lb = rng.normal(size=(2, 64, 3)).astype(np.float32)
    sa, sb = np.exp(0.3 * rng.normal(size=(2, 64, 3))).astype(np.float32)
    jdists = [jd.Independent(jd.Normal(j(l), j(s)), 1)
              for l, s in ((la, sa), (lb, sb))]
    tdists = [td.Independent(td.Normal(t(l), t(s)), 1)
              for l, s in ((la, sa), (lb, sb))]
    return jdists, tdists


def _potential(x):
    return 0.5 * (x ** 2).sum(-1)


LOSSES = {
    "LogProbLoss": (jlosses.LogProbLoss(), lambda l, a, b, s: l(s, a)),
    "PotentialEnergyLogProbLoss": (
        jlosses.PotentialEnergyLogProbLoss(_potential),
        lambda l, a, b, s: l(a, samples=s)),
    "NonRegularizer": (jlosses.NonRegularizer(weight=0.7),
                       lambda l, a, b, s: l(a, b, samples=s)),
    "KLDivergenceEstimate": (jlosses.KLDivergenceEstimate(weight=0.7),
                             lambda l, a, b, s: l(a, b, samples=s)),
    "LogProbRegularizer": (jlosses.LogProbRegularizer(weight=0.7),
                           lambda l, a, b, s: l(a, b, samples=s)),
    "ReverseKLDivergenceEstimate": (
        jlosses.ReverseKLDivergenceEstimate(weight=0.7),
        lambda l, a, b, s: l(a, b, samples=s)),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(name):
    """Each loss class, carried by from_jax, at shared samples: means of
    64 float32 log-densities of O(1), 1e-6."""
    jloss, call = LOSSES[name]
    tloss = from_jax(jloss, "cpu")
    assert type(tloss).__name__ == name
    if hasattr(jloss, "weight"):
        assert (tloss.weight, tloss.sample_dist) == (jloss.weight,
                                                     jloss.sample_dist)
    rng = np.random.default_rng(1)
    (ja, jb), (ta, tb) = _dists(rng)
    s = rng.normal(size=(64, 3)).astype(np.float32)
    want = float(call(jloss, ja, jb, j(s)))
    got = float(call(tloss, ta, tb, t(s)))
    assert abs(got - want) < 1e-6 * max(1.0, abs(want))


def test_regularizers_draw_from_their_sample_dist():
    """Without samples a regularizer draws from ``sample_dist`` with the
    generator (dist_a for KL, dist_b for reverse KL), and refuses to
    run without one; a bad sample_dist is refused when built."""
    rng = np.random.default_rng(2)
    _, (ta, tb) = _dists(rng)
    for cls, src in ((tlosses.KLDivergenceEstimate, ta),
                     (tlosses.ReverseKLDivergenceEstimate, tb)):
        reg = cls(weight=0.5)
        gen = torch.Generator().manual_seed(3)
        replay = torch.Generator().manual_seed(3)
        got = reg(ta, tb, generator=gen)
        assert torch.equal(got, reg(ta, tb, samples=src.sample(replay)))
        with pytest.raises(ValueError, match="generator"):
            reg(ta, tb)
    with pytest.raises(ValueError, match="sample_dist"):
        tlosses.KLDivergenceEstimate(sample_dist="prior")
    assert isinstance(tconfig.RegularizerConfig("reverse_kl", 0.5).build(),
                      tlosses.ReverseKLDivergenceEstimate)


# ---------------------------------------------------------------------------
# ELBO and IWAE against jax.grad
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    """A flagship-family VAE (hidden 32, 8 bins), biases made non-zero,
    and the port's copy."""
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    vae = JVAE(
        encoder=JM2D.create(keys[0], JBlockwise.create(1, "normal"),
                            input_shape=2, mapping_kwargs={"hidden_dim": 32}),
        decoder=JM2D.create(keys[1], JBlockwise.create(2, "normal"),
                            input_shape=1, mapping_kwargs={"hidden_dim": 32}),
        prior=JStatic(
            flow=JMAF.create(keys[2], 1, num_blocks=2,
                             rqs_params={"num_bins": 8, "hidden_dim": 32,
                                         "bin_range": [-5.0, 5.0]}),
            base=jd.Independent(jd.Normal(jnp.zeros(1), jnp.ones(1)), 1)),
        regularizer=jlosses.KLDivergenceEstimate(weight=0.8))
    leaves, tree = jax.tree_util.tree_flatten(vae)
    rng = np.random.default_rng(0)
    leaves = [leaf + 0.05 * rng.normal(size=leaf.shape).astype(np.float32)
              if leaf.ndim == 1 and leaf.size > 2 else leaf
              for leaf in leaves]
    vae = jax.tree_util.tree_unflatten(tree, leaves)
    return vae, from_jax(vae, "cpu")


def _compare_grads(tv, jgrads, atol, rtol):
    """The port's .grad of every parameter against the JAX gradient
    pytree, carried into the port's layout by from_jax (so the names
    line up)."""
    want = from_jax(jgrads, "cpu").state_dict()
    names = [n for n, _ in tv.named_parameters()]
    assert names
    for name, p in tv.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=atol, rtol=rtol, err_msg=name)


def test_elbo_loss_and_gradients_match_jax(pair):
    """elbo_loss's value, every metric and every parameter's gradient,
    against jax.grad of the same ELBO built at the port's own encoder
    draw (its standard normals, replayed): values to 1e-5, gradients to
    1e-4 (sums over 128 rows through 32-wide stacks and 8-bin splines)."""
    jv, tv = pair
    x = np.random.default_rng(4).normal(size=(128, 2)).astype(np.float32)
    gen = torch.Generator().manual_seed(5)
    replay = torch.Generator()
    replay.set_state(gen.get_state())
    tv.zero_grad()
    loss, metrics = tv.elbo_loss(t(x), gen)
    loss.backward()
    eps = torch.randn(128, 1, generator=replay).numpy()

    def jelbo(v):
        enc = v.encoder(j(x), train=True)
        f = enc.families[0]
        z = f.loc + f.scale * j(eps)
        prior = v._prior_dist(z, True)
        reg = v.regularizer(enc, prior, samples=z)
        recon = -jnp.mean(v.decoder(z, train=True).log_prob(j(x)))
        return recon + reg, {"loss": recon + reg, "recon_nll": recon,
                             "kl_div": reg / v.regularizer.weight,
                             "regularizer_loss": reg}

    (jloss, jmetrics), jgrads = jax.jit(
        jax.value_and_grad(jelbo, has_aux=True))(jv)
    assert set(metrics) == set(jmetrics)
    for name in metrics:
        np.testing.assert_allclose(float(metrics[name].detach()),
                                   float(jmetrics[name]), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               atol=1e-5, rtol=1e-5)
    _compare_grads(tv, jgrads, 1e-4, 1e-4)


def test_iwae_loss_and_gradients_match_jax(pair):
    """iwae_loss with K = 4 draws as one leading batch axis, against the
    JAX bound (vmapped over the same 4 replayed draws) and its jax.grad:
    value to 1e-5, gradients to 1e-4."""
    jv, tv = pair
    x = np.random.default_rng(6).normal(size=(96, 2)).astype(np.float32)
    gen = torch.Generator().manual_seed(7)
    replay = torch.Generator()
    replay.set_state(gen.get_state())
    tv.zero_grad()
    loss = tv.iwae_loss(t(x), gen, n_samples=4)
    loss.backward()
    eps = torch.randn(4, 96, 1, generator=replay).numpy()

    def jiwae(v):
        enc = v.encoder(j(x), train=True)
        f = enc.families[0]

        def one(e):
            z = f.loc + f.scale * e
            prior = v._prior_dist(z, True)
            return (v.decoder(z, train=True).log_prob(j(x))
                    + prior.log_prob(z) - enc.log_prob(z))

        log_w = jax.vmap(one)(j(eps))
        return -jnp.mean(jax.scipy.special.logsumexp(log_w, axis=0)
                         - jnp.log(4.0))

    jloss, jgrads = jax.jit(jax.value_and_grad(jiwae))(jv)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               atol=1e-5, rtol=1e-5)
    _compare_grads(tv, jgrads, 1e-4, 1e-4)


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,wd", [("adam", 0.0), ("adamw", 0.05),
                                     ("sgd", 0.0)])
def test_optimizer_steps_match_optax(name, wd):
    """Three steps of OptimizerConfig(...).build() on shared parameters
    and gradients, against optax: 1e-6."""
    rng = np.random.default_rng(8)
    shapes = [(3, 4), (4,), (2,)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    tparams = [torch.nn.Parameter(t(p)) for p in p0]
    opt = tconfig.OptimizerConfig(name, 1e-2, wd).build()(tparams)
    jopt = jconfig.OptimizerConfig(name, 1e-2, wd).build()
    jparams = [j(p) for p in p0]
    state = jopt.init(jparams)
    for g in grads:
        for p, gi in zip(tparams, g):
            p.grad = t(gi)
        opt.step()
        updates, state = jopt.update([j(gi) for gi in g], state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    for p, w in zip(tparams, jparams):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                   atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="weight_decay"):
        tconfig.OptimizerConfig("adam", 1e-3, 0.1).build()


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------


class Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(2))


def quad_loss(seen=None):
    """Mean squared distance of the batch to w, with a duplicate "loss"
    metric (reserved) and an "extra" metric; records batch sizes."""
    def fn(m, batch, gen):
        if seen is not None:
            seen.append(batch.shape[0])
        loss = ((batch - m.w) ** 2).sum(-1).mean()
        return loss, {"loss": loss * 0 + 123.0, "extra": 2 * loss}
    return fn


def _data(n=10, seed=9):
    return t(np.random.default_rng(seed).normal(size=(n, 2)) + 1.0)


def test_fit_history_batches_and_reserved_keys():
    """Drop-remainder batches (n = 10 at batch 3: three batches of 3 per
    epoch, then the 4-row validation set), one full batch when
    batch_size > n, per-epoch means, the reserved "loss" key kept for
    the total, and val_loss with a validation set."""
    seen = []
    data = _data()
    sgd = tconfig.OptimizerConfig("sgd", 0.1).build()
    _, hist = fit(Toy(), quad_loss(seen), data,
                  generator=torch.Generator().manual_seed(0), num_epochs=2,
                  batch_size=3, optimizer=sgd, validation_data=data[:4])
    assert seen == [3, 3, 3, 4] * 2
    assert set(hist) == {"loss", "epoch_time_s", "extra", "val_loss"}
    assert all(len(v) == 2 for v in hist.values())
    assert hist["loss"][0] != 123.0
    np.testing.assert_allclose(hist["extra"], 2 * np.asarray(hist["loss"]),
                               rtol=1e-6)
    seen.clear()
    fit(Toy(), quad_loss(seen), data,
        generator=torch.Generator().manual_seed(0), batch_size=64,
        optimizer=sgd)
    assert seen == [10]


def test_fit_early_stopping_and_restore_best():
    """With a learning rate of 0 the loss never improves after the first
    epoch: patience 2 stops after 3 epochs.  restore_best returns the
    weights of the epoch with the best validation loss (training pulls w
    away from the validation set after the first epoch)."""
    data = _data()
    _, hist = fit(Toy(), quad_loss(), data,
                  generator=torch.Generator().manual_seed(0), num_epochs=10,
                  optimizer=tconfig.OptimizerConfig("sgd", 0.0).build(),
                  early_stopping_patience=2)
    assert len(hist["loss"]) == 3
    sgd = tconfig.OptimizerConfig("sgd", 0.05).build()
    val = torch.zeros(4, 2) + torch.tensor([0.2, 0.2])
    one, _ = fit(Toy(), quad_loss(), data,
                 generator=torch.Generator().manual_seed(1), num_epochs=1,
                 batch_size=5, optimizer=sgd, validation_data=val)
    best, hist = fit(Toy(), quad_loss(), data,
                     generator=torch.Generator().manual_seed(1), num_epochs=4,
                     batch_size=5, optimizer=sgd, validation_data=val,
                     restore_best=True)
    assert int(np.argmin(hist["val_loss"])) == 0
    assert torch.equal(best.w, one.w)


def test_fit_ema_returns_averaged_weights():
    """ema_decay: the returned weights are d*ema + (1-d)*w after every
    step from the initial weights (replayed from the weights each step
    saw), while the raw model keeps the last weights; 1e-6."""
    trail = []

    def loss_fn(m, batch, gen):
        trail.append(m.w.detach().clone())
        return ((batch - m.w) ** 2).sum(-1).mean()

    raw = Toy()
    avg, _ = fit(raw, loss_fn, _data(), generator=torch.Generator(
        ).manual_seed(2), num_epochs=3, batch_size=5, ema_decay=0.6,
        optimizer=tconfig.OptimizerConfig("sgd", 0.1).build())
    assert avg is not raw
    ema = trail[0]
    for w in trail[1:] + [raw.w.detach()]:
        ema = 0.6 * ema + 0.4 * w
    np.testing.assert_allclose(avg.w.detach().numpy(), ema.numpy(), atol=1e-6)


def test_fit_scan_epochs_runs_the_same_loop():
    runs = [fit(Toy(), quad_loss(), _data(), generator=torch.Generator(
        ).manual_seed(3), num_epochs=2, batch_size=4, scan_epochs=scan)[0].w
        for scan in (False, True)]
    assert torch.equal(*runs)


@pytest.mark.parametrize("kw", ["mesh", "process_local_data", "streamed",
                                "fit_ensemble"])
def test_fit_options_not_ported_raise(kw):
    """Every option is ported; each raises as the JAX package does on what
    it cannot take: a mesh that is not a DeviceMesh, process_local_data
    without scan_epochs, an empty stream, and a stream given to the
    ensemble (sharded training runs in tests/test_torch_distributed.py)."""
    gen = torch.Generator()
    if kw == "fit_ensemble":
        with pytest.raises(ValueError, match="in-memory"):
            fit_ensemble([Toy()], quad_loss(), lambda g: iter([]),
                         generator=gen)
    elif kw == "streamed":
        with pytest.raises(ValueError, match="no batches"):
            fit(Toy(), quad_loss(), lambda g: iter([]), generator=gen)
    elif kw == "mesh":
        with pytest.raises(TypeError, match="DeviceMesh"):
            fit(Toy(), quad_loss(), _data(), generator=gen, mesh=object())
    else:
        with pytest.raises(ValueError, match="scan_epochs"):
            fit(Toy(), quad_loss(), _data(), generator=gen,
                mesh=object(), process_local_data=True)


def test_flow_model_nll_falls_under_fit():
    """A D=2 MAF flow model (hidden 16, 8 bins), maximum likelihood on a
    correlated Gaussian: the mean NLL falls over 4 epochs."""
    cfg = tconfig.ExperimentConfig(model=tconfig.FlowModelConfig(
        tconfig.FlowedDistConfig(tconfig.MAFConfig(
            data_dim=2, rqs=tconfig.RQSParams(hidden_dim=16, num_bins=8)),
            base=None, static_base_dim=2)), seed=4)
    model = cfg.build("cpu")
    rng = np.random.default_rng(10)
    data = t(rng.multivariate_normal([1.0, -1.0], [[2.0, 1.2], [1.2, 1.0]],
                                     size=512))
    _, hist = fit(model, lambda m, b, g: -m.log_prob(b).mean(), data,
                  generator=torch.Generator().manual_seed(5), num_epochs=4,
                  batch_size=128, learning_rate=1e-2)
    assert all(math.isfinite(v) for v in hist["loss"])
    assert hist["loss"][-1] < hist["loss"][0] - 0.1
    draws = model.predict(torch.zeros(64, 2), torch.Generator().manual_seed(6))
    assert draws.shape == (64, 2) and bool(torch.isfinite(draws).all())


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


def test_flow_model_json_from_jax_builds_same_architecture(tmp_path):
    """A FlowModelConfig JSON written by the JAX package loads in the port,
    equals the same config built here, and builds the architecture of
    from_jax(the JAX build): every parameter shape and input order."""
    jcfg = jconfig.ExperimentConfig(model=jconfig.FlowModelConfig(
        jconfig.FlowedDistConfig(jconfig.MAFConfig(
            data_dim=3, num_blocks=3, order_seed=2,
            rqs=jconfig.RQSParams(hidden_dim=16, num_bins=6)),
            base=None, static_base_dim=3)),
        optimizer=jconfig.OptimizerConfig("adamw", 1e-3, 0.01))
    path = str(tmp_path / "flow.json")
    jconfig.save_json(jcfg, path)
    cfg = tconfig.load_json(path)
    assert cfg == tconfig.ExperimentConfig(model=tconfig.FlowModelConfig(
        tconfig.FlowedDistConfig(tconfig.MAFConfig(
            data_dim=3, num_blocks=3, order_seed=2,
            rqs=tconfig.RQSParams(hidden_dim=16, num_bins=6)),
            base=None, static_base_dim=3)),
        optimizer=tconfig.OptimizerConfig("adamw", 1e-3, 0.01))
    built, carried = cfg.build("cpu"), from_jax(jcfg.build(), "cpu")
    assert ({k: tuple(v.shape) for k, v in built.state_dict().items()}
            == {k: tuple(v.shape) for k, v in carried.state_dict().items()})
    for a, b in zip(built.flowed_dist.flow.blocks,
                    carried.flowed_dist.flow.blocks):
        assert (a.conditioner.w_net.input_order_static
                == b.conditioner.w_net.input_order_static)
    assert isinstance(cfg.optimizer.build()(built.parameters()),
                      torch.optim.AdamW)
