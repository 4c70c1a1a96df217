"""The port's batch norms and the bijectors of slice 9 against the JAX
package, on the CPU: Sigmoid, Tanh, Softplus and ``make_domain_transform``;
``BatchNormBijector`` in both modes; the ``BatchNorm`` layer and the
FCDeepNN batch-norm trunk; MAF and RealNVP flows with ``batch_norm=True``
and their ``update_batch_stats``.

Inputs come from numpy seeds and go to both packages as the same arrays;
JAX objects are carried across by ``from_jax(..., "cpu")``.  Float32
throughout: values and log-densities to 1e-5, gradients and batch-norm
statistics to 1e-4 (absolute and relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu.flows import RQSSplineMAF as JMAF
from vaemolsim_tpu.flows import RQSSplineRealNVP as JRealNVP
from vaemolsim_tpu.nn import FCDeepNN as JFCDeepNN
from vaemolsim_tpu.nn.core import BatchNorm as JBatchNorm
from vaemolsim_tpu.ops import bijectors as jbj
from vaemolsim_tpu.ops import distributions as jd
from vaemolsim_tpu_torch import config as tconfig
from vaemolsim_tpu_torch.convert import from_jax
from vaemolsim_tpu_torch.flows import RQSSplineMAF, RQSSplineRealNVP
from vaemolsim_tpu_torch.nn import FCDeepNN
from vaemolsim_tpu_torch.ops import bijectors as tbj
from vaemolsim_tpu_torch.ops import distributions as td
from vaemolsim_tpu_torch.ops import fused_mlp

torch.set_num_threads(1)

VAL = dict(atol=1e-5, rtol=1e-5)
STAT = dict(atol=1e-4, rtol=1e-4)
RQS = {"num_bins": 8, "hidden_dim": 16, "bin_range": [-4.0, 4.0]}


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def close(got, want, tol=VAL, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), err_msg=msg, **tol)


# ---------------------------------------------------------------------------
# Scalar bijectors and the domain transform
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["Identity", "Sigmoid", "Tanh", "Softplus"])
def test_scalar_bijectors_match_jax(name):
    """Forward and inverse values and log-dets, and the round trip."""
    rng = np.random.default_rng(1)
    x = (3.0 * rng.normal(size=(64, 3))).astype(np.float32)
    jb = getattr(jbj, name)()
    tb = from_jax(jb, "cpu")
    assert type(tb) is getattr(tbj, name)
    ty, tl = tb.forward_and_log_det(t(x))
    jy, jl = jb.forward_and_log_det(j(x))
    close(ty, jy, msg="forward")
    close(tl, jl, msg="forward log-det")
    # The inverse away from the codomain's ends, where float32 saturates.
    y = np.asarray(jy)
    if name == "Sigmoid":
        y = np.clip(y, 1e-3, 1 - 1e-3)
    elif name == "Tanh":
        y = np.clip(y, -0.999, 0.999)
    elif name == "Softplus":
        y = np.maximum(y, 1e-3)
    tx, til = tb.inverse_and_log_det(t(y))
    jx, jil = jb.inverse_and_log_det(j(y))
    close(tx, jx, STAT, "inverse")
    close(til, jil, STAT, "inverse log-det")
    inner = np.abs(x) < 2.0
    np.testing.assert_allclose(
        tb.inverse(tb.forward(t(x))).numpy()[inner], x[inner], atol=1e-4)


@pytest.mark.parametrize("from_target", [False, True])
def test_make_domain_transform_matches_jax(from_target):
    domains = [(-3.0, 1.0), (0.0, 10.0), (-np.pi, np.pi)]
    jb = jbj.Block(jbj.make_domain_transform(domains, (-1.0, 2.0),
                                             from_target), 1)
    tb = tbj.Block(tbj.make_domain_transform(domains, (-1.0, 2.0),
                                             from_target, device="cpu"), 1)
    x = np.random.default_rng(2).uniform(-3.0, 3.0, (50, 3)).astype(
        np.float32)
    for direction in ("forward_and_log_det", "inverse_and_log_det"):
        ty, tl = getattr(tb, direction)(t(x))
        jy, jl = getattr(jb, direction)(j(x))
        close(ty, jy, msg=direction)
        close(tl, jl, msg=direction)
    carried = from_jax(jb, "cpu")
    close(carried.forward(t(x)), jb.forward(j(x)))


# ---------------------------------------------------------------------------
# BatchNormBijector and BatchNorm
# ---------------------------------------------------------------------------


def bn_bijector_params(seed, d):
    rng = np.random.default_rng(seed)
    return dict(mean=j(rng.normal(size=d)),
                var=j(rng.uniform(0.5, 2.0, d)),
                log_gamma=j(0.3 * rng.normal(size=d)),
                beta=j(0.3 * rng.normal(size=d)))


@pytest.mark.parametrize("use_batch_stats", [False, True])
def test_batch_norm_bijector_matches_jax(use_batch_stats):
    """Both directions, their log-dets, and the moments the inverse
    normalised by (the batch's, biased, over both leading axes)."""
    jb = jbj.BatchNormBijector(**bn_bijector_params(3, 4),
                               use_batch_stats=use_batch_stats)
    tb = from_jax(jb, "cpu")
    assert tb.eps == 1e-5 and tb.use_batch_stats == use_batch_stats
    y = (2.0 + 1.5 * np.random.default_rng(4).normal(size=(5, 30, 4))
         ).astype(np.float32)
    tx, tl, tm, tv = tb.inverse_and_log_det_and_moments(t(y))
    jx, jl, jm, jv = jb.inverse_and_log_det_and_moments(j(y))
    close(tx, jx, msg="inverse")
    close(tl, jl, msg="inverse log-det")
    close(tm, jm, STAT, "mean")
    close(tv, jv, STAT, "variance")
    ty, tfl = tb.forward_and_log_det(t(y))
    jy, jfl = jb.forward_and_log_det(j(y))
    close(ty, jy, msg="forward")
    close(tfl, jfl, msg="forward log-det")
    # The view in the other mode reads the same tensors.
    other = tb.with_batch_stats(not use_batch_stats)
    jo = jb.replace(use_batch_stats=not use_batch_stats)
    close(other.inverse(t(y)), jo.inverse(j(y)))
    assert tb.with_batch_stats(use_batch_stats) is tb


@pytest.mark.parametrize("train", [False, True])
def test_batch_norm_layer_call_and_update_matches_jax(train):
    rng = np.random.default_rng(5)
    jbn = JBatchNorm.create(6).replace(
        mean=j(rng.normal(size=6)), var=j(rng.uniform(0.5, 2, 6)),
        scale=j(rng.uniform(0.5, 1.5, 6)), offset=j(rng.normal(size=6)))
    tbn = from_jax(jbn, "cpu")
    assert tbn.eps == 1e-3 and tbn.momentum == 0.99
    x = (1.0 + 2.0 * rng.normal(size=(40, 6))).astype(np.float32)
    close(tbn(t(x), train), jbn(j(x), train), msg="__call__")
    close(tbn.mean, jbn.mean, msg="__call__ never updates")
    tout, same = tbn.call_and_update(t(x), train)
    jout, jnew = jbn.call_and_update(j(x), train)
    assert same is tbn
    close(tout, jout, msg="call_and_update")
    close(tbn.mean, jnew.mean, STAT, "running mean")
    close(tbn.var, jnew.var, STAT, "running variance")


def jax_bn_trunk(seed):
    """A JAX FCDeepNN (3 -> 12 -> 10 -> 5) with batch norm and non-trivial
    batch-norm parameters and running moments."""
    net = JFCDeepNN.create(jax.random.PRNGKey(seed), 3, 5,
                           hidden_dim=[12, 10], batch_norm=True)
    rng = np.random.default_rng(seed)
    bns = tuple(b.replace(mean=j(0.5 * rng.normal(size=b.mean.shape)),
                          var=j(rng.uniform(0.5, 2.0, b.var.shape)),
                          scale=j(rng.uniform(0.5, 1.5, b.scale.shape)),
                          offset=j(0.3 * rng.normal(size=b.offset.shape)))
                for b in net.bns)
    return net.replace(bns=bns)


@pytest.mark.parametrize("train", [False, True])
def test_fcdeepnn_batch_norm_trunk_matches_jax(train, monkeypatch):
    """Output, parameter gradients and (after call_and_update) the
    running moments of every layer; the trunk runs layer by layer, never
    through the dense-stack route."""
    jnet = jax_bn_trunk(6)
    tnet = from_jax(jnet, "cpu")
    assert tnet.batch_norm and len(tnet.bns) == 2

    def no_stack(*a, **k):
        raise AssertionError("the batch-norm trunk took the dense stack")

    monkeypatch.setattr(fused_mlp, "fused_dense_stack", no_stack)
    x = np.random.default_rng(7).normal(size=(32, 3)).astype(np.float32)
    out = tnet(t(x), train=train)
    close(out, jnet(j(x), train=train))
    params = list(tnet.parameters())
    got = torch.autograd.grad((out ** 2).sum(), params)
    jgrads = jax.grad(lambda m: (m(j(x), train=train) ** 2).sum())(jnet)
    want = ([g for l in jgrads.layers for g in (l.kernel, l.bias)]
            + [g for b in jgrads.bns for g in (b.scale, b.offset)]
            + [jgrads.head.kernel, jgrads.head.bias])
    names = [n for n, _ in tnet.named_parameters()]
    order = ([f"layers.{i}.{a}" for i in range(2) for a in ("kernel", "bias")]
             + [f"bns.{i}.{a}" for i in range(2) for a in ("scale", "offset")]
             + ["head.kernel", "head.bias"])
    by_name = dict(zip(names, got))
    for name, w in zip(order, want):
        close(by_name[name], w, STAT, name)
    tout, _ = tnet.call_and_update(t(x), train=train)
    jout, jnew = jnet.call_and_update(j(x), train=train)
    close(tout, jout)
    for tb, jb in zip(tnet.bns, jnew.bns):
        close(tb.mean, jb.mean, STAT, "running mean")
        close(tb.var, jb.var, STAT, "running variance")


def test_fcdeepnn_batch_norm_create_and_config():
    """create(batch_norm=True) and MappingConfig build one BatchNorm per
    hidden layer with JAX's initial state."""
    net = tconfig.MappingConfig(input_shape=4, target_shape=(2, 3),
                                hidden_dim=[8, 8], batch_norm=True).build(
        torch.Generator().manual_seed(0), "cpu")
    jnet = JFCDeepNN.create(jax.random.PRNGKey(0), 4, (2, 3),
                            hidden_dim=[8, 8], batch_norm=True)
    assert ({k: tuple(v.shape) for k, v in net.state_dict().items()}
            == {k: tuple(v.shape) for k, v in
                from_jax(jnet, "cpu").state_dict().items()})
    for bn in net.bns:
        assert torch.equal(bn.mean, torch.zeros(8))
        assert torch.equal(bn.var, torch.ones(8))
    assert net(torch.zeros(5, 4)).shape == (5, 2, 3)


# ---------------------------------------------------------------------------
# Flows with batch norm between blocks
# ---------------------------------------------------------------------------


def jax_bn_flow(kind, seed, d=3, blocks=3):
    if kind == "maf":
        flow = JMAF.create(jax.random.PRNGKey(seed), d, num_blocks=blocks,
                           order_seed=4, rqs_params=dict(RQS),
                           batch_norm=True)
    else:
        flow = JRealNVP.create(jax.random.PRNGKey(seed), d,
                               num_blocks=blocks, rqs_params=dict(RQS),
                               batch_norm=True)
    bns = tuple(b.replace(**bn_bijector_params(seed + i, d))
                for i, b in enumerate(flow.bn_params))
    return flow.replace(bn_params=bns)


def flow_dists(jflow, tflow, train):
    jbase = jd.Independent(jd.Normal(jnp.zeros(3), jnp.ones(3)), 1)
    tbase = td.Independent(td.Normal(torch.zeros(3), torch.ones(3)), 1)
    return jflow(jbase, train=train), tflow(tbase, train=train)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kind", ["maf", "realnvp"])
def test_bn_flow_log_prob_and_gradients_match_jax(kind, train):
    """log_prob in training mode (batch moments) and in eval mode
    (running moments), and its parameter gradients."""
    jflow = jax_bn_flow(kind, 10)
    tflow = from_jax(jflow, "cpu")
    assert len(tflow.bn_params) == 2
    y = (0.5 + 1.3 * np.random.default_rng(11).normal(size=(64, 3))
         ).astype(np.float32)
    jdist, tdist = flow_dists(jflow, tflow, train)
    lp = tdist.log_prob(t(y))
    # One compiled JAX program for the value and the gradient.
    (jlp, jg) = jax.jit(lambda f: (
        flow_dists(f, tflow, train)[0].log_prob(j(y)),
        jax.grad(lambda g: flow_dists(g, tflow, train)[0].log_prob(
            j(y)).mean())(f)))(jflow)
    close(lp, jlp)
    got = dict(zip([n for n, _ in tflow.named_parameters()],
                   torch.autograd.grad(lp.mean(), list(tflow.parameters()))))
    for i, b in enumerate(jg.bn_params):
        close(got[f"bn_params.{i}.log_gamma"], b.log_gamma, STAT)
        close(got[f"bn_params.{i}.beta"], b.beta, STAT)
    # The running moments take no gradient (buffers).
    assert not any("mean" in n or "var" in n for n in got)
    # Sampling direction (running moments in both modes).
    x = np.random.default_rng(12).normal(size=(20, 3)).astype(np.float32)
    close(tdist.bijector.forward(t(x)), jax.jit(
        lambda f: flow_dists(f, tflow, train)[0].bijector.forward(j(x)))(
            jflow))


@pytest.mark.parametrize("kind", ["maf", "realnvp"])
def test_update_batch_stats_matches_jax(kind):
    """Three update_batch_stats calls on three batches: every batch
    norm's running moments, then the eval-mode log_prob."""
    jflow = jax_bn_flow(kind, 20)
    tflow = from_jax(jflow, "cpu")
    rng = np.random.default_rng(21)
    update = jax.jit(lambda f, y: f.update_batch_stats(y))
    for _ in range(3):
        y = (1.0 + 2.0 * rng.normal(size=(50, 3))).astype(np.float32)
        assert tflow.update_batch_stats(t(y)) is tflow
        jflow = update(jflow, j(y))
    for tb, jb in zip(tflow.bn_params, jflow.bn_params):
        close(tb.mean, jb.mean, STAT, "running mean")
        close(tb.var, jb.var, STAT, "running variance")
    y = rng.normal(size=(30, 3)).astype(np.float32)
    tdist = flow_dists(jflow, tflow, False)[1]
    close(tdist.log_prob(t(y)), jax.jit(
        lambda f: flow_dists(f, tflow, False)[0].log_prob(j(y)))(jflow))


def test_bn_flows_build_with_batch_norm_and_keep_no_stat_parameter():
    """Both flow configs build with batch norm; no batch-norm running
    moment is a Parameter, and Adam steps leave them where they are."""
    gen = torch.Generator().manual_seed(1)
    flows = [tconfig.MAFConfig(data_dim=2, num_blocks=3, batch_norm=True,
                               rqs=tconfig.RQSParams(hidden_dim=8,
                                                     num_bins=4)
                               ).build(gen, "cpu"),
             tconfig.RealNVPConfig(data_dim=2, num_blocks=3,
                                   batch_norm=True,
                                   rqs=tconfig.RQSParams(hidden_dim=8,
                                                         num_bins=4)
                                   ).build(gen, "cpu")]
    net = FCDeepNN.create(gen, 2, 3, hidden_dim=4, batch_norm=True,
                          device="cpu")
    for m in flows + [net]:
        params = dict(m.named_parameters())
        buffers = dict(m.named_buffers())
        stats = [n for n in buffers if n.endswith((".mean", ".var"))]
        assert len(stats) == (2 if m is net else 4)
        assert not any(n.endswith((".mean", ".var")) for n in params)
    for flow in flows:
        assert isinstance(flow, (RQSSplineMAF, RQSSplineRealNVP))
        before = {n: b.clone() for n, b in flow.named_buffers()}
        opt = torch.optim.Adam(flow.parameters(), lr=0.1)
        base = td.Independent(td.Normal(torch.zeros(2), torch.ones(2)), 1)
        for train in (True, False):
            opt.zero_grad()
            (-flow(base, train=train).log_prob(torch.randn(
                16, 2, generator=gen)).mean()).backward()
            opt.step()
        for n, b in flow.named_buffers():
            assert torch.equal(b, before[n]), n


# ---------------------------------------------------------------------------
# Every create builds on the card by default
# ---------------------------------------------------------------------------


def _creates():
    from vaemolsim_tpu_torch.dists import AutoregressiveBlockwise
    from vaemolsim_tpu_torch.dists import StaticFlowedDistribution
    from vaemolsim_tpu_torch.flows import (MaskedSplineConditioner,
                                           SplineConditioner)
    from vaemolsim_tpu_torch.models import FlowModel, MappingToDistribution
    from vaemolsim_tpu_torch.nn import (MADE, MLP, BatchNorm, CGCenterOfMass,
                                        CGCentroid, Dense, DistanceSelection,
                                        LayerNorm, ParticleEmbedding,
                                        VectorAttention)
    from vaemolsim_tpu_torch.nn.attention import AttentionBlock
    from vaemolsim_tpu_torch.dists import IndependentBlockwise

    def g():
        return torch.Generator().manual_seed(0)

    return {
        "Dense": lambda d: Dense.create(g(), 2, 3, device=d),
        "LayerNorm": lambda d: LayerNorm.create(3, device=d),
        "BatchNorm": lambda d: BatchNorm.create(3, device=d),
        "MLP": lambda d: MLP.create(g(), 2, [4], 3, device=d),
        "MADE": lambda d: MADE.create(g(), 3, 2, [6], device=d),
        "FCDeepNN": lambda d: FCDeepNN.create(g(), 2, 3, 4, device=d),
        "DistanceSelection": lambda d: DistanceSelection.create(
            2.0, 4, [3.0, 3.0, 3.0], device=d),
        "CGCentroid": lambda d: CGCentroid.create([2, 1], device=d),
        "CGCenterOfMass": lambda d: CGCenterOfMass.create(
            [2, 1], [1.0, 2.0, 3.0], device=d),
        "VectorAttention": lambda d: VectorAttention.create(
            g(), 3, 3, 4, device=d),
        "AttentionBlock": lambda d: AttentionBlock.create(g(), 3, 4,
                                                          device=d),
        "ParticleEmbedding": lambda d: ParticleEmbedding.create(
            g(), 2, 3, 4, 1, device=d),
        "SplineConditioner": lambda d: SplineConditioner.create(
            g(), 1, 1, num_bins=4, hidden_dim=4, device=d),
        "MaskedSplineConditioner": lambda d: MaskedSplineConditioner.create(
            g(), 2, num_bins=4, hidden_dim=4, device=d),
        "RQSSplineRealNVP": lambda d: RQSSplineRealNVP.create(
            g(), 2, 2, rqs_params=dict(num_bins=4, hidden_dim=4),
            batch_norm=True, device=d),
        "RQSSplineMAF": lambda d: RQSSplineMAF.create(
            g(), 2, 2, rqs_params=dict(num_bins=4, hidden_dim=4),
            batch_norm=True, device=d),
        "BatchNormBijector": lambda d: tbj.BatchNormBijector.create(2,
                                                                    device=d),
        "make_domain_transform": lambda d: tbj.make_domain_transform(
            [(0.0, 1.0)], device=d),
        "AutoregressiveBlockwise": lambda d: AutoregressiveBlockwise.create(
            g(), 2, "normal", device=d),
        "MappingToDistribution": lambda d: MappingToDistribution.create(
            g(), IndependentBlockwise.create(2), 3, device=d),
        "FlowModel": lambda d: FlowModel.create(
            g(), StaticFlowedDistribution(
                RQSSplineMAF.create(g(), 1, 1, rqs_params=dict(
                    num_bins=4, hidden_dim=4), device="cpu"),
                td.Independent(td.Normal(torch.zeros(1), torch.ones(1)),
                               1)), device=d),
    }


def _tensors(obj):
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    return [v for v in vars(obj).values() if torch.is_tensor(v)] + [
        t for v in vars(obj).values() if isinstance(v, (list, tuple))
        for b in v for t in _tensors(b)]


@pytest.mark.parametrize("name", sorted(_creates()))
def test_create_without_a_device_raises_without_a_card(name):
    """With no device, every parameter-allocating create builds on the
    CUDA card; where there is none it raises and names the CPU option
    (never a quiet CPU build).  With device='cpu' it builds here."""
    make = _creates()[name]
    built = make("cpu")
    assert all(not x.is_cuda for x in _tensors(built))
    if torch.cuda.is_available():
        assert all(x.is_cuda for x in _tensors(make(None)))
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make(None)
