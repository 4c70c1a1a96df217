"""The port's RealNVP flow family, its config and the analytic mixture
distributions against the JAX package, on the CPU.

A JAX ``RQSSplineRealNVP`` (2 blocks, hidden 16, 8 bins on [-4, 4]) is
built, its weights doubled and its biases shifted so that the bins have
contrast, and carried to the port by ``convert.from_jax``.  The JAX side
runs its plain XLA references on the CPU (the dense stack and the RQS
spline), as its own tests do.  Inputs are made from a seed with numpy.
Float32 throughout; tolerances are stated with each test.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import knot_safe
from vaemolsim_tpu import config as jcfg
from vaemolsim_tpu.dists import StaticFlowedDistribution as JStatic
from vaemolsim_tpu.flows import RQSSplineRealNVP as JRealNVP
from vaemolsim_tpu.models import FlowModel as JFlowModel
from vaemolsim_tpu.ops import distributions as jd
from vaemolsim_tpu_torch import config as tcfg
from vaemolsim_tpu_torch.convert import from_jax
from vaemolsim_tpu_torch.flows import CouplingLayer, RQSSplineRealNVP
from vaemolsim_tpu_torch.ops import fused_mlp

torch.set_num_threads(1)

K, HIDDEN, BLOCKS = 8, 16, 2
RQS = {"num_bins": K, "hidden_dim": HIDDEN, "bin_range": [-4.0, 4.0]}
DIMS = [1, 2, 3, 5]


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def jax_flow(d, seed=0):
    flow = JRealNVP.create(jax.random.PRNGKey(seed), d, num_blocks=BLOCKS,
                           rqs_params=RQS)
    rng = np.random.default_rng(seed)

    def contrast(a):
        a = np.asarray(a, np.float32)
        return jnp.asarray(2.0 * a + 0.1 * rng.normal(size=a.shape)
                           .astype(np.float32))

    return jax.tree_util.tree_map(contrast, flow)


def jax_model(d, seed=0):
    base = jd.Independent(jd.Normal(jnp.zeros(d), jnp.ones(d)), 1)
    return JFlowModel.create(jax.random.PRNGKey(seed + 1),
                             JStatic(flow=jax_flow(d, seed), base=base))


def rows(d, n=96, seed=1):
    rng = np.random.default_rng(100 + seed + d)
    # 2.2 standard deviations reach both identity tails of [-4, 4].
    return (2.2 * rng.normal(size=(n, d))).astype(np.float32)


def safe(flow, y, inverse=True):
    """Rows away from every knot in every block of the given direction
    (chip_smoke.knot_safe's rule): a row that roundoff moves across a
    knot changes the bin parameters' gradient by O(1)."""
    blocks = list(flow.blocks)
    keep = knot_safe(reversed(blocks) if inverse else blocks, t(y),
                     inverse=inverse)
    assert keep.float().mean() > 0.8
    return y[keep.numpy()]


@pytest.mark.parametrize("d", DIMS)
def test_realnvp_transforms_match_jax(d):
    """Forward, inverse and both log-dets through the whole chain: values
    to 1e-5 absolute and relative; log-dets to 5e-5 absolute and 1e-5
    relative.  The conditioners' outputs differ by an ulp (XLA's and
    MKL's orders of summation), which a narrow bin's log-derivative
    amplifies by 1/width: 2e-5 at d = 5 here."""
    jflow = jax_flow(d)
    flow = from_jax(jflow, "cpu")
    assert isinstance(flow, RQSSplineRealNVP)
    assert [b.num_masked for b in flow.blocks] == \
        [b.num_masked for b in jflow.blocks]
    x = rows(d)
    for inverse in (False, True):
        xs = safe(flow, x, inverse)
        jb, tb = jflow.as_bijector(), flow.as_bijector()
        jfn = jb.inverse_and_log_det if inverse else jb.forward_and_log_det
        tfn = tb.inverse_and_log_det if inverse else tb.forward_and_log_det
        jy, jl = jfn(jnp.asarray(xs))
        with torch.no_grad():
            ty, tl = tfn(t(xs))
        torch.testing.assert_close(ty, t(jy), atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(tl, t(jl), atol=5e-5, rtol=1e-5)


@pytest.mark.parametrize("d", DIMS)
def test_realnvp_mask_rule_matches_jax(d):
    """Even blocks condition on the first floor(d/2) DOFs, odd blocks on
    the last ceil(d/2) (a negative num_masked); d = 1 masks nothing."""
    g = torch.Generator().manual_seed(0)
    flow = RQSSplineRealNVP.create(g, d, num_blocks=4, rqs_params=RQS,
                                   device="cpu")
    jflow = JRealNVP.create(jax.random.PRNGKey(0), d, num_blocks=4,
                            rqs_params=RQS)
    for b, jb in zip(flow.blocks, jflow.blocks):
        assert b.num_masked == jb.num_masked
        assert b.conditioner.data_dim == jb.conditioner.data_dim
        assert tuple(b.conditioner.trunk.kernel.shape) == \
            tuple(jb.conditioner.trunk.kernel.shape)


@pytest.mark.parametrize("d", DIMS)
def test_realnvp_flow_model_log_prob_and_gradients_match_jax(d):
    """FlowModel.log_prob and every parameter's gradient of the mean NLL,
    on knot-safe rows: 1e-5 absolute and relative (gradients are sums
    over 96 rows in another order: still within 1e-5 here)."""
    jm = jax_model(d)
    model = from_jax(jm, "cpu")
    x = safe(model.flowed_dist.flow, rows(d))
    jlp = jm.log_prob(jnp.asarray(x))
    tx = t(x)
    tlp = model.log_prob(tx)
    torch.testing.assert_close(tlp.detach(), t(jlp), atol=1e-5, rtol=1e-5)

    def jloss(flow):
        m = jm.replace(flowed_dist=jm.flowed_dist.replace(flow=flow))
        return -jnp.mean(m.log_prob(jnp.asarray(x)))

    jg = jax.grad(jloss)(jm.flowed_dist.flow)
    flow = model.flowed_dist.flow
    params, want = [], []
    for b, jb in zip(flow.blocks, jg.blocks):
        for name in ("trunk", "w_head", "h_head", "s_head"):
            for leaf in ("kernel", "bias"):
                params.append(getattr(getattr(b.conditioner, name), leaf))
                want.append(getattr(getattr(jb.conditioner, name), leaf))
    got = torch.autograd.grad(-tlp.mean(), params)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, t(w_), atol=1e-5, rtol=1e-5)


def test_one_d_conditioner_runs_on_one_row(monkeypatch):
    """The 1-D coupling block's conditioner sees a zero-width input: it
    runs on ONE (ones) row and the spline broadcasts it over the batch,
    in both directions."""
    seen = []
    real = fused_mlp.fused_dense_stack

    def spy(x, *a, **kw):
        seen.append(tuple(x.shape))
        return real(x, *a, **kw)

    monkeypatch.setattr(fused_mlp, "fused_dense_stack", spy)
    flow = from_jax(jax_flow(1), "cpu")
    with torch.no_grad():
        flow.as_bijector().forward_and_log_det(torch.zeros(500, 1))
        flow.as_bijector().inverse_and_log_det(torch.zeros(500, 1))
    assert seen == [(1, 1)] * (2 * BLOCKS)
    seen.clear()
    flow2 = from_jax(jax_flow(2), "cpu")
    with torch.no_grad():
        flow2.as_bijector().forward_and_log_det(torch.zeros(500, 2))
    assert seen == [(500, 1)] * BLOCKS


def test_realnvp_config_builds_and_round_trips(tmp_path):
    """RealNVPConfig builds RQSSplineRealNVP with the coupling kwargs and
    round-trips through the tagged JSON of both packages."""
    cfg = tcfg.ExperimentConfig(model=tcfg.FlowModelConfig(
        tcfg.FlowedDistConfig(
            tcfg.RealNVPConfig(data_dim=3, num_blocks=3, rqs=tcfg.RQSParams(
                num_bins=K, hidden_dim=HIDDEN, bin_range=(-4.0, 4.0))),
            base=None, static_base_dim=3)))
    path = tmp_path / "cfg.json"
    tcfg.save_json(cfg, str(path))
    assert tcfg.load_json(str(path)) == cfg
    jback = jcfg.load_json(str(path))
    assert isinstance(jback.model.flowed_dist.flow, jcfg.RealNVPConfig)
    jcfg.save_json(jback, str(path))
    assert tcfg.load_json(str(path)) == cfg
    model = cfg.build("cpu")
    flow = model.flowed_dist.flow
    assert isinstance(flow, RQSSplineRealNVP) and len(flow.blocks) == 3
    assert all(isinstance(b, CouplingLayer) for b in flow.blocks)
    assert [b.num_masked for b in flow.blocks] == [1, -2, 1]
    lp = model.log_prob(torch.zeros(4, 3))
    assert lp.shape == (4,) and bool(torch.isfinite(lp).all())
    assert json.loads(path.read_text())["model"]["flowed_dist"]["flow"][
        "__config__"] == "RealNVPConfig"


def test_realnvp_refuses_what_is_not_ported():
    with pytest.raises(ValueError, match="never conditional"):
        tcfg.RQSParams(conditional=True,
                       conditional_event_shape=2).asdict(coupling=True)
    assert "conditional" not in tcfg.RQSParams().asdict(coupling=True)
    # Batch norm between blocks is ported: one bijector between each
    # pair of blocks (tests/test_torch_batchnorm.py holds it to JAX).
    flow = tcfg.RealNVPConfig(data_dim=2, num_blocks=3,
                              batch_norm=True).build(torch.Generator(),
                                                     "cpu")
    assert len(flow.bn_params) == 2


def test_categorical_log_prob_and_sampling_match_jax():
    """log_prob against JAX at 1e-6; sample frequencies within 5 sigma
    of the probabilities (200k draws)."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(3, 5)).astype(np.float32)
    x = rng.integers(0, 5, size=(7, 3))
    jc = jd.Categorical(jnp.asarray(logits))
    tc = from_jax(jc, "cpu")
    assert tc.batch_shape == (3,) and tc.num_categories == 5
    want = np.stack([np.asarray(jc.log_prob(jnp.asarray(row)))
                     for row in x])
    torch.testing.assert_close(tc.log_prob(torch.tensor(x)), t(want),
                               atol=1e-6, rtol=1e-6)
    n = 200_000
    s = tc.sample(torch.Generator().manual_seed(0), (n,))
    assert s.shape == (n, 3) and s.dtype == torch.int64
    p = torch.softmax(t(logits), -1)
    freq = torch.stack([(s == k).double().mean(0) for k in range(5)], -1)
    sigma = torch.sqrt(p * (1 - p) / n)
    assert bool(((freq - p).abs() < 5 * sigma).all())


@pytest.mark.parametrize("event", ["scalar", "vector"])
def test_mixture_log_prob_and_sampling_match_jax(event):
    """Scalar-event (Normal) and vector-event (Independent Normal, locs
    (K, 2)) components: log_prob against JAX at 1e-6 absolute and
    relative; the sample's component shares and means within 5 sigma."""
    rng = np.random.default_rng(4)
    logits = np.array([0.3, -0.2, 0.5], np.float32)
    locs = np.array([-3.0, 0.0, 3.0], np.float32)
    if event == "scalar":
        comp = jd.Normal(jnp.asarray(locs), 0.4 * jnp.ones(3))
        x = rng.normal(scale=3.0, size=(50,)).astype(np.float32)
    else:
        locs = np.stack([locs, -locs], -1)
        comp = jd.Independent(jd.Normal(jnp.asarray(locs),
                                        0.4 * jnp.ones((3, 2))), 1)
        x = rng.normal(scale=3.0, size=(50, 2)).astype(np.float32)
    jm = jd.MixtureSameFamily(jnp.asarray(logits), comp)
    tm = from_jax(jm, "cpu")
    assert tm.event_shape == tuple(jm.event_shape)
    torch.testing.assert_close(tm.log_prob(t(x)),
                               t(jm.log_prob(jnp.asarray(x))), atol=1e-6,
                               rtol=1e-6)
    n = 200_000
    s = tm.sample(torch.Generator().manual_seed(1), (n,))
    assert s.shape == (n,) + tuple(jm.event_shape)
    first = (s if event == "scalar" else s[:, 0]).contiguous()
    label = torch.bucketize(first, torch.tensor([-1.5, 1.5]))
    p = torch.softmax(t(logits), -1).double()
    for k in range(3):
        share = (label == k).double().mean()
        assert abs(share - p[k]) < 5 * torch.sqrt(p[k] * (1 - p[k]) / n)
        mean = s[label == k].double().mean(0)
        se = 0.4 / torch.sqrt((label == k).double().sum())
        assert bool(((mean - torch.tensor(locs[k]).double()).abs()
                     < 5 * se).all())
