"""The port's flow matching against the JAX package, on the CPU.

Weights come across with ``convert.from_jax``.  The velocity field to
1e-5; the CFM loss at handed-in ``t`` and base draws to 1e-5 and its
weight gradients to 1e-4; ``sample``, ``sample_and_log_prob`` and
``log_prob`` at ``n_steps=8`` to 1e-4 with the exact divergence (JAX's d
JVPs against the port's stacked copies and one gradient); and two Adam
steps through ``train.fit`` on a fixed-draw loss, losses to 1e-5 and
weights to 1e-4.  Inputs come from ``numpy.random.default_rng``;
float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import train as jtrain
from vaemolsim_tpu.flows import FlowMatching as JFlowMatching
from vaemolsim_tpu.flows import FlowMatchingLayer as JFlowMatchingLayer
from vaemolsim_tpu.flows.flow_matching import _divergence as jdivergence
from vaemolsim_tpu_torch.convert import from_jax
from vaemolsim_tpu_torch.flows import (FlowMatching, FlowMatchingDist,
                                       FlowMatchingLayer, VelocityField)
from vaemolsim_tpu_torch.flows.flow_matching import _divergence
from vaemolsim_tpu_torch.train import fit

torch.set_num_threads(1)

D, HIDDEN = 3, (24, 24)


def t(a):
    return torch.as_tensor(np.array(a))


def jmodel(cond_dim=0, seed=0):
    return JFlowMatching.create(jax.random.PRNGKey(seed), D,
                                hidden_dim=HIDDEN, n_freqs=3,
                                cond_dim=cond_dim)


def inputs(n, seed, cond_dim=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, D)).astype(np.float32)
    tt = rng.uniform(size=(n,)).astype(np.float32)
    c = rng.normal(size=(n, cond_dim)).astype(np.float32)
    return x, tt, c


def jcfm(model, x1, tt, x0, cond=None):
    """JAX's CFM loss with its draws handed in (FlowMatching.loss draws
    them from its key)."""
    a = 1.0 - (1.0 - model.sigma_min) * tt[..., None]
    xt = a * x0 + tt[..., None] * x1
    u = x1 - (1.0 - model.sigma_min) * x0
    v = model.velocity(xt, tt, cond)
    return jnp.mean(jnp.sum((v - u) ** 2, axis=-1))


@pytest.mark.parametrize("cond_dim", [0, 2])
def test_velocity_field_and_divergence_match_jax(cond_dim):
    jm = jmodel(cond_dim)
    m = from_jax(jm, "cpu")
    assert isinstance(m, FlowMatching)
    assert isinstance(m.velocity, VelocityField)
    x, tt, c = inputs(16, 1, cond_dim)
    jc, tc = (jnp.asarray(c), t(c)) if cond_dim else (None, None)
    with torch.no_grad():
        got = m.velocity(t(x), t(tt), tc)
    want = jm.velocity(jnp.asarray(x), jnp.asarray(tt), jc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    v, div = _divergence(lambda xs: m.velocity(xs, t(tt), tc), t(x))
    jv, jdiv = jdivergence(lambda xs: jm.velocity(xs, jnp.asarray(tt), jc),
                           jnp.asarray(x))
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(jv),
                               atol=1e-5)
    np.testing.assert_allclose(div.detach().numpy(), np.asarray(jdiv),
                               atol=1e-5)


def test_cfm_loss_and_gradients_match_jax():
    jm = jmodel(seed=2)
    m = from_jax(jm, "cpu")
    x1, tt, _ = inputs(64, 3)
    x0 = np.random.default_rng(4).normal(size=x1.shape).astype(np.float32)
    loss = m.loss(None, t(x1), t=t(tt), x0=t(x0))
    jloss, jgrad = jax.value_and_grad(jcfm)(jm, jnp.asarray(x1),
                                            jnp.asarray(tt),
                                            jnp.asarray(x0))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    loss.backward()
    net, jnet = m.velocity.net, jgrad.velocity.net
    pairs = [(net.head.kernel.grad, jnet.head.kernel),
             (net.head.bias.grad, jnet.head.bias)]
    pairs += [(a.kernel.grad, b.kernel)
              for a, b in zip(net.layers, jnet.layers)]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)


def test_sample_and_log_prob_match_jax():
    jm = jmodel(seed=5)
    m = from_jax(jm, "cpu")
    key = jax.random.PRNGKey(6)
    x0 = jax.random.normal(key, (32, D))
    want = jm.sample(key, (32,), n_steps=8)
    jx1, jlp = jm.sample_and_log_prob(key, (32,), n_steps=8)
    with torch.no_grad():
        got = m.sample(None, (32,), n_steps=8, x0=t(x0))
        x1, lp = m.sample_and_log_prob(None, (32,), n_steps=8, x0=t(x0))
        back = m.log_prob(x1, n_steps=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(x1.numpy(), np.asarray(jx1), atol=1e-4)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-4)
    jback = jm.log_prob(jx1, n_steps=8)
    np.testing.assert_allclose(back.numpy(), np.asarray(jback), atol=1e-4)
    # RK4 at 8 steps runs the ODE back close to where it started.
    np.testing.assert_allclose(back.numpy(), lp.numpy(), atol=5e-2)


def test_layer_and_distribution_match_jax():
    jl = JFlowMatchingLayer.create(jax.random.PRNGKey(7), D, 2,
                                   hidden_dim=HIDDEN, n_freqs=2, n_steps=6)
    layer = from_jax(jl, "cpu")
    assert isinstance(layer, FlowMatchingLayer)
    assert layer.params_size() == 2
    x, _, c = inputs(8, 8, 2)
    dist = layer(t(c))
    assert isinstance(dist, FlowMatchingDist)
    assert dist.batch_shape == (8,) and dist.event_shape == (D,)
    with torch.no_grad():
        got = dist.log_prob(t(x))
    want = jl(jnp.asarray(c)).log_prob(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    s = dist.sample(torch.Generator().manual_seed(0), (2,))
    assert s.shape == (2, 8, D) and torch.isfinite(s).all()


def test_fit_steps_match_jax():
    """Two epochs of one full batch, unshuffled, on the CFM loss at fixed
    t and base draws: each epoch's loss to 1e-5 and the weights to
    1e-4."""
    jm = jmodel(seed=9)
    m = from_jax(jm, "cpu")
    x1, tt, _ = inputs(128, 10)
    x0 = np.random.default_rng(11).normal(size=x1.shape).astype(np.float32)
    jt, jx0 = jnp.asarray(tt), jnp.asarray(x0)
    kw = dict(num_epochs=2, batch_size=128, learning_rate=1e-2,
              shuffle=False)
    jm, jhist = jtrain.fit(jm, lambda mm, b, k: jcfm(mm, b, jt, jx0),
                           jnp.asarray(x1), key=jax.random.PRNGKey(0), **kw)
    m, hist = fit(m, lambda mm, b, g: mm.loss(g, b, t=t(tt), x0=t(x0)),
                  t(x1), generator=torch.Generator(), **kw)
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-5)
    np.testing.assert_allclose(
        m.velocity.net.head.kernel.detach().numpy(),
        np.asarray(jm.velocity.net.head.kernel), atol=1e-4)
    xs, ts, _ = inputs(16, 12)
    with torch.no_grad():
        got = m.velocity(t(xs), t(ts))
    want = jm.velocity(jnp.asarray(xs), jnp.asarray(ts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert hist["loss"][1] < hist["loss"][0]
