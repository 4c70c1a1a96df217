"""The port's score diffusion against the JAX package, on the CPU.

Weights come across with ``convert.from_jax``; JAX's draws are built as
the JAX functions build them from their keys and handed to the port (the
loss's stratified uniforms, permutation and noise; the prior draw; the
SDE's ``fold_in`` normals).  Tolerances, float32: the schedule to 1e-6
relative; ``score`` to 1e-5 of its largest entry (at ``t_min``, where it
divides by sigma ~ 0.0105, too); the DSM loss to 1e-5 relative and its
weight gradients to 1e-4; samples, ``log_prob`` and
``sample_and_log_prob`` at 8-16 steps to 1e-5 of the largest |value| (an
untrained model's samples spread to ~1/alpha(1) ~ 150, and the densities
add a divergence integral over the stiff t -> t_min end); two ``fit``
epochs' losses to 1e-5 and weights to 1e-4.  Inputs come from
``numpy.random.default_rng``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import train as jtrain
from vaemolsim_tpu.flows import Diffusion as JDiffusion
from vaemolsim_tpu.flows import DiffusionLayer as JDiffusionLayer
from vaemolsim_tpu.models import MappingToDistribution as JMapping
from vaemolsim_tpu_torch.convert import from_jax
from vaemolsim_tpu_torch.flows import Diffusion, DiffusionDist, DiffusionLayer
from vaemolsim_tpu_torch.models import MappingToDistribution
from vaemolsim_tpu_torch.train import fit

torch.set_num_threads(1)

D, HIDDEN = 2, (16, 16)


def t(a):
    return torch.as_tensor(np.array(a))


def close(got, want, rtol):
    """|got - want| within rtol of the largest |want|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def randomize_head(model, key, scale=0.05):
    """tests/test_diffusion.py's small random head (a fresh model's head
    is zero, eps = 0)."""
    net = model.eps_net.net
    head = net.head.replace(kernel=scale * jax.random.normal(
        key, net.head.kernel.shape, net.head.kernel.dtype))
    return model.replace(
        eps_net=model.eps_net.replace(net=net.replace(head=head)))


def jmodel(seed=0, cond_dim=0, scale=0.05):
    return randomize_head(
        JDiffusion.create(jax.random.PRNGKey(seed), D, hidden_dim=HIDDEN,
                          n_freqs=3, cond_dim=cond_dim),
        jax.random.PRNGKey(seed + 100), scale)


def loss_draws(key, shape):
    """JAX's Diffusion.loss draws: (u, strata, eps)."""
    k_t, k_e, k_p = jax.random.split(key, 3)
    n = int(np.prod(shape[:-1]))
    u = jax.random.uniform(k_t, (n,), jnp.float32)
    strata = jax.random.permutation(k_p, n).astype(jnp.float32)
    eps = jax.random.normal(k_e, shape, jnp.float32)
    return t(u), t(strata), t(eps)


def sde_draws(key, shape, n_steps):
    """JAX's _sample_sde draws: the prior and each step's fold_in."""
    k_init, k_path = jax.random.split(key)
    x1 = jax.random.normal(k_init, shape)
    noise = jnp.stack([jax.random.normal(jax.random.fold_in(k_path, i),
                                         shape) for i in range(n_steps)])
    return t(x1), t(noise)


def test_schedule_and_score_match_jax():
    jm = jmodel(scale=1.0)
    m = from_jax(jm, "cpu")
    assert isinstance(m, Diffusion) and m.event_dim == D
    ts = np.concatenate([[0.0, 1e-7, 1e-5, 1e-4, m.t_min],
                         np.linspace(m.t_min, 1.0, 33)]).astype(np.float32)
    a, s = m.alpha_sigma(t(ts))
    ja, js = jm.alpha_sigma(jnp.asarray(ts))
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-12)
    assert float(s[1]) > 0.0  # the expm1 form: sigma > 0 just above 0
    np.testing.assert_allclose(m.beta(t(ts)).numpy(),
                               np.asarray(jm.beta(jnp.asarray(ts))),
                               rtol=1e-6)
    x = np.random.default_rng(1).normal(size=(5, D)).astype(np.float32)
    for tt in (0.4, m.t_min, np.linspace(0.1, 0.9, 5).astype(np.float32)):
        with torch.no_grad():
            got = m.score(t(x), t(tt) if isinstance(tt, np.ndarray) else tt)
        close(got, jm.score(jnp.asarray(x), jnp.asarray(tt)), 1e-5)


@pytest.mark.parametrize("batch", [(32,), (4, 8)])
def test_dsm_loss_and_gradients_match_jax(batch):
    jm = jmodel(seed=2)
    m = from_jax(jm, "cpu")
    x0 = np.random.default_rng(3).normal(size=batch + (D,)).astype(
        np.float32)
    key = jax.random.PRNGKey(4)
    u, strata, eps = loss_draws(key, x0.shape)
    loss = m.loss(None, t(x0), u=u, strata=strata, eps=eps)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda mm: mm.loss(key, jnp.asarray(x0))))(jm)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    loss.backward()
    net, jnet = m.eps_net.net, jgrad.eps_net.net
    pairs = [(net.head.kernel.grad, jnet.head.kernel),
             (net.head.bias.grad, jnet.head.bias)]
    pairs += [(a.kernel.grad, b.kernel) for a, b in zip(net.layers,
                                                        jnet.layers)]
    pairs += [(a.bias.grad, b.bias) for a, b in zip(net.layers, jnet.layers)]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)


def test_densities_match_jax():
    jm = jmodel(seed=5)
    m = from_jax(jm, "cpu")
    key = jax.random.PRNGKey(6)
    x1 = t(jax.random.normal(key, (32, D)))
    jx, jlp = jax.jit(lambda k: jm.sample_and_log_prob(k, (32,),
                                                       n_steps=8))(key)
    with torch.no_grad():
        x, lp = m.sample_and_log_prob(None, (32,), n_steps=8, x1=x1)
        back = m.log_prob(t(jx), n_steps=8)
    close(x, jx, 1e-5)
    close(lp, jlp, 1e-5)
    close(back, jax.jit(lambda v: jm.log_prob(v, n_steps=8))(jx), 1e-5)
    # A density through the ODE keeps its graph under grad mode.
    xs = t(np.random.default_rng(7).normal(size=(4, D)).astype(np.float32))
    xs.requires_grad_(True)
    (g,) = torch.autograd.grad(m.log_prob(xs, n_steps=4).sum(), xs)
    jg = jax.jit(jax.grad(lambda v: jnp.sum(jm.log_prob(v, n_steps=4))))(
        jnp.asarray(xs.detach().numpy()))
    close(g, jg, 1e-4)


@pytest.mark.parametrize("method,denoise", [("sde", True), ("sde", False),
                                            ("ode", True)])
def test_samplers_match_jax(method, denoise):
    jm = jmodel(seed=8)
    m = from_jax(jm, "cpu")
    key, n = jax.random.PRNGKey(9), 16
    want = jax.jit(lambda k: jm.sample(k, (48,), n_steps=n, method=method,
                                       denoise_final=denoise))(key)
    if method == "sde":
        x1, noise = sde_draws(key, (48, D), n)
    else:
        x1, noise = t(jax.random.normal(key, (48, D))), None
    with torch.no_grad():
        got = m.sample(None, n_steps=n, method=method,
                       denoise_final=denoise, x1=x1, noise=noise)
    assert got.shape == (48, D)
    close(got, want, 1e-5)
    # From a generator: the same shapes, finite.
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        s = m.sample(g, (3, 5), n_steps=4, method=method)
    assert s.shape == (3, 5, D) and torch.isfinite(s).all()


def test_conditional_layer_in_a_mapping_matches_jax():
    jl = JDiffusionLayer.create(jax.random.PRNGKey(10), D, 4,
                                hidden_dim=HIDDEN, n_freqs=2, n_steps=4)
    jl = jl.replace(model=randomize_head(jl.model, jax.random.PRNGKey(11)))
    jmap = JMapping.create(jax.random.PRNGKey(12), jl, input_shape=3)
    layer = from_jax(jl, "cpu")
    assert isinstance(layer, DiffusionLayer) and layer.params_size() == 4
    m2d = from_jax(jmap, "cpu")
    assert isinstance(m2d, MappingToDistribution)
    rng = np.random.default_rng(13)
    x_in = rng.normal(size=(5, 3)).astype(np.float32)
    target = rng.normal(size=(5, D)).astype(np.float32)
    dist = m2d(t(x_in))
    assert isinstance(dist, DiffusionDist)
    assert dist.batch_shape == (5,) and dist.event_shape == (D,)
    lp = dist.log_prob(t(target))
    jlp = jax.jit(lambda mm: mm(jnp.asarray(x_in)).log_prob(
        jnp.asarray(target)))(jmap)
    close(lp, jlp, 1e-5)
    # The NLL's weight gradients, through the mapping and the ODE.
    (-lp.mean()).backward()
    jg = jax.jit(jax.grad(lambda mm: -jnp.mean(
        mm(jnp.asarray(x_in)).log_prob(jnp.asarray(target)))))(jmap)
    close(m2d.mapping.head.kernel.grad, jg.mapping.head.kernel, 1e-4)
    close(m2d.dist.model.eps_net.net.head.kernel.grad,
          jg.dist.model.eps_net.net.head.kernel, 1e-4)
    # The conditional DSM loss at JAX's draws.
    cond = t(rng.normal(size=(16, 4)).astype(np.float32))
    x0 = rng.normal(size=(16, D)).astype(np.float32)
    key = jax.random.PRNGKey(14)
    got = layer.model.loss(None, t(x0), cond,
                           **dict(zip(("u", "strata", "eps"),
                                      loss_draws(key, x0.shape))))
    want = jl.model.loss(key, jnp.asarray(x0), jnp.asarray(cond.numpy()))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    # The distribution protocol's draws.
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        s = dist.sample(g, (2,))
        x, lpf = dist.sample_and_log_prob(g)
    assert s.shape == (2, 5, D) and x.shape == (5, D) and lpf.shape == (5,)
    assert torch.isfinite(s).all() and torch.isfinite(lpf).all()


def test_unknown_sampling_method_raises():
    m = Diffusion.create(torch.Generator(), 1, hidden_dim=(8,), device="cpu")
    with pytest.raises(ValueError, match="method"):
        m.sample(torch.Generator(), (4,), method="nope")
    # A fresh model predicts eps = 0 exactly (the zero head).
    with torch.no_grad():
        assert float(m.eps_net(torch.ones(3, 1), 0.5).abs().max()) == 0.0


def test_fit_steps_match_jax():
    """Two epochs of one full batch, unshuffled, on the DSM loss at fixed
    draws: each epoch's loss to 1e-5 and the weights to 1e-4."""
    jm = jmodel(seed=15)
    m = from_jax(jm, "cpu")
    x0 = np.random.default_rng(16).normal(size=(64, D)).astype(np.float32)
    u, strata, eps = loss_draws(jax.random.PRNGKey(17), x0.shape)
    ju, jstrata, jeps = (jnp.asarray(a.numpy()) for a in (u, strata, eps))

    def jdsm(mm, b):
        tt = mm.t_min + (1.0 - mm.t_min) * (jstrata + ju) / b.shape[0]
        alpha, sigma = mm.alpha_sigma(tt)
        xt = alpha[:, None] * b + sigma[:, None] * jeps
        return jnp.mean(jnp.sum((mm.eps_net(xt, tt) - jeps) ** 2, -1))

    kw = dict(num_epochs=2, batch_size=64, learning_rate=1e-2,
              shuffle=False)
    jm, jhist = jtrain.fit(jm, lambda mm, b, k: jdsm(mm, b),
                           jnp.asarray(x0), key=jax.random.PRNGKey(0), **kw)
    m, hist = fit(m, lambda mm, b, g: mm.loss(g, b, u=u, strata=strata,
                                              eps=eps),
                  t(x0), generator=torch.Generator(), **kw)
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-5)
    np.testing.assert_allclose(
        m.eps_net.net.head.kernel.detach().numpy(),
        np.asarray(jm.eps_net.net.head.kernel), atol=1e-4)
    assert hist["loss"][1] < hist["loss"][0]
