"""The port's VAMPnets against the JAX package's on the CPU, on
numpy-seeded transition pairs (a 3-state chain embedded in 2-D with
Gaussian noise): VAMP-2 and VAMP-1 scores, Koopman singular values,
implied timescales and the Koopman matrix to rtol 1e-4; the loss gradient
with respect to every lobe weight to 1e-4 of the largest gradient entry
over all weights (float32 whitening leaves ~4e-5 of it; in float64 the
two agree to 1e-13), through ``convert.from_jax``, for a softmax lobe
(whose mean-free features have an exact null direction, trimmed by the
pseudo-inverse) and an unconstrained one; and a few ``train.fit`` epochs giving JAX ``fit``'s
losses to rtol 1e-3.  float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import vamp as jvamp
from vaemolsim_tpu.train import fit as jfit
from vaemolsim_tpu_torch import vamp
from vaemolsim_tpu_torch.convert import from_jax
from vaemolsim_tpu_torch.train import fit

torch.set_num_threads(1)

T3 = np.array([[0.90, 0.08, 0.02],
               [0.16, 0.80, 0.04],
               [0.08, 0.08, 0.84]])
MEANS = np.array([[-1.0, 0.0], [1.0, 0.0], [0.0, 1.5]])


def pairs(seed, n_steps=1500, n_traj=4, lag=2):
    """Lagged pairs of the chain's 2-D emissions (numpy draws)."""
    rng = np.random.default_rng(seed)
    cum = np.cumsum(T3, 1)
    s = np.zeros(n_traj, np.int64)
    x = np.empty((n_traj, n_steps, 2))
    for k in range(n_steps):
        s = np.minimum((rng.random(n_traj)[:, None] > cum[s]).sum(1), 2)
        x[:, k] = MEANS[s] + 0.35 * rng.normal(size=(n_traj, 2))
    x = x.astype(np.float32)
    j0, jt = jvamp.lagged_pairs(jnp.asarray(x), lag)
    p0, pt = vamp.lagged_pairs(torch.as_tensor(x), lag)
    np.testing.assert_array_equal(p0.numpy(), np.asarray(j0))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    return np.asarray(j0), np.asarray(jt)


@pytest.fixture(scope="module")
def data():
    return pairs(0)


def t(a):
    return torch.as_tensor(np.array(a))


def close(got, want, rtol=1e-4, atol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("softmax", [True, False])
def test_scores_and_spectra_match_jax(data, softmax):
    x0, xt = data
    jnet = jvamp.VAMPNet.create(jax.random.PRNGKey(1), in_dim=2, k=3,
                                hidden_dims=(16, 16), softmax=softmax)
    net = from_jax(jnet, "cpu")
    assert isinstance(net, vamp.VAMPNet) and net.softmax == softmax
    close(net(t(x0)), jnet(jnp.asarray(x0)), 1e-5)
    chi0, chit = net(t(x0)), net(t(xt))
    jchi0, jchit = jnet(jnp.asarray(x0)), jnet(jnp.asarray(xt))
    for method in ("vamp2", "vamp1"):
        close(vamp.vamp_score(chi0, chit, method=method),
              jvamp.vamp_score(jchi0, jchit, method=method))
    sv = net.singular_values(t(x0), t(xt))
    close(sv, jnet.singular_values(jnp.asarray(x0), jnp.asarray(xt)))
    close(vamp.vamp_timescales(sv, 2.0),
          jvamp.vamp_timescales(jnp.asarray(sv.detach().numpy()), 2.0))
    close(net.koopman_matrix(t(x0), t(xt)),
          jnet.koopman_matrix(jnp.asarray(x0), jnp.asarray(xt)), 1e-4, 1e-5)
    with pytest.raises(ValueError, match="unknown VAMP"):
        vamp.vamp_score(chi0, chit, method="vamp3")


@pytest.mark.parametrize("softmax", [True, False])
def test_loss_gradient_matches_jax(data, softmax):
    """Every lobe weight's gradient of the negative VAMP-2 score.  With
    softmax the feature covariances carry an exact null direction: the
    trimmed, where-guarded inverse square root keeps it finite in both."""
    x0, xt = data
    jnet = jvamp.VAMPNet.create(jax.random.PRNGKey(2), in_dim=2, k=3,
                                hidden_dims=(16, 16), softmax=softmax)
    net = from_jax(jnet, "cpu")
    jloss, jgrad = jax.value_and_grad(
        lambda m: m.loss(jnp.asarray(x0), jnp.asarray(xt)))(jnet)
    loss = net.loss(t(x0), t(xt))
    loss.backward()
    close(loss, jloss, 1e-5)
    pairs_ = [(got, want) for layer, jlayer in zip(net.lobe.layers,
                                                   jgrad.lobe.layers)
              for got, want in ((layer.kernel.grad, jlayer.kernel),
                                (layer.bias.grad, jlayer.bias))]
    scale = max(float(np.abs(want).max()) for _, want in pairs_)
    for got, want in pairs_:
        assert torch.isfinite(got).all()
        close(got, want, 1e-4, 1e-4 * scale)


def test_exact_null_direction_is_trimmed():
    """Features whose third column is the negated sum of the others
    (rank 2 mean-free, as softmax memberships): the pseudo-inverse projects
    the null direction out, so the score stays at most 1 + rank."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(2000, 2)).astype(np.float32)
    b = (0.8 * a + 0.6 * rng.normal(size=(2000, 2))).astype(np.float32)
    a3 = np.concatenate([a, -a.sum(1, keepdims=True)], 1)
    b3 = np.concatenate([b, -b.sum(1, keepdims=True)], 1)
    got = vamp.vamp_score(t(a3), t(b3))
    close(got, jvamp.vamp_score(jnp.asarray(a3), jnp.asarray(b3)))
    assert float(got) < 3.0
    with pytest.raises(ValueError, match="matching"):
        vamp.vamp_score(t(a3), t(b))


def test_fit_losses_match_jax(data):
    """Three full-batch Adam epochs at lr 3e-3 without shuffling."""
    x0, xt = data
    jnet = jvamp.VAMPNet.create(jax.random.PRNGKey(3), in_dim=2, k=3,
                                hidden_dims=(16, 16))
    net = from_jax(jnet, "cpu")
    kw = dict(num_epochs=3, batch_size=len(x0), learning_rate=3e-3,
              shuffle=False)
    _, jhist = jfit(jnet, lambda m, b, k: m.loss(*b),
                    (jnp.asarray(x0), jnp.asarray(xt)),
                    key=jax.random.PRNGKey(4), **kw)
    _, hist = fit(net, lambda m, b, g: m.loss(*b), (t(x0), t(xt)),
                  generator=torch.Generator().manual_seed(4), **kw)
    np.testing.assert_allclose(np.asarray(hist["loss"], np.float64),
                               np.asarray(jhist["loss"], np.float64),
                               rtol=1e-3)


def test_create_on_the_cpu_and_bad_lag():
    net = vamp.VAMPNet.create(torch.Generator().manual_seed(0), 2, 4,
                              hidden_dims=(8,), device="cpu")
    y = net(torch.zeros(5, 2))
    assert y.shape == (5, 4)
    torch.testing.assert_close(y.sum(-1), torch.ones(5))
    with pytest.raises(ValueError, match="lag"):
        vamp.lagged_pairs(torch.zeros(10, 2), 10)
