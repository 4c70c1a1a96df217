"""The port's dual-ELBO VAE, Hamiltonian VAE bound and CG maps against
the JAX package, on the CPU.

A small flagship-shaped VAE (normal encoder 2 -> 16 -> 1 and decoder
1 -> 16 -> 2, a 2-block 1-D RQS-spline MAF prior with 8 bins) is built
by the JAX config and carried across by ``from_jax(..., "cpu")``.  The
port is fed JAX's own draws: the dual pass's three samples, and the
HVAE's encoder normals and momenta split from the key as the JAX loss
splits it.  Float32: values to 1e-5 and gradients to 1e-4 (absolute and
relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import config as jconfig
from vaemolsim_tpu.nn import CGCenterOfMass as JCGCenterOfMass
from vaemolsim_tpu.nn import CGCentroid as JCGCentroid
from vaemolsim_tpu_torch import config as tconfig
from vaemolsim_tpu_torch.convert import from_jax
from vaemolsim_tpu_torch.models import VAE, VAEDualELBO
from vaemolsim_tpu_torch.nn import CGCenterOfMass, CGCentroid

torch.set_num_threads(1)

VAL = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def close(got, want, tol=VAL, msg=""):
    got, want = (a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
                 for a in (got, want))
    np.testing.assert_allclose(got, want, err_msg=msg, **tol)


def vae_config(module, dual, reverse_weight=1.0, forward_kind="kl"):
    c = module
    return c.VAEConfig(
        encoder=c.MappingToDistConfig(
            input_shape=2, dist=c.DistLayerConfig(num_dofs=1),
            mapping_kwargs={"hidden_dim": 16}),
        decoder=c.MappingToDistConfig(
            input_shape=1, dist=c.DistLayerConfig(num_dofs=2),
            mapping_kwargs={"hidden_dim": 16}),
        prior=c.FlowedDistConfig(
            flow=c.MAFConfig(data_dim=1, num_blocks=2, rqs=c.RQSParams(
                num_bins=8, hidden_dim=16, bin_range=(-5.0, 5.0))),
            static_base_dim=1),
        regularizer=c.RegularizerConfig(kind=forward_kind, weight=0.7),
        dual_elbo=dual,
        reverse_regularizer=(c.RegularizerConfig(kind="reverse_kl",
                                                 weight=reverse_weight)
                             if dual else None))


def perturbed(model, seed):
    """Every weight and bias nudged so that biases are non-zero and the
    splines have contrast."""
    leaves, tree = jax.tree_util.tree_flatten(model)
    rng = np.random.default_rng(seed)
    leaves = [leaf + 0.1 * rng.normal(size=leaf.shape).astype(np.float32)
              if hasattr(leaf, "ndim") and leaf.ndim >= 1
              and leaf.dtype == jnp.float32 else leaf for leaf in leaves]
    return jax.tree_util.tree_unflatten(tree, leaves)


def data(n, seed):
    rng = np.random.default_rng(seed)
    return (np.where(rng.random((n, 2)) < 0.5, -1.0, 1.0)
            + 0.5 * rng.normal(size=(n, 2))).astype(np.float32)


def potential(x):
    return 0.5 * (x ** 2).sum(-1)


# ---------------------------------------------------------------------------
# Dual ELBO
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reverse_weight", [1.0, 0.0])
def test_dual_elbo_terms_match_jax_at_jax_draws(reverse_weight):
    """Every field of the dual output and every metric of the loss,
    with the port fed the encoder, prior and decoder draws JAX made; a
    zero reverse weight gives a zero unweighted reverse KL."""
    jvae = perturbed(vae_config(jconfig, True, reverse_weight).build(
        jax.random.PRNGKey(0)), 1)
    tvae = from_jax(jvae, "cpu")
    assert isinstance(tvae, VAEDualELBO)
    x = data(48, 2)
    key = jax.random.PRNGKey(3)
    jout = jvae(j(x), key, train=True)
    draws = {"encode": t(jout.encode_sample), "prior": t(jout.prior_sample),
             "decode": t(jout.decode_sample)}
    seen = []

    def draw(role, dist):
        seen.append((role, tuple(dist.batch_shape)))
        return draws[role]

    tout = tvae._dual_pass(t(x), True, draw)
    assert [r for r, _ in seen] == ["encode", "prior", "decode"]
    # The static prior has no batch axis: JAX drew one latent per row.
    assert seen[1][1] == () and draws["prior"].shape == (48, 1)
    for name in ("regularizer_loss_forward", "regularizer_loss_reverse",
                 "kl_div_forward", "kl_div_reverse"):
        close(getattr(tout, name), getattr(jout, name), msg=name)
    if reverse_weight == 0.0:
        assert float(tout.kl_div_reverse) == 0.0
    close(tout.decode_dist_forward.log_prob(t(x)),
          jout.decode_dist_forward.log_prob(j(x)))
    close(tout.decode_dist_reverse.log_prob(draws["decode"]),
          jout.decode_dist_reverse.log_prob(jout.decode_sample))
    tloss, tmet = VAEDualELBO._dual_loss(t(x), tout, potential)
    jloss, jmet = jvae.dual_elbo_loss(j(x), key, potential)
    close(tloss, jloss)
    assert set(tmet) == set(jmet)
    for name in jmet:
        close(tmet[name], jmet[name], msg=name)


def test_dual_elbo_loss_runs_with_its_own_draws_and_trains():
    """dual_elbo_loss with the port's generator: finite, a gradient for
    every parameter, and the reverse latents one per input row."""
    tvae = vae_config(tconfig, True).build(torch.Generator().manual_seed(4),
                                           "cpu")
    x = t(data(64, 5))
    gen = torch.Generator().manual_seed(6)
    out = tvae(x, gen, train=True)
    assert out.prior_sample.shape == (64, 1)
    assert out.decode_sample.shape == (64, 2)
    loss, metrics = tvae.dual_elbo_loss(x, gen, potential)
    assert bool(torch.isfinite(loss))
    grads = torch.autograd.grad(loss, list(tvae.parameters()),
                                allow_unused=True)
    assert all(g is not None and bool(torch.isfinite(g).all())
               for g in grads)
    with torch.no_grad():
        assert bool(torch.isfinite(tvae.dual_elbo_loss(x, gen,
                                                       potential)[0]))


def test_vae_config_dual_elbo_builds_on_cpu():
    """VAEConfig(dual_elbo=True).build: a VAEDualELBO with the forward
    regularizer and the reverse one (reverse KL by default), the same
    state as JAX's build."""
    cfg = vae_config(tconfig, True, reverse_weight=0.3)
    tvae = cfg.build(torch.Generator().manual_seed(0), "cpu")
    assert isinstance(tvae, VAEDualELBO)
    assert type(tvae.regularizer_forward).__name__ == "KLDivergenceEstimate"
    assert tvae.regularizer_forward.weight == 0.7
    assert type(tvae.regularizer_reverse).__name__ == \
        "ReverseKLDivergenceEstimate"
    assert tvae.regularizer_reverse.weight == 0.3
    cfg.reverse_regularizer = None
    assert tvae.regularizer_reverse.sample_dist == "dist_b"
    assert type(cfg.build(torch.Generator(), "cpu").regularizer_reverse
                ).__name__ == "ReverseKLDivergenceEstimate"
    jvae = vae_config(jconfig, True, 0.3).build(jax.random.PRNGKey(0))
    assert ({k: tuple(v.shape) for k, v in tvae.state_dict().items()}
            == {k: tuple(v.shape) for k, v in
                from_jax(jvae, "cpu").state_dict().items()})
    exp = tconfig.ExperimentConfig(model=vae_config(tconfig, True))
    again = tconfig.from_dict(None, tconfig.to_tagged_dict(exp))
    assert again.model.dual_elbo and isinstance(again.build("cpu"),
                                                VAEDualELBO)


# ---------------------------------------------------------------------------
# Hamiltonian VAE
# ---------------------------------------------------------------------------


def jax_draws(jvae, x, key):
    """The encoder normals and momenta JAX's hvae_elbo_loss draws from
    ``key``: z0 = loc + scale * eps, rho0 ~ N(0, I)."""
    k_enc, k_mom = jax.random.split(key)
    fam = jvae.encoder(j(x), train=True).families[0]
    eps = jax.random.normal(jax.random.split(k_enc, 1)[0], fam.loc.shape)
    z0 = jvae.encoder(j(x), train=True).sample(k_enc)
    np.testing.assert_array_equal(np.asarray(fam.loc + fam.scale * eps),
                                  np.asarray(z0))
    return np.asarray(eps), np.asarray(jax.random.normal(k_mom, z0.shape))


@pytest.mark.parametrize("n_leapfrog", [0, 5])
def test_hvae_bound_and_gradients_match_jax(n_leapfrog):
    """The bound, its metrics and every parameter's gradient at JAX's
    draws (the gradient through the leapfrog's inner gradients)."""
    jvae = perturbed(vae_config(jconfig, False).build(
        jax.random.PRNGKey(7)), 8)
    tvae = from_jax(jvae, "cpu")
    assert isinstance(tvae, VAE)
    x = data(32, 9)
    key = jax.random.PRNGKey(10)
    eps, rho0 = jax_draws(jvae, x, key)

    def jloss(m):
        return m.hvae_elbo_loss(j(x), key, n_leapfrog=n_leapfrog,
                                step_size=0.1)

    (jl, jmet), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jvae)
    enc = tvae.encoder(t(x), train=True)
    fam = enc.families[0]
    z0 = fam.loc + fam.scale * t(eps)
    tl, tmet = tvae._hvae_loss(t(x), enc, z0, t(rho0), n_leapfrog, 0.1,
                               True)
    close(tl, jl)
    for name in ("recon_nll", "hvae_bound"):
        close(tmet[name], jmet[name], msg=name)
    names = [n for n, _ in tvae.named_parameters()]
    got = dict(zip(names, torch.autograd.grad(tl, list(tvae.parameters()))))
    want = dict(from_jax(jg, "cpu").named_parameters())
    assert set(got) == set(want)
    for name in names:
        close(got[name], want[name], GRAD, name)
    if n_leapfrog == 0:
        # The one-sample ELBO at the same draw, pointwise.
        prior = tvae._prior_dist(z0, True)
        elbo = -(tvae.decoder(z0, train=True).log_prob(t(x))
                 + prior.log_prob(z0) - enc.log_prob(z0)).mean()
        close(tl, elbo, dict(atol=1e-6, rtol=1e-6))


def test_hvae_elbo_loss_runs_under_no_grad_and_with_its_own_draws():
    """With the port's generator: finite, differentiable; under no_grad
    (fit's validation) the same value, with no graph."""
    tvae = vae_config(tconfig, False).build(torch.Generator().manual_seed(1),
                                            "cpu")
    x = t(data(40, 11))
    loss, _ = tvae.hvae_elbo_loss(x, torch.Generator().manual_seed(2),
                                  n_leapfrog=3, step_size=0.05)
    assert loss.requires_grad and bool(torch.isfinite(loss))
    with torch.no_grad():
        again, met = tvae.hvae_elbo_loss(x, torch.Generator().manual_seed(2),
                                         n_leapfrog=3, step_size=0.05)
    assert not again.requires_grad
    close(again, loss, dict(atol=1e-6, rtol=1e-6))
    assert set(met) == {"loss", "recon_nll", "hvae_bound"}


# ---------------------------------------------------------------------------
# CG maps
# ---------------------------------------------------------------------------


def test_cg_maps_match_jax():
    """Centroid, centre of mass (flat masses and the residue dict) on
    batched frames, their gradient with respect to the coordinates, and
    the aggregation matrix as a buffer."""
    nums = [3, 2, 4]
    rng = np.random.default_rng(12)
    masses = rng.uniform(1.0, 16.0, sum(nums)).astype(np.float32)
    coords = rng.normal(size=(5, 2, sum(nums), 3)).astype(np.float32)
    res = {"ALA": [12.0, 14.0, 1.0], "GLY": [12.0, 16.0],
           "SER": [14.0, 12.0, 16.0, 1.0]}
    pairs = [
        (CGCentroid.create(nums, device="cpu"), JCGCentroid.create(nums)),
        (CGCenterOfMass.create(nums, masses, device="cpu"),
         JCGCenterOfMass.create(nums, masses)),
        (CGCenterOfMass.from_residue_dict(res, ["ALA", "GLY", "SER"],
                                          device="cpu"),
         JCGCenterOfMass.from_residue_dict(res, ["ALA", "GLY", "SER"]))]
    for tmap, jmap in pairs:
        assert list(tmap.parameters()) == []
        assert "agg" in dict(tmap.named_buffers())
        close(from_jax(jmap, "cpu").agg, jmap.agg)
        x = t(coords).requires_grad_(True)
        out = tmap(x)
        assert out.shape == (5, 2, 3, 3)
        close(out, jmap(j(coords)))
        (g,) = torch.autograd.grad((out ** 2).sum(), x)
        close(g, jax.grad(lambda c: (jmap(c) ** 2).sum())(j(coords)), GRAD)
