"""The port's Brownian, generalized-Langevin and DPD dynamics against the
JAX package, on the CPU.

The RPY mobility to 1e-5, the GLE propagator pair to 1e-6 and the DPD
force at a given symmetric noise to 3e-5 (a force component sums ~60
pair terms of up to ~25 in float32); then each integrator with
JAX's own draws (split from the key as the JAX function splits it) to
1e-5, and DPD's total momentum conserved to 1e-5.  Inputs come from
``numpy.random.default_rng``; float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import bd as jbd
from vaemolsim_tpu import dpd as jdpd
from vaemolsim_tpu import gle as jgle
from vaemolsim_tpu_torch import bd, dpd, gle

torch.set_num_threads(1)


def t(a):
    return torch.as_tensor(np.array(a))


def harmonic(x):
    return 0.5 * (x * x).sum((-2, -1))


def jharmonic(x):
    return 0.5 * jnp.sum(x * x, axis=(-2, -1))


def lattice(n_side, spacing, seed, jitter=0.1):
    g = np.arange(n_side) * spacing
    x = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    rng = np.random.default_rng(seed)
    return (x + jitter * rng.normal(size=x.shape)).astype(np.float32)


def close(a, b, tol=1e-5):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, rtol=tol)


@pytest.mark.parametrize("spacing", [3.0, 1.3])   # far pairs, overlaps
def test_rpy_mobility_matches_jax(spacing):
    x = np.stack([lattice(2, spacing, 0), lattice(2, spacing, 1)])
    got = bd.rpy_mobility(t(x), radius=0.8, eta=1.3)
    want = jbd.rpy_mobility(jnp.asarray(x), radius=0.8, eta=1.3)
    close(got, want, 3e-5)
    torch.testing.assert_close(got, got.transpose(-1, -2))


def test_brownian_matches_jax_with_its_draws():
    x = np.stack([lattice(2, 1.5, 2), lattice(2, 1.5, 3)])
    d = np.linspace(0.5, 1.5, 8).astype(np.float32)
    kw = dict(dt=0.01, n_steps=6, kT=0.7, diffusion=d, collect_every=3)
    key = jax.random.PRNGKey(4)
    kn, k = jax.random.split(key)
    noise = [t(jax.random.normal(kn, x.shape, jnp.float32))] + [
        t(jax.random.normal(kk, x.shape, jnp.float32))
        for kk in jax.random.split(k, 6)]
    s, xs = bd.brownian(harmonic, t(x), None, noise=noise, **kw)
    js, jxs = jbd.brownian(jharmonic, jnp.asarray(x), key, **kw)
    for a, b in ((s.x, js.x), (s.force, js.force), (s.noise, js.noise),
                 (xs, jxs)):
        close(a, b)


def test_brownian_rpy_matches_jax_with_its_draws():
    x = np.stack([lattice(2, 2.1, 5), lattice(2, 2.1, 6)])
    kw = dict(dt=0.01, n_steps=4, kT=1.0, radius=1.0, eta=1.0,
              collect_every=2)
    key = jax.random.PRNGKey(7)
    noise = [t(jax.random.normal(k, (2, 24), jnp.float32))
             for k in jax.random.split(key, 4)]
    xf, xs = bd.brownian_rpy(harmonic, t(x), None, noise=noise, **kw)
    jxf, jxs = jbd.brownian_rpy(jharmonic, jnp.asarray(x), key, **kw)
    close(xf, jxf)
    close(xs, jxs)


@pytest.mark.parametrize("a_matrix", [
    jgle.white_noise_matrix(2.0), jgle.exp_memory_matrix(1.5, 0.4),
    np.array([[1.0, 0.6, 0.0], [-0.6, 2.0, 0.3], [0.0, -0.3, 0.7]])])
def test_gle_matrices_match_jax(a_matrix):
    got = gle.gle_matrices(a_matrix, 0.05, 0.8)
    want = jgle.gle_matrices(a_matrix, 0.05, 0.8)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-6)
    np.testing.assert_allclose(gle.exp_memory_matrix(1.5, 0.4),
                               jgle.exp_memory_matrix(1.5, 0.4))
    np.testing.assert_allclose(gle._expm_scaled(-a_matrix * 0.05),
                               jgle._expm_scaled(-a_matrix * 0.05),
                               atol=1e-12)


@pytest.mark.parametrize("n_s", [0, 1])
def test_gle_baoab_matches_jax_with_its_draws(n_s):
    x = lattice(2, 1.0, 8)[None].repeat(2, 0)
    v = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)
    a = (jgle.white_noise_matrix(2.0) if n_s == 0
         else jgle.exp_memory_matrix(1.5, 0.4))
    masses = np.linspace(1.0, 2.0, 8).astype(np.float32)
    kw = dict(dt=0.02, n_steps=6, kT=0.8, a_matrix=a, masses=masses,
              collect_every=3, collect_v=True)
    key = jax.random.PRNGKey(10)
    ks, k = jax.random.split(key)
    noise = ([t(jax.random.normal(ks, x.shape + (n_s,), jnp.float32))]
             if n_s else [])
    noise += [t(jax.random.normal(kk, x.shape + (1 + n_s,), jnp.float32))
              for kk in jax.random.split(k, 6)]
    s, (xs, vs) = gle.gle_baoab(harmonic, t(x), t(v), None, noise=noise,
                                **kw)
    js, (jxs, jvs) = jgle.gle_baoab(jharmonic, jnp.asarray(x),
                                    jnp.asarray(v), key, **kw)
    for got, want in ((s.x, js.x), (s.v, js.v), (s.s, js.s),
                      (s.force, js.force), (xs, jxs), (vs, jvs)):
        close(got, want)


def dpd_fluid(n_side, seed):
    box = np.full(3, n_side / 3.0 ** (1 / 3), np.float32)   # density 3
    x = (lattice(n_side, box[0] / n_side, seed, jitter=0.05)
         % box).astype(np.float32)
    v = np.random.default_rng(seed + 1).normal(size=x.shape)
    return x, (v - v.mean(0)).astype(np.float32), box


def test_dpd_forces_match_jax_at_a_given_theta():
    x, v, box = dpd_fluid(4, 11)
    rng = np.random.default_rng(12)
    aa = rng.normal(size=(64, 64))
    theta = ((aa + aa.T) / np.sqrt(2.0)).astype(np.float32)
    kw = dict(a=25.0, gamma=4.5, kT=1.0, dt=0.04, box=box)
    got = dpd.dpd_forces(t(x), t(v), t(theta), **kw)
    want = jdpd.dpd_forces(jnp.asarray(x), jnp.asarray(v),
                           jnp.asarray(theta), **kw)
    close(got, want, 3e-5)
    assert float(got.sum(0).abs().max()) < 1e-3
    e = dpd.soft_pair_energy(25.0, box=box)
    close(e(t(x)), jdpd.soft_pair_energy(25.0, box=box)(jnp.asarray(x)))


def test_dpd_vv_matches_jax_with_its_draws_and_keeps_momentum():
    x, v, box = dpd_fluid(4, 13)
    kw = dict(n_steps=6, dt=0.04, a=25.0, gamma=4.5, kT=1.0, box=box,
              collect_every=3, collect_v=True)
    key = jax.random.PRNGKey(14)
    k0, k = jax.random.split(key)
    noise = [t(jdpd._symmetric_normal(kk, 64, jnp.float32))
             for kk in [k0] + list(jax.random.split(k, 6))]
    s, (xs, vs) = dpd.dpd_vv(t(x), t(v), None, noise=noise, **kw)
    js, (jxs, jvs) = jdpd.dpd_vv(jnp.asarray(x), jnp.asarray(v), key, **kw)
    for got, want in ((s.x, js.x), (s.v, js.v), (xs, jxs), (vs, jvs)):
        close(got, want)
    close(s.force, js.force, 3e-5)
    p0 = torch.as_tensor(v).sum(0)
    torch.testing.assert_close(s.v.sum(0), p0, atol=1e-5, rtol=0.0)
    sym = dpd._symmetric_normal(torch.Generator().manual_seed(0), 5,
                                torch.float32, "cpu")
    torch.testing.assert_close(sym, sym.T)
