"""The port's path-integral MD against the JAX package, on the CPU.

The normal-mode matrix, ring frequencies and the exact free-ring
propagator to 1e-6; the spring energy, ring Hamiltonian, primitive and
virial estimators and the radius of gyration at shared bead
configurations to 1e-5; the thermal ring and the RPMD, PILE and TRPMD
integrators with JAX's own draws (split from the key as the JAX
functions split it) to 1e-5 after 10 steps.  Inputs come from
``numpy.random.default_rng``; float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import pimd as jp
from vaemolsim_tpu_torch import pimd as tp

torch.set_num_threads(1)

KT, HBAR = 0.5, 1.0
MASSES = np.array([1.0, 2.5], np.float32)


def t(a):
    return torch.as_tensor(np.array(a))


def double_well(x):
    """Example 34's quartic double well per coordinate, summed over the
    atoms and coordinates of (..., n, d)."""
    return ((x * x - 1.0) ** 2 + 0.1 * x).sum((-2, -1))


def jdouble_well(x):
    return jnp.sum((x * x - 1.0) ** 2 + 0.1 * x, axis=(-2, -1))


def beads(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * 0.6).astype(np.float32)


@pytest.mark.parametrize("p", [1, 4, 5, 8])
def test_normal_modes_and_frequencies_match_jax(p):
    np.testing.assert_allclose(tp.normal_mode_matrix(p),
                               jp.normal_mode_matrix(p), atol=1e-6)
    c = tp.normal_mode_matrix(p)
    np.testing.assert_allclose(c @ c.T, np.eye(p), atol=1e-12)
    wp, wk = tp.ring_frequencies(p, KT, HBAR)
    jwp, jwk = jp.ring_frequencies(p, KT, HBAR)
    assert wp == jwp
    np.testing.assert_allclose(wk, jwk, atol=1e-6)


@pytest.mark.parametrize("p", [4, 8])
def test_free_ring_propagation_matches_jax(p):
    x, v = beads((3, p, 2, 2), 0), beads((3, p, 2, 2), 1)
    c = tp.normal_mode_matrix(p).astype(np.float32)
    _, w = tp.ring_frequencies(p, KT, HBAR)
    w = w.astype(np.float32)
    got = tp._free_ring_step(t(c), t(w), torch.tensor(0.05))(t(x), t(v))
    want = jp._free_ring_step(jnp.asarray(c), jnp.asarray(w),
                              jnp.float32(0.05))(jnp.asarray(x),
                                                 jnp.asarray(v))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_estimators_match_jax():
    x, v = beads((3, 8, 2, 2), 2), beads((3, 8, 2, 2), 3)
    kw = dict(kT=KT, hbar=HBAR, masses=MASSES)
    jx, jv = jnp.asarray(x), jnp.asarray(v)
    pairs = [
        (tp.spring_energy(t(x), **kw), jp.spring_energy(jx, **kw)),
        (tp.ring_hamiltonian(double_well, t(x), t(v), **kw),
         jp.ring_hamiltonian(jdouble_well, jx, jv, **kw)),
        (tp.energy_primitive(double_well, t(x), **kw),
         jp.energy_primitive(jdouble_well, jx, **kw)),
        (tp.energy_virial(double_well, t(x), kT=KT, masses=MASSES),
         jp.energy_virial(jdouble_well, jx, kT=KT, masses=MASSES)),
        (tp.radius_of_gyration2(t(x)), jp.radius_of_gyration2(jx))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


def test_thermal_ring_matches_jax():
    x = beads((3, 2, 2), 4)
    key = jax.random.PRNGKey(5)
    p = 8
    kq, kv = jax.random.split(key)
    shape = (3, p, 2, 2)
    noise = (t(jax.random.normal(kq, (3, p - 1, 2, 2), jnp.float32)),
             t(jax.random.normal(kv, shape, jnp.float32)))
    got = tp.init_thermal_ring(None, t(x), n_beads=p, kT=KT, masses=MASSES,
                               noise=noise)
    want = jp.init_thermal_ring(key, jnp.asarray(x), n_beads=p, kT=KT,
                                masses=MASSES)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    # The centroid stays at the classical positions.
    np.testing.assert_allclose(got[0].mean(-3).numpy(), x, atol=1e-5)


@pytest.mark.parametrize("kind", ["rpmd_nve", "pimd_pile", "trpmd"])
def test_integrators_match_jax_with_its_draws(kind):
    p, n_steps = 8, 10
    x, v = beads((3, p, 2, 2), 6), beads((3, p, 2, 2), 7)
    kw = dict(dt=0.02, n_steps=n_steps, kT=KT, hbar=HBAR, masses=MASSES,
              collect_every=5, collect_v=True)
    key = jax.random.PRNGKey(9)
    if kind == "rpmd_nve":
        got = tp.rpmd_nve(double_well, t(x), t(v), **kw)
        want = jp.rpmd_nve(jdouble_well, jnp.asarray(x), jnp.asarray(v),
                           **kw)
    else:
        noise = [t(jax.random.normal(k, x.shape, jnp.float32))
                 for k in jax.random.split(key, n_steps)]
        got = getattr(tp, kind)(double_well, t(x), t(v), None, noise=noise,
                                **kw)
        want = getattr(jp, kind)(jdouble_well, jnp.asarray(x),
                                 jnp.asarray(v), key, **kw)
    (s, (xs, vs)), (js, (jxs, jvs)) = got, want
    for a, b in ((s.x, js.x), (s.v, js.v), (s.force, js.force), (xs, jxs),
                 (vs, jvs)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)
    if kind == "rpmd_nve":
        h0 = tp.ring_hamiltonian(double_well, t(x), t(v), kT=KT,
                                 masses=MASSES)
        h1 = tp.ring_hamiltonian(double_well, s.x, s.v, kT=KT,
                                 masses=MASSES)
        np.testing.assert_allclose(h1.numpy(), h0.numpy(), rtol=2e-3)
