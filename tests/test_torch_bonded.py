"""The port's bonded terms (angles, torsions, Morse bonds, impropers) and
the Buckingham and soft-core pair terms against the JAX package, on the
CPU: energies and gradients, with the degenerate geometries (collinear
angles, coincident atoms) whose gradients the guards keep finite.

Inputs come from ``numpy.random.default_rng``; float32, energies to 1e-5
relative + 1e-5 and gradients to 1e-5 of the largest (+ 1e-6) unless a
test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import potentials as jp
from vaemolsim_tpu_torch import potentials as tp

torch.set_num_threads(1)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def check(energy, jenergy, x, rtol=1e-5, *jargs):
    xt = t(x).requires_grad_()
    e = energy(xt, *jargs)
    (g,) = torch.autograd.grad(e.sum(), xt)
    je, jg = jax.value_and_grad(
        lambda y: jenergy(y, *jargs).sum())(jnp.asarray(x, jnp.float32))
    assert np.isfinite(g.numpy()).all()
    np.testing.assert_allclose(e.detach().numpy().sum(), float(je),
                               rtol=rtol, atol=1e-5)
    scale = float(np.abs(np.asarray(jg)).max())
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-5 * scale + 1e-6)
    return e


def chain(n, seed, batch=(3,)):
    rng = np.random.default_rng(seed)
    steps = rng.normal(size=batch + (n, 3))
    steps /= np.linalg.norm(steps, axis=-1, keepdims=True)
    return np.cumsum(1.5 * steps, axis=-2).astype(np.float32)


ANGLES = np.array([[0, 1, 2], [1, 2, 3], [2, 3, 4], [3, 4, 5]])
QUADS = np.array([[0, 1, 2, 3], [1, 2, 3, 4], [2, 3, 4, 5]])


@pytest.mark.parametrize("geometry", ["random", "collinear"])
def test_harmonic_angles_matches_jax(geometry):
    """Per-angle k and theta0 on a batch of chains, and on a straight
    chain (theta = pi, where the arccos form's gradient is infinite)."""
    x = chain(6, 0)
    if geometry == "collinear":
        x = np.broadcast_to(np.arange(6, dtype=np.float32)[:, None]
                            * np.array([1.0, 0.0, 0.0], np.float32),
                            (3, 6, 3)).copy()
    k = np.array([10.0, 20.0, 30.0, 40.0])
    th = np.array([1.9, 2.0, 2.1, 1.8])
    check(tp.harmonic_angles(ANGLES, k, th, device="cpu"),
          jp.harmonic_angles(ANGLES, k, th), x)


def test_harmonic_angles_2d_matches_jax():
    """2-D coordinates take the scalar cross product."""
    x = chain(6, 1)[..., :2]
    check(tp.harmonic_angles(ANGLES, 5.0, 2.0, device="cpu"),
          jp.harmonic_angles(ANGLES, 5.0, 2.0), x)


@pytest.mark.parametrize("geometry", ["random", "near_straight"])
def test_periodic_torsions_matches_jax(geometry):
    """Per-torsion k, multiplicity and phase; and on a nearly straight
    chain (bond angles within ~2 degrees of pi, where the dihedral is
    ill-conditioned; an exactly straight one has none, in JAX too)."""
    x = chain(6, 2)
    if geometry == "near_straight":
        rng = np.random.default_rng(12)
        x = (np.arange(6)[:, None] * np.array([1.5, 0.0, 0.0])
             + 0.03 * rng.normal(size=(3, 6, 3))).astype(np.float32)
    k = np.array([1.0, 2.0, 0.5])
    n = np.array([1, 2, 3])
    ph = np.array([0.0, np.pi, 0.3])
    check(tp.periodic_torsions(QUADS, k, n, ph, device="cpu"),
          jp.periodic_torsions(QUADS, k, n, ph), x)


@pytest.mark.parametrize("geometry", ["random", "coincident"])
def test_morse_bonds_matches_jax(geometry):
    """Per-bond D, a and r0; and a bond of length 0."""
    x = chain(6, 3)
    if geometry == "coincident":
        x[:, 1] = x[:, 0]
    bonds = np.array([[0, 1], [1, 2], [2, 3], [4, 5]])
    D = np.array([5.0, 4.0, 3.0, 2.0])
    check(tp.morse_bonds(bonds, D, 1.5, 1.4, device="cpu"),
          jp.morse_bonds(bonds, D, 1.5, 1.4), x)


def test_harmonic_impropers_matches_jax():
    """Restraints at phi0 = pi and elsewhere (the wrapped deviation)."""
    x = chain(6, 4)
    phi0 = np.array([np.pi, 0.5, -2.0])
    check(tp.harmonic_impropers(QUADS, 3.0, phi0, device="cpu"),
          jp.harmonic_impropers(QUADS, 3.0, phi0), x)


@pytest.mark.parametrize("kw", [
    dict(), dict(box=[4.0] * 3, cutoff=1.9),
    dict(exclusions=np.eye(12, k=1, dtype=bool) | np.eye(12, k=-1,
                                                         dtype=bool))])
def test_buckingham_matches_jax(kw):
    """Dense exp-6 in vacuum, cut under minimum image, and with
    exclusions; one pair inside r_core (the linear continuation)."""
    rng = np.random.default_rng(5)
    x = (rng.random((2, 12, 3)) * 4.0).astype(np.float32)
    x[:, 1] = x[:, 0] + 0.1
    args = dict(A=100.0, rho=0.3, C=1.5, **kw)
    check(tp.buckingham(device="cpu", **args), jp.buckingham(**args), x)


@pytest.mark.parametrize("lam", [0.0, 0.5, 1.0])
def test_softcore_matches_jax(lam):
    """Two alchemical atoms in 10, per-atom sigma and epsilon, one
    excluded pair, in a box: energy and gradient at lambda 0, 0.5 and 1,
    and dU/dlambda by autograd against ``jax.grad``."""
    rng = np.random.default_rng(6)
    x = (rng.random((3, 10, 3)) * 4.0).astype(np.float32)
    alch = np.zeros(10, bool)
    alch[[0, 5]] = True
    kw = dict(sigma=rng.uniform(0.9, 1.1, 10),
              epsilon=rng.uniform(0.5, 1.0, 10), alchemical=alch,
              exclude=np.array([[1, 2]]), box=[4.0] * 3)
    energy = tp.lennard_jones_softcore(device="cpu", **kw)
    jenergy = jp.lennard_jones_softcore(**kw)
    check(energy, jenergy, x, 1e-5, lam)
    lt = torch.tensor(lam, requires_grad=True)
    (dl,) = torch.autograd.grad(energy(t(x), lt).sum(), lt)
    jdl = jax.grad(lambda l_: jenergy(jnp.asarray(x), l_).sum())(
        jnp.float32(lam))
    np.testing.assert_allclose(float(dl), float(jdl), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lam", [0.0, 0.5])
def test_softcore_coincident_pair_is_finite(lam):
    """An alchemical atom exactly on top of another at lambda < 1: the
    soft core keeps energy and gradient finite, and equal to JAX's."""
    x = np.array([[[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [1.5, 0.0, 0.0]]],
                 np.float32)
    alch = np.array([True, False, False])
    e = check(tp.lennard_jones_softcore(alchemical=alch, device="cpu"),
              jp.lennard_jones_softcore(alchemical=alch), x, 1e-5, lam)
    assert np.isfinite(e.detach().numpy()).all()
