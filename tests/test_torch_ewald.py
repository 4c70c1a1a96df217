"""The port's Ewald sum, dense Coulomb and LJ tail correction against the
JAX package, on the CPU.

Inputs come from ``numpy.random.default_rng``; float32 throughout, each
test states its tolerance.  The Ewald total is a difference of terms
several times its size (self against reciprocal), each summed in another
order by the two packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import potentials as jp
from vaemolsim_tpu_torch import potentials as tp

torch.set_num_threads(1)

MADELUNG_NACL = 1.7475645946331822


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def charges_in_box(n, L, seed, neutral=True):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, 3)) * L).astype(np.float32)
    q = rng.normal(size=n)
    if neutral:
        q = q - q.mean()
    return x, q


def value_and_grad(energy, x):
    xt = t(x).requires_grad_()
    e = energy(xt)
    (g,) = torch.autograd.grad(e.sum(), xt)
    return e.detach().numpy(), g.numpy()


def jax_value_and_grad(energy, x):
    e, g = jax.value_and_grad(lambda y: energy(y).sum())(jnp.asarray(x))
    return np.asarray(energy(jnp.asarray(x))), np.asarray(g)


def assert_energy_force(e, g, je, jg, rtol):
    np.testing.assert_allclose(e, je, rtol=rtol, atol=1e-5)
    scale = float(np.abs(jg).max())
    np.testing.assert_allclose(g, jg, rtol=0, atol=1e-5 * scale + 1e-6)


@pytest.mark.parametrize("case", ["plain", "exclude", "net_charge",
                                  "recip_only"])
def test_ewald_matches_jax(case):
    """30 charges in a box of 6 at tolerance 1e-5: energy to 2e-5
    relative, forces to 1e-5 of the largest; with bonded-pair
    exclusions, a net charge (the background term), and the reciprocal,
    self and correction terms alone."""
    x, q = charges_in_box(30, 6.0, 1, neutral=case != "net_charge")
    kw = dict(box=[6.0] * 3, r_cutoff=2.5, tolerance=1e-5)
    if case == "exclude":
        kw["exclude"] = np.array([[2 * k, 2 * k + 1] for k in range(15)])
    if case == "recip_only":
        kw["include_real_space"] = False
    energy = tp.ewald_coulomb(q, device="cpu", **kw)
    jenergy = jp.ewald_coulomb(q, **kw)
    assert energy.ewald_alpha == jenergy.ewald_alpha
    e, g = value_and_grad(energy, x)
    je, jg = jax_value_and_grad(jenergy, x)
    assert_energy_force(e, g, je, jg, 2e-5)


def test_ewald_batched_matches_jax():
    """A (2, 3) batch of configurations: shape (2, 3), each to 2e-5."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=8)
    x = (rng.random((2, 3, 8, 3)) * 4.0).astype(np.float32)
    kw = dict(box=[4.0] * 3, r_cutoff=1.9)
    e = tp.ewald_coulomb(q, device="cpu", **kw)(t(x))
    je = np.asarray(jp.ewald_coulomb(q, **kw)(jnp.asarray(x)))
    assert e.shape == (2, 3)
    np.testing.assert_allclose(e.numpy(), je, rtol=2e-5, atol=1e-5)


def test_nacl_madelung_constant():
    """The 8-ion NaCl cell: -4 M to 1e-6, as the JAX package's test."""
    g = np.stack(np.meshgrid(*[np.arange(2)] * 3, indexing="ij"),
                 -1).reshape(-1, 3).astype(np.float32)
    qs = np.asarray([(-1.0) ** int(s.sum()) for s in g])
    u = tp.ewald_coulomb(qs, box=[2.0] * 3, r_cutoff=0.99, tolerance=1e-7,
                         device="cpu")
    np.testing.assert_allclose(float(u(t(g))), -4.0 * MADELUNG_NACL,
                               rtol=1e-6)


def test_split_ewald_with_the_cell_list_equals_the_dense_sum():
    """Example 15's production form on 64 ions (a lattice of spacing
    2.25, box 9): the reciprocal half (``include_real_space=False``)
    plus the cell list's LJ + erfc (its alpha and cutoff) equals the
    dense Ewald sum plus the dense LJ, to 1e-5 relative; and the JAX
    package's split sum to 1e-5 relative."""
    rng = np.random.default_rng(7)
    g = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    x = (2.25 * g + 0.2 * rng.normal(size=g.shape)).astype(np.float32) % 9.0
    q = 1.5 * np.where(g.sum(-1) % 2 == 0, 1.0, -1.0)
    box = [9.0] * 3
    recip = tp.ewald_coulomb(q, box=box, r_cutoff=2.5,
                             include_real_space=False, device="cpu")
    dense = tp.ewald_coulomb(q, box=box, r_cutoff=2.5, device="cpu")
    build, cell = tp.lennard_jones_cell_neighbor(
        box=box, cutoff=2.5, skin=0.4, capacity=12, charges=q,
        coulomb_alpha=recip.ewald_alpha, device="cpu")
    lj = tp.lennard_jones(box=box, cutoff=2.5, device="cpu")
    xt = t(x)
    split = float(cell(build(xt), xt) + recip(xt))
    whole = float(dense(xt) + lj(xt))
    np.testing.assert_allclose(split, whole, rtol=1e-5)
    jrecip = jp.ewald_coulomb(q, box=box, r_cutoff=2.5,
                              include_real_space=False)
    jbuild, jcell = jp.lennard_jones_cell_neighbor(
        box=box, cutoff=2.5, skin=0.4, capacity=12, charges=q,
        coulomb_alpha=jrecip.ewald_alpha)
    jsplit = float(jcell(jbuild(jnp.asarray(x)), jnp.asarray(x))
                   + jrecip(jnp.asarray(x)))
    np.testing.assert_allclose(split, jsplit, rtol=1e-5)


def test_ewald_tensor_box_matches_jax_and_differentiates():
    """A tensor box (the NPT convention (1, 1, 3)) with the mode set
    frozen at ``reference_box``: energy at a box 2% larger to 2e-5
    against JAX's traced box, and dU/dL (autograd through k and V)
    against JAX's to 1e-4 relative."""
    x, q = charges_in_box(20, 5.0, 3)
    kw = dict(r_cutoff=2.4, reference_box=[5.0] * 3, tolerance=1e-5)
    L = np.float32(5.1)

    def jax_u(b):
        return jp.ewald_coulomb(q, box=b[None, None, :], **kw)(
            jnp.asarray(x))

    jb = jnp.full((3,), L)
    je, jg = jax.value_and_grad(lambda b: jax_u(b).sum())(jb)
    bt = torch.full((3,), float(L), requires_grad=True)
    e = tp.ewald_coulomb(q, box=bt[None, None, :], device="cpu", **kw)(t(x))
    (g,) = torch.autograd.grad(e.sum(), bt)
    np.testing.assert_allclose(e.detach().numpy(), np.asarray(je),
                               rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("cutoff,shift,box", [
    (None, True, None), (2.0, True, [5.0] * 3), (2.0, False, [5.0] * 3)])
def test_coulomb_matches_jax(cutoff, shift, box):
    """Dense Coulomb, in vacuum and cut (shifted or not) under minimum
    image, with exclusions: energy to 1e-5, forces to 1e-5 of the
    largest."""
    x, q = charges_in_box(16, 5.0, 5)
    kw = dict(cutoff=cutoff, shift=shift, box=box,
              exclude=np.array([[0, 1], [2, 3]]))
    e, g = value_and_grad(tp.coulomb(q, device="cpu", **kw), x)
    je, jg = jax_value_and_grad(jp.coulomb(q, **kw), x)
    assert_energy_force(e, g, je, jg, 1e-5)


def test_lennard_jones_tail_matches_jax():
    """The tail correction at a list box and at an NPT-convention tensor
    box (1, 1, 3) of a batch: values to 1e-6 and dU/dL to 1e-6."""
    x = np.zeros((2, 10, 3), np.float32)
    kw = dict(sigma=1.1, epsilon=0.9, cutoff=2.5)
    e = tp.lennard_jones_tail(box=[6.0, 6.5, 7.0], **kw)(t(x))
    je = jp.lennard_jones_tail(box=[6.0, 6.5, 7.0], **kw)(jnp.asarray(x))
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-6)
    assert e.shape == (2,)
    boxes = np.array([[6.0, 6.5, 7.0], [5.0, 5.0, 5.0]], np.float32)
    bt = t(boxes).requires_grad_()
    e = tp.lennard_jones_tail(box=bt[:, None, None, :], **kw)(t(x))
    (g,) = torch.autograd.grad(e.sum(), bt)
    jg = jax.grad(lambda b: jp.lennard_jones_tail(
        box=b[:, None, None, :], **kw)(jnp.asarray(x)).sum())(
            jnp.asarray(boxes))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6)
