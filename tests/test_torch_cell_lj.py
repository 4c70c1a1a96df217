"""The port's cell-list Lennard-Jones (with its cell-pair block), dense
Lennard-Jones and bonded terms against the JAX package, on the CPU.

Systems follow tests/test_potentials.py's cell-list size: a box of 10,
cutoff 2.5, skin 0.5, capacity 32 (27 cells), here 150 atoms on a
jittered lattice (numpy-seeded), in five branches of the cell-pair
block: scalar, Lorentz-Berthelot species (sigma in {1, 0.88}, epsilon in
{1, 0.5}), Ewald real-space charges, bonded exclusions (1-2 and 1-3 on
triples, D = 2), and all of them together.  The JAX block runs as its
own tests run it: ``cell_pair_energy_force(interpret=True)`` and
``lennard_jones_cell_neighbor(backend="pallas", interpret=True)``,
beside the XLA path ``backend="xla"``.  Float32 throughout.  Tolerances:
energies to 1e-5 relative; gradients to 1e-5 of the largest gradient
component (sums of up to 27 C terms in another order; the port takes
erfc from the math library, the Pallas kernel from an Abramowitz-Stegun
form within 1.5e-7 of it, the XLA path from jax.scipy).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import potentials as jp
from vaemolsim_tpu.ops.cell_lj_pallas import \
    cell_pair_energy_force as jax_cell_pair
from vaemolsim_tpu_torch import potentials as tp
from vaemolsim_tpu_torch.ops import cell_lj

torch.set_num_threads(1)

L, CUT, SKIN, CAP, N = 10.0, 2.5, 0.5, 32, 150
GEOM = dict(box=[L] * 3, cutoff=CUT, skin=SKIN, capacity=CAP)
BRANCHES = ["scalar", "species", "coulomb", "exclusion", "all"]


def t(a, dtype=np.float32):
    return torch.tensor(np.asarray(a, dtype))


def lattice(n=N, seed=0, jitter=0.2):
    """n atoms on a 5 x 5 x 6 lattice filling the box, jittered."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(np.arange(5), np.arange(5), np.arange(6),
                             indexing="ij"), -1).reshape(-1, 3)[:n]
    x = (g + 0.5) * (L / np.array([5, 5, 6])) + jitter * rng.normal(
        size=(n, 3))
    return x.astype(np.float32)


def branch_kwargs(branch, n=N):
    sig = np.where(np.arange(n) % 3 == 0, 0.88, 1.0)
    eps = np.where(sig == 1.0, 1.0, 0.5)
    q = np.tile([0.5, -0.5], n // 2)
    triples = [[3 * k, 3 * k + 1] for k in range(n // 3)] + \
        [[3 * k + 1, 3 * k + 2] for k in range(n // 3)]
    excl = jp.exclusions_from_bonds(n, triples)
    np.fill_diagonal(excl, False)
    kw = {}
    if branch in ("species", "all"):
        kw.update(sigma=sig, epsilon=eps)
    if branch in ("coulomb", "all"):
        kw.update(charges=q, coulomb_alpha=0.9)
    if branch in ("exclusion", "all"):
        kw.update(exclude=excl if branch == "all" else np.argwhere(
            np.triu(excl, 1)))
    return kw


_CACHE = {}


def system(branch):
    """(port build/energy, JAX pallas build/energy, JAX xla energy, x at
    build, x displaced within skin / 2), made once per branch."""
    if branch not in _CACHE:
        kw = branch_kwargs(branch)
        tb, te = tp.lennard_jones_cell_neighbor(device="cpu", **GEOM, **kw)
        jb, je = jp.lennard_jones_cell_neighbor(
            backend="pallas", interpret=True, **GEOM, **kw)
        jbx, jex = jp.lennard_jones_cell_neighbor(**GEOM, **kw)
        x0 = lattice()
        rng = np.random.default_rng(1)
        x1 = (x0 + 0.1 * rng.normal(size=x0.shape) / np.sqrt(3.0)).astype(
            np.float32)
        _CACHE[branch] = (tb, te, jb, je, jbx, jex, x0, x1)
    return _CACHE[branch]


def grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("branch", BRANCHES)
def test_plain_block_matches_pallas_interpret(branch):
    """The plain cell-pair block against the Pallas kernel in interpret
    mode, on the gathered inputs of a port build: per-cell energies to
    1e-5 of the largest, gradients to 1e-5 of the largest."""
    tb, te, *_, x0, x1 = system(branch)
    args, kwargs = te.cell_pair_inputs(tb(t(x0)), t(x1))
    e, g = cell_lj.cell_pair_energy_force_plain(*args, **kwargs)

    def jx(a):
        if a is None:
            return None
        if isinstance(a, tuple):
            return tuple(jnp.asarray(v.numpy()) for v in a)
        return jnp.asarray(a.numpy())

    ja = [jx(a) for a in args]
    je, jg = jax_cell_pair(*ja[:4], species=ja[4], charge=ja[5],
                           exclusion=ja[6], interpret=True, **kwargs)
    je = np.asarray(je)
    np.testing.assert_allclose(e.numpy(), je, rtol=1e-5,
                               atol=1e-5 * np.abs(je).max())
    grad_close(g.numpy(), jg)
    # The wrapper takes the plain version for a CPU tensor.
    e2, g2 = cell_lj.cell_pair_energy_force(*args, **kwargs)
    assert torch.equal(e2, e) and torch.equal(g2, g)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_matches_jax_exactly(seed):
    """cell_atoms, atom_slot, overflow and x_ref equal the JAX build's
    bit for bit (stable sort by cell id), with atoms outside the box."""
    rng = np.random.default_rng(seed)
    x = ((rng.random((N, 3)) * 1.4 - 0.2) * L).astype(np.float32)
    tb, _ = tp.lennard_jones_cell_neighbor(device="cpu", **GEOM)
    jb, _ = jp.lennard_jones_cell_neighbor(backend="pallas", **GEOM)
    nl, jnl = tb(t(x)), jb(jnp.asarray(x))
    for field in ("cell_atoms", "atom_slot", "overflow", "x_ref"):
        got, want = getattr(nl, field).numpy(), np.asarray(getattr(jnl, field))
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    assert nl.nb_cid.numel() == 0 and nl.mask.numel() == 0


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("branch", BRANCHES)
def test_energy_and_gradient_match_jax(branch, backend):
    """Energy (1e-5 relative) and gradient (1e-5 of the largest) of the
    port's list at positions displaced within skin / 2, against the JAX
    Pallas route on its own build and the JAX XLA route on its own."""
    tb, te, jb, je, jbx, jex, x0, x1 = system(branch)
    x = t(x1).requires_grad_()
    e = te(tb(t(x0)), x)
    (g,) = torch.autograd.grad(e, x)
    build, energy = (jb, je) if backend == "pallas" else (jbx, jex)
    jnl = build(jnp.asarray(x0))
    ej, gj = jax.value_and_grad(lambda y: energy(jnl, y))(jnp.asarray(x1))
    np.testing.assert_allclose(e.item(), float(ej), rtol=1e-5)
    grad_close(g.numpy(), gj)


@pytest.mark.parametrize("case", ["overflow", "drift"])
def test_invalid_list_gives_nan_energy_and_gradient(case):
    """An overflowed build (8 atoms in the last cell, of capacity 2, so
    that their slots run past the table's end) or an atom moved past
    skin / 2 makes the energy and every gradient component NaN, as in
    JAX."""
    if case == "overflow":
        geom = dict(GEOM, capacity=2, skin=0.0)
        x0 = np.full((8, 3), 9.0, np.float32) + np.linspace(
            0, 0.7, 8, dtype=np.float32)[:, None]
        x1 = x0
    else:
        geom = GEOM
        x0 = lattice(64, seed=2)
        x1 = x0.copy()
        x1[5, 0] += 0.6
    tb, te = tp.lennard_jones_cell_neighbor(device="cpu", **geom)
    jb, je = jp.lennard_jones_cell_neighbor(backend="pallas",
                                            interpret=True, **geom)
    nl = tb(t(x0))
    assert bool(nl.overflow) == (case == "overflow")
    x = t(x1).requires_grad_()
    e = te(nl, x)
    (g,) = torch.autograd.grad(e, x)
    assert torch.isnan(e) and bool(torch.isnan(g).all())
    jnl = jb(jnp.asarray(x0))
    assert np.isnan(float(je(jnl, jnp.asarray(x1))))


def test_coincident_atoms_stay_finite():
    """An exact overlap takes the finite linear core: energy and gradient
    finite and equal to the JAX XLA route's (1e-5)."""
    x0 = lattice(64, seed=3)
    x0[7] = x0[3]
    tb, te = tp.lennard_jones_cell_neighbor(device="cpu", **GEOM)
    jb, je = jp.lennard_jones_cell_neighbor(**GEOM)
    x = t(x0).requires_grad_()
    e = te(tb(x.detach()), x)
    (g,) = torch.autograd.grad(e, x)
    assert torch.isfinite(e) and bool(torch.isfinite(g).all())
    jnl = jb(jnp.asarray(x0))
    ej, gj = jax.value_and_grad(lambda y: je(jnl, y))(jnp.asarray(x0))
    np.testing.assert_allclose(e.item(), float(ej), rtol=1e-5)
    grad_close(g.numpy(), gj)


@pytest.mark.parametrize("branch", ["scalar", "all"])
def test_stress_matches_jax(branch):
    """The configurational pressure tensor against the JAX XLA route's
    (1e-5 of its largest component), and NaN past skin / 2."""
    tb, te, _, _, jbx, jex, x0, x1 = system(branch)
    nl = tb(t(x0))
    s = te.stress(nl, t(x1)).numpy()
    sj = np.asarray(jex.stress(jbx(jnp.asarray(x0)), jnp.asarray(x1)))
    np.testing.assert_allclose(s, sj, rtol=0, atol=1e-5 * np.abs(sj).max())
    far = x1.copy()
    far[0, 1] += 0.6
    assert bool(torch.isnan(te.stress(nl, t(far))).all())


@pytest.mark.parametrize("branch", ["scalar", "species", "coulomb"])
def test_heat_flux_matches_jax(branch):
    """The energy flux with per-atom masses against the JAX XLA route's
    (1e-5 of its largest component)."""
    tb, te, _, _, jbx, jex, x0, x1 = system(branch)
    rng = np.random.default_rng(4)
    v = rng.normal(size=x1.shape).astype(np.float32)
    m = rng.uniform(0.5, 2.0, N).astype(np.float32)
    h = te.heat_flux(tb(t(x0)), t(x1), t(v), masses=t(m)).numpy()
    hj = np.asarray(jex.heat_flux(jbx(jnp.asarray(x0)), jnp.asarray(x1),
                                  jnp.asarray(v), masses=jnp.asarray(m)))
    np.testing.assert_allclose(h, hj, rtol=0, atol=1e-5 * np.abs(hj).max())


def test_heat_flux_refused_with_exclusions():
    tb, te, *_, x0, x1 = system("exclusion")
    with pytest.raises(NotImplementedError, match="exclusions"):
        te.heat_flux(tb(t(x0)), t(x1), t(x1))


def test_from_jax_xla_build_drives_stress_and_energy():
    """A list built by the JAX XLA route (with its stored per-atom
    candidates) evaluates in the port like the port's own build."""
    from vaemolsim_tpu_torch.convert import from_jax
    tb, te, _, _, jbx, _, x0, x1 = system("all")
    nl_j = from_jax(jbx(jnp.asarray(x0)), "cpu")
    assert nl_j.nb_cid.numel() > 0 and nl_j.mask.dtype == torch.bool
    nl = tb(t(x0))
    assert float(te(nl_j, t(x1))) == float(te(nl, t(x1)))
    np.testing.assert_allclose(te.stress(nl_j, t(x1)).numpy(),
                               te.stress(nl, t(x1)).numpy(), rtol=1e-6,
                               atol=1e-6)


def test_lennard_jones_cell_matches_jax_batched():
    """Build-every-call cell LJ over a batch of two configurations."""
    x = np.stack([lattice(seed=5), lattice(seed=6)])
    e = tp.lennard_jones_cell(box=[L] * 3, cutoff=CUT, capacity=CAP,
                              device="cpu")(t(x))
    ej = jp.lennard_jones_cell(box=[L] * 3, cutoff=CUT, capacity=CAP)(
        jnp.asarray(x))
    assert e.shape == (2,)
    np.testing.assert_allclose(e.numpy(), np.asarray(ej), rtol=1e-5)


@pytest.mark.parametrize("case", ["box_cutoff", "no_shift", "exclude_bool",
                                  "exclude_pairs", "per_atom", "pair_matrix",
                                  "open"])
def test_dense_lennard_jones_matches_jax(case):
    """The dense O(N^2) form, energy (1e-5 relative) and gradient (1e-5
    of the largest), over a batch of two 40-atom configurations."""
    rng = np.random.default_rng(7)
    n = 40
    x = (rng.random((2, n, 3)) * 6.0).astype(np.float32)
    kw = dict(box=[6.0] * 3, cutoff=2.5)
    pairs = np.array([[0, 1], [1, 2], [5, 9]])
    if case == "no_shift":
        kw["shift"] = False
    elif case == "exclude_bool":
        kw["exclude"] = jp.exclusions_from_bonds(n, pairs)
    elif case == "exclude_pairs":
        kw["exclude"] = pairs
    elif case == "per_atom":
        kw.update(sigma=rng.uniform(0.8, 1.2, n), epsilon=rng.uniform(0.5,
                                                                      1.5, n))
    elif case == "pair_matrix":
        s = rng.uniform(0.8, 1.2, (n, n))
        kw.update(sigma=(s + s.T) / 2)
    elif case == "open":
        kw = {}
    tl = tp.lennard_jones(device="cpu", **kw)
    jl = jp.lennard_jones(**kw)
    xt = t(x).requires_grad_()
    e = tl(xt)
    (g,) = torch.autograd.grad(e.sum(), xt)
    ej, gj = jax.value_and_grad(lambda y: jl(y).sum())(jnp.asarray(x))
    np.testing.assert_allclose(e.sum().item(), float(ej), rtol=1e-5)
    grad_close(g.numpy(), gj)


def test_cell_list_matches_dense_form():
    """The port's cell-list energy against its dense form on the same
    atoms (the chip check's reference, here at small size): 1e-5."""
    x0 = lattice()
    tb, te = tp.lennard_jones_cell_neighbor(device="cpu", **GEOM)
    dense = tp.lennard_jones(box=[L] * 3, cutoff=CUT, device="cpu")
    x = t(x0).requires_grad_()
    e = te(tb(x.detach()), x)
    (g,) = torch.autograd.grad(e, x)
    xd = t(x0).requires_grad_()
    ed = dense(xd)
    (gd,) = torch.autograd.grad(ed, xd)
    np.testing.assert_allclose(e.item(), ed.item(), rtol=1e-5)
    grad_close(g.numpy(), gd.numpy())


def test_harmonic_bonds_and_exclusions_match_jax():
    rng = np.random.default_rng(8)
    bonds = [[0, 1], [1, 2], [2, 3], [5, 4]]
    k = rng.uniform(50, 150, 4)
    r0 = rng.uniform(0.8, 1.2, 4)
    x = rng.normal(size=(3, 6, 3)).astype(np.float32)
    tb = tp.harmonic_bonds(bonds, k, r0, device="cpu")
    jbnd = jp.harmonic_bonds(bonds, k, r0)
    xt = t(x).requires_grad_()
    e = tb(xt)
    (g,) = torch.autograd.grad(e.sum(), xt)
    ej, gj = jax.value_and_grad(lambda y: jbnd(y).sum())(jnp.asarray(x))
    np.testing.assert_allclose(e.sum().item(), float(ej), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-5)
    for through in (True, False):
        np.testing.assert_array_equal(
            tp.exclusions_from_bonds(6, bonds, through),
            jp.exclusions_from_bonds(6, bonds, through))
    with pytest.raises(ValueError, match="bonds"):
        tp.harmonic_bonds([0, 1, 2], 1.0, 1.0, device="cpu")


def test_cell_neighbor_validation():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tp.lennard_jones_cell_neighbor(mesh=object(), device="cpu", **GEOM)
    with pytest.raises(ValueError, match="need >= 3"):
        tp.lennard_jones_cell_neighbor(device="cpu",
                                       **dict(GEOM, box=[8.0] * 3))
    with pytest.raises(ValueError, match="coulomb_alpha"):
        tp.lennard_jones_cell_neighbor(device="cpu", charges=np.ones(N),
                                       **GEOM)
    tb, te = tp.lennard_jones_cell_neighbor(
        device="cpu", charges=np.ones(N), coulomb_alpha=1.0, **GEOM)
    with pytest.raises(ValueError, match="charges"):
        te(tb(t(lattice(64))), t(lattice(64)))
