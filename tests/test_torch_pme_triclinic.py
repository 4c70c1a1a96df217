"""The port's triclinic PME (``pme_coulomb(cell=...)``) on the CPU:
against the JAX package's to 1e-5 relative, against the port's own
classic ``ewald_coulomb_triclinic`` on a sheared rock-salt supercell and
on random neutral systems (to the JAX package's own 2e-4 of
tests/test_triclinic_ewald.py::TestTriclinicPME), a diagonal ``cell=``
equal to the ``box=`` path, and forces against finite differences.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import potentials as jp
from vaemolsim_tpu_torch import potentials as tp
from vaemolsim_tpu_torch import triclinic as tt

torch.set_num_threads(1)

CELL = np.array([[6.0, 0.0, 0.0], [1.8, 6.5, 0.0], [-1.2, 1.9, 7.0]])
MADELUNG_NACL = 1.7475645946331822


def neutral_system(n, seed, cell):
    rs = np.random.RandomState(seed)
    x = (rs.uniform(0, 1, (n, 3)) @ np.asarray(cell)).astype(np.float32)
    q = rs.normal(size=n)
    return x, q - q.mean()


def t(a):
    return torch.as_tensor(np.array(a, np.float32))


@pytest.mark.parametrize("excl", [None, np.array([[0, 1], [2, 3]])])
def test_matches_jax(excl):
    """24 ions in a sheared cell, real space included, with and without
    exclusions; and the reciprocal part alone: 1e-5 relative."""
    x, q = neutral_system(24, 10, CELL)
    for real in (True, False):
        kw = dict(cell=CELL, r_cutoff=2.8, tolerance=1e-5, exclude=excl,
                  include_real_space=real)
        want = float(jp.pme_coulomb(q, **kw)(jnp.asarray(x)))
        u = tp.pme_coulomb(q, device="cpu", **kw)
        np.testing.assert_allclose(float(u(t(x))), want, rtol=1e-5)
    assert u.grid_shape == jp.pme_coulomb(q, **kw).grid_shape


@pytest.mark.parametrize("excl", [None, np.array([[0, 1], [2, 3]])])
def test_matches_classic_triclinic_ewald(excl):
    """Random neutral ions in a sheared cell: PME against the classic sum
    to 2e-4 relative."""
    x, q = neutral_system(24, 14, CELL)
    kw = dict(r_cutoff=2.8, tolerance=1e-5, exclude=excl)
    e_ref = float(tt.ewald_coulomb_triclinic(
        q, reference_cell=CELL, device="cpu", **kw)(t(x), t(CELL)))
    e_pme = float(tp.pme_coulomb(q, cell=CELL, device="cpu", **kw)(t(x)))
    np.testing.assert_allclose(e_pme, e_ref, rtol=2e-4)


def test_sheared_rock_salt_madelung():
    """Rock salt as the sheared supercell (4,0,0), (2,2,0), (0,0,2) scaled
    to 3x (144 ions, spacing 1): PME against the classic triclinic sum
    to 2e-4, and both at the Madelung energy -N M / 2 to 1e-4."""
    base = np.array([[4.0, 0.0, 0.0], [2.0, 2.0, 0.0], [0.0, 0.0, 2.0]])
    cell = 3.0 * base
    g = np.stack(np.meshgrid(np.arange(12), np.arange(6), np.arange(6),
                             indexing="ij"), -1).reshape(-1, 3)
    s = g / np.array([12.0, 6.0, 6.0])
    x = s @ cell
    qs = np.asarray([(-1.0) ** int(v.sum()) for v in np.rint(x)])
    kw = dict(r_cutoff=2.9, tolerance=1e-6)
    ref = float(tt.ewald_coulomb_triclinic(
        qs, reference_cell=cell, device="cpu", **kw)(t(x), t(cell)))
    pme = float(tp.pme_coulomb(qs, cell=cell, device="cpu", **kw)(t(x)))
    want = -0.5 * len(qs) * MADELUNG_NACL
    np.testing.assert_allclose(pme, ref, rtol=2e-4)
    np.testing.assert_allclose(ref, want, rtol=1e-4)


def test_diagonal_cell_matches_box_path():
    box = [7.0, 8.0, 9.0]
    x, q = neutral_system(20, 11, np.diag(box))
    kw = dict(r_cutoff=3.0, tolerance=1e-5, device="cpu")
    e_cell = float(tp.pme_coulomb(q, cell=np.diag(box), **kw)(t(x)))
    e_box = float(tp.pme_coulomb(q, box=box, **kw)(t(x)))
    np.testing.assert_allclose(e_cell, e_box, rtol=1e-6)


def test_forces_match_finite_difference():
    x, q = neutral_system(12, 12, CELL)
    u = tp.pme_coulomb(q, cell=CELL, r_cutoff=2.8, tolerance=1e-5,
                       device="cpu")
    xg = t(x).requires_grad_(True)
    (g,) = torch.autograd.grad(u(xg), xg)
    h = 1e-3
    for i, a in ((0, 0), (7, 1), (11, 2)):
        xp, xm = x.astype(np.float64), x.astype(np.float64)
        xp = xp.copy()
        xm = xm.copy()
        xp[i, a] += h
        xm[i, a] -= h
        fd = (float(u(t(xp))) - float(u(t(xm)))) / (2 * h)
        np.testing.assert_allclose(float(g[i, a]), fd, rtol=3e-2, atol=3e-3)


def test_validation_and_mesh_refusal():
    q = np.asarray([1.0, -1.0])
    with pytest.raises(ValueError, match="exactly one of"):
        tp.pme_coulomb(q, r_cutoff=1.0, device="cpu")
    with pytest.raises(ValueError, match="exactly one of"):
        tp.pme_coulomb(q, box=[5.0] * 3, cell=CELL, r_cutoff=1.0,
                       device="cpu")
    with pytest.raises(ValueError, match="perpendicular width"):
        tp.pme_coulomb(q, cell=CELL, r_cutoff=4.0, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        tp.pme_coulomb(q, box=[5.0] * 3, r_cutoff=1.0, mesh=object(),
                       device="cpu")
    with pytest.raises(ValueError, match="orthorhombic"):
        tp.pme_coulomb(q, cell=CELL, r_cutoff=1.0, mesh=object(),
                       device="cpu")
