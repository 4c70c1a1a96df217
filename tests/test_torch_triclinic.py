"""The port's triclinic cells against the JAX package, on the CPU: the
cell geometry and sequential minimum image on sheared cells at the tilt
limits (bit for bit), the dense and cell-list LJ (energies and forces to
1e-5 relative, NaN on overflow), the triclinic Ewald sum and the
strain-derivative pressure tensor (1e-5 relative), and anisotropic NPT
sweeps on JAX's own draws (cells, positions and energies to 1e-5, the
counts exactly).  Inputs come from ``numpy.random.default_rng``;
float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import triclinic as jt
from vaemolsim_tpu.mcmc.engine import log_uniform as jlog_uniform
from vaemolsim_tpu_torch import triclinic as tt

torch.set_num_threads(1)


def t(a):
    return torch.as_tensor(np.array(a, np.float32))


def count(c):
    return int(c.lo) + (int(c.hi) << 30)


# Tilts at the bounds (|bx| = ax/2, |cx| = ax/2, |cy| = by/2) and inside.
CELLS = [np.array([[5.0, 0, 0], [2.5, 6.0, 0], [-2.5, 3.0, 7.0]]),
         np.array([[6.0, 0, 0], [1.8, 6.5, 0], [-1.2, 1.9, 7.0]])]


@pytest.mark.parametrize("cell", CELLS)
def test_geometry_matches_jax_exactly(cell):
    """Fractional maps, wrap, the sequential minimum image and the volume
    are the same float32 operations: equal bit for bit; the widths to
    1e-6."""
    h = np.asarray(jt.validate_cell(cell))
    np.testing.assert_array_equal(tt.validate_cell(cell), h)
    rng = np.random.default_rng(0)
    x = (rng.uniform(-2, 3, size=(4, 9, 3)) * 5).astype(np.float32)
    hj, ht = jnp.asarray(h, jnp.float32), t(h)
    for fn in ("to_fractional", "wrap", "min_image"):
        np.testing.assert_array_equal(getattr(tt, fn)(t(x), ht).numpy(),
                                      np.asarray(getattr(jt, fn)(x, hj)))
    s = np.asarray(jt.to_fractional(x, hj))
    np.testing.assert_array_equal(tt.from_fractional(t(s), ht).numpy(),
                                  np.asarray(jt.from_fractional(s, hj)))
    d = x[:, :, None] - x[:, None]
    np.testing.assert_array_equal(tt.min_image(t(d), ht).numpy(),
                                  np.asarray(jt.min_image(d, hj)))
    assert float(tt.cell_volume(ht)) == float(jt.cell_volume(hj))
    np.testing.assert_allclose(tt.perpendicular_widths(ht).numpy(),
                               np.asarray(jt.perpendicular_widths(hj)),
                               rtol=1e-6)
    np.testing.assert_array_equal(
        tt.lattice_in_cell(20, cell, device="cpu").numpy(),
        np.asarray(jt.lattice_in_cell(20, cell)))


def test_validate_cell_refuses_what_jax_refuses():
    for bad, msg in ((np.array([[5.0, 0.1, 0], [0, 5, 0], [0, 0, 5]]),
                      "LOWER"),
                     (np.array([[5.0, 0, 0], [2.6, 5, 0], [0, 0, 5]]),
                      "tilt"),
                     (np.diag([5.0, -1.0, 5.0]), "positive")):
        with pytest.raises(ValueError, match=msg):
            jt.validate_cell(bad)
        with pytest.raises(ValueError, match=msg):
            tt.validate_cell(bad)


def lj_system(n, cell, seed, jitter=0.15):
    rng = np.random.default_rng(seed)
    x = np.asarray(jt.lattice_in_cell(n, cell)) + jitter * rng.normal(
        size=(n, 3))
    return x.astype(np.float32)


def energy_and_force(fn, x):
    xg = x.clone().requires_grad_(True)
    e = fn(xg)
    (g,) = torch.autograd.grad(e.sum(), xg)
    return e.detach(), -g


@pytest.mark.parametrize("cell", CELLS)
def test_lj_dense_and_cell_list_match_jax(cell):
    """A 500-atom sheared LJ liquid (cell 2.5x the listed one): the dense
    energy and forces, the cell-list energy and forces, each against JAX
    and against each other, to 1e-5 relative."""
    big = 2.5 * cell
    x = lj_system(500, big, 1)
    hj = jnp.asarray(big, jnp.float32)
    jd = jt.lennard_jones_triclinic(cutoff=2.5)
    td = tt.lennard_jones_triclinic(cutoff=2.5)
    jbuild, jcell = jt.lennard_jones_cell_triclinic(big, cutoff=2.5,
                                                    skin=0.4, capacity=24)
    tbuild, tcell = tt.lennard_jones_cell_triclinic(big, cutoff=2.5,
                                                    skin=0.4, capacity=24,
                                                    device="cpu")
    want_e = float(jd(jnp.asarray(x), hj))
    want_f = -np.asarray(jax.grad(lambda y: jd(y, hj))(jnp.asarray(x)))
    jnl = jbuild(jnp.asarray(x))
    jcell_f = -np.asarray(jax.grad(lambda y: jcell(jnl, y))(jnp.asarray(x)))
    nl = tbuild(t(x))
    for fn in (lambda y: td(y, t(big)), lambda y: tcell(nl, y)):
        e, f = energy_and_force(fn, t(x))
        np.testing.assert_allclose(float(e), want_e, rtol=1e-5)
        scale = np.abs(want_f).max()
        np.testing.assert_allclose(f.numpy(), want_f, rtol=0,
                                   atol=1e-5 * scale)
    np.testing.assert_allclose(float(tcell(nl, t(x))),
                               float(jcell(jnl, jnp.asarray(x))), rtol=1e-5)
    np.testing.assert_allclose(jcell_f, want_f, rtol=0,
                               atol=1e-5 * np.abs(want_f).max())


def test_cell_list_nan_contract():
    """Overflow (capacity 2 on a dense cell) and an atom drifted past
    skin/2 both give NaN, in both packages."""
    big = 2.5 * CELLS[1]
    x = lj_system(500, big, 2)
    for cap, shift in ((2, 0.0), (24, 0.5)):
        jb, je = jt.lennard_jones_cell_triclinic(big, cutoff=2.5, skin=0.4,
                                                 capacity=cap)
        tb, te = tt.lennard_jones_cell_triclinic(big, cutoff=2.5, skin=0.4,
                                                 capacity=cap, device="cpu")
        y = x.copy()
        y[0] += shift
        assert np.isnan(float(je(jb(jnp.asarray(x)), jnp.asarray(y))))
        assert torch.isnan(te(tb(t(x)), t(y)))


def ionic_system(n, seed, cell):
    rs = np.random.RandomState(seed)
    x = (rs.uniform(0, 1, (n, 3)) @ cell).astype(np.float32)
    q = rs.normal(size=n)
    return x, q - q.mean()


@pytest.mark.parametrize("excl", [None, np.array([[0, 1], [2, 3]])])
def test_ewald_and_pressure_tensor_match_jax(excl):
    """The triclinic Ewald sum on 3 chains of 24 ions in per-chain sheared
    cells, with and without exclusions, and the pressure tensor of LJ +
    Ewald by the strain derivative (kinetic part from kT and from
    velocities): 1e-5 relative."""
    cell = CELLS[1]
    kw = dict(reference_cell=cell, r_cutoff=2.8, tolerance=1e-5,
              exclude=excl)
    xs, cells = [], []
    for c in range(3):
        x, q = ionic_system(24, 10, cell * (1 + 0.02 * c))
        xs.append(x)
        cells.append(cell * (1 + 0.02 * c))
    x = np.stack(xs)
    h = np.stack(cells).astype(np.float32)
    je = jt.ewald_coulomb_triclinic(q, **kw)
    te = tt.ewald_coulomb_triclinic(q, device="cpu", **kw)
    np.testing.assert_allclose(te(t(x), t(h)).numpy(),
                               np.asarray(je(jnp.asarray(x),
                                             jnp.asarray(h))), rtol=1e-5)
    jlj = jt.lennard_jones_triclinic(sigma=0.8, cutoff=2.8)
    tlj = tt.lennard_jones_triclinic(sigma=0.8, cutoff=2.8)

    def jtot(y, c):
        return jlj(y, c) + je(y, c)

    def ttot(y, c):
        return tlj(y, c) + te(y, c)

    v = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)
    want = np.stack([np.asarray(jt.pressure_tensor(
        jtot, jnp.asarray(x[i]), jnp.asarray(h[i]), kT=1.5))
        for i in range(3)])
    got = tt.pressure_tensor(ttot, t(x), t(h), kT=1.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    want_v = np.asarray(jt.pressure_tensor(jtot, jnp.asarray(x[0]),
                                           jnp.asarray(h[0]),
                                           v=jnp.asarray(v[0])))
    got_v = tt.pressure_tensor(ttot, t(x[0]), t(h[0]), v=t(v[0]))
    np.testing.assert_allclose(got_v.numpy(), want_v, rtol=1e-5,
                               atol=1e-5 * np.abs(want_v).max())


def npt_draws(key, x, e, n_comp):
    _, k1, k2, k3, k4, k5 = jax.random.split(key, 6)
    batch = e.shape
    return dict(disp=t(jax.random.normal(k1, x.shape, x.dtype)),
                disp_logu=t(jlog_uniform(k2, batch, x.dtype)),
                comp=torch.as_tensor(np.array(
                    jax.random.randint(k3, batch, 0, n_comp))).long(),
                delta=t(jax.random.normal(k4, batch, x.dtype)),
                cell_logu=t(jlog_uniform(k5, batch, x.dtype)))


@pytest.mark.parametrize("diagonal_only", [False, True])
def test_npt_triclinic_sweeps_match_jax(diagonal_only):
    """Six sweeps of 8 chains x 27 LJ atoms from a sheared start at a
    high pressure: cells, positions and energies to 1e-5, the four
    counts exactly; run_npt_triclinic collects."""
    cell0 = np.array([[4.2, 0, 0], [1.2, 4.2, 0], [-1.0, 0.9, 4.2]])
    x = np.broadcast_to(lj_system(27, cell0, 5, jitter=0.05),
                        (8, 27, 3)).copy()
    kw = dict(beta=0.5, pressure=3.0, dx_scale=0.05, dh_scale=0.15,
              min_perp=3.0, diagonal_only=diagonal_only)
    jen = jt.lennard_jones_triclinic(cutoff=1.5)
    ten = tt.lennard_jones_triclinic(cutoff=1.5)
    js = jt.npt_triclinic_init(jen, jnp.asarray(x), cell0,
                               jax.random.PRNGKey(2))
    s = tt.npt_triclinic_init(ten, t(x), cell0, torch.Generator())
    jstep = jax.jit(jt.make_npt_triclinic_step(jen, **kw))
    step = tt.make_npt_triclinic_step(ten, **kw)
    for _ in range(6):
        noise = npt_draws(js.key, js.x, js.energy, 3 if diagonal_only else 6)
        with torch.no_grad():
            s = step.move(s, noise)
        js = jstep(js)
        np.testing.assert_allclose(s.cell.numpy(), np.asarray(js.cell),
                                   atol=1e-5)
        np.testing.assert_allclose(s.x.numpy(), np.asarray(js.x), atol=1e-5)
        np.testing.assert_allclose(s.energy.numpy(), np.asarray(js.energy),
                                   rtol=1e-5, atol=1e-5)
    assert [int(s.disp_trials), int(s.disp_acc), int(s.cell_trials),
            int(s.cell_acc)] == [count(js.disp_trials), count(js.disp_acc),
                                 count(js.cell_trials), count(js.cell_acc)]
    assert 0 < int(s.cell_acc) < int(s.cell_trials)
    s2 = tt.npt_triclinic_init(ten, t(x), cell0,
                               torch.Generator().manual_seed(0))
    s2, traj = tt.run_npt_triclinic(step, s2, 7, collect_every=3)
    assert traj["volume"].shape == (2, 8) and traj["cell"].shape == (2, 8,
                                                                      3, 3)
    for hh in s2.cell:
        tt.validate_cell(hh)
