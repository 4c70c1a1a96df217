"""The port's remaining MD integrators against the JAX package, on the
CPU: SHAKE / RATTLE bond constraints, Nose-Hoover chains, r-RESPA,
steered Langevin, CSVR and the NPT barostat.

Deterministic integrators (and the stochastic ones at friction 0) are
compared step for step with JAX; the random streams differ between the
packages (torch.Generator against JAX keys), so CSVR and the barostat
are held to their stationary statistics, with the bounds stated.  Inputs
come from ``numpy.random.default_rng``; float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import md as jmd
from vaemolsim_tpu import potentials as jp
from vaemolsim_tpu_torch import md, potentials as tp
from vaemolsim_tpu_torch.ops.distributions import standard_gamma

torch.set_num_threads(1)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def waters(n_mol, seed, spacing=3.0):
    """n_mol three-site molecules on a line: O-H 1.0, H-H 1.633, random
    orientations; the bonds (with H-H) and masses (16, 1, 1)."""
    rng = np.random.default_rng(seed)
    xs, bonds = [], []
    for k in range(n_mol):
        o = np.array([spacing * k, 0.0, 0.0]) + 0.1 * rng.normal(size=3)
        a, b = rng.normal(size=3), rng.normal(size=3)
        a /= np.linalg.norm(a)
        b -= (b @ a) * a
        b /= np.linalg.norm(b)
        half = 0.5 * 1.8239
        h1 = o + np.cos(half) * a + np.sin(half) * b
        h2 = o + np.cos(half) * a - np.sin(half) * b
        xs += [o, h1, h2]
        bonds += [[3 * k, 3 * k + 1], [3 * k, 3 * k + 2],
                  [3 * k + 1, 3 * k + 2]]
    x = np.asarray(xs, np.float32)
    bonds = np.asarray(bonds)
    lengths = np.linalg.norm(x[bonds[:, 0]] - x[bonds[:, 1]], axis=-1)
    masses = np.tile([16.0, 1.0, 1.0], n_mol).astype(np.float32)
    return x, bonds, lengths.astype(np.float32), masses


def water_potential(n, bonds, torch_side):
    excl = tp.exclusions_from_bonds(n, bonds)
    if torch_side:
        lj = tp.lennard_jones(sigma=1.2, epsilon=0.5, exclude=excl,
                              device="cpu")
        return lambda x: lj(x) + 0.01 * (x * x).sum((-2, -1))
    jlj = jp.lennard_jones(sigma=1.2, epsilon=0.5, exclude=excl)
    return lambda x: jlj(x) + 0.01 * jnp.sum(x * x, axis=(-2, -1))


def test_shake_and_rattle_match_jax():
    """One SHAKE projection of a displaced batch (positions and the
    separate correction) and one RATTLE projection of random velocities,
    to 1e-5 + 1e-5 relative; the bonds then hold to 1e-5."""
    x, bonds, lengths, masses = waters(3, 0)
    rng = np.random.default_rng(1)
    xb = np.stack([x, x]).astype(np.float32)
    moved = (xb + 0.05 * rng.normal(size=xb.shape)).astype(np.float32)
    vel = rng.normal(size=xb.shape).astype(np.float32)
    con = md.bond_constraints(bonds, lengths, 9, masses, device="cpu")
    jcon = jmd.bond_constraints(bonds, lengths, 9, masses)
    np.testing.assert_array_equal(con.inc.numpy(), np.asarray(jcon.inc))
    got, delta = con.shake_delta(t(xb), t(moved))
    want, jdelta = jcon.shake_delta(jnp.asarray(xb), jnp.asarray(moved))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(delta.numpy(), np.asarray(jdelta), rtol=1e-5,
                               atol=1e-5)
    d = got[..., bonds[:, 0], :] - got[..., bonds[:, 1], :]
    np.testing.assert_allclose(d.norm(dim=-1).numpy(),
                               np.broadcast_to(lengths, (2, 9)), atol=1e-5)
    v = con.rattle(got, t(vel))
    jv = jcon.rattle(want, jnp.asarray(vel))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("thermostat", ["verlet", "baoab_friction_0"])
def test_constrained_integrators_match_jax(thermostat):
    """50 RATTLE steps (dt 0.005) of three rigid waters, and constrained
    BAOAB at friction 0 (its noise then vanishes), step for step with
    JAX: positions to 1e-4, velocities to 1e-3 (float32 over 50 steps);
    the bond lengths to 1e-5."""
    x, bonds, lengths, masses = waters(3, 2)
    v0 = (0.3 * np.random.default_rng(3).normal(size=x.shape)
          / np.sqrt(masses)[:, None]).astype(np.float32)
    con = md.bond_constraints(bonds, lengths, 9, masses, device="cpu")
    jcon = jmd.bond_constraints(bonds, lengths, 9, masses)
    kw = dict(dt=0.005, n_steps=50, masses=masses)
    pot, jpot = water_potential(9, bonds, True), water_potential(9, bonds,
                                                                 False)
    if thermostat == "verlet":
        s, _ = md.velocity_verlet_constrained(pot, t(x), t(v0),
                                              constraints=con, **kw)
        js, _ = jmd.velocity_verlet_constrained(
            jpot, jnp.asarray(x), jnp.asarray(v0), constraints=jcon, **kw)
    else:
        s, _ = md.baoab_constrained(pot, t(x), t(v0), torch.Generator(),
                                    constraints=con, friction=0.0, **kw)
        js, _ = jmd.baoab_constrained(
            jpot, jnp.asarray(x), jnp.asarray(v0), jnp.zeros(2, jnp.uint32),
            constraints=jcon, friction=0.0, **kw)
    np.testing.assert_allclose(s.x.numpy(), np.asarray(js.x), atol=1e-4)
    np.testing.assert_allclose(s.v.numpy(), np.asarray(js.v), atol=1e-3)
    d = s.x[bonds[:, 0]] - s.x[bonds[:, 1]]
    np.testing.assert_allclose(d.norm(dim=-1).numpy(), lengths, atol=1e-5)


def oscillators(seed, shape=(4, 8, 3)):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def anharmonic(x):
    return (0.5 * x * x + 0.1 * x ** 4).sum((-2, -1))


def test_nose_hoover_matches_jax_and_conserves_its_invariant():
    """Nose-Hoover chains on anharmonic oscillators: 40 steps against
    JAX (positions, velocities and chain variables to 1e-4), then 500
    steps on the port alone, whose invariant drifts by less than 1e-3
    relative."""
    x, v = oscillators(0)
    kw = dict(dt=0.01, kT=1.0, tau=0.2)
    s, _ = md.nose_hoover(anharmonic, t(x), t(v), n_steps=40, **kw)
    js, _ = jmd.nose_hoover(anharmonic, jnp.asarray(x), jnp.asarray(v),
                            n_steps=40, **kw)
    for a, b in ((s.x, js.x), (s.v, js.v), (s.xi, js.xi),
                 (s.v_xi, js.v_xi)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)
    h0 = md.nose_hoover_invariant(anharmonic, s, kT=1.0, tau=0.2)
    np.testing.assert_allclose(
        h0.numpy(), np.asarray(jmd.nose_hoover_invariant(
            anharmonic, js, kT=1.0, tau=0.2)), rtol=1e-5)
    s, _ = md.nose_hoover(anharmonic, None, None, n_steps=500, state=s,
                          **kw)
    h1 = md.nose_hoover_invariant(anharmonic, s, kT=1.0, tau=0.2)
    assert float(((h1 - h0).abs() / h0.abs()).max()) < 1e-3


def test_respa_matches_jax():
    """r-RESPA with a stiff fast force and a soft slow one, 30 outer
    steps of 4 inner, collecting every 10: trajectory and final state
    against JAX to 1e-4."""
    x, v = oscillators(1)

    def fast(y):
        return (20.0 * y * y).sum((-2, -1))

    def slow(y):
        return (0.1 * y ** 4).sum((-2, -1))

    kw = dict(dt=0.02, n_steps=30, n_inner=4, collect_every=10)
    s, traj = md.respa_verlet(fast, slow, t(x), t(v), **kw)
    js, jtraj = jmd.respa_verlet(fast, slow, jnp.asarray(x), jnp.asarray(v),
                                 **kw)
    assert traj.shape == jtraj.shape == (3, 4, 8, 3)
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), atol=1e-4)
    np.testing.assert_allclose(s.v.numpy(), np.asarray(js.v), atol=1e-4)


def test_steered_baoab_matches_jax_at_friction_0():
    """A harmonic trap dragged from 0 to 1 over 40 steps at friction 0
    (deterministic): the final state and the per-replica work against
    JAX to 1e-4."""
    x, v = oscillators(2)

    def for_lam(lam):
        return lambda y: (0.5 * (y - lam) ** 2).sum((-2, -1))

    lams = np.linspace(0.0, 1.0, 41).astype(np.float32)
    kw = dict(dt=0.02, n_steps=40, friction=0.0)
    s, w = md.steered_baoab(for_lam, t(x), t(v), torch.Generator(),
                            lambdas=lams, **kw)
    js, jw = jmd.steered_baoab(for_lam, jnp.asarray(x), jnp.asarray(v),
                               jnp.zeros(2, jnp.uint32),
                               lambdas=jnp.asarray(lams), **kw)
    np.testing.assert_allclose(s.x.numpy(), np.asarray(js.x), atol=1e-4)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-4,
                               rtol=1e-4)


def test_standard_gamma_moments():
    """200 000 draws of the gamma that CSVR's chi^2 takes, at
    concentrations 0.5, 1.5 and 40.5 (a chi^2 of 82 degrees of freedom):
    mean a and variance a, each within 5 standard errors."""
    g = torch.Generator().manual_seed(0)
    n = 200_000
    for a in (0.5, 1.5, 40.5):
        d = standard_gamma(g, torch.tensor(a), (n,)).double()
        assert bool(torch.isfinite(d).all()) and float(d.min()) > 0
        assert abs(float(d.mean()) - a) < 5 * np.sqrt(a / n)
        assert abs(float(d.var()) - a) < 5 * np.sqrt(2 * a * a * (a + 3) / n)


def test_csvr_samples_the_canonical_kinetic_energy():
    """CSVR on 256 replicas of 8 anharmonic oscillators at kT = 1.5:
    after 200 steps of burn-in, the mean kinetic temperature over the
    next 300 steps (every 10th) is within 2% of 1.5 and its spread across
    replicas matches the canonical 2 kT^2 / n_dof within 15%; the
    effective energy E - work drifts by less than 1e-2 relative."""
    x, v = oscillators(3, (256, 8, 3))
    g = torch.Generator().manual_seed(1)
    kw = dict(dt=0.01, kT=1.5, tau=0.1)
    s, _ = md.csvr(anharmonic, t(x), t(v), g, n_steps=200, **kw)
    temps = []
    e0 = anharmonic(s.x) + md.kinetic_energy(s.v) - s.work
    for _ in range(30):
        s, _ = md.csvr(anharmonic, None, None, g, n_steps=10, state=s, **kw)
        temps.append(md.temperature(s.v))
    temps = torch.stack(temps)
    assert abs(float(temps.mean()) - 1.5) < 0.03
    want_var = 2 * 1.5 ** 2 / 24
    assert abs(float(temps.var()) / want_var - 1.0) < 0.15
    e1 = anharmonic(s.x) + md.kinetic_energy(s.v) - s.work
    assert float(((e1 - e0).abs() / e0.abs()).max()) < 1e-2


def test_baoab_npt_ideal_gas_volume():
    """The MC barostat on an ideal gas (U = 0) of 4 atoms at P = 1, kT =
    1: the stationary law of V is Gamma(N + 1, kT / P), mean 5, variance
    5; over 512 replicas and 300 cycles (the last 200 kept) the mean is
    within 3% and the variance within 10%; acceptance in (0.2, 0.98)."""
    g = torch.Generator().manual_seed(2)
    x = torch.rand(512, 4, 3, generator=g) * 1.7

    def ideal(box):
        return lambda y: (y * 0.0).sum((-2, -1)) + 0.0 * box.sum((-3, -2, -1))

    s, (xs, boxes) = md.baoab_npt(ideal, x, torch.zeros_like(x),
                                  [1.7] * 3, g, dt=0.01, n_steps=300,
                                  pressure=1.0, vol_every=1,
                                  dlnv_scale=0.5, collect=True)
    vol = boxes[100:].prod(-1).double()
    assert abs(float(vol.mean()) / 5.0 - 1.0) < 0.03
    assert abs(float(vol.var()) / 5.0 - 1.0) < 0.10
    assert 0.2 < float(s.vol_acceptance_rate) < 0.98
