"""The port's PME, MD integrators and the molecular stack against the JAX
package, on the CPU.

Inputs come from ``numpy.random.default_rng``; the integrators' random
normals differ between the packages (torch.Generator and JAX keys), so
trajectories are compared only where they are deterministic (velocity
Verlet), and Langevin runs by their statistics.  Float32 throughout;
each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import md as jmd
from vaemolsim_tpu import potentials as jp
from vaemolsim_tpu_torch import md, potentials as tp
from vaemolsim_tpu_torch.convert import from_jax

torch.set_num_threads(1)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def pme_system(n, L, seed):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, 3)) * L).astype(np.float32)
    q = rng.normal(size=n)
    return x, q - q.mean(), np.array([[2 * k, 2 * k + 1]
                                      for k in range(n // 2)])


def value_and_grad(energy, x):
    xt = t(x).requires_grad_()
    e = energy(xt)
    (g,) = torch.autograd.grad(e, xt)
    return e.item(), g.numpy()


@pytest.mark.parametrize("exclude", [False, True])
@pytest.mark.parametrize("real_space", [True, False])
def test_pme_matches_jax(real_space, exclude):
    """Energy and forces (autograd through the spread and the FFT) of 40
    charges in a box of 6 at tolerance 1e-5 (grid 30^3, order 6).  The
    total is a difference of terms ~4x its size (self against
    reciprocal), each summed in float32 in another order (FFT included):
    energy to 5e-5 relative; forces to 1e-5 of the largest."""
    x, q, pairs = pme_system(40, 6.0, 0)
    kw = dict(box=[6.0] * 3, r_cutoff=2.5, tolerance=1e-5,
              include_real_space=real_space,
              exclude=pairs if exclude else None)
    energy = tp.pme_coulomb(q, device="cpu", **kw)
    jenergy = jp.pme_coulomb(q, **kw)
    assert energy.grid_shape == jenergy.grid_shape
    assert energy.ewald_alpha == jenergy.ewald_alpha
    e, g = value_and_grad(energy, x)
    ej, gj = jax.value_and_grad(jenergy)(jnp.asarray(x))
    np.testing.assert_allclose(e, float(ej), rtol=5e-5)
    np.testing.assert_allclose(g, np.asarray(gj), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(gj)).max())


@pytest.mark.parametrize("spread", ["binned", "scatter"])
def test_pme_matches_jax_spreads_at_1024(spread):
    """1024 charges on a coarse 16^3 grid, order 4, reciprocal part only,
    with exclusions: the port's one index_add against both JAX spreads
    (the binned one is JAX's default at this size).  Tolerances as
    above."""
    x, q, pairs = pme_system(1024, 12.0, 1)
    kw = dict(box=[12.0] * 3, r_cutoff=3.0, tolerance=1e-4,
              grid_shape=(16, 16, 16), order=4, exclude=pairs,
              include_real_space=False)
    e, g = value_and_grad(tp.pme_coulomb(q, device="cpu", **kw), x)
    ej, gj = jax.value_and_grad(jp.pme_coulomb(q, spread=spread, **kw))(
        jnp.asarray(x))
    np.testing.assert_allclose(e, float(ej), rtol=5e-5)
    np.testing.assert_allclose(g, np.asarray(gj), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(gj)).max())


def test_pme_grid_rule_matches_jax_at_the_molecular_stack():
    """The grid and alpha chosen for the production molecular stack (8192
    atoms at density 0.6, r_cutoff 3.5, tolerance 1e-4) are JAX's."""
    L = float((8192 / 0.6) ** (1.0 / 3.0))
    kw = dict(box=[L] * 3, r_cutoff=3.5, tolerance=1e-4,
              include_real_space=False)
    q = np.array([0.5, -0.5])
    got = tp.pme_coulomb(q, device="cpu", **kw)
    want = jp.pme_coulomb(q, **kw)
    assert got.grid_shape == want.grid_shape == (64, 64, 64)
    assert got.ewald_alpha == want.ewald_alpha


def test_pme_refuses_what_is_not_ported():
    q = np.array([1.0, -1.0])
    # Triclinic PME (cell=) is ported; box= and cell= together are refused.
    assert callable(tp.pme_coulomb(q, cell=np.eye(3) * 6.0, r_cutoff=2.0,
                                   device="cpu"))
    with pytest.raises(ValueError, match="exactly one"):
        tp.pme_coulomb(q, box=[6.0] * 3, cell=np.eye(3) * 6.0, r_cutoff=2.0,
                       device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        tp.pme_coulomb(q, box=[6.0] * 3, r_cutoff=2.0, mesh=object(),
                       device="cpu")
    with pytest.raises(ValueError, match="r_cutoff"):
        tp.pme_coulomb(q, box=[4.0] * 3, r_cutoff=2.5, device="cpu")
    with pytest.raises(ValueError, match="atoms"):
        tp.pme_coulomb(q, box=[6.0] * 3, r_cutoff=2.0,
                       device="cpu")(torch.zeros(3, 3))


def neighbor_system(port=True, capacity=32):
    """tests/test_md.py's 64-atom system: a 4^3 lattice of spacing 2.2 in
    a box of 9 (27 cells, 2.4 atoms each on average), cutoff 2.5, skin
    0.5, capacity 32."""
    g = np.stack(np.meshgrid(*[np.arange(4.0)] * 3, indexing="ij"),
                 -1).reshape(-1, 3) * 2.2
    v0 = 0.2 * np.random.default_rng(2).normal(size=g.shape)
    kw = dict(box=[9.0] * 3, cutoff=2.5, skin=0.5, capacity=capacity)
    pair = (tp.lennard_jones_cell_neighbor(device="cpu", **kw) if port
            else jp.lennard_jones_cell_neighbor(**kw))
    return (*pair, g.astype(np.float32), v0.astype(np.float32))


def test_velocity_verlet_neighbor_matches_jax_trajectory():
    """20 NVE steps (dt 0.002, rebuild every 10) from the same start:
    deterministic in both packages, so positions, velocities and forces
    agree to 1e-5 (float32 sums in another order, carried 20 steps)."""
    build, energy, x0, v0 = neighbor_system()
    jbuild, jenergy, *_ = neighbor_system(port=False)
    s, traj = md.velocity_verlet_neighbor(build, energy, t(x0), t(v0),
                                          dt=0.002, n_steps=20,
                                          rebuild_every=10)
    js, _ = jmd.velocity_verlet_neighbor(jbuild, jenergy, jnp.asarray(x0),
                                         jnp.asarray(v0), dt=0.002,
                                         n_steps=20, rebuild_every=10)
    assert traj is None
    for got, want in zip(s, js):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


def test_velocity_verlet_matches_jax_with_collection_and_masses():
    """A harmonic dimer with per-atom masses: 100 steps, positions every
    20, against JAX (1e-5), and the collect_every validation."""
    pot = tp.harmonic_bonds([[0, 1]], 100.0, 1.0, device="cpu")
    jpot = jp.harmonic_bonds([[0, 1]], 100.0, 1.0)
    x0 = np.array([[0.0, 0, 0], [1.2, 0.1, 0]], np.float32)
    v0 = np.array([[0.0, 0.3, 0], [0.1, 0, 0]], np.float32)
    m = np.array([1.0, 3.0], np.float32)
    s, traj = md.velocity_verlet(pot, t(x0), t(v0), dt=0.01, n_steps=100,
                                 masses=t(m), collect_every=20)
    js, jtraj = jmd.velocity_verlet(jpot, jnp.asarray(x0), jnp.asarray(v0),
                                    dt=0.01, n_steps=100,
                                    masses=jnp.asarray(m), collect_every=20)
    assert traj.shape == (5, 2, 3)
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), atol=1e-5)
    np.testing.assert_allclose(s.v.numpy(), np.asarray(js.v), atol=1e-5)
    with pytest.raises(ValueError, match="multiple"):
        md.velocity_verlet(pot, t(x0), t(v0), dt=0.01, n_steps=10,
                           collect_every=3)


def test_baoab_at_zero_friction_is_velocity_verlet():
    """friction=0 makes the O step the identity: the same trajectory as
    velocity Verlet to 1e-5, and the collected (x, v) pair."""
    pot = tp.harmonic_bonds([[0, 1]], 100.0, 1.0, device="cpu")
    x0 = t([[0.0, 0, 0], [1.15, 0, 0]])
    v0 = t([[0.1, 0, 0], [-0.1, 0, 0]])
    nve, _ = md.velocity_verlet(pot, x0, v0, dt=0.01, n_steps=50)
    nvt, (xs, vs) = md.baoab(pot, x0, v0, torch.Generator().manual_seed(0),
                             dt=0.01, n_steps=50, friction=0.0,
                             collect_every=10, collect_v=True)
    torch.testing.assert_close(nvt.x, nve.x, atol=1e-5, rtol=0)
    torch.testing.assert_close(nvt.v, nve.v, atol=1e-5, rtol=0)
    assert xs.shape == vs.shape == (5, 2, 3)
    assert torch.equal(xs[-1], nvt.x) and torch.equal(vs[-1], nvt.v)


def test_baoab_neighbor_thermalizes():
    """As tests/test_md.py: 600 Langevin steps at kT 0.7, friction 2,
    rebuild every 10, from a lattice: finite, kinetic temperature within
    0.25 of kT.  Capacity 12 (an overflow would show as NaN) keeps the
    plain cell-pair block small on the CPU."""
    build, energy, x0, v0 = neighbor_system(capacity=12)
    gen = torch.Generator().manual_seed(3)
    s, _ = md.baoab_neighbor(build, energy, t(x0), t(v0), gen, dt=0.004,
                             n_steps=600, rebuild_every=10, friction=2.0,
                             kT=0.7)
    assert bool(torch.isfinite(s.x).all())
    assert abs(float(md.temperature(s.v)) - 0.7) < 0.25


def test_rebuild_every_validated():
    build, energy, x0, v0 = neighbor_system()
    with pytest.raises(ValueError, match="rebuild_every"):
        md.velocity_verlet_neighbor(build, energy, t(x0), t(v0), dt=0.01,
                                    n_steps=10, rebuild_every=3)
    with pytest.raises(ValueError, match="rebuild_every"):
        md.baoab_neighbor(build, energy, t(x0), t(v0), torch.Generator(),
                          dt=0.01, n_steps=10, rebuild_every=0)


def molecular_stack(port, n=144, L=9.0, cutoff=2.5):
    """The production molecular stack (bench.py's) at small size: charged
    dimers (+-0.5) with harmonic bonds (k 200, r0 1), bonded exclusions
    masked inside the cell-list LJ with its Ewald real-space term, and
    PME reciprocal space with the same exclusions."""
    pkg = tp if port else jp
    dev = dict(device="cpu") if port else {}
    bonds = np.array([[2 * k, 2 * k + 1] for k in range(n // 2)])
    q = np.tile([0.5, -0.5], n // 2)
    recip = pkg.pme_coulomb(q, box=[L] * 3, r_cutoff=cutoff, tolerance=1e-4,
                            exclude=bonds, include_real_space=False, **dev)
    kw = dict(box=[L] * 3, cutoff=cutoff, skin=0.4, capacity=32, charges=q,
              coulomb_alpha=recip.ewald_alpha, exclude=bonds, **dev)
    if not port:
        kw.update(backend="pallas", interpret=True)
    build, cell_e = pkg.lennard_jones_cell_neighbor(**kw)
    bonded = pkg.harmonic_bonds(bonds, k=200.0, r0=1.0, **dev)
    return build, lambda nl, x: cell_e(nl, x) + recip(x) + bonded(x)


def dimer_lattice(n=144, L=9.0, seed=4):
    """bench.py's even-z lattice start: consecutive atoms z-adjacent, so
    every bond starts at one lattice spacing; jittered slightly."""
    mz = 2 * int(np.ceil(n ** (1.0 / 3.0) / 2.0))
    mxy = int(np.ceil(np.sqrt(n / mz)))
    g = np.stack(np.meshgrid(np.arange(mxy), np.arange(mxy), np.arange(mz),
                             indexing="ij"), -1).reshape(-1, 3)[:n]
    g = g * (L / np.array([mxy, mxy, mz]))
    return (g + 0.05 * np.random.default_rng(seed).normal(size=g.shape)
            ).astype(np.float32)


def test_molecular_stack_energy_matches_jax():
    """Energy (1e-5 relative) and gradient (1e-5 of the largest) of the
    whole stack, bonds + cell LJ/erfc + PME, against JAX's pallas route."""
    x = dimer_lattice()
    build, energy = molecular_stack(True)
    jbuild, jenergy = molecular_stack(False)
    e, g = value_and_grad(lambda y: energy(build(t(x)), y), x)
    jnl = jbuild(jnp.asarray(x))
    ej, gj = jax.value_and_grad(lambda y: jenergy(jnl, y))(jnp.asarray(x))
    np.testing.assert_allclose(e, float(ej), rtol=1e-5)
    np.testing.assert_allclose(g, np.asarray(gj), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(gj)).max())


def test_from_jax_carries_a_list_and_a_trajectory_state():
    """A JAX cell list and a JAX velocity-Verlet state, carried into the
    port: the port evaluates the JAX list as its own build (same energy)
    and continues the JAX trajectory as JAX does (1e-5 after 10 more
    steps)."""
    build, energy, x0, v0 = neighbor_system()
    jbuild, jenergy, *_ = neighbor_system(port=False)
    js, _ = jmd.velocity_verlet_neighbor(jbuild, jenergy, jnp.asarray(x0),
                                         jnp.asarray(v0), dt=0.002,
                                         n_steps=10, rebuild_every=10)
    state = from_jax(js, "cpu")
    assert isinstance(state, md.MDState)
    jnl = jbuild(js.x)
    nl = from_jax(jnl, "cpu")
    assert nl.cell_atoms.dtype == torch.int32 and nl.overflow.dtype == \
        torch.bool
    assert energy(nl, state.x).item() == energy(build(state.x),
                                                state.x).item()
    s, _ = md.velocity_verlet(lambda x: energy(nl, x), state.x, state.v,
                              dt=0.002, n_steps=10, f0=state.force)
    jn, _ = jmd.velocity_verlet(lambda x: jenergy(jnl, x), js.x, js.v,
                                dt=0.002, n_steps=10, f0=js.force)
    for got, want in zip(s, jn):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


def test_constructors_build_on_the_card_by_default():
    """With no device every potential constructor builds on CUDA; without
    a card it raises and names the CPU option."""
    makers = [
        lambda d: tp.harmonic_bonds([[0, 1]], 1.0, 1.0, device=d),
        lambda d: tp.lennard_jones(device=d),
        lambda d: tp.lennard_jones_cell_neighbor(box=[9.0] * 3, cutoff=2.5,
                                                 device=d),
        lambda d: tp.lennard_jones_cell(box=[9.0] * 3, cutoff=2.5, device=d),
        lambda d: tp.pme_coulomb([1.0, -1.0], box=[6.0] * 3, r_cutoff=2.0,
                                 device=d),
    ]
    for make in makers:
        if torch.cuda.is_available():
            make(None)
            continue
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(None)
        make("cpu")
