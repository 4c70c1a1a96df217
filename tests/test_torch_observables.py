"""The port's observables against the JAX package, on the CPU: every
function of ``observables.py`` on the same numpy-made arrays, float32,
to 1e-5 relative + 1e-5 unless a test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import observables as jo
from vaemolsim_tpu import potentials as jp
from vaemolsim_tpu_torch import observables as to
from vaemolsim_tpu_torch import potentials as tp

torch.set_num_threads(1)

RNG = np.random.default_rng(0)
X = (RNG.random((3, 12, 3)) * 4.0).astype(np.float32)          # configs
TRAJ = np.cumsum(0.1 * RNG.normal(size=(64, 2, 5, 3)), 0).astype(np.float32)
VTRAJ = RNG.normal(size=(64, 2, 5, 3)).astype(np.float32)
BOX = [4.0, 4.0, 4.0]


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def close(got, want, rtol=1e-5, atol=1e-5):
    got = [got] if isinstance(got, torch.Tensor) else list(got)
    want = [want] if not isinstance(want, (tuple, list)) else list(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=rtol, atol=atol)


CASES = {
    "radius_of_gyration": lambda m, x: m.radius_of_gyration(x(X)),
    "pair_distance_histogram": lambda m, x: m.pair_distance_histogram(
        x(X), r_max=3.0, n_bins=20, box=BOX),
    "radial_distribution": lambda m, x: m.radial_distribution(
        x(X), box=BOX, n_bins=16),
    "mean_squared_displacement": lambda m, x: m.mean_squared_displacement(
        x(TRAJ)),
    "velocity_autocorrelation": lambda m, x: m.velocity_autocorrelation(
        x(VTRAJ)),
    "autocorrelation_fft": lambda m, x: m.autocorrelation_fft(x(VTRAJ)),
    "diffusion_coefficient": lambda m, x: m.diffusion_coefficient(
        x(TRAJ), dt=0.1),
    "green_kubo_diffusion": lambda m, x: m.green_kubo_diffusion(
        x(VTRAJ), dt=0.1),
    "vibrational_spectrum": lambda m, x: m.vibrational_spectrum(
        x(VTRAJ), dt=0.1),
    "kinetic_stress": lambda m, x: m.kinetic_stress(
        x(VTRAJ[0]), box=BOX, masses=np.arange(1, 6, dtype=np.float32)),
    "green_kubo_viscosity": lambda m, x: m.green_kubo_viscosity(
        x(RNG.normal(size=(40, 2, 3, 3))), dt=0.05, volume=64.0, kt=1.2),
    "green_kubo_thermal_conductivity":
        lambda m, x: m.green_kubo_thermal_conductivity(
            x(RNG.normal(size=(40, 2, 3))), dt=0.05, volume=64.0, kt=1.2),
    "surface_tension": lambda m, x: m.surface_tension(
        x(RNG.normal(size=(10, 3))), box=[4.0, 4.0, 9.0]),
    "structure_factor": lambda m, x: m.structure_factor(
        x(X), box=BOX, k_max=6.0, n_bins=8),
    "kabsch_align": lambda m, x: m.kabsch_align(
        x(X), x(X[0] + 0.1), weights=x(np.arange(1, 13))),
    "rmsd": lambda m, x: m.rmsd(x(X), x(X[0] + 0.1)),
    "rmsd_no_superpose": lambda m, x: m.rmsd(x(X), x(X[0]),
                                             superpose=False),
    "quasi_harmonic_frequencies": lambda m, x: m.quasi_harmonic_frequencies(
        x(TRAJ[:, 0, :2]), kt=1.0, masses=x([1.0, 2.0])),
    "harmonic_free_energy": lambda m, x: m.harmonic_free_energy(
        x([0.0, 0.5, 1.5, 3.0]), kt=0.7),
    "heat_capacity_nvt": lambda m, x: m.heat_capacity_nvt(
        x(RNG.normal(size=(50, 4))), kt=1.3, n_dof_kinetic=6),
    "heat_capacity_npt": lambda m, x: m.heat_capacity_npt(
        x(RNG.normal(size=(50, 4))), x(5 + RNG.random((50, 4))), kt=1.3,
        pressure=0.8, n_dof_kinetic=6),
    "isothermal_compressibility": lambda m, x: m.isothermal_compressibility(
        x(5 + RNG.random((50, 4))), kt=1.3),
    "thermal_expansion": lambda m, x: m.thermal_expansion(
        x(RNG.normal(size=(50, 4))), x(5 + RNG.random((50, 4))), kt=1.3,
        pressure=0.8),
    "total_dipole": lambda m, x: m.total_dipole(x(X), x(RNG.normal(
        size=12))),
    "dielectric_constant": lambda m, x: m.dielectric_constant(
        x(RNG.normal(size=(30, 2, 3))), volume=64.0, kt=1.1),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_observable_matches_jax(name):
    """Each function on the same arrays (drawn once, in a fixed order),
    to 1e-5 relative + 1e-5 (the histograms' counts exactly; the FFT
    estimators to 1e-4 of their scale)."""
    state = RNG.bit_generator.state
    got = CASES[name](to, t)
    RNG.bit_generator.state = state
    want = CASES[name](jo, jnp.asarray)
    if "fft" in name or name.startswith(("green", "diffusion", "vib")):
        g = [got] if isinstance(got, torch.Tensor) else list(got)
        w = [want] if not isinstance(want, tuple) else list(want)
        for a, b in zip(g, w):
            scale = float(np.abs(np.asarray(b)).max())
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-4 * scale + 1e-6)
    elif name == "quasi_harmonic_frequencies":
        close(got, want, rtol=1e-3)
    else:
        close(got, want)


def lj_for_box(box_module):
    if box_module is tp:
        return lambda b: tp.lennard_jones(box=b, cutoff=1.9, device="cpu")
    return lambda b: jp.lennard_jones(box=b, cutoff=1.9)


def test_virial_pressure_matches_jax_and_the_pair_virial():
    """The dilation derivative on dense LJ (box 4, cutoff 1.9, shifted)
    equals JAX's to 1e-5 and the explicit pair virial ``(N kT + (1/3)
    sum_{i<j} r_ij . f_ij) / V`` to 1e-4 relative."""
    x = t(X)
    p = to.virial_pressure(lj_for_box(tp), x, box=BOX, kt=1.2)
    jpv = jo.virial_pressure(lj_for_box(jp), jnp.asarray(X), box=BOX,
                             kt=1.2)
    close(p, jpv)
    d = x[..., :, None, :] - x[..., None, :, :]
    d = d - 4.0 * torch.round(d / 4.0)
    r = d.norm(dim=-1) + torch.eye(12)
    sr6 = (1.0 / r) ** 6
    dudr = -24.0 * (2 * sr6 * sr6 - sr6) / r
    mask = torch.ones(12, 12, dtype=torch.bool).triu(1) & (r < 1.9)
    w = torch.where(mask, -dudr * r, 0.0).sum((-2, -1))
    want = (12 * 1.2 + w / 3.0) / 64.0
    close(p, want.numpy(), rtol=1e-4)


def test_pressure_tensor_diag_matches_jax_and_its_mean_is_the_virial():
    """Per-axis dilations with velocities and with kT, against JAX to
    1e-5; the mean of the diagonal (kT form) is the virial pressure."""
    x = t(X)
    v = t(VTRAJ[0, 0])[None].expand(3, 5, 3)
    got = to.pressure_tensor_diag(lj_for_box(tp), x, box=BOX, kt=1.2)
    want = jo.pressure_tensor_diag(lj_for_box(jp), jnp.asarray(X), box=BOX,
                                   kt=1.2)
    close(got, want)
    close(got.mean(-1), to.virial_pressure(lj_for_box(tp), x, box=BOX,
                                           kt=1.2).numpy())
    x5 = t(X[:, :5])
    got = to.pressure_tensor_diag(lj_for_box(tp), x5, box=BOX, v=v)
    want = jo.pressure_tensor_diag(lj_for_box(jp), jnp.asarray(X[:, :5]),
                                   box=BOX, v=jnp.asarray(v.numpy()))
    close(got, want)


def test_virial_pressure_through_ewald():
    """The dilation goes through ``ewald_coulomb`` with a tensor box and
    a frozen mode set (``reference_box``): against JAX to 1e-4."""
    q = np.tile([1.0, -1.0], 6)
    kw = dict(r_cutoff=1.9, reference_box=BOX)
    p = to.virial_pressure(
        lambda b: tp.ewald_coulomb(q, box=b, device="cpu", **kw), t(X),
        box=BOX)
    jpv = jo.virial_pressure(lambda b: jp.ewald_coulomb(q, box=b, **kw),
                             jnp.asarray(X), box=BOX)
    close(p, jpv, rtol=1e-4)


def test_normal_modes_match_jax():
    """A bonded triangle of three atoms with masses (1, 2, 3): the
    signed eigenvalues omega |omega| to 1e-4 of the largest (the six
    zero modes are float32 noise, so their square roots are compared
    squared) and each vibrational mode up to sign."""
    bonds = np.array([[0, 1], [1, 2], [0, 2]])
    x = np.array([[0.0, 0.0, 0.0], [1.1, 0.0, 0.0], [0.5, 0.9, 0.0]],
                 np.float32)
    masses = np.array([1.0, 2.0, 3.0], np.float32)
    om, modes = to.normal_modes(
        tp.harmonic_bonds(bonds, 50.0, 1.0, device="cpu"), t(x),
        masses=masses)
    jom, jmodes = jo.normal_modes(jp.harmonic_bonds(bonds, 50.0, 1.0),
                                  jnp.asarray(x), masses=masses)
    lam, jlam = om * om.abs(), np.asarray(jom) * np.abs(np.asarray(jom))
    np.testing.assert_allclose(lam.numpy(), jlam, rtol=0,
                               atol=1e-4 * float(np.abs(jlam).max()))
    top = slice(-3, None)
    got, want = modes.numpy()[:, top], np.asarray(jmodes)[:, top]
    sign = np.sign((got * want).sum(0))
    np.testing.assert_allclose(got * sign, want, atol=1e-3)


def test_widom_insertion_matches_jax_on_shared_ghosts():
    """The estimator on the same ghosts: the port's generator draws them,
    JAX's ``exp_free_energy`` averages the same insertion energies; mu
    and its error to 1e-5 relative, on three 8-atom lattice
    configurations (spacing 2, box 4, noise 0.1: moderate energies, so
    the differences U([x; ghost]) - U(x) keep their float32 digits).
    Zero potential gives mu_ex = 0 exactly."""
    from vaemolsim_tpu.mcmc.free_energy import exp_free_energy
    grid = np.stack(np.meshgrid(*[np.arange(2)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)
    xs = (2.0 * grid + 0.5 + 0.1 * np.random.default_rng(9).normal(
        size=(3, 8, 3))).astype(np.float32)
    lj = tp.lennard_jones(box=BOX, cutoff=1.9, device="cpu")
    jlj = jp.lennard_jones(box=BOX, cutoff=1.9)
    g = torch.Generator().manual_seed(3)
    mu, err = to.widom_insertion(lj, t(xs), box=BOX, generator=g,
                                 n_insertions=8, kT=1.3)
    ghosts = 4.0 * torch.rand((8, 3, 3), generator=torch.Generator()
                              .manual_seed(3))
    aug = [np.concatenate([xs, gh.numpy()[:, None, :]], 1) for gh in ghosts]
    du = np.stack([np.asarray(jlj(jnp.asarray(a)) - jlj(jnp.asarray(xs)))
                   for a in aug])
    jmu, jerr = exp_free_energy(jnp.asarray(du) / 1.3)
    np.testing.assert_allclose(float(mu), 1.3 * float(jmu), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(err), 1.3 * float(jerr), rtol=1e-4)
    zero, _ = to.widom_insertion(lambda y: (0.0 * y).sum((-2, -1)), t(X),
                                 box=BOX, generator=g)
    assert float(zero) == 0.0
