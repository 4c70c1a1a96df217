"""Equilibrium and dynamical observables (port of
``vaemolsim_tpu/observables.py``).

Reductions over configurations ``(..., n_atoms, dim)`` and trajectories
``(T, ..., n_atoms, dim)`` in plain PyTorch on the input's device: pair
histograms by ``bucketize`` and ``index_add``, autocorrelations by
``torch.fft``, pressures by a forward-mode derivative
(``torch.func.jvp``) through a dilation of coordinates and box, normal
modes by ``torch.func.hessian`` and ``torch.linalg.eigh``.  Random draws
(Widom ghosts) take an explicit ``torch.Generator``.  Nothing here
synchronises with the host except where a function returns a Python
number.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from vaemolsim_tpu_torch.mcmc.free_energy import exp_free_energy

Tensor = torch.Tensor

__all__ = ["radius_of_gyration", "pair_distance_histogram",
           "radial_distribution", "mean_squared_displacement",
           "velocity_autocorrelation", "virial_pressure",
           "structure_factor", "widom_insertion",
           "autocorrelation_fft", "diffusion_coefficient",
           "green_kubo_diffusion", "kabsch_align", "rmsd",
           "vibrational_spectrum", "normal_modes",
           "harmonic_free_energy", "quasi_harmonic_frequencies",
           "kinetic_stress", "pressure_tensor_diag",
           "green_kubo_viscosity", "surface_tension",
           "green_kubo_thermal_conductivity",
           "heat_capacity_nvt", "heat_capacity_npt",
           "isothermal_compressibility", "thermal_expansion",
           "dielectric_constant", "total_dipole"]


def _as(a, like: Tensor) -> Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def radius_of_gyration(x: Tensor) -> Tensor:
    """``sqrt(mean_atoms |r - com|^2)`` per configuration (equal
    masses)."""
    com = x.mean(-2, keepdim=True)
    return torch.sqrt(((x - com) ** 2).sum(-1).mean(-1))


def _pair_r(x: Tensor, box) -> Tuple[Tensor, Tensor]:
    n = x.shape[-2]
    mask = torch.ones((n, n), dtype=torch.bool, device=x.device).triu(1)
    d = x[..., :, None, :] - x[..., None, :, :]
    if box is not None:
        b = _as(box, x)
        d = d - b * torch.round(d / b)
    return torch.sqrt((d * d).sum(-1).clamp_min(1e-12)), mask


def _histogram(r: Tensor, keep: Tensor, r_max: float, n_bins: int
               ) -> Tensor:
    """Counts of ``r`` where ``keep`` in n_bins equal bins of [0, r_max]
    (the bin of an edge is the one it opens, as ``searchsorted(side=
    "right") - 1``)."""
    edges = torch.linspace(0.0, float(r_max), n_bins + 1, device=r.device)
    idx = (torch.bucketize(r, edges, right=True) - 1).clamp(0, n_bins - 1)
    keep = keep.expand(r.shape)
    return torch.zeros(n_bins, device=r.device).index_add(
        0, idx.reshape(-1), keep.reshape(-1).to(torch.float32))


def pair_distance_histogram(x: Tensor, *, r_max: float, n_bins: int = 100,
                            box: Optional[Sequence[float]] = None
                            ) -> Tuple[Tensor, Tensor]:
    """Probability density of pair distances over all configurations:
    ``(r_centers, pdf)`` with ``sum(pdf) dr = 1`` over [0, r_max]."""
    r, mask = _pair_r(x, box)
    counts = _histogram(r, mask & (r < r_max), r_max, n_bins)
    dr = r_max / n_bins
    edges = torch.linspace(0.0, float(r_max), n_bins + 1, device=x.device)
    return (0.5 * (edges[:-1] + edges[1:]),
            counts / (counts.sum().clamp_min(1.0) * dr))


def radial_distribution(x: Tensor, *, box: Sequence[float],
                        r_max: Optional[float] = None,
                        n_bins: int = 100) -> Tuple[Tensor, Tensor]:
    """g(r) of a homogeneous periodic system in 3-D: pair counts over the
    ideal-gas shell expectation, averaged over the leading axes;
    ``r_max`` defaults to half the smallest box edge."""
    if x.shape[-1] != 3:
        raise ValueError("radial_distribution is defined for 3-D boxes")
    box_np = np.asarray(box, np.float64)
    if r_max is None:
        r_max = float(box_np.min() / 2.0)
    n = x.shape[-2]
    n_frames = int(np.prod(x.shape[:-2])) or 1
    r, mask = _pair_r(x, box)
    counts = _histogram(r, mask & (r < r_max), r_max, n_bins) / n_frames
    rho_pairs = n * (n - 1) / 2.0 / float(box_np.prod())
    edges = torch.linspace(0.0, float(r_max), n_bins + 1, device=x.device)
    shell = (4.0 / 3.0) * math.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    return 0.5 * (edges[:-1] + edges[1:]), counts / (rho_pairs * shell)


def _lead_mean_dims(traj: Tensor) -> Tuple[int, ...]:
    return tuple(range(1, traj.dim() - 1))


def mean_squared_displacement(traj: Tensor) -> Tensor:
    """``<|x(t) - x(0)|^2>`` over atoms and replicas from the trajectory's
    origin; ``traj`` (T, ..., n_atoms, dim) unwrapped; returns (T,)."""
    d = traj - traj[:1]
    return (d * d).sum(-1).mean(_lead_mean_dims(traj))


def velocity_autocorrelation(vtraj: Tensor, normalize: bool = True
                             ) -> Tensor:
    """``<v(t) . v(0)>`` over atoms and replicas (over C(0) when
    ``normalize``); returns (T,)."""
    c = (vtraj * vtraj[:1]).sum(-1).mean(_lead_mean_dims(vtraj))
    return c / c[0].clamp_min(1e-30) if normalize else c


def autocorrelation_fft(traj: Tensor) -> Tensor:
    """Multi-origin ``<a(t) . a(t + tau)>`` over all T - tau origins,
    atoms and replicas, by zero-padded real FFTs over time; ``traj`` (T,
    ..., n_atoms, dim); returns (T,)."""
    t = traj.shape[0]
    flat = traj.reshape(t, -1)
    f = torch.fft.rfft(flat, n=2 * t, dim=0)
    corr = torch.fft.irfft(f * torch.conj(f), n=2 * t, dim=0)[:t]
    n_vectors = flat.shape[1] // traj.shape[-1]
    counts = (t - torch.arange(t, device=traj.device)).to(traj.dtype)
    return corr.sum(1) / (counts * n_vectors)


def _green_kubo_integral(acf: Tensor, dt: float, t_max: Optional[float]
                         ) -> Tensor:
    t = acf.shape[0]
    n_keep = (max(t // 4, 2) if t_max is None
              else min(int(round(t_max / dt)) + 1, t))
    kept = acf[:n_keep]
    return dt * (kept.sum() - 0.5 * (kept[0] + kept[-1]))


def diffusion_coefficient(traj: Tensor, *, dt: float,
                          fit_start: float = 0.25, fit_stop: float = 0.75
                          ) -> Tuple[Tensor, Tensor]:
    """Self-diffusion by the Einstein relation ``MSD -> 2 d D t`` from
    unwrapped coordinates: the multi-origin MSD ``S1 - 2 S2`` (the
    cross term by :func:`autocorrelation_fft`, the squares by prefix
    sums), a least-squares line over lag fractions [fit_start, fit_stop).
    Returns ``(D, msd)``."""
    t, dim = traj.shape[0], traj.shape[-1]
    s2 = autocorrelation_fft(traj)
    d2 = (traj * traj).sum(-1).mean(_lead_mean_dims(traj))
    p = torch.cat([torch.zeros(1, dtype=d2.dtype, device=d2.device),
                   torch.cumsum(d2, 0)])
    m = torch.arange(t, device=traj.device)
    counts = (t - m).to(traj.dtype)
    msd = (p[t - m] + p[t] - p[m]) / counts - 2.0 * s2
    lo = max(int(fit_start * t), 1)
    hi = max(int(fit_stop * t), lo + 2)
    w = ((m >= lo) & (m < hi)).to(traj.dtype)
    times = m.to(traj.dtype) * dt
    n = w.sum()
    tm = (w * times).sum() / n
    ym = (w * msd).sum() / n
    slope = ((w * (times - tm) * (msd - ym)).sum()
             / (w * (times - tm) ** 2).sum())
    return slope / (2.0 * dim), msd


def green_kubo_diffusion(vtraj: Tensor, *, dt: float,
                         t_max: Optional[float] = None
                         ) -> Tuple[Tensor, Tensor]:
    """``D = (1/d) integral <v(0) . v(t)> dt`` with the multi-origin VACF
    and a trapezoid truncated at ``t_max`` (default a quarter of the
    trajectory).  Returns ``(D, vacf)``."""
    vacf = autocorrelation_fft(vtraj)
    return _green_kubo_integral(vacf, dt, t_max) / vtraj.shape[-1], vacf


def _dilated_energy(potential_for_box, x: Tensor, box: Tensor):
    def scaled(s):
        return potential_for_box(s * box)(s * x)
    return scaled


def virial_pressure(potential_for_box, x: Tensor, *, box,
                    kt: float = 1.0) -> Tensor:
    """Instantaneous virial pressure ``(N kT - (1/d) dU(s x; s L)/ds) /
    V`` at s = 1, one forward-mode derivative through a uniform dilation
    of coordinates and box.  ``potential_for_box(box) -> energy_fn`` of
    the dense periodic factories (a tensor box; the cell-list potentials
    cannot be dilated); keep their ``shift=True``.  ``box`` (dim,) is
    shared by the batch.  Returns (...,)."""
    box_t = _as(box, x)
    n, dim = x.shape[-2], x.shape[-1]
    one = torch.ones((), dtype=x.dtype, device=x.device)
    _, du_ds = torch.func.jvp(_dilated_energy(potential_for_box, x, box_t),
                              (one,), (one,))
    return (n * kt - du_ds / dim) / torch.prod(box_t)


def kinetic_stress(v: Tensor, *, box, masses=1.0) -> Tensor:
    """Kinetic part of the pressure tensor ``(1/V) sum_i m_i v_ia v_ib``,
    (..., dim, dim); its trace is 2 KE / V."""
    m = _as(masses, v)
    if m.dim() == 1:
        m = m[:, None]
    mv = m * v
    return (mv[..., :, :, None] * v[..., :, None, :]).sum(-3) / torch.prod(
        _as(box, v))


def pressure_tensor_diag(potential_for_box, x: Tensor, *, box,
                         v: Optional[Tensor] = None, masses=1.0,
                         kt: Optional[float] = None) -> Tensor:
    """Diagonal of the pressure tensor by per-axis dilation, ``P_aa =
    (K_aa - dU(s.x; s.L)/ds_a) / V`` (its mean is
    :func:`virial_pressure`); ``K_aa`` from velocities ``v`` or ``N kT``.
    Returns (..., dim)."""
    box_t = _as(box, x)
    n, dim = x.shape[-2], x.shape[-1]
    ones = torch.ones(dim, dtype=x.dtype, device=x.device)
    scaled = _dilated_energy(potential_for_box, x, box_t)
    du = []
    for a in range(dim):
        tangent = torch.zeros(dim, dtype=x.dtype, device=x.device)
        tangent[a] = 1.0
        du.append(torch.func.jvp(scaled, (ones,), (tangent,))[1])
    du = torch.stack(du, -1)
    if v is not None:
        m = _as(masses, v)
        if m.dim() == 1:
            m = m[:, None]
        kin = (m * v * v).sum(-2)
    else:
        if kt is None:
            raise ValueError("pass velocities v for the instantaneous "
                             "kinetic part, or kt for the ensemble "
                             "N kT value")
        kin = torch.full((dim,), n * kt, dtype=x.dtype, device=x.device)
    return (kin - du) / torch.prod(box_t)


def _shear_components(p: Tensor) -> Tensor:
    """P_xy, P_xz, P_yz, (P_xx - P_yy)/2, (P_yy - P_zz)/2 (Daivis & Evans
    1994)."""
    return torch.stack([p[..., 0, 1], p[..., 0, 2], p[..., 1, 2],
                        0.5 * (p[..., 0, 0] - p[..., 1, 1]),
                        0.5 * (p[..., 1, 1] - p[..., 2, 2])], -1)


def green_kubo_viscosity(ptensor: Tensor, *, dt: float, volume: float,
                         kt: float, t_max: Optional[float] = None
                         ) -> Tuple[Tensor, Tensor]:
    """``eta = (V / kT) integral <P_ab(0) P_ab(t)> dt`` averaged over the
    five traceless shear components, from pressure tensors (T, ..., 3,
    3).  Returns ``(eta, sacf)``."""
    if ptensor.shape[-1] != 3 or ptensor.shape[-2] != 3:
        raise ValueError("green_kubo_viscosity expects 3-D pressure "
                         f"tensors (..., 3, 3); got {tuple(ptensor.shape)}")
    comps = _shear_components(ptensor)
    sacf = autocorrelation_fft(comps[..., None, :]) / comps.shape[-1]
    return volume / kt * _green_kubo_integral(sacf, dt, t_max), sacf


def green_kubo_thermal_conductivity(jflux: Tensor, *, dt: float,
                                    volume: float, kt: float,
                                    t_max: Optional[float] = None
                                    ) -> Tuple[Tensor, Tensor]:
    """``lambda = (V / (d kT^2)) integral <J(0) . J(t)> dt`` from heat
    fluxes (T, ..., dim), their sample mean subtracted first.  Returns
    ``(lambda, jacf)`` (the per-component ACF)."""
    j = jflux - jflux.mean(0, keepdim=True)
    jacf = autocorrelation_fft(j[..., None, :]) / jflux.shape[-1]
    return (volume / (kt * kt) * _green_kubo_integral(jacf, dt, t_max),
            jacf)


def surface_tension(ptensor_diag: Tensor, *, box,
                    normal_axis: int = 2) -> Tensor:
    """Kirkwood-Buff ``gamma = (L_n / 2) <P_nn - mean tangential P>`` of a
    slab with two interfaces normal to ``normal_axis``."""
    p = ptensor_diag
    dim = p.shape[-1]
    tang = [a for a in range(dim) if a != normal_axis]
    anis = p[..., normal_axis] - sum(p[..., a] for a in tang) / len(tang)
    return 0.5 * _as(box, p)[normal_axis] * anis.mean()


def structure_factor(x: Tensor, *, box: Sequence[float], k_max: float,
                     n_bins: int = 40) -> Tuple[Tensor, Tensor]:
    """``S(k) = <|sum_j exp(i k . r_j)|^2> / N`` over the half-space modes
    0 < |k| <= k_max, averaged in n_bins |k| bins (empty ones NaN).
    The phases are multiply-adds, not a matrix product (TF32 would round
    them)."""
    n = x.shape[-2]
    box_np = np.asarray(box, np.float64)
    if box_np.shape != (3,):
        raise ValueError(f"box must be 3 lengths; got {box_np.shape}")
    n_max = np.maximum(np.ceil(k_max * box_np / (2 * np.pi)), 1).astype(int)
    axes = [np.arange(-m, m + 1) for m in n_max]
    nn = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    half = ((nn[:, 0] > 0)
            | ((nn[:, 0] == 0) & (nn[:, 1] > 0))
            | ((nn[:, 0] == 0) & (nn[:, 1] == 0) & (nn[:, 2] > 0)))
    k_all = 2 * np.pi * nn[half] / box_np
    k_mag = np.sqrt((k_all ** 2).sum(-1))
    keep = k_mag <= k_max
    if not keep.any():
        raise ValueError(f"no reciprocal modes with |k| <= {k_max}; "
                         "increase k_max")
    k = torch.as_tensor(k_all[keep].astype(np.float32), device=x.device)
    k_mag = k_mag[keep]
    phase = (x[..., :, None, 0] * k[:, 0] + x[..., :, None, 1] * k[:, 1]
             + x[..., :, None, 2] * k[:, 2])
    s2 = (torch.cos(phase).sum(-2) ** 2 + torch.sin(phase).sum(-2) ** 2) / n
    s2 = s2.reshape(-1, s2.shape[-1]).mean(0)
    edges = np.linspace(0.0, float(k_max), n_bins + 1)
    idx = np.clip(np.searchsorted(edges, k_mag, side="right") - 1,
                  0, n_bins - 1)
    counts = torch.as_tensor(np.bincount(idx, minlength=n_bins),
                             dtype=torch.float32, device=x.device)
    sums = torch.zeros(n_bins, device=x.device).index_add(
        0, torch.as_tensor(idx, device=x.device), s2.float())
    centers = torch.as_tensor((0.5 * (edges[:-1] + edges[1:])).astype(
        np.float32), device=x.device)
    return centers, torch.where(counts > 0, sums / counts.clamp_min(1.0),
                                torch.nan)


def widom_insertion(potential, xs: Tensor, *, box,
                    generator: torch.Generator, n_insertions: int = 16,
                    kT: float = 1.0) -> Tuple[Tensor, Tensor]:
    """Widom's test-particle excess chemical potential ``mu_ex = -kT ln
    <exp(-beta dU)>``, dU = U([x; ghost]) - U(x) at ghosts uniform in the
    box (from ``generator``), ``n_insertions`` per configuration.
    ``potential`` must take n and n + 1 atoms (scalar parameters).
    Returns ``(mu_ex, stderr)``."""
    box_t = _as(box, xs)
    flat = xs.reshape((-1,) + tuple(xs.shape[-2:]))
    n_frames, _, dim = flat.shape
    ghosts = box_t * torch.rand((n_insertions, n_frames, dim),
                                generator=generator, dtype=xs.dtype,
                                device=xs.device)
    with torch.no_grad():
        u0 = potential(flat)
        du = torch.stack([potential(torch.cat([flat, g[:, None, :]], -2))
                          - u0 for g in ghosts])
    beta_mu, stderr = exp_free_energy(du / kT)
    return kT * beta_mu, kT * stderr


def kabsch_align(x: Tensor, ref: Tensor, weights=None
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """Optimal (weighted) rigid superposition of ``x`` (..., n, dim) onto
    ``ref`` (n, dim) (Kabsch 1976), reflections excluded: ``(aligned,
    rotation, rmsd)``."""
    ref = _as(ref, x)
    n = x.shape[-2]
    w = (torch.ones(n, dtype=x.dtype, device=x.device) if weights is None
         else _as(weights, x))
    w = w / w.sum()
    xc = x - (w[:, None] * x).sum(-2, keepdim=True)
    rc = ref - (w[:, None] * ref).sum(-2, keepdim=True)
    H = ((xc * w[:, None])[..., :, :, None] * rc[..., :, None, :]).sum(-3)
    U, _, Vt = torch.linalg.svd(H)
    det = torch.linalg.det(U @ Vt)
    D = torch.ones(x.shape[:-2] + (x.shape[-1],), dtype=x.dtype,
                   device=x.device)
    D = torch.cat([D[..., :-1], det[..., None]], -1)
    R = ((U * D[..., None, :]) @ Vt).transpose(-1, -2)
    aligned = ((xc[..., :, None, :] * R[..., None, :, :]).sum(-1)
               + (w[:, None] * ref).sum(-2)[..., None, :])
    d2 = ((aligned - ref) ** 2).sum(-1)
    return aligned, R, torch.sqrt((w * d2).sum(-1))


def rmsd(x: Tensor, ref: Tensor, weights=None,
         superpose: bool = True) -> Tensor:
    """(Weighted) RMSD of ``x`` to ``ref``, after optimal superposition
    unless ``superpose=False``."""
    if superpose:
        return kabsch_align(x, ref, weights)[2]
    ref = _as(ref, x)
    n = x.shape[-2]
    w = (torch.ones(n, dtype=x.dtype, device=x.device) if weights is None
         else _as(weights, x))
    w = w / w.sum()
    return torch.sqrt((w * ((x - ref) ** 2).sum(-1)).sum(-1))


def vibrational_spectrum(vtraj: Tensor, *, dt: float
                         ) -> Tuple[Tensor, Tensor]:
    """Vibrational density of states: the one-sided velocity periodogram
    per atom, ``(freqs, spectrum)`` of length T//2 + 1, frequencies in
    cycles per unit time."""
    t = vtraj.shape[0]
    flat = vtraj.reshape(t, -1)
    power = (torch.fft.rfft(flat, dim=0).abs() ** 2).sum(1)
    n_vectors = flat.shape[1] // vtraj.shape[-1]
    return (torch.fft.rfftfreq(t, d=dt, device=vtraj.device),
            power * (dt / (t * n_vectors)))


def _mass_vector(masses, n_atoms: int, dim: int, like: Tensor) -> Tensor:
    m = torch.as_tensor(masses, dtype=like.dtype, device=like.device)
    if m.dim() == 0:
        m = m.expand(n_atoms)
    return m.repeat_interleave(dim)


def normal_modes(potential, x: Tensor, *, masses=1.0
                 ) -> Tuple[Tensor, Tensor]:
    """Mass-weighted normal modes at ``x`` (n_atoms, dim): the eigenpairs
    of ``M^-1/2 H M^-1/2`` (``torch.func.hessian``), ``omega`` ascending
    and signed ``sign(lambda) sqrt(|lambda|)`` (imaginary modes of a
    saddle negative), ``modes`` (n dim, n dim) Cartesian columns."""
    n, d = x.shape

    def u_flat(xf):
        return potential(xf.reshape(n, d)).reshape(())

    h = torch.func.hessian(u_flat)(x.reshape(-1).detach())
    inv_sqrt_m = 1.0 / torch.sqrt(_mass_vector(masses, n, d, x))
    h_mw = h * inv_sqrt_m[:, None] * inv_sqrt_m[None, :]
    lam, v = torch.linalg.eigh(0.5 * (h_mw + h_mw.T))
    omega = torch.sign(lam) * torch.sqrt(lam.abs())
    return omega, inv_sqrt_m[:, None] * v


def harmonic_free_energy(omega: Tensor, *, kt: float, hbar: float = 1.0,
                         zero_tol: float = 1e-4) -> Tensor:
    """Classical harmonic free energy ``kT sum_i ln(hbar omega_i / kT)``
    over modes above ``zero_tol``; NaN if any mode is below -zero_tol (a
    saddle)."""
    real = omega > zero_tol
    term = torch.where(real, torch.log(hbar * omega.abs() / kt), 0.0)
    a = kt * term.sum()
    return torch.where((omega < -zero_tol).any(), torch.nan, a)


def quasi_harmonic_frequencies(traj: Tensor, *, kt: float, masses=1.0
                               ) -> Tensor:
    """Quasi-harmonic frequencies ``sqrt(kT / lambda_i)`` of the
    mass-weighted covariance of a trajectory (T, n_atoms, dim)
    (Karplus & Kushick 1981), descending: null directions come first as
    inf."""
    t = traj.shape[0]
    n, d = traj.shape[-2], traj.shape[-1]
    flat = traj.reshape(t, n * d)
    flat = flat - flat.mean(0)
    cov = (flat[:, :, None] * flat[:, None, :]).sum(0) / t
    sqrt_m = torch.sqrt(_mass_vector(masses, n, d, traj))
    c_mw = cov * sqrt_m[:, None] * sqrt_m[None, :]
    lam = torch.linalg.eigvalsh(0.5 * (c_mw + c_mw.T))
    tol = lam[-1] * lam.shape[0] * torch.finfo(lam.dtype).eps
    lam = torch.where(lam <= tol.clamp_min(0.0), 0.0, lam)
    return torch.sqrt(kt / lam)


def _flat_samples(*arrs) -> Tuple[Tensor, ...]:
    arrs = torch.broadcast_tensors(*[torch.as_tensor(a) for a in arrs])
    return tuple(a.reshape(-1) for a in arrs)


def _var(a: Tensor) -> Tensor:
    return ((a - a.mean()) ** 2).mean()


def heat_capacity_nvt(u: Tensor, *, kt: float,
                      n_dof_kinetic: int = 0) -> Tensor:
    """``C_V / k_B = Var(U) / kT^2 + n_dof_kinetic / 2`` over all samples
    of ``u``."""
    (u,) = _flat_samples(u)
    return _var(u) / (kt * kt) + 0.5 * n_dof_kinetic


def heat_capacity_npt(u: Tensor, volume: Tensor, *, kt: float,
                      pressure: float, n_dof_kinetic: int = 0) -> Tensor:
    """``C_P / k_B = Var(U + P V) / kT^2 + n_dof_kinetic / 2``."""
    u, v = _flat_samples(u, volume)
    return _var(u + pressure * v) / (kt * kt) + 0.5 * n_dof_kinetic


def isothermal_compressibility(volume: Tensor, *, kt: float) -> Tensor:
    """``kappa_T = Var(V) / (kT <V>)`` from NPT volumes."""
    (v,) = _flat_samples(volume)
    return _var(v) / (kt * v.mean())


def thermal_expansion(u: Tensor, volume: Tensor, *, kt: float,
                      pressure: float) -> Tensor:
    """``alpha_P = Cov(V, U + P V) / (kT^2 <V>)`` from NPT samples."""
    u, v = _flat_samples(u, volume)
    h = u + pressure * v
    return (((v - v.mean()) * (h - h.mean())).mean()
            / (kt * kt * v.mean()))


def total_dipole(x: Tensor, charges) -> Tensor:
    """``M = sum_i q_i r_i`` per configuration, (..., dim); use unwrapped
    or molecule-whole coordinates."""
    return (_as(charges, x)[..., :, None] * x).sum(-2)


def dielectric_constant(m_traj: Tensor, *, volume: float,
                        kt: float) -> Tensor:
    """Tinfoil ``eps = 1 + 4 pi (<M^2> - <M>^2) / (3 V kT)`` from total
    dipoles (T, ..., dim), every leading axis a sample."""
    m = m_traj.reshape(-1, m_traj.shape[-1])
    dm = m - m.mean(0)
    return 1.0 + 4.0 * math.pi * (dm * dm).sum(-1).mean() / (
        3.0 * volume * kt)
