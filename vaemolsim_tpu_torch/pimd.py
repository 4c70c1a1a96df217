"""Path-integral molecular dynamics: PIMD, RPMD and TRPMD (port of
``vaemolsim_tpu/pimd.py``).

Each quantum particle is a ring polymer of ``P`` beads joined by springs
of frequency ``omega_P = P kT / hbar``; the bead axis is one more batch
axis, ``(..., P, n_atoms, dim)``, so every potential of the package
applies to all beads unchanged.  The free ring is propagated exactly in
normal-mode coordinates: one orthonormal (P, P) transform over the bead
axis, then each mode rotates as a harmonic oscillator.

- :func:`rpmd_nve`: B half-kick, exact free ring for dt, B half-kick.
- :func:`pimd_pile`: BAOAB with the PILE thermostat on the modes
  (``gamma_k = 2 omega_k``, centroid ``1 / tau0``).
- :func:`trpmd`: PILE with the centroid thermostat off.

Estimators: :func:`energy_primitive`, :func:`energy_virial` and
:func:`radius_of_gyration2`.  Reduced units with ``hbar`` explicit;
``kT`` is the physical temperature and bead velocities are Maxwellian
at ``P kT`` (the ring-polymer convention of the JAX package).  The
normal-mode matrix and frequencies are NumPy, built here.  Every draw
comes from an explicit ``torch.Generator``; ``noise=`` hands a run its
normals instead (what tests feed the JAX package's own draws).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from vaemolsim_tpu_torch.md import _force_fn, _masses_arr

Tensor = torch.Tensor

__all__ = ["RPMDState", "normal_mode_matrix", "ring_frequencies",
           "spring_energy", "ring_hamiltonian", "energy_primitive",
           "energy_virial", "radius_of_gyration2", "init_thermal_ring",
           "rpmd_nve", "pimd_pile", "trpmd"]


class RPMDState(NamedTuple):
    """Bead positions and velocities (..., P, n_atoms, dim) and the
    physical force ``-grad U`` per bead."""
    x: Tensor
    v: Tensor
    force: Tensor


def normal_mode_matrix(n_beads: int) -> np.ndarray:
    """The orthonormal bead -> mode transform C (P, P): row 0 the
    centroid, rows 1..P//2 cosines (row P/2 alternating for even P),
    rows P//2+1..P-1 sines, row k at frequency ``2 omega_P sin(pi k /
    P)``."""
    p = int(n_beads)
    if p < 1:
        raise ValueError(f"n_beads must be >= 1, got {p}")
    j = np.arange(p)
    c = np.zeros((p, p))
    c[0] = 1.0 / math.sqrt(p)
    for k in range(1, p // 2 + 1):
        if 2 * k == p:
            c[k] = (-1.0) ** j / math.sqrt(p)
        else:
            c[k] = math.sqrt(2.0 / p) * np.cos(2.0 * math.pi * k * j / p)
    for k in range(p // 2 + 1, p):
        c[k] = math.sqrt(2.0 / p) * np.sin(2.0 * math.pi * (p - k) * j / p)
    return c


def ring_frequencies(n_beads: int, kT: float,
                     hbar: float = 1.0) -> Tuple[float, np.ndarray]:
    """``(omega_P, omega_k)``: the spring frequency ``P kT / hbar`` and
    the (P,) free-ring mode frequencies ``2 omega_P sin(pi k / P)``."""
    p = int(n_beads)
    omega_p = p * kT / hbar
    return omega_p, 2.0 * omega_p * np.sin(math.pi * np.arange(p) / p)


def _to_modes(c: Tensor, x: Tensor) -> Tensor:
    return torch.einsum("kj,...jnd->...knd", c, x)


def _to_beads(c: Tensor, q: Tensor) -> Tensor:
    return torch.einsum("jk,...jnd->...knd", c, q)


def spring_energy(x: Tensor, *, kT: float, hbar: float = 1.0,
                  masses=1.0) -> Tensor:
    """``sum_j m omega_P^2 |x_j - x_{j+1}|^2 / 2`` per replica."""
    m = _masses_arr(masses, x)
    omega_p = x.shape[-3] * kT / hbar
    diff = x - torch.roll(x, shifts=-1, dims=-3)
    return 0.5 * omega_p * omega_p * (m * diff * diff).sum((-3, -2, -1))


def ring_hamiltonian(potential: Callable[[Tensor], Tensor], x: Tensor,
                     v: Tensor, *, kT: float, hbar: float = 1.0,
                     masses=1.0) -> Tensor:
    """The conserved quantity of :func:`rpmd_nve`: kinetic + springs +
    the potential of every bead, per replica."""
    m = _masses_arr(masses, x)
    ke = 0.5 * (m * v * v).sum((-3, -2, -1))
    return (ke + spring_energy(x, kT=kT, hbar=hbar, masses=masses)
            + potential(x).sum(-1))


def energy_primitive(potential: Callable[[Tensor], Tensor], x: Tensor, *,
                     kT: float, hbar: float = 1.0, masses=1.0) -> Tensor:
    """Barker's primitive estimator, ``d n P kT / 2 - E_spring / P +
    mean_j U(x_j)`` per replica (its variance grows with P)."""
    p, n, d = x.shape[-3:]
    u = potential(x).mean(-1)
    return (0.5 * d * n * p * kT
            - spring_energy(x, kT=kT, hbar=hbar, masses=masses) / p + u)


def energy_virial(potential: Callable[[Tensor], Tensor], x: Tensor, *,
                  kT: float, masses=1.0) -> Tensor:
    """The centroid-virial estimator, ``d n kT / 2 + (1/2P) sum_j (x_j -
    xbar) . grad U(x_j) + mean_j U(x_j)`` per replica (mass-free)."""
    del masses
    p, n, d = x.shape[-3:]
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        u = potential(xg)
        (g,) = torch.autograd.grad(u.sum(), xg)
    centroid = x.mean(-3, keepdim=True)
    vir = ((x - centroid) * g).sum((-3, -2, -1)) / (2.0 * p)
    return 0.5 * d * n * kT + vir + u.detach().mean(-1)


def radius_of_gyration2(x: Tensor) -> Tensor:
    """Per-atom ``(1/P) sum_j |x_j - xbar|^2``, (..., n_atoms)."""
    centroid = x.mean(-3, keepdim=True)
    return ((x - centroid) ** 2).sum(-1).mean(-2)


def init_thermal_ring(generator: torch.Generator, x: Tensor, *,
                      n_beads: int, kT: float, hbar: float = 1.0,
                      masses=1.0, noise: Optional[Sequence[Tensor]] = None
                      ) -> Tuple[Tensor, Tensor]:
    """Free-ring thermal beads around classical positions ``x`` (...,
    n_atoms, dim): internal modes ``q_k ~ N(0, P kT / (m omega_k^2))``
    (centroid at x), velocities ``N(0, P kT / m)``; returns ``(x_beads,
    v_beads)`` of shape (..., P, n_atoms, dim).  ``noise = (q_normals,
    v_normals)`` replaces the two draws."""
    p = int(n_beads)
    m = _masses_arr(masses, x)
    c = torch.as_tensor(normal_mode_matrix(p), dtype=x.dtype,
                        device=x.device)
    _, omega_k = ring_frequencies(p, kT, hbar)
    kT = p * kT
    shape = x.shape[:-2] + (p,) + x.shape[-2:]
    kw = dict(generator=generator, dtype=x.dtype, device=x.device)
    if noise is None:
        nq = (torch.randn(shape[:-3] + (p - 1,) + shape[-2:], **kw)
              if p > 1 else None)
        noise = (nq, torch.randn(shape, **kw))
    q0 = math.sqrt(p) * x[..., None, :, :]
    if p > 1:
        sigma = torch.sqrt(kT / m) / torch.as_tensor(
            omega_k[1:, None, None], dtype=x.dtype, device=x.device)
        q = torch.cat([q0, sigma * noise[0]], -3)
    else:
        q = q0
    v = torch.sqrt(kT / m) * noise[1]
    return _to_beads(c, q), v


def _free_ring_step(c: Tensor, omega_k: Tensor, dt: Tensor):
    """The exact free-ring propagator for time dt, in normal modes (the
    centroid drifts)."""
    w = omega_k[:, None, None]
    cos = torch.cos(w * dt)
    safe_w = torch.where(w == 0.0, 1.0, w)
    sinc = torch.where(w == 0.0, dt, torch.sin(w * dt) / safe_w)
    wsin = torch.where(w == 0.0, 0.0, w * torch.sin(w * dt))

    def step(x: Tensor, v: Tensor) -> Tuple[Tensor, Tensor]:
        q, u = _to_modes(c, x), _to_modes(c, v)
        q, u = cos * q + sinc * u, cos * u - wsin * q
        return _to_beads(c, q), _to_beads(c, u)

    return step


def _pimd_dispatch(potential, x0, v0, *, kT, hbar, masses, dt, n_steps,
                   collect_every, collect_v, generator, noise, thermostat,
                   tau0):
    """The RPMD / PILE driver: without ``thermostat``, B half, exact free
    ring for dt, B half; with it, B half, free ring dt/2, PILE O-step on
    the modes, free ring dt/2, B half (centroid friction 1/tau0, or none
    when ``tau0`` is None)."""
    if collect_every and n_steps % collect_every != 0:
        raise ValueError("n_steps must be a multiple of collect_every")
    p = x0.shape[-3]
    force = _force_fn(potential)
    m = _masses_arr(masses, x0)
    dtt = torch.tensor(dt, dtype=x0.dtype, device=x0.device)
    c = torch.as_tensor(normal_mode_matrix(p), dtype=x0.dtype,
                        device=x0.device)
    _, omega_np = ring_frequencies(p, kT, hbar)
    omega_k = torch.as_tensor(omega_np, dtype=x0.dtype, device=x0.device)
    if not thermostat:
        drift = _free_ring_step(c, omega_k, dtt)

        def one(s, _):
            v = s.v + 0.5 * dtt * s.force / m
            x, v = drift(s.x, v)
            _, f = force(x)
            return RPMDState(x, v + 0.5 * dtt * f / m, f)
    else:
        drift = _free_ring_step(c, omega_k, 0.5 * dtt)
        gam = 2.0 * omega_k
        gam[0] = 0.0 if tau0 is None else 1.0 / tau0
        c1 = torch.exp(-gam * dtt)[:, None, None]
        c2 = torch.sqrt(p * kT * (1.0 - c1 * c1) / m)

        def one(s, k):
            v = s.v + 0.5 * dtt * s.force / m
            x, v = drift(s.x, v)
            u = _to_modes(c, v)
            xi = (noise[k] if noise is not None else torch.randn(
                u.shape, generator=generator, dtype=u.dtype,
                device=u.device))
            v = _to_beads(c, c1 * u + c2 * xi)
            x, v = drift(x, v)
            _, f = force(x)
            return RPMDState(x, v + 0.5 * dtt * f / m, f)

    _, f0 = force(x0)
    s = RPMDState(x0, v0.to(x0.dtype), f0)
    traj = []
    for k in range(n_steps):
        s = one(s, k)
        if collect_every and (k + 1) % collect_every == 0:
            traj.append((s.x, s.v) if collect_v else s.x)
    if not collect_every:
        return s, None
    if collect_v:
        return s, (torch.stack([t[0] for t in traj]),
                   torch.stack([t[1] for t in traj]))
    return s, torch.stack(traj)


def rpmd_nve(potential: Callable[[Tensor], Tensor], x0: Tensor, v0: Tensor,
             *, dt: float, n_steps: int, kT: float, hbar: float = 1.0,
             masses=1.0, collect_every: int = 0, collect_v: bool = False
             ) -> Tuple[RPMDState, Optional[Tensor]]:
    """Ring-polymer MD (Craig & Manolopoulos 2004): exact free-ring
    evolution between physical half-kicks; :func:`ring_hamiltonian` at
    this ``kT`` is conserved."""
    return _pimd_dispatch(potential, x0, v0, kT=kT, hbar=hbar,
                          masses=masses, dt=dt, n_steps=n_steps,
                          collect_every=collect_every, collect_v=collect_v,
                          generator=None, noise=None, thermostat=False,
                          tau0=None)


def pimd_pile(potential: Callable[[Tensor], Tensor], x0: Tensor,
              v0: Tensor, generator: Optional[torch.Generator], *,
              dt: float, n_steps: int, kT: float, hbar: float = 1.0,
              masses=1.0, tau0: float = 1.0, collect_every: int = 0,
              collect_v: bool = False,
              noise: Optional[Sequence[Tensor]] = None
              ) -> Tuple[RPMDState, Optional[Tensor]]:
    """PILE-thermostatted PIMD (Ceriotti et al. 2010) on bead arrays
    (..., P, n_atoms, dim): each internal mode at friction ``2 omega_k``,
    the centroid at ``1 / tau0``.  ``noise``: the ``n_steps`` O-step
    normals (mode-shaped) instead of the generator's."""
    return _pimd_dispatch(potential, x0, v0, kT=kT, hbar=hbar,
                          masses=masses, dt=dt, n_steps=n_steps,
                          collect_every=collect_every, collect_v=collect_v,
                          generator=generator, noise=noise,
                          thermostat=True, tau0=tau0)


def trpmd(potential: Callable[[Tensor], Tensor], x0: Tensor, v0: Tensor,
          generator: Optional[torch.Generator], *, dt: float, n_steps: int,
          kT: float, hbar: float = 1.0, masses=1.0, collect_every: int = 0,
          collect_v: bool = False,
          noise: Optional[Sequence[Tensor]] = None
          ) -> Tuple[RPMDState, Optional[Tensor]]:
    """Thermostatted RPMD (Rossi et al. 2014): :func:`pimd_pile` with the
    centroid thermostat off."""
    return _pimd_dispatch(potential, x0, v0, kT=kT, hbar=hbar,
                          masses=masses, dt=dt, n_steps=n_steps,
                          collect_every=collect_every, collect_v=collect_v,
                          generator=generator, noise=noise,
                          thermostat=True, tau0=None)
