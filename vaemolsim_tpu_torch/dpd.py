"""Dissipative particle dynamics (port of ``vaemolsim_tpu/dpd.py``).

Soft conservative repulsion plus a pairwise thermostat whose
dissipative and random forces act along the lines between particles
(Hoogerbrugge & Koelman 1992; Groot & Warren 1997).  With ``e = r_ij /
|r_ij|`` and ``w(r) = 1 - r / r_c`` inside the cutoff:

    F^C = a w e,   F^D = -gamma w^2 (e . v_ij) e,
    F^R = sigma w theta_ij e / sqrt(dt),   sigma^2 = 2 gamma kT,

with ``theta_ij = theta_ji``: every term is antisymmetric in (i, j), so
total momentum is conserved exactly.  The pair geometry is one dense
(N, N, 3) difference tensor with the minimum image; the symmetric noise
is one normal draw symmetrised as ``(A + A^T) / sqrt(2)``.  The
integrator is Groot and Warren's modified velocity Verlet (one force a
step).  Every draw comes from an explicit ``torch.Generator``; ``noise=``
hands a run its (n, n) normals instead.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from vaemolsim_tpu_torch.md import MDState, _masses_arr

Tensor = torch.Tensor

__all__ = ["soft_pair_energy", "dpd_forces", "dpd_vv"]

_EPS = 1e-12


def _pair_geometry(x: Tensor, r_cut: float, box):
    """Unit pair vectors (minimum image) and the weight ``max(1 - r/r_c,
    0)`` with the diagonal zeroed."""
    n = x.shape[-2]
    d = x[..., :, None, :] - x[..., None, :, :]
    if box is not None:
        b = torch.as_tensor(box, dtype=x.dtype, device=x.device)
        d = d - b * torch.round(d / b)
    r = torch.sqrt((d * d).sum(-1).clamp_min(_EPS))
    e = d / r[..., None]
    off = ~torch.eye(n, dtype=torch.bool, device=x.device)
    w = torch.where(off, (1.0 - r / r_cut).clamp_min(0.0), 0.0)
    return e, w


def soft_pair_energy(a=25.0, *, r_cut: float = 1.0,
                     box=None) -> Callable[[Tensor], Tensor]:
    """The conservative energy ``sum_{i<j} a r_c / 2 (1 - r/r_c)^2``
    (``a`` scalar or (n, n)), whose gradient is ``-F^C``."""

    def energy(x: Tensor) -> Tensor:
        _, w = _pair_geometry(x, r_cut, box)
        aij = torch.as_tensor(a, dtype=x.dtype, device=x.device)
        return (0.5 * aij * (r_cut / 2.0) * w * w).sum((-2, -1))

    return energy


def dpd_forces(x: Tensor, v: Tensor, theta: Tensor, *, a, gamma, kT: float,
               dt: float, r_cut: float = 1.0, box=None) -> Tensor:
    """The total DPD force (..., N, 3) for a symmetric standard-normal
    ``theta`` (n, n); ``a`` and ``gamma`` scalar or (n, n)."""
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    gamma = torch.as_tensor(gamma, dtype=x.dtype, device=x.device)
    e, w = _pair_geometry(x, r_cut, box)
    ev = (e * (v[..., :, None, :] - v[..., None, :, :])).sum(-1)
    sigma = torch.sqrt(2.0 * gamma * kT)
    dt_t = torch.tensor(dt, dtype=x.dtype, device=x.device)
    mag = a * w - gamma * w * w * ev + sigma * w * theta / torch.sqrt(dt_t)
    return (mag[..., None] * e).sum(-2)


def _symmetric_normal(generator: torch.Generator, n: int, dtype,
                      device) -> Tensor:
    aa = torch.randn((n, n), generator=generator, dtype=dtype, device=device)
    return (aa + aa.T) / math.sqrt(2.0)


def dpd_vv(x0: Tensor, v0: Tensor, generator: Optional[torch.Generator],
           *, n_steps: int, dt: float, a=25.0, gamma: float = 4.5,
           kT: float = 1.0, r_cut: float = 1.0, box=None, masses=1.0,
           lam: float = 0.5, collect_every: int = 0,
           collect_v: bool = False,
           noise: Optional[Sequence[Tensor]] = None
           ) -> Tuple[MDState, Optional[Tensor]]:
    """A Groot-Warren modified velocity Verlet run: drift with the carried
    force, predict velocities with ``lam``, one force at the new
    positions and predicted velocities with a fresh symmetric noise
    matrix, then the trapezoidal velocity correction.  ``noise``: the
    n_steps + 1 symmetric (n, n) matrices (the first for the opening
    force) instead of the generator's."""
    if collect_every and n_steps % collect_every != 0:
        raise ValueError("n_steps must be a multiple of collect_every")
    m = _masses_arr(masses, x0)
    n = x0.shape[-2]
    dtt = torch.tensor(dt, dtype=x0.dtype, device=x0.device)
    draws = iter(noise) if noise is not None else None

    def force(x, v):
        theta = (next(draws) if draws is not None else _symmetric_normal(
            generator, n, x.dtype, x.device))
        return dpd_forces(x, v, theta, a=a, gamma=gamma, kT=kT, dt=dt,
                          r_cut=r_cut, box=box)

    s = MDState(x0, v0, force(x0, v0))
    traj = []
    for k in range(1, n_steps + 1):
        x = s.x + dtt * s.v + 0.5 * dtt * dtt * s.force / m
        v_pred = s.v + lam * dtt * s.force / m
        f_new = force(x, v_pred)
        s = MDState(x, s.v + 0.5 * dtt * (s.force + f_new) / m, f_new)
        if collect_every and k % collect_every == 0:
            traj.append((s.x, s.v) if collect_v else s.x)
    if not collect_every:
        return s, None
    if collect_v:
        return s, (torch.stack([t[0] for t in traj]),
                   torch.stack([t[1] for t in traj]))
    return s, torch.stack(traj)
