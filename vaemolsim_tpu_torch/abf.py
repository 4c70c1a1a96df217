"""Extended-system adaptive biasing force (eABF) with the CZAR estimator
(port of ``vaemolsim_tpu/abf.py``).

A fictitious particle ``lam`` per walker is tethered to the CV ``s(x)``
with stiffness ``kappa``; the instantaneous free-energy gradient at fixed
``lam`` is ``kappa (lam - s)``, and ABF applies the negative of its
running bin mean to ``lam`` (ramped in by ``min(count / ramp_count, 1)``).
The unbiased profile along ``s`` comes from CZAR,

    A'(s) = -kT d ln rho~(s) / ds + kappa ( <lam>_s - s ).

The run is one :func:`scan_collect` over joint BAOAB steps; the tables
are shared by all walkers and accumulated every step by a one-hot sum
over the fixed bin axis, in a fixed order, so a replayed chunk on the
card repeats the eager loop exactly.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from vaemolsim_tpu_torch.config import default_device
from vaemolsim_tpu_torch.md import MDState, _masses_arr, _normal
from vaemolsim_tpu_torch.metadynamics import _biased_force
from vaemolsim_tpu_torch.utils.scan import scan_collect

Tensor = torch.Tensor

__all__ = ["ABFState", "abf_grid", "eabf_baoab", "abf_free_energy",
           "czar_free_energy"]


@dataclass
class ABFState:
    """Adaptive mean-force tables on ``n`` bins: ``f_sum`` / ``count`` the
    per-bin sum of ``kappa (lam - s)`` and visits, binned by ``lam``;
    ``s_count`` / ``delta_sum`` the CZAR accumulators binned by the true
    CV ``s`` (visits and the sum of the wrapped ``lam - s``)."""

    f_sum: Tensor
    count: Tensor
    s_count: Tensor
    delta_sum: Tensor
    lo: float
    hi: float
    periodic: bool

    @property
    def n_bins(self) -> int:
        return self.f_sum.shape[0]

    def _replace(self, **kw) -> "ABFState":
        return dataclasses.replace(self, **kw)


def abf_grid(lo: float, hi: float, n: int, periodic: bool = False,
             device=None) -> ABFState:
    z = torch.zeros(n, device=default_device(device))
    return ABFState(f_sum=z, count=z, s_count=z, delta_sum=z, lo=float(lo),
                    hi=float(hi), periodic=bool(periodic))


def _bin_centers(g: ABFState) -> Tensor:
    w = (g.hi - g.lo) / g.n_bins
    return g.lo + w * (torch.arange(g.n_bins, device=g.f_sum.device) + 0.5)


def _bin_index(g: ABFState, s: Tensor) -> Tensor:
    n = g.n_bins
    i = torch.floor((s - g.lo) / (g.hi - g.lo) * n).long()
    if g.periodic:
        return torch.remainder(i, n)
    return torch.clamp(i, 0, n - 1)


def _wrap(g: ABFState, d: Tensor) -> Tensor:
    if not g.periodic:
        return d
    period = g.hi - g.lo
    return d - period * torch.round(d / period)


def _bin_sum(g: ABFState, idx: Tensor, values: Tensor) -> Tensor:
    """Per-bin sums of ``values`` at bins ``idx`` (both flattened)."""
    bins = torch.arange(g.n_bins, device=idx.device)
    hot = (idx.reshape(-1, 1) == bins).to(values.dtype)
    return (hot * values.reshape(-1, 1)).sum(0)


def eabf_baoab(potential: Callable[[Tensor], Tensor],
               cv_fn: Callable[[Tensor], Tensor],
               x0: Tensor, v0: Tensor,
               generator: Optional[torch.Generator], *,
               dt: float, n_steps: int, grid: ABFState,
               kappa: float, kT: float = 1.0,
               lam_mass: float = 1.0, friction: float = 1.0,
               friction_lam: Optional[float] = None, masses=1.0,
               ramp_count: float = 200.0, collect_every: int = 0,
               noise: Optional[Tuple[Tensor, Tensor]] = None
               ) -> Tuple[MDState, Tensor, ABFState, Optional[Tensor]]:
    """Multiple-walker eABF over joint BAOAB Langevin dynamics.

    Every walker carries its own ``lam`` (started at ``cv_fn(x0)``, with
    friction ``friction_lam`` and mass ``lam_mass``); all walkers share
    the tables.  The normals of the O-steps come from ``generator``, or
    from ``noise = (for x (n_steps, *x0.shape), for lam (n_steps,
    *batch))``.  Returns ``(MDState, lam, tables, (s, lam) every
    collect_every steps as (n_collect, 2, *batch))``."""
    if collect_every and n_steps % collect_every:
        raise ValueError(f"collect_every={collect_every} must divide "
                         f"n_steps={n_steps}")
    m = _masses_arr(masses, x0)
    dt_a = torch.tensor(dt, dtype=x0.dtype, device=x0.device)
    g_l = friction if friction_lam is None else friction_lam
    c1 = torch.exp(-friction * dt_a)
    c2 = torch.sqrt(kT * (1.0 - c1 * c1) / m)
    c1l = torch.exp(-g_l * dt_a)
    c2l = torch.sqrt(kT * (1.0 - c1l * c1l) / lam_mass)

    def forces(x, lam, tbl):
        """Joint forces on (x, lam) under the tether and the ABF bias."""
        f_x, s = _biased_force(potential, cv_fn, x,
                               lambda s: -kappa * _wrap(tbl, lam - s))
        delta = _wrap(tbl, lam - s)
        idx = _bin_index(tbl, lam)
        mean_f = tbl.f_sum[idx] / torch.clamp(tbl.count[idx], min=1.0)
        ramp = torch.clamp(tbl.count[idx] / ramp_count, max=1.0)
        return f_x, -kappa * delta + ramp * mean_f, s, delta

    def accumulate(tbl, lam, s, delta):
        il = _bin_index(tbl, lam)
        isx = _bin_index(tbl, s)
        one = torch.ones_like(delta)
        return tbl._replace(
            f_sum=tbl.f_sum + _bin_sum(tbl, il, kappa * delta),
            count=tbl.count + _bin_sum(tbl, il, one),
            s_count=tbl.s_count + _bin_sum(tbl, isx, one),
            delta_sum=tbl.delta_sum + _bin_sum(tbl, isx, delta))

    def step(carry):
        st, lam, vl, f_lam, tbl, _, i = carry
        if noise is None:
            zx, zl = _normal(generator, st.v), _normal(generator, vl)
        else:
            zx, zl = (z.index_select(0, i)[0] for z in noise)
        v = st.v + 0.5 * dt_a * st.force / m                    # B
        vl = vl + 0.5 * dt_a * f_lam / lam_mass
        x = st.x + 0.5 * dt_a * v                               # A
        lam = lam + 0.5 * dt_a * vl
        v = c1 * v + c2 * zx                                    # O
        vl = c1l * vl + c2l * zl
        x = x + 0.5 * dt_a * v                                  # A
        lam = lam + 0.5 * dt_a * vl
        f_x, f_lam, s, delta = forces(x, lam, tbl)              # B
        v = v + 0.5 * dt_a * f_x / m
        vl = vl + 0.5 * dt_a * f_lam / lam_mass
        tbl = accumulate(tbl, lam, s, delta)
        return (MDState(x=x, v=v, force=f_x), lam, vl, f_lam, tbl, s,
                i + 1)

    lam0 = cv_fn(x0).detach()
    f_x0, f_lam0, s0, _ = forces(x0, lam0, grid)
    i0 = torch.zeros(1, dtype=torch.long, device=x0.device)
    carry = (MDState(x=x0, v=v0, force=f_x0), lam0, torch.zeros_like(lam0),
             f_lam0, grid, s0, i0)
    carry, traj = scan_collect(
        step, carry, n_steps, collect_every=collect_every,
        snapshot_fn=lambda c: torch.stack([c[5], c[1]]),
        generators=() if generator is None else (generator,))
    st, lam, _, _, tbl, _, _ = carry
    return st, lam, tbl, traj


def abf_free_energy(g: ABFState) -> Tuple[Tensor, Tensor]:
    """The extended variable's profile: the per-bin mean force integrated
    along ``lam`` (trapezoid over the bin centres), which is A(s)
    convolved with the tether's Gaussian of width ``sqrt(kT/kappa)``.
    Returns ``(centers, A)`` zeroed at the minimum."""
    w = (g.hi - g.lo) / g.n_bins
    mean_f = g.f_sum / torch.clamp(g.count, min=1.0)
    a = torch.cat([mean_f.new_zeros(1),
                   torch.cumsum(0.5 * (mean_f[1:] + mean_f[:-1]) * w, 0)])
    return _bin_centers(g), a - a.min()


def czar_free_energy(g: ABFState, *, kappa: float, kT: float = 1.0,
                     min_count: float = 1.0) -> Tuple[Tensor, Tensor]:
    """CZAR along the true CV: ``A'(s) = -kT d ln rho~/ds + kappa <lam -
    s>_s``, the log-density derivative by (periodic-aware) central
    differences; bins visited fewer than ``min_count`` times give a zero
    gradient.  Returns ``(centers, A)`` zeroed at the minimum."""
    w = (g.hi - g.lo) / g.n_bins
    visited = g.s_count >= min_count
    logp = torch.log(torch.clamp(g.s_count, min=0.5))
    if g.periodic:
        dlogp = (torch.roll(logp, -1) - torch.roll(logp, 1)) / (2 * w)
        ok = visited & torch.roll(visited, -1) & torch.roll(visited, 1)
    else:
        (dlogp,) = torch.gradient(logp, spacing=w)
        ok = visited
    mean_delta = g.delta_sum / torch.clamp(g.s_count, min=1.0)
    da = torch.where(ok, -kT * dlogp + kappa * mean_delta, 0.0)
    a = torch.cat([da.new_zeros(1),
                   torch.cumsum(0.5 * (da[1:] + da[:-1]) * w, 0)])
    return _bin_centers(g), a - a.min()
