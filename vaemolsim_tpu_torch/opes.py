"""OPES, on-the-fly probability enhanced sampling (port of
``vaemolsim_tpu/opes.py``; Invernizzi & Parrinello, J. Phys. Chem. Lett.
11, 2731 (2020)).

A weighted kernel-density estimate of the UNBIASED marginal ``P(s)`` is
built on the fly, and the bias targets its well-tempered form:

    V(s) = (1 - 1/gamma) kT ln( P~(s) / Z + eps ),
    eps  = exp( -beta DeltaE / (1 - 1/gamma) ),

each deposit weighted by ``exp(beta V(s_k))``; ``eps`` floors the bias at
``-DeltaE`` (the ``barrier``).  The estimate lives on a fixed grid, as in
:mod:`~vaemolsim_tpu_torch.metadynamics`, whose grid helpers and run it
shares: walkers share one estimate, periodic CVs wrap.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from vaemolsim_tpu_torch.config import default_device
from vaemolsim_tpu_torch.md import MDState
from vaemolsim_tpu_torch.metadynamics import (BiasGrid, _baoab_intervals,
                                              _cv_delta, _grid_points,
                                              _interp)

Tensor = torch.Tensor

__all__ = ["OPESBias", "opes_grid", "opes_deposit", "opes_bias_value",
           "opes_bias_derivative", "opes_baoab", "free_energy_from_opes"]


@dataclass
class OPESBias:
    """On-the-fly probability estimate on a fixed CV grid: ``prob`` /
    ``dprob`` the weighted kernel density and d/ds at the nodes
    (unnormalized: divide by ``sum_w``), ``sum_w`` the total deposit
    weight (0 before the first deposit, when the bias is exactly 0); the
    range as :class:`~vaemolsim_tpu_torch.metadynamics.BiasGrid`'s, and
    the OPES parameters ``barrier`` (DeltaE), ``gamma`` and ``kT``."""

    prob: Tensor
    dprob: Tensor
    sum_w: Tensor
    lo: float
    hi: float
    periodic: bool
    barrier: float
    gamma: float
    kT: float

    def _as_grid(self) -> BiasGrid:
        return BiasGrid(v=self.prob, dv=self.dprob, lo=self.lo, hi=self.hi,
                        periodic=self.periodic)

    def _replace(self, **kw) -> "OPESBias":
        return dataclasses.replace(self, **kw)

    @property
    def _eps(self) -> float:
        return math.exp(-self.barrier / (self.kT * (1.0 - 1.0 / self.gamma)))

    @property
    def _prefactor(self) -> float:
        return (1.0 - 1.0 / self.gamma) * self.kT


def opes_grid(lo: float, hi: float, n: int, *, barrier: float,
              gamma: float = 10.0, kT: float = 1.0,
              periodic: bool = False, device=None) -> OPESBias:
    """A fresh estimate over ``n`` nodes on ``[lo, hi]``: ``barrier``
    (DeltaE) a little above the highest barrier to cross, ``gamma`` the
    bias factor of the target ``P^{1/gamma}``."""
    if barrier <= 0.0:
        raise ValueError("barrier must be positive")
    if gamma <= 1.0:
        raise ValueError("gamma must exceed 1 (gamma -> inf flattens "
                         "fully; gamma = 1 means no bias)")
    dev = default_device(device)
    return OPESBias(prob=torch.zeros(n, device=dev),
                    dprob=torch.zeros(n, device=dev),
                    sum_w=torch.zeros((), device=dev), lo=float(lo),
                    hi=float(hi), periodic=bool(periodic),
                    barrier=float(barrier), gamma=float(gamma),
                    kT=float(kT))


def _prob_and_z(ob: OPESBias, s: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Normalized KDE P~(s), dP~/ds and the domain average Z; zero before
    the first deposit."""
    g = ob._as_grid()
    denom = torch.clamp(ob.sum_w, min=1e-30)
    p = _interp(g, ob.prob, s) / denom
    dp = _interp(g, ob.dprob, s) / denom
    node_p = ob.prob / denom
    if ob.periodic:
        z = node_p.mean()
    else:
        z = (node_p.sum() - 0.5 * (node_p[0] + node_p[-1])) / (
            node_p.shape[0] - 1)
    return p, dp, torch.clamp(z, min=1e-30)


def opes_bias_value(ob: OPESBias, s: Tensor) -> Tensor:
    """V(s) = (1 - 1/gamma) kT ln(P~(s)/Z + eps); exactly 0 before the
    first deposit."""
    p, _, z = _prob_and_z(ob, s)
    v = ob._prefactor * torch.log(p / z + ob._eps)
    return torch.where(ob.sum_w > 0.0, v, torch.zeros_like(v))


def opes_bias_derivative(ob: OPESBias, s: Tensor) -> Tensor:
    p, dp, z = _prob_and_z(ob, s)
    dv = ob._prefactor * (dp / z) / (p / z + ob._eps)
    return torch.where(ob.sum_w > 0.0, dv, torch.zeros_like(dv))


def opes_deposit(ob: OPESBias, s: Tensor, *, sigma: float) -> OPESBias:
    """Add one Gaussian kernel of bandwidth ``sigma`` per walker CV in
    ``s`` (any shape; flattened), each weighted by ``exp(V(s_i)/kT)``
    under the current bias."""
    g = ob._as_grid()
    pts = _grid_points(g)
    s = s.reshape(-1)
    w_i = torch.exp(opes_bias_value(ob, s) / ob.kT)
    d = _cv_delta(g, pts[None, :], s[:, None])        # (walkers, n)
    norm = 1.0 / (sigma * math.sqrt(2.0 * math.pi))
    gauss = norm * torch.exp(-0.5 * (d / sigma) ** 2)
    p_add = (w_i[:, None] * gauss).sum(0)
    dp_add = (w_i[:, None] * gauss * (-d / sigma ** 2)).sum(0)
    return ob._replace(prob=ob.prob + p_add, dprob=ob.dprob + dp_add,
                       sum_w=ob.sum_w + w_i.sum())


def opes_baoab(potential: Callable[[Tensor], Tensor],
               cv_fn: Callable[[Tensor], Tensor],
               x0: Tensor, v0: Tensor,
               generator: Optional[torch.Generator], *,
               dt: float, n_steps: int, deposit_every: int,
               grid: OPESBias, sigma: float,
               friction: float = 1.0, masses=1.0,
               collect_cv: bool = True, noise: Optional[Tensor] = None
               ) -> Tuple[MDState, OPESBias, Optional[Tensor]]:
    """OPES over BAOAB Langevin dynamics, with the contract of
    :func:`~vaemolsim_tpu_torch.metadynamics.metad_baoab` (``noise``
    included); the thermostat's temperature is ``grid.kT``.  Read the
    profile with :func:`free_energy_from_opes`."""
    st, grid, cvs = _baoab_intervals(
        potential, cv_fn, x0, v0, generator, dt=dt, n_steps=n_steps,
        deposit_every=deposit_every, bias=grid, dbias=opes_bias_derivative,
        deposit=lambda ob, s: opes_deposit(ob, s, sigma=sigma), kT=grid.kT,
        friction=friction, masses=masses, noise=noise)
    return st, grid, (cvs if collect_cv else None)


def free_energy_from_opes(ob: OPESBias) -> Tuple[Tensor, Tensor]:
    """``F(s) = -kT ln P~(s)`` at the nodes, zeroed at its minimum (floored
    where the estimate has no mass): ``(s_grid, F)``."""
    denom = torch.clamp(ob.sum_w, min=1e-30)
    p = torch.clamp(ob.prob / denom, min=1e-30)
    f = -ob.kT * torch.log(p)
    return _grid_points(ob._as_grid()), f - f.min()
