"""Well-tempered metadynamics (port of ``vaemolsim_tpu/metadynamics.py``).

Gaussian hills deposited along a collective variable (CV) flatten the
free-energy surface; in the well-tempered limit the bias converges to
``-(1 - 1/gamma) F(s)`` (Barducci, Bussi & Parrinello 2008).

The bias lives on a FIXED grid over the CV range: each deposit adds one
broadcast Gaussian per walker to the value and derivative tables, and
the bias and its derivative are read by linear interpolation.  All
leading axes of the coordinates are walkers sharing one grid.  The run
is JAX's nested scan: :func:`scan_collect` over deposit intervals, each
interval ``deposit_every`` BAOAB steps, the deposit of every walker's
hill and a fresh force under the new bias.  On the card a chunk of
intervals, deposits included, is captured once and replayed.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from vaemolsim_tpu_torch.config import default_device
from vaemolsim_tpu_torch.md import MDState, _masses_arr, _normal
from vaemolsim_tpu_torch.utils.scan import chunk_size, scan_collect

Tensor = torch.Tensor

__all__ = ["BiasGrid", "bias_grid", "bias_value", "bias_derivative",
           "deposit_hills", "metad_baoab", "free_energy_from_bias"]


@dataclass
class BiasGrid:
    """Accumulated bias on a fixed CV grid: ``v`` / ``dv`` the bias value
    and d(bias)/ds at the ``n`` nodes; ``lo`` / ``hi`` the CV range (for a
    periodic CV one period, ``hi`` exclusive); ``periodic`` wraps
    interpolation and deposition."""

    v: Tensor
    dv: Tensor
    lo: float
    hi: float
    periodic: bool

    def _replace(self, **kw) -> "BiasGrid":
        return dataclasses.replace(self, **kw)


def bias_grid(lo: float, hi: float, n: int, periodic: bool = False,
              device=None) -> BiasGrid:
    dev = default_device(device)
    return BiasGrid(v=torch.zeros(n, device=dev),
                    dv=torch.zeros(n, device=dev), lo=float(lo),
                    hi=float(hi), periodic=bool(periodic))


def _grid_points(g: BiasGrid) -> Tensor:
    n = g.v.shape[0]
    if g.periodic:
        return g.lo + (g.hi - g.lo) * torch.arange(n, device=g.v.device) / n
    return torch.linspace(g.lo, g.hi, n, device=g.v.device)


def _interp(g: BiasGrid, table: Tensor, s: Tensor) -> Tensor:
    """Linear interpolation of ``table`` at CV values ``s``."""
    n = table.shape[0]
    if g.periodic:
        u = (s - g.lo) / (g.hi - g.lo) * n
        i0 = torch.floor(u).long()
        w = u - i0
        i0 = torch.remainder(i0, n)
        i1 = torch.remainder(i0 + 1, n)
    else:
        u = (s - g.lo) / (g.hi - g.lo) * (n - 1)
        u = torch.clamp(u, 0.0, n - 1.0)
        i0 = torch.clamp(torch.floor(u).long(), 0, n - 2)
        w = u - i0
        i1 = i0 + 1
    return (1.0 - w) * table[i0] + w * table[i1]


def bias_value(g: BiasGrid, s: Tensor) -> Tensor:
    return _interp(g, g.v, s)


def bias_derivative(g: BiasGrid, s: Tensor) -> Tensor:
    return _interp(g, g.dv, s)


def _cv_delta(g: BiasGrid, a: Tensor, b: Tensor) -> Tensor:
    d = a - b
    if g.periodic:
        period = g.hi - g.lo
        d = d - period * torch.round(d / period)
    return d


def deposit_hills(g: BiasGrid, s: Tensor, *, height, width: float,
                  kT: float = 1.0, gamma: float = 5.0) -> BiasGrid:
    """Add one well-tempered Gaussian hill per walker CV in ``s`` (any
    shape; flattened), each of height ``height * exp(-V(s_i) / (kT (gamma
    - 1)))``."""
    pts = _grid_points(g)
    s = s.reshape(-1)
    w_i = height * torch.exp(-bias_value(g, s) / (kT * (gamma - 1.0)))
    d = _cv_delta(g, pts[None, :], s[:, None])        # (walkers, n)
    gauss = torch.exp(-0.5 * (d / width) ** 2)
    v_add = (w_i[:, None] * gauss).sum(0)
    dv_add = (w_i[:, None] * gauss * (-d / width ** 2)).sum(0)
    return g._replace(v=g.v + v_add, dv=g.dv + dv_add)


def _biased_force(potential, cv_fn, x: Tensor, dbias
                  ) -> Tuple[Tensor, Tensor]:
    """``(-grad U(x) - dbias(s) grad s, s)`` at ``x``: one forward of the
    potential and the CV and one backward (``dbias(s)`` is held fixed
    through it), the force of every bias engine here."""
    xg = x.detach().requires_grad_(True)
    with torch.enable_grad():
        s = cv_fn(xg)
        e = potential(xg).sum() + (dbias(s.detach()) * s).sum()
        (g,) = torch.autograd.grad(e, xg)
    return -g, s.detach()


def _baoab_intervals(potential, cv_fn, x0, v0, generator, *, dt, n_steps,
                     deposit_every, bias, dbias, deposit, kT, friction,
                     masses, noise):
    """The run shared by :func:`metad_baoab` and ``opes.opes_baoab``:
    ``n_steps / deposit_every`` intervals of ``deposit_every`` BAOAB steps
    under the force ``-grad U - dbias(bias, s) grad s``, each followed by
    ``bias = deposit(bias, s)`` and the force under the new bias.
    Returns ``(MDState, bias, CV at each deposit)``."""
    if n_steps % deposit_every:
        raise ValueError(f"deposit_every={deposit_every} must divide "
                         f"n_steps={n_steps}")
    n_dep = n_steps // deposit_every
    m = _masses_arr(masses, x0)
    dt_a = torch.tensor(dt, dtype=x0.dtype, device=x0.device)
    c1 = torch.exp(-friction * dt_a)
    c2 = torch.sqrt(kT * (1.0 - c1 * c1) / m)
    # Given draws: (n_steps, ...) as (intervals, deposit_every, ...),
    # read by the interval counter the carry holds.
    blocks = (None if noise is None else
              noise.reshape((n_dep, deposit_every) + noise.shape[1:]))

    def force(x, b):
        return _biased_force(potential, cv_fn, x, lambda s: dbias(b, s))

    def interval(carry):
        st, b, _, i = carry
        z = None if blocks is None else blocks.index_select(0, i)[0]
        for k in range(deposit_every):
            v = st.v + 0.5 * dt_a * st.force / m                  # B
            x = st.x + 0.5 * dt_a * v                             # A
            eps = _normal(generator, v) if z is None else z[k]
            v = c1 * v + c2 * eps                                 # O
            x = x + 0.5 * dt_a * v                                # A
            f, _ = force(x, b)
            st = MDState(x=x, v=v + 0.5 * dt_a * f / m, force=f)  # B
        s = cv_fn(st.x)
        b = deposit(b, s)
        f, _ = force(st.x, b)
        return st._replace(force=f), b, s, i + 1

    f0, s0 = force(x0, bias)
    i0 = torch.zeros(1, dtype=torch.long, device=x0.device)
    carry = (MDState(x=x0, v=v0, force=f0), bias, s0, i0)
    carry, cvs = scan_collect(
        interval, carry, n_dep, collect_every=1, snapshot_fn=lambda c: c[2],
        chunk=chunk_size(n_dep, 1, deposit_every),
        generators=() if generator is None else (generator,))
    return carry[0], carry[1], cvs


def metad_baoab(potential: Callable[[Tensor], Tensor],
                cv_fn: Callable[[Tensor], Tensor],
                x0: Tensor, v0: Tensor,
                generator: Optional[torch.Generator], *,
                dt: float, n_steps: int, deposit_every: int,
                grid: BiasGrid, hill_height: float, hill_width: float,
                kT: float = 1.0, gamma: float = 5.0,
                friction: float = 1.0, masses=1.0,
                collect_cv: bool = True, noise: Optional[Tensor] = None
                ) -> Tuple[MDState, BiasGrid, Optional[Tensor]]:
    """Well-tempered metadynamics over BAOAB Langevin dynamics.

    ``cv_fn``: differentiable CV ``(..., n, d) -> (...)``, one scalar per
    walker; every walker deposits a hill into the shared ``grid`` every
    ``deposit_every`` steps.  The O-step's normals come from
    ``generator``, or from ``noise`` (n_steps, *x0.shape) when given (the
    draws a test hands over).  Returns ``(MDState, BiasGrid, CV of every
    walker at each deposit (n_deposits, ...))``; read the profile with
    :func:`free_energy_from_bias`."""

    def deposit(g, s):
        return deposit_hills(g, s, height=hill_height, width=hill_width,
                             kT=kT, gamma=gamma)

    st, grid, cvs = _baoab_intervals(
        potential, cv_fn, x0, v0, generator, dt=dt, n_steps=n_steps,
        deposit_every=deposit_every, bias=grid, dbias=bias_derivative,
        deposit=deposit, kT=kT, friction=friction, masses=masses,
        noise=noise)
    return st, grid, (cvs if collect_cv else None)


def free_energy_from_bias(g: BiasGrid, *, kT: float = 1.0,
                          gamma: float = 5.0) -> Tuple[Tensor, Tensor]:
    """The well-tempered estimator ``F(s) = -gamma/(gamma-1) V(s)``,
    zeroed at its minimum: ``(s_grid, F)``."""
    f = -(gamma / (gamma - 1.0)) * g.v
    return _grid_points(g), f - f.min()
