"""Molecular dynamics integrators (port of ``vaemolsim_tpu/md.py``, the
molecular MD slice).

- :func:`velocity_verlet`: NVE, one force per step (the closing force of
  step k opens step k + 1).
- :func:`baoab`: Langevin NVT by the BAOAB splitting (Leimkuhler &
  Matthews 2013); velocity Verlet at ``friction=0``.
- :func:`velocity_verlet_neighbor`, :func:`baoab_neighbor`: the same
  with a cell neighbour list rebuilt every ``rebuild_every`` steps.
- :func:`steered_baoab`: nonequilibrium Langevin with protocol work.
- :func:`nose_hoover` (with :func:`nose_hoover_invariant`) and
  :func:`csvr`: deterministic and stochastic-rescale thermostats.
- :func:`respa_verlet`: multiple time steps (fast and slow forces).
- :func:`baoab_npt`: Langevin plus a Monte Carlo barostat.
- :func:`bond_constraints`, :func:`velocity_verlet_constrained`,
  :func:`baoab_constrained`: SHAKE / RATTLE bond constraints.

Reduced units; ``potential(x) -> (...,)`` over ``x`` of shape (...,
n_atoms, dim); per-atom ``masses`` broadcast as (n_atoms, 1).  Forces are
``-grad potential`` by ``torch.autograd.grad``.  Steps run in a Python
loop on ``x``'s device with no host synchronisation; every random draw
(the O-step's normals, CSVR's gamma, the barostat's moves) comes from an
explicit ``torch.Generator`` on that device.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vaemolsim_tpu_torch.config import default_device
from vaemolsim_tpu_torch.ops.distributions import standard_gamma
from vaemolsim_tpu_torch.utils.scan import scan_collect

Tensor = torch.Tensor

__all__ = ["MDState", "NPTMDState", "NHCState", "CSVRState",
           "kinetic_energy", "temperature", "velocity_verlet", "baoab",
           "steered_baoab", "nose_hoover", "nose_hoover_invariant", "csvr",
           "respa_verlet", "velocity_verlet_neighbor", "baoab_neighbor",
           "baoab_npt", "BondConstraints", "bond_constraints",
           "velocity_verlet_constrained", "baoab_constrained"]


class MDState(NamedTuple):
    """Positions, velocities and the force at ``x``, which the next step
    reuses."""
    x: Tensor
    v: Tensor
    force: Tensor


def _force_fn(potential: Callable[[Tensor], Tensor]):
    def force(x: Tensor) -> Tuple[Tensor, Tensor]:
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            e = potential(x)
            (g,) = torch.autograd.grad(e.sum(), x)
        return e.detach(), -g

    return force


def _masses_arr(masses, x: Tensor) -> Tensor:
    m = torch.as_tensor(masses, dtype=x.dtype, device=x.device)
    return m[:, None] if m.ndim == 1 else m


def _normal(generator: torch.Generator, like: Tensor) -> Tensor:
    return torch.randn(like.shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def kinetic_energy(v: Tensor, masses=1.0) -> Tensor:
    """``sum m |v|^2 / 2`` per replica (reduces the last two axes)."""
    return 0.5 * (_masses_arr(masses, v) * v * v).sum((-2, -1))


def temperature(v: Tensor, masses=1.0) -> Tensor:
    """Instantaneous kinetic temperature ``2 KE / n_dof``, all n_atoms *
    dim momenta counted."""
    return 2.0 * kinetic_energy(v, masses) / (v.shape[-2] * v.shape[-1])


def _check_collect(n_steps: int, collect_every: int) -> None:
    if collect_every and n_steps % collect_every != 0:
        raise ValueError("n_steps must be a multiple of collect_every")


def velocity_verlet(potential: Callable[[Tensor], Tensor], x0: Tensor,
                    v0: Tensor, *, dt: float, n_steps: int, masses=1.0,
                    collect_every: int = 0, f0: Optional[Tensor] = None
                    ) -> Tuple[MDState, Optional[Tensor]]:
    """NVE velocity Verlet.  Returns ``(MDState, trajectory)``: every
    ``collect_every``-th position stacked as (n_steps // collect_every,
    ...), or None when 0.  ``f0``: the force at ``x0`` when known (a
    previous segment's closing force), which skips the opening force."""
    _check_collect(n_steps, collect_every)
    force = _force_fn(potential)
    m = _masses_arr(masses, x0)
    dt = torch.tensor(dt, dtype=x0.dtype, device=x0.device)
    if f0 is None:
        _, f0 = force(x0)
    s = MDState(x=x0, v=v0, force=f0)
    traj = []
    for k in range(1, n_steps + 1):
        v_half = s.v + 0.5 * dt * s.force / m
        x = s.x + dt * v_half
        _, f = force(x)
        s = MDState(x=x, v=v_half + 0.5 * dt * f / m, force=f)
        if collect_every and k % collect_every == 0:
            traj.append(s.x)
    return s, (torch.stack(traj) if collect_every else None)


def baoab(potential: Callable[[Tensor], Tensor], x0: Tensor, v0: Tensor,
          generator: torch.Generator, *, dt: float, n_steps: int,
          friction: float = 1.0, kT: float = 1.0, masses=1.0,
          collect_every: int = 0, f0: Optional[Tensor] = None,
          collect_v: bool = False):
    """Langevin NVT dynamics by BAOAB: B half-kick, A half-drift, O exact
    Ornstein-Uhlenbeck refresh (normals from ``generator``, on ``x0``'s
    device), A, B; one force per step.  With ``collect_every`` the second
    return is the position trajectory, or an ``(x_traj, v_traj)`` pair
    with ``collect_v``."""
    _check_collect(n_steps, collect_every)
    force = _force_fn(potential)
    m = _masses_arr(masses, x0)
    dt = torch.tensor(dt, dtype=x0.dtype, device=x0.device)
    c1 = torch.exp(-friction * dt)
    # O-step noise amplitude per velocity component: sqrt(kT/m (1-c1^2)).
    c2 = torch.sqrt(kT * (1.0 - c1 * c1) / m)
    if f0 is None:
        _, f0 = force(x0)
    s = MDState(x=x0, v=v0, force=f0)
    xs, vs = [], []
    for k in range(1, n_steps + 1):
        v = s.v + 0.5 * dt * s.force / m                      # B
        x = s.x + 0.5 * dt * v                                # A
        v = c1 * v + c2 * _normal(generator, v)               # O
        x = x + 0.5 * dt * v                                  # A
        _, f = force(x)
        s = MDState(x=x, v=v + 0.5 * dt * f / m, force=f)     # B
        if collect_every and k % collect_every == 0:
            xs.append(s.x)
            vs.append(s.v)
    if not collect_every:
        return s, None
    return s, ((torch.stack(xs), torch.stack(vs)) if collect_v
               else torch.stack(xs))


class _BAOAB:
    """:func:`baoab`'s dynamics with its noise given as rows (or drawn from
    a generator), run through :func:`scan_collect`: the long Langevin
    loops of ``mcmc.tps``, ``mcmc.ffs`` and the weighted-ensemble
    propagators.  Its constants are made once per device and dtype, as
    :func:`baoab` makes them, so that a captured step copies nothing from
    the host.  :func:`baoab` itself stays an eager loop: its callers
    include potentials that launch port kernels, which a captured step
    may not."""

    def __init__(self, potential, *, dt, kt, friction, masses):
        self.force = _force_fn(potential)
        self.dt, self.kt, self.friction = dt, kt, friction
        self.masses = masses
        self._consts = {}

    def consts(self, x: Tensor):
        key = (x.device, x.dtype)
        if key not in self._consts:
            m = _masses_arr(self.masses, x)
            dt = torch.tensor(self.dt, dtype=x.dtype, device=x.device)
            c1 = torch.exp(-self.friction * dt)
            c2 = torch.sqrt(self.kt * (1.0 - c1 * c1) / m)
            self._consts[key] = (m, dt, c1, c2)
        return self._consts[key]

    def start(self, x0: Tensor, v0: Tensor) -> MDState:
        """The state at (x0, v0), with the force there."""
        _, f0 = self.force(x0)
        return MDState(x=x0, v=v0, force=f0)

    def step(self, s: MDState, z: Tensor) -> MDState:
        """One BAOAB step on the O-step normals ``z``."""
        m, dt, c1, c2 = self.consts(s.x)
        v = s.v + 0.5 * dt * s.force / m                      # B
        x = s.x + 0.5 * dt * v                                # A
        v = c1 * v + c2 * z                                   # O
        x = x + 0.5 * dt * v                                  # A
        _, f = self.force(x)
        return MDState(x=x, v=v + 0.5 * dt * f / m, force=f)  # B

    @staticmethod
    def normals(noise, i: Tensor, like: Tensor) -> Tensor:
        """Step ``i``'s normals: row ``i`` (a (1,) long tensor) of the
        tensor ``noise``, or a draw from the generator ``noise``."""
        if isinstance(noise, Tensor):
            return noise.index_select(0, i)[0]
        return _normal(noise, like)

    def scan(self, s: MDState, n_steps: int, noise, *,
             collect_every: int = 0, snapshot_fn=None):
        """``n_steps`` steps from the state ``s``; the O-step normals are
        rows of ``noise`` (n_steps, *x.shape) or drawn from it as a
        generator.  Returns ``(final MDState, snapshots)`` as
        :func:`scan_collect` does."""
        given = isinstance(noise, Tensor)

        def step(carry):
            s, i = carry
            return self.step(s, self.normals(noise, i, s.v)), i + 1

        start = (s, torch.zeros(1, dtype=torch.long, device=s.x.device))
        snap = snapshot_fn or (lambda st: st)
        (s, _), traj = scan_collect(
            step, start, n_steps, collect_every=collect_every,
            snapshot_fn=lambda c: snap(c[0]),
            generators=() if given else (noise,))
        return s, traj

    def run(self, x0: Tensor, v0: Tensor, n_steps: int, noise,
            collect_v: bool, collect_every: int = 1):
        """``n_steps`` steps from (x0, v0) on ``noise`` (as in
        :meth:`scan`).  Returns every ``collect_every``-th step's
        positions (and velocities), (n_steps // collect_every, ...)."""
        _, traj = self.scan(
            self.start(x0, v0), n_steps, noise, collect_every=collect_every,
            snapshot_fn=(lambda s: (s.x, s.v)) if collect_v
            else (lambda s: s.x))
        return traj


def _check_rebuild(n_steps: int, rebuild_every: int) -> None:
    if rebuild_every < 1 or n_steps % rebuild_every:
        raise ValueError(
            f"rebuild_every={rebuild_every} must be >= 1 and divide "
            f"n_steps={n_steps}")


def velocity_verlet_neighbor(build, energy, x0: Tensor, v0: Tensor, *,
                             dt: float, n_steps: int, rebuild_every: int,
                             masses=1.0) -> Tuple[MDState, None]:
    """NVE velocity Verlet with a neighbour list rebuilt by ``build``
    every ``rebuild_every`` steps (``(build, energy)`` as from
    ``potentials.lennard_jones_cell_neighbor``, ``energy(nl, x)``).  Size
    the skin so that no atom moves skin/2 between rebuilds: past it the
    coordinates turn NaN, never silently wrong."""
    _check_rebuild(n_steps, rebuild_every)
    nl = build(x0)
    _, f = _force_fn(lambda x: energy(nl, x))(x0)
    s = MDState(x=x0, v=v0, force=f)
    for _ in range(n_steps // rebuild_every):
        nl = build(s.x)
        # The carried force was computed at this x with the previous,
        # still valid list: any valid list gives the same force.
        s, _ = velocity_verlet(lambda x, nl=nl: energy(nl, x), s.x, s.v,
                               dt=dt, n_steps=rebuild_every, masses=masses,
                               f0=s.force)
    return s, None


def baoab_neighbor(build, energy, x0: Tensor, v0: Tensor,
                   generator: torch.Generator, *, dt: float, n_steps: int,
                   rebuild_every: int, friction: float = 1.0,
                   kT: float = 1.0, masses=1.0) -> Tuple[MDState, None]:
    """Langevin NVT :func:`baoab` with an amortised neighbour list (the
    contract of :func:`velocity_verlet_neighbor`)."""
    _check_rebuild(n_steps, rebuild_every)
    nl = build(x0)
    _, f = _force_fn(lambda x: energy(nl, x))(x0)
    s = MDState(x=x0, v=v0, force=f)
    for _ in range(n_steps // rebuild_every):
        nl = build(s.x)
        s, _ = baoab(lambda x, nl=nl: energy(nl, x), s.x, s.v, generator,
                     dt=dt, n_steps=rebuild_every, friction=friction, kT=kT,
                     masses=masses, f0=s.force)
    return s, None


def steered_baoab(potential_for_lambda: Callable[[Tensor], Callable],
                  x0: Tensor, v0: Tensor, generator: torch.Generator, *,
                  dt: float, n_steps: int, lambdas, friction: float = 1.0,
                  kT: float = 1.0, masses=1.0) -> Tuple[MDState, Tensor]:
    """Steered Langevin dynamics with the protocol work: BAOAB at frozen
    ``lambdas[k]``, then ``W += U(x; lambdas[k+1]) - U(x; lambdas[k])`` at
    fixed x (Jarzynski 1997).  ``lambdas`` has n_steps + 1 entries;
    ``potential_for_lambda(lam) -> energy_fn``.  Returns ``(MDState,
    work)`` with the per-replica work in energy units (for
    ``exp_free_energy(work / kT)`` or, with a reverse run,
    ``bar_free_energy``)."""
    lambdas = torch.as_tensor(lambdas, dtype=x0.dtype, device=x0.device)
    if lambdas.shape[0] != n_steps + 1:
        raise ValueError(f"lambdas must have n_steps + 1 = {n_steps + 1} "
                         f"entries, got {lambdas.shape[0]}")
    m = _masses_arr(masses, x0)
    dt = torch.tensor(dt, dtype=x0.dtype, device=x0.device)
    c1 = torch.exp(-friction * dt)
    c2 = torch.sqrt(kT * (1.0 - c1 * c1) / m)

    def energy_force(x, lam):
        return _force_fn(potential_for_lambda(lam))(x)

    _, f = energy_force(x0, lambdas[0])
    s = MDState(x=x0, v=v0, force=f)
    work = torch.zeros(x0.shape[:-2], dtype=x0.dtype, device=x0.device)
    for k in range(n_steps):
        v = s.v + 0.5 * dt * s.force / m                      # B
        x = s.x + 0.5 * dt * v                                # A
        v = c1 * v + c2 * _normal(generator, v)               # O
        x = x + 0.5 * dt * v                                  # A
        e_cur, f = energy_force(x, lambdas[k])
        v = v + 0.5 * dt * f / m                              # B
        # Switch lam at fixed x; its force opens the next step.
        e_next, f = energy_force(x, lambdas[k + 1])
        work = work + e_next - e_cur
        s = MDState(x=x, v=v, force=f)
    return s, work


class NHCState(NamedTuple):
    """The Nose-Hoover-chain state: positions, velocities, force, and the
    chain's positions ``xi`` and velocities ``v_xi``, (..., n_chain)."""
    x: Tensor
    v: Tensor
    force: Tensor
    xi: Tensor
    v_xi: Tensor


# Suzuki-Yoshida composition weights (Yoshida's 6th-order set for 7).
_W1_7, _W2_7, _W3_7 = (0.784513610477560, 0.235573213359357,
                       -1.17767998417887)
_W1_3 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
_SY_WEIGHTS = {
    1: (1.0,),
    3: (_W1_3, 1.0 - 2.0 * _W1_3, _W1_3),
    7: (_W1_7, _W2_7, _W3_7, 1.0 - 2.0 * (_W1_7 + _W2_7 + _W3_7),
        _W3_7, _W2_7, _W1_7),
}


def _nhc_masses(n_dof: int, kT: float, tau: float, n_chain: int):
    """MTK thermostat masses ``Q_1 = n_dof kT tau^2``, ``Q_i = kT tau^2``."""
    return tuple(float(v) for v in
                 [n_dof * kT * tau * tau] + [kT * tau * tau] * (n_chain - 1))


def _nhc_propagate(v, xi, v_xi, *, m, q, n_dof, kT, dt_half, n_sy,
                   n_respa):
    """``exp(i L_NHC dt/2)`` (Martyna, Tuckerman, Tobias & Klein 1996):
    per Suzuki-Yoshida substep a backward sweep of the chain velocities,
    one rescale of the particle velocities, the chain positions' drift
    and a forward sweep."""
    n_chain = len(q)
    ke2 = (m * v * v).sum((-2, -1))
    scale = torch.ones_like(ke2)
    vx = [v_xi[..., i] for i in range(n_chain)]
    xs = [xi[..., i] for i in range(n_chain)]

    def force_on(i):
        if i == 0:
            return (ke2 - n_dof * kT) / q[0]
        return (q[i - 1] * vx[i - 1] ** 2 - kT) / q[i]

    for _ in range(n_respa):
        for w in _SY_WEIGHTS[n_sy]:
            delta = w * dt_half / n_respa
            vx[-1] = vx[-1] + 0.5 * delta * force_on(n_chain - 1)
            for i in range(n_chain - 2, -1, -1):
                aa = torch.exp(-0.25 * delta * vx[i + 1])
                vx[i] = vx[i] * aa * aa + 0.5 * delta * force_on(i) * aa
            s = torch.exp(-delta * vx[0])
            scale = scale * s
            ke2 = ke2 * s * s
            for i in range(n_chain):
                xs[i] = xs[i] + delta * vx[i]
            for i in range(n_chain - 1):
                aa = torch.exp(-0.25 * delta * vx[i + 1])
                vx[i] = vx[i] * aa * aa + 0.5 * delta * force_on(i) * aa
            vx[-1] = vx[-1] + 0.5 * delta * force_on(n_chain - 1)
    return (v * scale[..., None, None], torch.stack(xs, -1),
            torch.stack(vx, -1))


def nose_hoover(potential: Callable[[Tensor], Tensor], x0: Tensor,
                v0: Tensor, *, dt: float, n_steps: int, kT: float = 1.0,
                tau: Optional[float] = None, masses=1.0, n_chain: int = 3,
                n_sy: int = 7, n_respa: int = 1, collect_every: int = 0,
                state: Optional[NHCState] = None
                ) -> Tuple[NHCState, Optional[Tensor]]:
    """Deterministic NVT by Nose-Hoover chains (the MTK scheme): half a
    chain propagation, velocity Verlet, half a chain propagation; one
    force a step.  ``tau`` defaults to 100 dt; :func:`nose_hoover_invariant`
    is its conserved quantity.  Pass ``state`` to resume (``x0`` / ``v0``
    are then ignored)."""
    _check_collect(n_steps, collect_every)
    if n_sy not in _SY_WEIGHTS:
        raise ValueError(f"n_sy must be one of {sorted(_SY_WEIGHTS)}")
    if n_chain < 1:
        raise ValueError("n_chain must be >= 1")
    force = _force_fn(potential)
    x0 = state.x if state is not None else x0
    m = _masses_arr(masses, x0)
    n_dof = x0.shape[-2] * x0.shape[-1]
    q = _nhc_masses(n_dof, float(kT),
                    float(tau) if tau is not None else 100.0 * float(dt),
                    n_chain)
    dt = torch.tensor(dt, dtype=x0.dtype, device=x0.device)
    kw = dict(m=m, q=q, n_dof=n_dof, kT=float(kT), dt_half=0.5 * dt,
              n_sy=n_sy, n_respa=n_respa)
    if state is None:
        _, f0 = force(x0)
        zeros = torch.zeros(x0.shape[:-2] + (n_chain,), dtype=x0.dtype,
                            device=x0.device)
        state = NHCState(x=x0, v=v0, force=f0, xi=zeros, v_xi=zeros)
    s = state
    traj = []
    for k in range(1, n_steps + 1):
        v, xi, v_xi = _nhc_propagate(s.v, s.xi, s.v_xi, **kw)
        v = v + 0.5 * dt * s.force / m
        x = s.x + dt * v
        _, f = force(x)
        v = v + 0.5 * dt * f / m
        v, xi, v_xi = _nhc_propagate(v, xi, v_xi, **kw)
        s = NHCState(x=x, v=v, force=f, xi=xi, v_xi=v_xi)
        if collect_every and k % collect_every == 0:
            traj.append(s.x)
    return s, (torch.stack(traj) if collect_every else None)


def nose_hoover_invariant(potential: Callable[[Tensor], Tensor],
                          state: NHCState, *, kT: float = 1.0,
                          tau: Optional[float] = None,
                          dt: Optional[float] = None, masses=1.0) -> Tensor:
    """The conserved quantity of :func:`nose_hoover` per replica, ``U + KE
    + sum_i Q_i v_xi_i^2 / 2 + n_dof kT xi_1 + kT sum_{i>1} xi_i``: pass
    the integrator's ``kT`` / ``tau`` / ``masses`` (and ``dt`` if ``tau``
    was its 100 dt default)."""
    if tau is None:
        if dt is None:
            raise ValueError("pass tau, or dt so the 100*dt default "
                             "tau matches the integrator")
        tau = 100.0 * float(dt)
    n_chain = state.v_xi.shape[-1]
    n_dof = state.x.shape[-2] * state.x.shape[-1]
    q = torch.tensor(_nhc_masses(n_dof, float(kT), float(tau), n_chain),
                     dtype=state.x.dtype, device=state.x.device)
    weights = torch.tensor([n_dof] + [1] * (n_chain - 1),
                           dtype=state.x.dtype, device=state.x.device)
    with torch.no_grad():
        u = potential(state.x)
    return (u + kinetic_energy(state.v, masses)
            + 0.5 * (q * state.v_xi * state.v_xi).sum(-1)
            + float(kT) * (weights * state.xi).sum(-1))


def respa_verlet(fast_potential: Callable[[Tensor], Tensor],
                 slow_potential: Callable[[Tensor], Tensor], x0: Tensor,
                 v0: Tensor, *, dt: float, n_steps: int, n_inner: int = 4,
                 masses=1.0, collect_every: int = 0
                 ) -> Tuple[MDState, Optional[Tensor]]:
    """r-RESPA (Tuckerman, Berne & Martyna 1992): a half slow kick, then
    ``n_inner`` velocity-Verlet steps of the fast force at dt / n_inner,
    then a half slow kick; one slow force an outer step.
    ``MDState.force`` carries the fast force."""
    _check_collect(n_steps, collect_every)
    if n_inner < 1:
        raise ValueError("n_inner must be >= 1")
    f_fast = _force_fn(fast_potential)
    f_slow = _force_fn(slow_potential)
    m = _masses_arr(masses, x0)
    dt = torch.tensor(dt, dtype=x0.dtype, device=x0.device)
    h = dt / n_inner
    _, f0 = f_fast(x0)
    _, fs = f_slow(x0)
    s = MDState(x=x0, v=v0, force=f0)
    traj = []
    for k in range(1, n_steps + 1):
        s = MDState(x=s.x, v=s.v + 0.5 * dt * fs / m, force=s.force)
        for _ in range(n_inner):
            v_half = s.v + 0.5 * h * s.force / m
            x = s.x + h * v_half
            _, f = f_fast(x)
            s = MDState(x=x, v=v_half + 0.5 * h * f / m, force=f)
        _, fs = f_slow(s.x)
        s = MDState(x=s.x, v=s.v + 0.5 * dt * fs / m, force=s.force)
        if collect_every and k % collect_every == 0:
            traj.append(s.x)
    return s, (torch.stack(traj) if collect_every else None)


class CSVRState(NamedTuple):
    """The CSVR state: positions, velocities, force and the accumulated
    rescale work (``E(t) - work`` is conserved)."""
    x: Tensor
    v: Tensor
    force: Tensor
    work: Tensor


def csvr(potential: Callable[[Tensor], Tensor], x0: Tensor, v0: Tensor,
         generator: torch.Generator, *, dt: float, n_steps: int,
         kT: float = 1.0, tau: float = 0.1, masses=1.0,
         collect_every: int = 0, state: Optional[CSVRState] = None
         ) -> Tuple[CSVRState, Optional[Tensor]]:
    """Canonical sampling through velocity rescaling (Bussi, Donadio &
    Parrinello 2007): velocity Verlet and one exact stochastic rescale of
    the kinetic energy a step, ``K' = K + (1-c)(Kbar (R1^2 + S)/Nf - K) +
    2 R1 sqrt(c (1-c) K Kbar / Nf)``, ``c = e^{-dt/tau}``, ``R1 ~ N(0,1)``,
    ``S ~ chi^2(Nf - 1)`` (twice a Gamma((Nf - 1) / 2) draw), ``Kbar = Nf kT /
    2``.  A replica with zero kinetic energy is left alone.  Pass
    ``state`` to resume."""
    _check_collect(n_steps, collect_every)
    force = _force_fn(potential)
    x0 = state.x if state is not None else x0
    m = _masses_arr(masses, x0)
    n_dof = x0.shape[-2] * x0.shape[-1]
    dt = torch.tensor(dt, dtype=x0.dtype, device=x0.device)
    c = torch.exp(-dt / tau)
    k_bar = 0.5 * n_dof * kT
    batch = x0.shape[:-2]
    half_dof = torch.tensor(0.5 * (n_dof - 1), dtype=x0.dtype,
                            device=x0.device)
    if state is None:
        _, f0 = force(x0)
        state = CSVRState(x=x0, v=v0, force=f0,
                          work=torch.zeros(batch, dtype=x0.dtype,
                                           device=x0.device))
    s = state
    traj = []
    for k in range(1, n_steps + 1):
        v = s.v + 0.5 * dt * s.force / m
        x = s.x + dt * v
        _, f = force(x)
        v = v + 0.5 * dt * f / m
        K = kinetic_energy(v, masses)
        r1 = torch.randn(batch, generator=generator, dtype=x0.dtype,
                         device=x0.device)
        s_sum = 2.0 * standard_gamma(generator, half_dof, batch)
        K_new = (K + (1.0 - c) * (k_bar * (r1 * r1 + s_sum) / n_dof - K)
                 + 2.0 * r1 * torch.sqrt(c * (1.0 - c) * K * k_bar / n_dof))
        K_new = K_new.clamp_min(0.0)
        has_ke = K > 0.0
        alpha = torch.where(has_ke,
                            torch.sqrt(K_new / K.clamp_min(1e-30)), 1.0)
        dK = torch.where(has_ke, K_new - K, 0.0)
        s = CSVRState(x=x, v=alpha[..., None, None] * v, force=f,
                      work=s.work + dK)
        if collect_every and k % collect_every == 0:
            traj.append(s.x)
    return s, (torch.stack(traj) if collect_every else None)


class NPTMDState(NamedTuple):
    """The NPT-MD state: positions, velocities, force, the per-replica box
    (..., dim), the potential energy at (x, box) and the barostat's
    counts."""
    x: Tensor
    v: Tensor
    force: Tensor
    box: Tensor
    energy: Tensor
    vol_trials: Tensor
    vol_acc: Tensor

    @property
    def volume(self) -> Tensor:
        return torch.prod(self.box, -1)

    @property
    def vol_acceptance_rate(self) -> Tensor:
        return self.vol_acc / self.vol_trials.clamp_min(1)


def baoab_npt(potential_for_box: Callable[[Tensor], Callable], x0: Tensor,
              v0: Tensor, box0, generator: torch.Generator, *, dt: float,
              n_steps: int, pressure: float, friction: float = 1.0,
              kT: float = 1.0, masses=1.0, vol_every: int = 25,
              dlnv_scale: float = 0.02, min_box: Optional[float] = None,
              collect: bool = False, state: Optional[NPTMDState] = None):
    """NPT dynamics: ``vol_every`` BAOAB steps at a frozen box, then one
    Monte Carlo volume move (a Gaussian step in ln V, coordinates and box
    dilated, accepted with ``exp(-beta dU - beta P dV + (N + 1) ln(V' /
    V))``; velocities untouched).  ``potential_for_box(box (..., 1, 1,
    dim)) -> energy_fn`` (the dense periodic factories take a tensor box);
    ``min_box`` rejects an edge below it (set 2 * cutoff for a truncated
    minimum-image potential).  With ``collect`` also returns ``(xs,
    boxes)`` once a barostat cycle.  Pass ``state`` to resume."""
    if vol_every < 1 or n_steps % vol_every:
        raise ValueError(f"vol_every={vol_every} must be >= 1 and divide "
                         f"n_steps={n_steps}")
    beta = 1.0 / float(kT)

    def u_at(x, box):
        return potential_for_box(box[..., None, None, :])(x)

    if state is None:
        box = torch.as_tensor(box0, dtype=x0.dtype, device=x0.device)
        box = box.expand(x0.shape[:-2] + (x0.shape[-1],)).clone()
        e0, f0 = _force_fn(lambda x: u_at(x, box))(x0)
        zero = torch.zeros((), dtype=torch.int64, device=x0.device)
        state = NPTMDState(x=x0, v=v0, force=f0, box=box, energy=e0,
                           vol_trials=zero, vol_acc=zero.clone())
    n_atoms, dim = state.x.shape[-2], state.x.shape[-1]
    n_chains = state.energy.numel()
    s = state
    xs, boxes = [], []
    for _ in range(n_steps // vol_every):
        md, _ = baoab(lambda x, b=s.box: u_at(x, b), s.x, s.v, generator,
                      dt=dt, n_steps=vol_every, friction=friction, kT=kT,
                      masses=masses, f0=s.force)
        with torch.no_grad():
            e1 = u_at(md.x, s.box)
            v1 = torch.prod(s.box, -1)
            ln_v1 = torch.log(v1)
            ln_v2 = ln_v1 + dlnv_scale * _normal(generator, v1)
            scale = torch.exp((ln_v2 - ln_v1) / dim)
            box2 = scale[..., None] * s.box
            x2 = scale[..., None, None] * md.x
            e2 = u_at(x2, box2)
            log_acc = (-beta * (e2 - e1)
                       - beta * pressure * (torch.exp(ln_v2) - v1)
                       + (n_atoms + 1) * (ln_v2 - ln_v1))
            if min_box is not None:
                log_acc = torch.where(box2.amin(-1) < float(min_box),
                                      -math.inf, log_acc)
            # mcmc's package imports this module (tps, ffs): import late.
            from vaemolsim_tpu_torch.mcmc.engine import log_uniform
            accept = log_acc >= log_uniform(generator, log_acc.shape,
                                            log_acc.dtype, log_acc.device)
            x = torch.where(accept[..., None, None], x2, md.x)
            box = torch.where(accept[..., None], box2, s.box)
            energy = torch.where(accept, e2, e1)
        _, f = _force_fn(lambda xx: u_at(xx, box))(x)
        s = NPTMDState(x=x, v=md.v, force=f, box=box, energy=energy,
                       vol_trials=s.vol_trials + n_chains,
                       vol_acc=s.vol_acc + accept.sum())
        if collect:
            xs.append(x)
            boxes.append(box)
    return s, ((torch.stack(xs), torch.stack(boxes)) if collect else None)


class BondConstraints(NamedTuple):
    """Holonomic bond-length constraints ``|x_i - x_j| = d_b``: SHAKE
    position projection and RATTLE velocity projection (Ryckaert et al.
    1977; Andersen 1983), all bonds at once (Jacobi) for a fixed
    ``n_iters`` sweeps, no host synchronisation.

    ``inc`` is the signed incidence matrix (+1 at i, -1 at j), kept as a
    public field; the sweeps compute with the bonds' atom indices ``bij``
    (gathers and ``index_add``), not with a product by ``inc``, which
    would be O(B n) work and, with TF32 allowed, rounded.  On CUDA
    tensors outside autograd each projection is captured once per shape as
    a CUDA graph and replayed (``graphs``): its sweeps are about a thousand
    small kernels, which eager PyTorch launches one by one from the host.
    Build with :func:`bond_constraints`."""

    inc: Tensor       # (n_bonds, n_atoms) signed incidence
    d0: Tensor        # (n_bonds,) target lengths
    inv_mu: Tensor    # (n_bonds,) 1/m_i + 1/m_j
    inv_m: Tensor     # (n_atoms, 1)
    n_iters: int
    bij: Tensor       # (2 n_bonds,) first atoms of the bonds, then second
    graphs: dict      # captured projections, by kind and call shapes

    def _replayed(self, kind: str, fn, *args: Tensor) -> Tuple[Tensor, ...]:
        """``fn(*args)`` (a tuple of tensors), replayed from a CUDA graph
        of it captured at the first call of these shapes; eager on the
        CPU, under autograd and inside another capture."""
        a0 = args[0]
        if (not a0.is_cuda or torch.cuda.is_current_stream_capturing()
                or (torch.is_grad_enabled()
                    and any(a.requires_grad for a in args))):
            return fn(*args)
        key = (kind,) + tuple((tuple(a.shape), a.dtype, a.device)
                              for a in args)
        if key not in self.graphs:
            static = [a.detach().clone() for a in args]
            main = torch.cuda.current_stream(a0.device)
            side = torch.cuda.Stream(a0.device)
            side.wait_stream(main)
            with torch.cuda.stream(side), torch.no_grad():
                fn(*static)                      # warm-up, off the capture
            main.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.no_grad(), torch.cuda.graph(graph):
                out = fn(*static)
            self.graphs[key] = (graph, static, out)
        graph, static, out = self.graphs[key]
        for dst, a in zip(static, args):
            dst.copy_(a)
        graph.replay()
        return tuple(o.clone() for o in out)

    def _bond_vectors(self, x: Tensor) -> Tensor:
        """x_i - x_j per bond: one gather of both ends."""
        ends = x.index_select(-2, self.bij)
        n_bonds = self.d0.shape[0]
        return ends[..., :n_bonds, :] - ends[..., n_bonds:, :]

    def _apply(self, per_bond: Tensor, like: Tensor) -> Tensor:
        """``-inc^T per_bond`` scaled by 1/m: -per_bond at i, + at j."""
        both = torch.cat([-per_bond, per_bond], -2)
        return torch.zeros_like(like).index_add(-2, self.bij,
                                                both) * self.inv_m

    def shake_delta(self, x_ref: Tensor, x: Tensor) -> Tuple[Tensor, Tensor]:
        """Project ``x`` onto the constraints along the reference bond
        directions (SHAKE's linearisation).  Returns ``(x_projected,
        delta)``, the correction summed apart: the integrators need
        ``delta / dt``, which ``(x_new - x) / dt`` would give with float32
        roundoff amplified by 1/dt."""
        return self._replayed("shake", self._shake, x_ref, x)

    def _shake(self, x_ref: Tensor, x: Tensor) -> Tuple[Tensor, Tensor]:
        r_ref = self._bond_vectors(x_ref)
        two_inv_mu = 2.0 * self.inv_mu
        d0_sq = self.d0 ** 2
        delta = torch.zeros_like(x)
        for _ in range(self.n_iters):
            r = self._bond_vectors(x)
            rr = torch.linalg.vecdot(r, r)
            denom = two_inv_mu * torch.linalg.vecdot(r, r_ref)
            # A reference direction orthogonal to the drift: the current
            # direction's norm instead.
            denom = torch.where(denom.abs() > 1e-10, denom, two_inv_mu * rr)
            dx = self._apply(((rr - d0_sq) / denom)[..., None] * r_ref, x)
            x = x + dx
            delta = delta + dx
        return x, delta

    def shake(self, x_ref: Tensor, x: Tensor) -> Tensor:
        """:meth:`shake_delta` without the correction."""
        return self.shake_delta(x_ref, x)[0]

    def rattle(self, x: Tensor, v: Tensor) -> Tensor:
        """Project velocities so that no constrained bond stretches."""
        return self._replayed("rattle", self._rattle, x, v)[0]

    def _rattle(self, x: Tensor, v: Tensor) -> Tuple[Tensor]:
        r = self._bond_vectors(x)
        r_scaled = r / (self.inv_mu * torch.linalg.vecdot(r, r))[..., None]
        for _ in range(self.n_iters):
            rv = torch.linalg.vecdot(r_scaled, self._bond_vectors(v))
            v = v + self._apply(rv[..., None] * r, v)
        return (v,)


def bond_constraints(bonds, lengths, n_atoms: int, masses=1.0,
                     n_iters: int = 50, device=None) -> BondConstraints:
    """:class:`BondConstraints` for ``bonds`` (B, 2) at ``lengths``
    (scalar or (B,)); ``masses`` scalar or (n_atoms,).  Built on
    ``config.default_device(device)``."""
    bonds = np.asarray(bonds, np.int64)
    if bonds.ndim != 2 or bonds.shape[1] != 2:
        raise ValueError(f"bonds must be (B, 2); got {bonds.shape}")
    dev = default_device(device)
    B = bonds.shape[0]
    inc = np.zeros((B, n_atoms), np.float32)
    inc[np.arange(B), bonds[:, 0]] = 1.0
    inc[np.arange(B), bonds[:, 1]] = -1.0
    m = np.broadcast_to(np.asarray(masses, np.float32), (n_atoms,))
    inv_mu = 1.0 / m[bonds[:, 0]] + 1.0 / m[bonds[:, 1]]
    d0 = np.broadcast_to(np.asarray(lengths, np.float32), (B,))

    def on(a, dtype=None):
        return torch.as_tensor(np.array(a), dtype=dtype,
                               device=dev)

    return BondConstraints(
        inc=on(inc), d0=on(d0), inv_mu=on(inv_mu.astype(np.float32)),
        inv_m=on((1.0 / m)[:, None].astype(np.float32)),
        n_iters=int(n_iters),
        bij=on(np.concatenate([bonds[:, 0], bonds[:, 1]])), graphs={})


def velocity_verlet_constrained(potential: Callable[[Tensor], Tensor],
                                x0: Tensor, v0: Tensor, *, dt: float,
                                n_steps: int, constraints: BondConstraints,
                                masses=1.0, collect_every: int = 0
                                ) -> Tuple[MDState, Optional[Tensor]]:
    """RATTLE: velocity Verlet with SHAKE after the drift and the velocity
    projection after each kick; conserves the constrained energy."""
    _check_collect(n_steps, collect_every)
    force = _force_fn(potential)
    m = _masses_arr(masses, x0)
    dt = torch.tensor(dt, dtype=x0.dtype, device=x0.device)
    con = constraints
    x0 = con.shake(x0, x0)
    _, f0 = force(x0)
    s = MDState(x=x0, v=con.rattle(x0, v0), force=f0)
    traj = []
    for k in range(1, n_steps + 1):
        v_half = s.v + 0.5 * dt * s.force / m
        x_new, delta = con.shake_delta(s.x, s.x + dt * v_half)
        v_half = v_half + delta / dt                 # constraint impulse
        _, f = force(x_new)
        s = MDState(x=x_new, v=con.rattle(x_new, v_half + 0.5 * dt * f / m),
                    force=f)
        if collect_every and k % collect_every == 0:
            traj.append(s.x)
    return s, (torch.stack(traj) if collect_every else None)


def baoab_constrained(potential: Callable[[Tensor], Tensor], x0: Tensor,
                      v0: Tensor, generator: torch.Generator, *, dt: float,
                      n_steps: int, constraints: BondConstraints,
                      friction: float = 1.0, kT: float = 1.0, masses=1.0,
                      collect_every: int = 0
                      ) -> Tuple[MDState, Optional[Tensor]]:
    """Constrained BAOAB (g-BAOAB with one projection a stage, Leimkuhler
    & Matthews 2016): SHAKE after each drift, RATTLE after each kick and
    after the Ornstein-Uhlenbeck refresh; equipartition carries (3 N -
    B)/2 kT."""
    _check_collect(n_steps, collect_every)
    force = _force_fn(potential)
    m = _masses_arr(masses, x0)
    dt = torch.tensor(dt, dtype=x0.dtype, device=x0.device)
    c1 = torch.exp(-friction * dt)
    c2 = torch.sqrt(kT * (1.0 - c1 * c1) / m)
    con = constraints
    x0 = con.shake(x0, x0)
    _, f0 = force(x0)
    s = MDState(x=x0, v=con.rattle(x0, v0), force=f0)
    traj = []
    for k in range(1, n_steps + 1):
        v = con.rattle(s.x, s.v + 0.5 * dt * s.force / m)          # B
        x, d1 = con.shake_delta(s.x, s.x + 0.5 * dt * v)           # A
        v = v + d1 / (0.5 * dt)
        v = con.rattle(x, c1 * v + c2 * _normal(generator, v))     # O
        x2, d2 = con.shake_delta(x, x + 0.5 * dt * v)              # A
        v = v + d2 / (0.5 * dt)
        _, f = force(x2)
        s = MDState(x=x2, v=con.rattle(x2, v + 0.5 * dt * f / m),  # B
                    force=f)
        if collect_every and k % collect_every == 0:
            traj.append(s.x)
    return s, (torch.stack(traj) if collect_every else None)
