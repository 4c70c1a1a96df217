"""Molecular dynamics integrators (port of ``vaemolsim_tpu/md.py``, the
molecular MD slice).

- :func:`velocity_verlet`: NVE, one force per step (the closing force of
  step k opens step k + 1).
- :func:`baoab`: Langevin NVT by the BAOAB splitting (Leimkuhler &
  Matthews 2013); velocity Verlet at ``friction=0``.
- :func:`velocity_verlet_neighbor`, :func:`baoab_neighbor`: the same
  with a cell neighbour list rebuilt every ``rebuild_every`` steps.

Reduced units; ``potential(x) -> (...,)`` over ``x`` of shape (...,
n_atoms, dim); per-atom ``masses`` broadcast as (n_atoms, 1).  Forces are
``-grad potential`` by ``torch.autograd.grad``.  Steps run in a Python
loop on ``x``'s device with no host synchronisation; the O-step's
normals come from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

Tensor = torch.Tensor

__all__ = ["MDState", "kinetic_energy", "temperature", "velocity_verlet",
           "baoab", "velocity_verlet_neighbor", "baoab_neighbor"]


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
        v = c1 * v + c2 * torch.randn(v.shape, generator=generator,
                                      dtype=v.dtype, device=v.device)  # O
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
