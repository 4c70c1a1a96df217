"""Replica-exchange molecular dynamics (port of
``vaemolsim_tpu/parallel/remd.py``).

``R`` temperature replicas, each an arbitrary batch of walkers, run
Langevin BAOAB dynamics at their own ``kT_r = 1 / beta_r``; every
``md_steps_per_exchange`` steps adjacent replicas attempt the swap

    A = min(1, exp((beta_i - beta_j) (U_i - U_j)))

on their potential energies, alternating even and odd pairings.  An
accepted swap exchanges positions and forces and carries the velocities
across rescaled by ``sqrt(beta_from / beta_to)``.  The closing force
evaluation of the last MD step gives the energies the swap uses.  Each
pair draws one uniform, indexed by its lower replica.

The replica axis is the leading tensor axis and every step runs on all
replicas at once on one device.  ``step.draw(state)`` gives a round's
draws (the O-step normals and the swap's ``log U``) from the state's
generator, ``step.move(state, noise)`` runs the round on given draws.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional, Tuple

import torch

from vaemolsim_tpu_torch.mcmc.engine import log_uniform
from vaemolsim_tpu_torch.md import _force_fn, _masses_arr
from vaemolsim_tpu_torch.parallel.replica import _swap_partner_perm

Tensor = torch.Tensor

__all__ = ["REMDState", "make_remd_step", "run_remd"]


@dataclass
class REMDState:
    """R replicas of MD state: ``x``, ``v``, ``force`` of shape (R,
    *batch, n_atoms, dim), the potential energies (R, *batch), the
    inverse temperatures (R,), the generator, the round count that
    drives the pairing, and exact int64 swap trial / acceptance counts
    (each attempted pair counted once per walker)."""

    x: Tensor
    v: Tensor
    force: Tensor
    energies: Tensor
    betas: Tensor
    generator: torch.Generator
    exchange_index: int
    num_swap_trials: Tensor
    num_swap_acc: Tensor

    @property
    def swap_acceptance_rate(self) -> Tensor:
        return (self.num_swap_acc.double()
                / max(int(self.num_swap_trials), 1))

    @classmethod
    def create(cls, potential: Callable[[Tensor], Tensor], x: Tensor,
               betas, generator: torch.Generator,
               v: Optional[Tensor] = None, masses=1.0) -> "REMDState":
        """The ladder; without ``v``, velocities are drawn from
        Maxwell-Boltzmann at each replica's own temperature."""
        betas = torch.as_tensor(betas, dtype=x.dtype, device=x.device)
        R = x.shape[0]
        if betas.shape != (R,):
            raise ValueError(f"betas must be shape ({R},) to match the "
                             "leading replica axis of x, got "
                             f"{tuple(betas.shape)}")
        if v is None:
            m = _masses_arr(masses, x)
            kT = (1.0 / betas).reshape((R,) + (1,) * (x.dim() - 1))
            v = torch.sqrt(kT / m) * torch.randn(
                x.shape, generator=generator, dtype=x.dtype, device=x.device)
        e, f = _force_fn(potential)(x)
        zero = torch.zeros((), dtype=torch.int64, device=x.device)
        return cls(x, v, f, e, betas, generator, 0, zero, zero.clone())


def make_remd_step(potential: Callable[[Tensor], Tensor], *, dt: float,
                   friction: float = 1.0, masses=1.0,
                   md_steps_per_exchange: int = 10
                   ) -> Callable[[REMDState], REMDState]:
    """One round: every replica advances ``md_steps_per_exchange`` BAOAB
    steps at its own temperature, then one round of adjacent swaps."""
    force = _force_fn(potential)

    def draw(state: REMDState) -> dict:
        g, x, e = state.generator, state.x, state.energies
        return dict(
            normals=[torch.randn(x.shape, generator=g, dtype=x.dtype,
                                 device=x.device)
                     for _ in range(md_steps_per_exchange)],
            logu=log_uniform(g, e.shape, e.dtype, e.device))

    def md_phase(state: REMDState, normals) -> REMDState:
        m = _masses_arr(masses, state.x)
        dt_ = torch.tensor(dt, dtype=state.x.dtype, device=state.x.device)
        R = state.betas.shape[0]
        kT = (1.0 / state.betas).reshape((R,) + (1,) * (state.x.dim() - 1))
        c1 = torch.exp(-friction * dt_)
        c2 = torch.sqrt(kT * (1.0 - c1 * c1) / m)
        x, v, f, e = state.x, state.v, state.force, state.energies
        for xi in normals:
            v = v + 0.5 * dt_ * f / m
            x = x + 0.5 * dt_ * v
            v = c1 * v + c2 * xi
            x = x + 0.5 * dt_ * v
            e, f = force(x)
            v = v + 0.5 * dt_ * f / m
        return replace(state, x=x, v=v, force=f, energies=e)

    def exchange_phase(state: REMDState, logu: Tensor) -> REMDState:
        R = state.x.shape[0]
        if R < 2:
            return replace(state, exchange_index=state.exchange_index + 1)
        dev = state.x.device
        odd = state.exchange_index % 2 == 1
        partner = _swap_partner_perm(R, odd, dev)
        idx = torch.arange(R, device=dev)
        e, beta = state.energies, state.betas
        e_p = e[partner]
        bcast = (R,) + (1,) * (e.dim() - 1)
        beta_r = beta.reshape(bcast)
        beta_p = beta[partner].reshape(bcast)
        delta = (beta_r - beta_p) * (e - e_p)
        u_pair = logu[torch.minimum(idx, partner)]
        has_partner = partner != idx
        accept = (u_pair <= delta) & has_partner.reshape(bcast)
        ev = (1,) * (state.x.dim() - e.dim())
        acc_x = accept.reshape(accept.shape + ev)
        scale = torch.sqrt(beta_p / beta_r).reshape(bcast + ev)
        # Pairs counted on the host: no device sync a round.
        n_att = len(range(1 if odd else 0, R - 1, 2)) * (e.numel() // R)
        return replace(
            state, x=torch.where(acc_x, state.x[partner], state.x),
            v=torch.where(acc_x, state.v[partner] * scale, state.v),
            force=torch.where(acc_x, state.force[partner], state.force),
            energies=torch.where(accept, e_p, e),
            exchange_index=state.exchange_index + 1,
            num_swap_trials=state.num_swap_trials + n_att,
            num_swap_acc=state.num_swap_acc
            + accept.sum(dtype=torch.int64) // 2)

    def move(state: REMDState, noise: dict) -> REMDState:
        return exchange_phase(md_phase(state, noise["normals"]),
                              noise["logu"])

    @torch.no_grad()
    def step(state: REMDState) -> REMDState:
        return move(state, draw(state))

    step.draw, step.move = draw, move
    return step


def run_remd(step_fn: Callable[[REMDState], REMDState], state: REMDState,
             n_rounds: int, *, collect_every: int = 0
             ) -> Tuple[REMDState, Optional[Tensor]]:
    """``n_rounds`` rounds; with ``collect_every = k > 0`` also the
    positions after every k-th round, (n_rounds // k, R, *batch,
    n_atoms, dim)."""
    if collect_every and n_rounds % collect_every:
        raise ValueError(f"collect_every={collect_every} must divide "
                         f"n_rounds={n_rounds}")
    xs = []
    for k in range(1, n_rounds + 1):
        state = step_fn(state)
        if collect_every and k % collect_every == 0:
            xs.append(state.x)
    return state, (torch.stack(xs) if collect_every else None)
