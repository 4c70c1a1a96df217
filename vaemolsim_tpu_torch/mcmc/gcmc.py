"""Grand-canonical (muVT) Monte Carlo (port of
``vaemolsim_tpu/mcmc/gcmc.py``): a fixed capacity of particle slots with
an active mask per chain; each sweep makes ``n_disp`` single-particle
displacement trials and one exchange trial (insertion or deletion, 1/2
each, per chain), every move costing one masked (n_max,) row of pair
energies.

Acceptance in reduced units (thermal wavelength folded into ``mu``, so
the activity is ``z = exp(beta mu)``): insertion at a uniform position
``min(1, z V / (N + 1) e^{-beta dU})`` into the first free slot,
deletion of a uniform active particle ``min(1, N / (z V) e^{-beta dU})``.
A full chain rejects insertions (size ``n_max`` with headroom).  Slots are
read and written by ``gather`` / ``scatter`` for every chain at once.
The draws come from the state's ``torch.Generator``;
``step.move(state, noise)`` is the sweep on given draws.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from vaemolsim_tpu_torch.mcmc.engine import log_uniform

Tensor = torch.Tensor

__all__ = ["GCMCState", "lj_pair_u", "gcmc_init", "make_gcmc_step",
           "run_gcmc", "total_energy"]

_EPS = 1e-12


def lj_pair_u(sigma: float = 1.0, epsilon: float = 1.0, *,
              cutoff: Optional[float] = None,
              shift: bool = True) -> Callable[[Tensor], Tensor]:
    """Truncated-shifted Lennard-Jones on squared distances, with the
    dense ``potentials.lennard_jones``'s linear core below 0.3 sigma and
    distance floor."""
    sigma = float(sigma)
    epsilon = float(epsilon)
    rc = 0.3 * sigma
    src6 = (sigma / rc) ** 6
    slope = 24.0 * epsilon / rc * (src6 - 2.0 * src6 * src6)

    def u(r2: Tensor) -> Tensor:
        r = torch.sqrt(r2.clamp_min(_EPS))
        sr6 = (sigma / torch.clamp_min(r, rc)) ** 6
        val = 4.0 * epsilon * (sr6 * sr6 - sr6)
        val = val + torch.where(r < rc, slope * (r - rc), 0.0)
        if cutoff is not None:
            if shift:
                sc6 = (sigma / cutoff) ** 6
                val = val - 4.0 * epsilon * (sc6 * sc6 - sc6)
            val = torch.where(r2 < cutoff * cutoff, val, 0.0)
        return val

    return u


def _count(device) -> Tensor:
    return torch.zeros((), dtype=torch.int64, device=device)


@dataclass
class GCMCState:
    """Slot coordinates (..., n_max, dim), the active mask (..., n_max),
    the chains' generator and exact int64 trial / acceptance counts."""

    x: Tensor
    active: Tensor
    generator: torch.Generator
    disp_trials: Tensor
    disp_acc: Tensor
    ins_trials: Tensor
    ins_acc: Tensor
    del_trials: Tensor
    del_acc: Tensor

    @property
    def n(self) -> Tensor:
        """Active particles per chain, (...,)."""
        return self.active.sum(-1)

    @property
    def disp_acceptance_rate(self) -> Tensor:
        return self.disp_acc.double() / self.disp_trials.double()

    @property
    def exchange_acceptance_rate(self) -> Tensor:
        return ((self.ins_acc + self.del_acc).double()
                / (self.ins_trials + self.del_trials).double())


def _one_particle_energy(pair_u, x: Tensor, active: Tensor, pos: Tensor,
                         box: Tensor, exclude_idx: Tensor) -> Tensor:
    """Energy of a particle at ``pos`` (..., dim) with every active slot
    except ``exclude_idx`` (...,)."""
    d = pos[..., None, :] - x
    d = d - box * torch.round(d / box)
    r2 = (d * d).sum(-1)
    slots = torch.arange(x.shape[-2], device=x.device)
    m = active & (slots != exclude_idx[..., None])
    return torch.where(m, pair_u(r2), 0.0).sum(-1)


def total_energy(state: GCMCState, pair_u, box) -> Tensor:
    """The masked total ``sum_{i<j active} u(r_ij)`` per chain."""
    x, active = state.x, state.active
    box = torch.as_tensor(box, dtype=x.dtype, device=x.device)
    d = x[..., :, None, :] - x[..., None, :, :]
    d = d - box * torch.round(d / box)
    n_max = x.shape[-2]
    pair = (active[..., :, None] & active[..., None, :]
            & torch.ones((n_max, n_max), dtype=torch.bool,
                         device=x.device).triu(1))
    return torch.where(pair, pair_u((d * d).sum(-1)), 0.0).sum((-2, -1))


def gcmc_init(x: Tensor, active: Tensor,
              generator: torch.Generator) -> GCMCState:
    """``x`` (..., n_max, dim) (inactive slots may hold anything),
    ``active`` (..., n_max) bool."""
    c = [_count(x.device) for _ in range(6)]
    return GCMCState(x, active.to(torch.bool), generator, *c)


def _gumbel(generator, shape, like: Tensor) -> Tensor:
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=like.device).clamp(1e-38, 1.0 - 1e-7)
    return -torch.log(-torch.log(u))


def _random_active_index(gumbel: Tensor, active: Tensor) -> Tensor:
    """A uniform active slot per chain from Gumbel noise (0 when none is
    active: callers gate on n > 0)."""
    return torch.where(active, gumbel, -math.inf).argmax(-1)


def _first_free_index(active: Tensor) -> Tensor:
    """The lowest inactive slot per chain (0 when full: callers gate on
    n < n_max)."""
    return (~active).to(torch.uint8).argmax(-1)


def _get_slot(x: Tensor, idx: Tensor) -> Tensor:
    """Slot ``idx`` (...,) of ``x`` (..., n_max, dim): (..., dim)."""
    i = idx[..., None, None].expand(idx.shape + (1, x.shape[-1]))
    return x.gather(-2, i)[..., 0, :]


def _set_slot(x: Tensor, idx: Tensor, value: Tensor) -> Tensor:
    """``x`` with slot ``idx`` (...,) set to ``value`` (..., dim)."""
    i = idx[..., None, None].expand(idx.shape + (1, x.shape[-1]))
    return x.scatter(-2, i, value[..., None, :])


def _set_flag(active: Tensor, idx: Tensor, value: Tensor) -> Tensor:
    """``active`` with slot ``idx`` set to ``value`` (..., bool)."""
    return active.scatter(-1, idx[..., None], value[..., None])


def make_gcmc_step(pair_u: Callable[[Tensor], Tensor], *, box, mu,
                   beta: float = 1.0, dx_scale: float = 0.1,
                   n_disp: int = 1) -> Callable[[GCMCState], GCMCState]:
    """One muVT sweep at chemical potential ``mu`` (a scalar, or a tensor
    of the chains' shape: a whole isotherm at once) in a fixed ``box``.
    The returned step has ``step.draw(state)`` and ``step.move(state,
    noise)``."""
    beta = float(beta)
    if n_disp < 0:
        raise ValueError(f"n_disp must be >= 0; got {n_disp}")

    def draw(state: GCMCState) -> dict:
        g, x, active = state.generator, state.x, state.active
        chains = tuple(x.shape[:-2])
        kw = dict(generator=g, dtype=x.dtype, device=x.device)
        disp = [(_gumbel(g, active.shape, x),
                 torch.randn(chains + (x.shape[-1],), **kw),
                 log_uniform(g, chains, x.dtype, x.device))
                for _ in range(n_disp)]
        return dict(disp=disp,
                    insert=torch.rand(chains, **kw) < 0.5,
                    pos=torch.rand(chains + (x.shape[-1],), **kw),
                    pick=_gumbel(g, active.shape, x),
                    logu=log_uniform(g, chains, x.dtype, x.device))

    def move(state: GCMCState, noise: dict) -> GCMCState:
        x, active = state.x, state.active
        dtype = x.dtype
        box_t = torch.as_tensor(box, dtype=dtype, device=x.device)
        n_max, dim = x.shape[-2], x.shape[-1]
        chains = tuple(x.shape[:-2])
        volume = torch.prod(box_t * torch.ones(dim, dtype=dtype,
                                               device=x.device))
        z = torch.exp(beta * torch.as_tensor(mu, dtype=dtype,
                                             device=x.device))
        disp_acc, disp_tri = state.disp_acc, state.disp_trials
        for gumbel, normal, logu in noise["disp"]:
            n_act = active.sum(-1)
            idx = _random_active_index(gumbel, active)
            old = _get_slot(x, idx)
            new = old + dx_scale * normal
            du = (_one_particle_energy(pair_u, x, active, new, box_t, idx)
                  - _one_particle_energy(pair_u, x, active, old, box_t, idx))
            ok = (n_act > 0) & ((-beta * du) >= logu)
            x = _set_slot(x, idx, torch.where(ok[..., None], new, old))
            disp_acc = disp_acc + ok.sum()
            disp_tri = disp_tri + (n_act > 0).sum()
        # The exchange: insert or delete with probability 1/2 per chain.
        n_act = active.sum(-1).to(dtype)
        do_insert = noise["insert"]
        pos_ins = box_t * noise["pos"]
        slot_ins = _first_free_index(active)
        du_ins = _one_particle_energy(
            pair_u, x, active, pos_ins, box_t,
            torch.full(chains, n_max, dtype=torch.long, device=x.device))
        log_acc_ins = (torch.log(z * volume) - torch.log1p(n_act)
                       - beta * du_ins)
        log_acc_ins = torch.where(active.all(-1), -math.inf, log_acc_ins)
        slot_del = _random_active_index(noise["pick"], active)
        du_del = -_one_particle_energy(pair_u, x, active,
                                       _get_slot(x, slot_del), box_t,
                                       slot_del)
        log_acc_del = (torch.log(n_act.clamp_min(1.0))
                       - torch.log(z * volume) - beta * du_del)
        log_acc_del = torch.where(n_act < 0.5, -math.inf, log_acc_del)
        log_acc = torch.where(do_insert, log_acc_ins, log_acc_del)
        ok = log_acc >= noise["logu"]
        slot = torch.where(do_insert, slot_ins, slot_del)
        flag = torch.where(ok, do_insert,
                           active.gather(-1, slot[..., None])[..., 0])
        active = _set_flag(active, slot, flag)
        ins = ok & do_insert
        x = _set_slot(x, slot, torch.where(ins[..., None], pos_ins,
                                           _get_slot(x, slot)))
        return GCMCState(
            x=x, active=active, generator=state.generator,
            disp_trials=disp_tri, disp_acc=disp_acc,
            ins_trials=state.ins_trials + do_insert.sum(),
            ins_acc=state.ins_acc + ins.sum(),
            del_trials=state.del_trials + (~do_insert).sum(),
            del_acc=state.del_acc + (ok & ~do_insert).sum())

    @torch.no_grad()
    def step(state: GCMCState) -> GCMCState:
        return move(state, draw(state))

    step.draw, step.move = draw, move
    return step


def run_gcmc(step_fn: Callable[[GCMCState], GCMCState], state: GCMCState,
             n_steps: int, collect_every: int = 0
             ) -> Tuple[GCMCState, Optional[Tensor]]:
    """``n_steps`` sweeps; with ``collect_every = k > 0`` also the
    particle counts of every k-th sweep, (n_steps // k, ...)."""
    if collect_every and n_steps % collect_every:
        raise ValueError(f"collect_every={collect_every} must divide "
                         f"n_steps={n_steps}")
    ns = []
    for k in range(1, n_steps + 1):
        state = step_fn(state)
        if collect_every and k % collect_every == 0:
            ns.append(state.n)
    return state, (torch.stack(ns) if collect_every else None)
