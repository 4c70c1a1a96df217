"""Gibbs-ensemble Monte Carlo (port of ``vaemolsim_tpu/mcmc/gibbs.py``):
two cubic boxes per chain exchange volume and particles at fixed total N,
V and T (Panagiotopoulos 1987), so that below the critical point they
become the coexisting phases.  Each box is a slot array with an active
mask, as in :mod:`vaemolsim_tpu_torch.mcmc.gcmc`.

A sweep per chain: ``n_disp`` single-particle displacements in each box;
one volume exchange (a Gaussian step in ln(V_A / V_B) at fixed V_A +
V_B, both boxes rescaled, accepted with ``exp(-b dU_A - b dU_B + (N_A +
1) ln(V_A'/V_A) + (N_B + 1) ln(V_B'/V_B))``); one transfer A -> B or B
-> A (1/2 each) of a uniform active particle to a uniform position,
accepted with ``min(1, N_src V_dst / ((N_dst + 1) V_src) e^{-b dU})``.
The draws come from the state's ``torch.Generator``;
``step.move(state, noise)`` is the sweep on given draws.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from vaemolsim_tpu_torch.mcmc.engine import log_uniform
from vaemolsim_tpu_torch.mcmc.gcmc import (_first_free_index, _get_slot,
                                           _gumbel, _one_particle_energy,
                                           _random_active_index, _set_flag,
                                           _set_slot)

Tensor = torch.Tensor

__all__ = ["GibbsState", "gibbs_init", "make_gibbs_step", "run_gibbs"]


@dataclass
class GibbsState:
    """Both boxes' slot coordinates and active masks, their per-chain
    edge lengths (...,), the chains' generator and exact int64 counts."""

    x_a: Tensor
    act_a: Tensor
    x_b: Tensor
    act_b: Tensor
    box_a: Tensor
    box_b: Tensor
    generator: torch.Generator
    disp_trials: Tensor
    disp_acc: Tensor
    vol_trials: Tensor
    vol_acc: Tensor
    xfer_trials: Tensor
    xfer_acc: Tensor

    @property
    def n_a(self) -> Tensor:
        return self.act_a.sum(-1)

    @property
    def n_b(self) -> Tensor:
        return self.act_b.sum(-1)

    @property
    def rho_a(self) -> Tensor:
        return self.n_a / self.box_a ** self.x_a.shape[-1]

    @property
    def rho_b(self) -> Tensor:
        return self.n_b / self.box_b ** self.x_b.shape[-1]

    @property
    def disp_acceptance_rate(self) -> Tensor:
        return self.disp_acc.double() / self.disp_trials.double()

    @property
    def vol_acceptance_rate(self) -> Tensor:
        return self.vol_acc.double() / self.vol_trials.double()

    @property
    def xfer_acceptance_rate(self) -> Tensor:
        return self.xfer_acc.double() / self.xfer_trials.double()


def gibbs_init(x_a: Tensor, act_a: Tensor, x_b: Tensor, act_b: Tensor,
               box_a, box_b, generator: torch.Generator) -> GibbsState:
    chains = x_a.shape[:-2]

    def edge(b):
        return torch.as_tensor(b, dtype=x_a.dtype,
                               device=x_a.device).expand(chains).clone()

    c = [torch.zeros((), dtype=torch.int64, device=x_a.device)
         for _ in range(6)]
    return GibbsState(x_a, act_a.to(torch.bool), x_b, act_b.to(torch.bool),
                      edge(box_a), edge(box_b), generator, *c)


def _box_energy(pair_u, x: Tensor, active: Tensor, box_l: Tensor) -> Tensor:
    """Masked total energy of one box of per-chain edge ``box_l``."""
    d = x[..., :, None, :] - x[..., None, :, :]
    b = box_l[..., None, None, None]
    d = d - b * torch.round(d / b)
    n_max = x.shape[-2]
    pair = (active[..., :, None] & active[..., None, :]
            & torch.ones((n_max, n_max), dtype=torch.bool,
                         device=x.device).triu(1))
    return torch.where(pair, pair_u((d * d).sum(-1)), 0.0).sum((-2, -1))


def make_gibbs_step(pair_u: Callable[[Tensor], Tensor], *,
                    beta: float = 1.0, dx_scale: float = 0.1,
                    dlnv_scale: float = 0.05, n_disp: int = 1,
                    min_box: Optional[float] = None
                    ) -> Callable[[GibbsState], GibbsState]:
    """One Gibbs-ensemble sweep.  ``min_box`` rejects a volume exchange
    that takes either edge below it (set 2 * cutoff for a truncated
    pair potential).  The returned step has ``step.draw(state)`` and
    ``step.move(state, noise)``."""
    beta = float(beta)

    def draw(state: GibbsState) -> dict:
        g, x = state.generator, state.x_a
        chains = tuple(x.shape[:-2])
        dim = x.shape[-1]
        kw = dict(generator=g, dtype=x.dtype, device=x.device)

        def box_disp(act):
            return (_gumbel(g, act.shape, x),
                    torch.randn(chains + (dim,), **kw),
                    log_uniform(g, chains, x.dtype, x.device))

        return dict(
            disp=[(box_disp(state.act_a), box_disp(state.act_b))
                  for _ in range(n_disp)],
            vol=torch.randn(chains, **kw),
            vol_logu=log_uniform(g, chains, x.dtype, x.device),
            a_to_b=torch.rand(chains, **kw) < 0.5,
            pick_a=_gumbel(g, state.act_a.shape, x),
            pick_b=_gumbel(g, state.act_b.shape, x),
            pos=torch.rand(chains + (dim,), **kw),
            xfer_logu=log_uniform(g, chains, x.dtype, x.device))

    def move(state: GibbsState, noise: dict) -> GibbsState:
        # Both boxes as one batch (2, chains, ...): box A first.  Every
        # move below is the same in each box, so each runs once on both.
        x = torch.stack([state.x_a, state.x_b])
        act = torch.stack([state.act_a, state.act_b])
        box = torch.stack([state.box_a, state.box_b])
        dtype = x.dtype
        dim = x.shape[-1]
        chains = tuple(state.x_a.shape[:-2])
        n_chains = math.prod(chains)
        disp_acc, disp_tri = state.disp_acc, state.disp_trials
        for da, db in noise["disp"]:
            gumbel, normal, logu = (torch.stack(p) for p in zip(da, db))
            n_act = act.sum(-1)
            idx = _random_active_index(gumbel, act)
            old = _get_slot(x, idx)
            new = old + dx_scale * normal
            e = box[..., None, None]
            du = (_one_particle_energy(pair_u, x, act, new, e, idx)
                  - _one_particle_energy(pair_u, x, act, old, e, idx))
            ok = (n_act > 0) & ((-beta * du) >= logu)
            x = _set_slot(x, idx, torch.where(ok[..., None], new, old))
            disp_acc = disp_acc + ok.sum()
            disp_tri = disp_tri + (n_act > 0).sum()
        # Volume exchange at fixed V_A + V_B.
        v = box ** dim
        v_a, v_b = v[0], v[1]
        r_new = (v_a / v_b) * torch.exp(dlnv_scale * noise["vol"])
        v_a2 = (v_a + v_b) * r_new / (1.0 + r_new)
        v2 = torch.stack([v_a2, (v_a + v_b) - v_a2])
        box2 = v2 ** (1.0 / dim)
        scale = (box2 / box)[..., None, None]
        n = act.sum(-1).to(dtype)
        du = (_box_energy(pair_u, x * scale, act, box2)
              - _box_energy(pair_u, x, act, box))
        log_acc = (-beta * du + (n + 1.0) * torch.log(v2 / v)).sum(0)
        if min_box is not None:
            log_acc = torch.where(box2.amin(0) < float(min_box), -math.inf,
                                  log_acc)
        okv = log_acc >= noise["vol_logu"]
        x = torch.where(okv[..., None, None], x * scale, x)
        box = torch.where(okv, box2, box)
        # Transfer A -> B or B -> A: a uniform active particle of the
        # source to a uniform position of the destination.
        a_to_b = noise["a_to_b"]
        v = box ** dim
        n = act.sum(-1).to(dtype)
        e = box[..., None, None]
        idx = _random_active_index(torch.stack([noise["pick_a"],
                                                noise["pick_b"]]), act)
        du_rm = -_one_particle_energy(pair_u, x, act, _get_slot(x, idx), e,
                                      idx)
        ins = noise["pos"] * box[..., None]
        none = torch.full((2,) + chains, x.shape[-2], dtype=torch.long,
                          device=x.device)
        du_in = _one_particle_energy(pair_u, x, act, ins, e, none)
        log_ab = (torch.log(n[0].clamp_min(1.0) * v[1])
                  - torch.log((n[1] + 1.0) * v[0])
                  - beta * (du_in[1] + du_rm[0]))
        log_ba = (torch.log(n[1].clamp_min(1.0) * v[0])
                  - torch.log((n[0] + 1.0) * v[1])
                  - beta * (du_in[0] + du_rm[1]))
        full = act.all(-1)
        log_ab = torch.where((n[0] < 0.5) | full[1], -math.inf, log_ab)
        log_ba = torch.where((n[1] < 0.5) | full[0], -math.inf, log_ba)
        okx = torch.where(a_to_b, log_ab, log_ba) >= noise["xfer_logu"]
        rm = torch.stack([okx & a_to_b, okx & ~a_to_b])   # source box
        add = rm.flip(0)                                   # destination
        slot = _first_free_index(act)
        x = _set_slot(x, slot, torch.where(add[..., None], ins,
                                           _get_slot(x, slot)))
        # Removal first, then insertion (a box is never both source and
        # destination of one transfer).
        act = _set_flag(act, idx, ~rm & act.gather(-1, idx[..., None])[..., 0])
        act = _set_flag(act, slot, add | act.gather(
            -1, slot[..., None])[..., 0])
        return GibbsState(
            x_a=x[0], act_a=act[0], x_b=x[1], act_b=act[1], box_a=box[0],
            box_b=box[1], generator=state.generator,
            disp_trials=disp_tri, disp_acc=disp_acc,
            vol_trials=state.vol_trials + n_chains,
            vol_acc=state.vol_acc + okv.sum(),
            xfer_trials=state.xfer_trials + n_chains,
            xfer_acc=state.xfer_acc + okx.sum())

    @torch.no_grad()
    def step(state: GibbsState) -> GibbsState:
        return move(state, draw(state))

    step.draw, step.move = draw, move
    return step


def run_gibbs(step_fn: Callable[[GibbsState], GibbsState],
              state: GibbsState, n_steps: int, collect_every: int = 0
              ) -> Tuple[GibbsState, Optional[Tuple[Tensor, Tensor]]]:
    """``n_steps`` sweeps; with ``collect_every = k > 0`` also ``(rho_a,
    rho_b)`` of every k-th sweep, (n_steps // k, ...)."""
    if collect_every and n_steps % collect_every:
        raise ValueError(f"collect_every={collect_every} must divide "
                         f"n_steps={n_steps}")
    ra, rb = [], []
    for k in range(1, n_steps + 1):
        state = step_fn(state)
        if collect_every and k % collect_every == 0:
            ra.append(state.rho_a)
            rb.append(state.rho_b)
    if not collect_every:
        return state, None
    return state, (torch.stack(ra), torch.stack(rb))
