"""Isothermal-isobaric (NPT) Monte Carlo (port of
``vaemolsim_tpu/mcmc/npt.py``): all-atom Gaussian displacement trials at
a fixed box, then one volume trial a sweep, a Gaussian step in ln V (or
in each ln L_a with ``anisotropic``) with coordinates and box dilated,
accepted with ``exp(-beta dU - beta P dV + (N + 1) ln(V'/V))``.

Every chain carries its own box.  The potential is a box-parametric
factory ``potential_for_box(box (..., 1, 1, dim)) -> energy_fn`` (the
dense periodic factories of ``potentials`` take a tensor box; the
cell-list ones cannot be dilated).  Energies are potential energies in
reduced units, not the NVT engine's log target.  The draws come from the
state's ``torch.Generator``; ``step.move(state, noise)`` is the sweep on
given draws (what tests feed the JAX package's own draws).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from vaemolsim_tpu_torch.mcmc.engine import log_uniform

Tensor = torch.Tensor

__all__ = ["NPTState", "npt_init", "make_npt_step", "run_npt"]


def _count(device) -> Tensor:
    return torch.zeros((), dtype=torch.int64, device=device)


@dataclass
class NPTState:
    """Coordinates (..., n_atoms, dim), per-chain boxes (..., dim), the
    potential energy U(x; box) (...,), the chains' generator, and exact
    int64 displacement and volume trial / acceptance counts."""

    x: Tensor
    box: Tensor
    energy: Tensor
    generator: torch.Generator
    disp_trials: Tensor
    disp_acc: Tensor
    vol_trials: Tensor
    vol_acc: Tensor

    @property
    def volume(self) -> Tensor:
        return torch.prod(self.box, -1)

    @property
    def disp_acceptance_rate(self) -> Tensor:
        return self.disp_acc.double() / self.disp_trials.double()

    @property
    def vol_acceptance_rate(self) -> Tensor:
        return self.vol_acc.double() / self.vol_trials.double()


def _energy_at(potential_for_box, x: Tensor, box: Tensor) -> Tensor:
    return potential_for_box(box[..., None, None, :])(x)


def npt_init(potential_for_box, x: Tensor, box,
             generator: torch.Generator) -> NPTState:
    """The initial state; ``box`` broadcasts to one box per chain."""
    box = torch.as_tensor(box, dtype=x.dtype, device=x.device)
    box = box.expand(x.shape[:-2] + (x.shape[-1],)).clone()
    with torch.no_grad():
        energy = _energy_at(potential_for_box, x, box)
    return NPTState(x, box, energy, generator, _count(x.device),
                    _count(x.device), _count(x.device), _count(x.device))


def make_npt_step(potential_for_box: Callable[[Tensor], Callable], *,
                  pressure: float, beta: float = 1.0,
                  dx_scale: float = 0.1, dlnv_scale: float = 0.02,
                  n_disp: int = 1, min_box: Optional[float] = None,
                  anisotropic: bool = False
                  ) -> Callable[[NPTState], NPTState]:
    """One NPT sweep: ``n_disp`` all-atom displacement trials (width
    ``dx_scale``), then one ln-V trial (width ``dlnv_scale``).
    ``min_box`` rejects a box with an edge below it (set 2 * cutoff for a
    truncated minimum-image potential).  The returned step has
    ``step.draw(state)`` (the sweep's draws from the state's generator)
    and ``step.move(state, noise)`` (the sweep on given draws)."""
    pressure = float(pressure)
    beta = float(beta)
    if n_disp < 1:
        raise ValueError(f"n_disp must be >= 1; got {n_disp}")

    def draw(state: NPTState) -> dict:
        g, x, e = state.generator, state.x, state.energy
        kw = dict(generator=g, dtype=x.dtype, device=x.device)
        disp = [(torch.randn(x.shape, **kw),
                 log_uniform(g, e.shape, e.dtype, e.device))
                for _ in range(n_disp)]
        shape = state.box.shape if anisotropic else e.shape
        return dict(disp=disp, vol=torch.randn(shape, **kw),
                    vol_logu=log_uniform(g, e.shape, e.dtype, e.device))

    def move(state: NPTState, noise: dict) -> NPTState:
        x, e = state.x, state.energy
        n, dim = x.shape[-2], x.shape[-1]
        disp_acc = state.disp_acc
        for normal, logu in noise["disp"]:
            x2 = x + dx_scale * normal
            e2 = _energy_at(potential_for_box, x2, state.box)
            accept = (-beta * (e2 - e)) >= logu
            x = torch.where(accept[..., None, None], x2, x)
            e = torch.where(accept, e2, e)
            disp_acc = disp_acc + accept.sum()
        v1 = torch.prod(state.box, -1)
        ln_v1 = torch.log(v1)
        if anisotropic:
            dln = dlnv_scale * noise["vol"]
            box2 = state.box * torch.exp(dln)
            x2 = x * torch.exp(dln)[..., None, :]
            ln_v2 = ln_v1 + dln.sum(-1)
        else:
            ln_v2 = ln_v1 + dlnv_scale * noise["vol"]
            s = torch.exp((ln_v2 - ln_v1) / dim)
            box2 = s[..., None] * state.box
            x2 = s[..., None, None] * x
        e2 = _energy_at(potential_for_box, x2, box2)
        log_acc = (-beta * (e2 - e)
                   - beta * pressure * (torch.exp(ln_v2) - v1)
                   + (n + 1) * (ln_v2 - ln_v1))
        if min_box is not None:
            log_acc = torch.where(box2.amin(-1) < float(min_box), -math.inf,
                                  log_acc)
        accept = log_acc >= noise["vol_logu"]
        n_chains = e.numel()
        return NPTState(
            x=torch.where(accept[..., None, None], x2, x),
            box=torch.where(accept[..., None], box2, state.box),
            energy=torch.where(accept, e2, e), generator=state.generator,
            disp_trials=state.disp_trials + n_disp * n_chains,
            disp_acc=disp_acc, vol_trials=state.vol_trials + n_chains,
            vol_acc=state.vol_acc + accept.sum())

    @torch.no_grad()
    def step(state: NPTState) -> NPTState:
        return move(state, draw(state))

    step.draw, step.move = draw, move
    return step


def run_npt(step_fn: Callable[[NPTState], NPTState], state: NPTState,
            n_steps: int, collect_every: int = 0
            ) -> Tuple[NPTState, Optional[Tuple[Tensor, Tensor]]]:
    """``n_steps`` sweeps; with ``collect_every = k > 0`` also ``(xs,
    boxes)`` of every k-th sweep, (n_steps // k, ...)."""
    if collect_every and n_steps % collect_every:
        raise ValueError(f"collect_every={collect_every} must divide "
                         f"n_steps={n_steps}")
    xs, boxes = [], []
    for k in range(1, n_steps + 1):
        state = step_fn(state)
        if collect_every and k % collect_every == 0:
            xs.append(state.x)
            boxes.append(state.box)
    if not collect_every:
        return state, None
    return state, (torch.stack(xs), torch.stack(boxes))
