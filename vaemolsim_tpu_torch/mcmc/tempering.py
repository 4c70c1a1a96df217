"""Simulated tempering: each chain carries one configuration and a rung
index into an inverse-temperature ladder, with on-device Wang-Landau
adaptation of the rungs' weights (port of
``vaemolsim_tpu/mcmc/tempering.py``).

The joint target is ``pi(x, k) ~ exp(beta_k l(x) + w_k)``, ``l`` the log
target density; with ``w_k = -ln Z_k`` the rungs are visited uniformly,
so the adapted weights estimate the free energies across the ladder.  A
step is a tempered local move (the moves' one trial core), a +-1 rung
hop rejected outside the ladder, and the Wang-Landau update
``w -= f_t counts / n``, ``f_t = wl_f0 / (1 + t / wl_tau)``, recentred to
zero mean.  :func:`st_step_core` is the step on given noise;
:func:`make_st_step` draws it from the state's generator.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional, Tuple

import torch

from vaemolsim_tpu_torch.mcmc.engine import log_uniform
from vaemolsim_tpu_torch.mcmc.moves import scaled_trial_core

Tensor = torch.Tensor

__all__ = ["STState", "make_st_step", "run_st", "st_step_core"]


@dataclass
class STState:
    """Per-chain expanded-ensemble state and the shared adaptive weights.
    ``energies`` holds the UNTEMPERED log target ``l(x)``; counters are
    exact int64."""

    x: Tensor             # (chains, *event)
    energies: Tensor      # (chains,)
    temp_idx: Tensor      # (chains,) int64
    log_weights: Tensor   # (R,)
    betas: Tensor         # (R,)
    generator: torch.Generator
    step_index: int       # drives the Wang-Landau decay
    occupancy: Tensor     # (R,) float32 visit counts
    num_trials: Tensor
    num_acc: Tensor
    num_temp_trials: Tensor
    num_temp_acc: Tensor

    @property
    def acceptance_rate(self) -> Tensor:
        return self.num_acc.double() / max(int(self.num_trials), 1)

    @property
    def temp_acceptance_rate(self) -> Tensor:
        return self.num_temp_acc.double() / max(int(self.num_temp_trials), 1)

    @property
    def free_energies(self) -> Tensor:
        """``F_k - F_0 = ln(Z_0 / Z_k)`` as the adapted weights estimate
        it."""
        return self.log_weights - self.log_weights[0]

    @classmethod
    def create(cls, x: Tensor, log_target_fn, betas, generator:
               torch.Generator, log_weights=None, temp_idx=None
               ) -> "STState":
        betas = torch.as_tensor(betas, dtype=x.dtype, device=x.device)
        R, n = betas.shape[0], x.shape[0]
        temp_idx = (torch.zeros(n, dtype=torch.int64, device=x.device)
                    if temp_idx is None else
                    torch.as_tensor(temp_idx, device=x.device).long())
        w = (torch.zeros(R, dtype=x.dtype, device=x.device)
             if log_weights is None else
             torch.as_tensor(log_weights, dtype=x.dtype, device=x.device))
        zero = torch.zeros((), dtype=torch.int64, device=x.device)
        with torch.no_grad():
            energies = log_target_fn(x)
        return cls(x, energies, temp_idx, w, betas, generator, 0,
                   torch.zeros(R, dtype=torch.float32, device=x.device),
                   zero, zero.clone(), zero.clone(), zero.clone())


@torch.no_grad()
def st_step_core(state: STState, log_target_fn, xi: Tensor,
                 log_u_move: Tensor, u_dir: Tensor, log_u_temp: Tensor, *,
                 kind: str = "random_walk", scale: float = 0.5,
                 n_leapfrog: int = 10, adapt: bool = True,
                 wl_f0: float = 0.5, wl_tau: float = 200.0) -> STState:
    """One tempering step on given noise: ``xi`` and ``log_u_move`` the
    configuration move's normals and accept draws, ``u_dir`` the uniforms
    that pick each hop's direction (below 0.5: down), ``log_u_temp`` the
    hops' accept draws."""
    beta_c = state.betas[state.temp_idx]

    def tempered(xs):
        return beta_c * log_target_fn(xs)

    x_new, e2_t, accept, _ = scaled_trial_core(
        kind, tempered, state.x, beta_c * state.energies, scale, xi,
        log_u_move, n_leapfrog)
    l_new = torch.where(accept, e2_t / beta_c, state.energies)

    R = state.betas.shape[0]
    j = state.temp_idx + torch.where(u_dir < 0.5, -1, 1)
    in_range = (j >= 0) & (j < R)
    j_c = j.clamp(0, R - 1)
    log_acc = ((state.betas[j_c] - beta_c) * l_new
               + state.log_weights[j_c] - state.log_weights[state.temp_idx])
    hop = in_range & (log_acc >= log_u_temp)
    temp_new = torch.where(hop, j_c, state.temp_idx)

    n = temp_new.shape[0]
    counts = torch.bincount(temp_new, minlength=R).to(
        state.log_weights.dtype) / n
    w = state.log_weights
    if adapt:
        f = wl_f0 / (1.0 + state.step_index / wl_tau)
        w = w - f * counts
        w = w - w.mean()
    return replace(
        state, x=x_new, energies=l_new, temp_idx=temp_new, log_weights=w,
        step_index=state.step_index + 1,
        occupancy=state.occupancy + counts.float() * n,
        num_trials=state.num_trials + accept.numel(),
        num_acc=state.num_acc + accept.sum(dtype=torch.int64),
        num_temp_trials=state.num_temp_trials + accept.numel(),
        num_temp_acc=state.num_temp_acc + hop.sum(dtype=torch.int64))


def make_st_step(log_target_fn: Callable[[Tensor], Tensor], *,
                 kind: str = "random_walk", scale: float = 0.5,
                 n_leapfrog: int = 10, adapt: bool = True,
                 wl_f0: float = 0.5, wl_tau: float = 200.0
                 ) -> Callable[[STState], STState]:
    """The (configuration move + rung hop [+ weight update]) step;
    ``adapt=False`` freezes the weights."""

    def step(state: STState) -> STState:
        g, x, e = state.generator, state.x, state.energies
        xi = torch.randn(x.shape, generator=g, dtype=x.dtype,
                         device=x.device)
        log_u_move = log_uniform(g, e.shape, e.dtype, e.device)
        u_dir = torch.rand(e.shape, generator=g, device=e.device)
        log_u_temp = log_uniform(g, e.shape, e.dtype, e.device)
        return st_step_core(state, log_target_fn, xi, log_u_move, u_dir,
                            log_u_temp, kind=kind, scale=scale,
                            n_leapfrog=n_leapfrog, adapt=adapt,
                            wl_f0=wl_f0, wl_tau=wl_tau)

    return step


def run_st(step_fn: Callable[[STState], STState], state: STState,
           n_steps: int, *, collect_every: int = 0
           ) -> Tuple[STState, Optional[Tuple[Tensor, Tensor]]]:
    """``n_steps`` tempering steps.  With ``collect_every = k`` also
    ``(xs, temp_idxs)`` stacked after every k-th step; filter by
    ``temp_idxs == 0`` for target-ensemble samples."""
    if collect_every and n_steps % collect_every != 0:
        raise ValueError("n_steps must be a multiple of collect_every")
    xs, idxs = [], []
    for i in range(n_steps):
        state = step_fn(state)
        if collect_every and (i + 1) % collect_every == 0:
            xs.append(state.x)
            idxs.append(state.temp_idx)
    if not collect_every:
        return state, None
    return state, (torch.stack(xs), torch.stack(idxs))
