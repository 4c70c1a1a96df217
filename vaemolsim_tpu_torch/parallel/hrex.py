"""Hamiltonian replica exchange (port of
``vaemolsim_tpu/parallel/hrex.py``).

R replicas, each holding C chains, run local MC (the random-walk, MALA
or HMC trial of ``mcmc.moves``) on their own reduced log density
``log pi(x; lam_r)``; every ``exchange_every`` steps adjacent replicas
attempt the pair-symmetric swap

    A = min(1, exp([l(x_i; lam_j) + l(x_j; lam_i)]
                   - [l(x_i; lam_i) + l(x_j; lam_j)]))

alternating even and odd pairings.  The cross terms cost one extra
batched evaluation an exchange (each replica's configurations at its
partner's lambda; the partner's term arrives by the same permutation as
the swap).  Each pair draws one uniform, indexed by its lower replica.
``step.draw(state)`` gives a step's draws from the state's generator and
``step.move(state, noise)`` runs the step on given draws.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional, Tuple

import torch

from vaemolsim_tpu_torch.mcmc.engine import log_uniform
from vaemolsim_tpu_torch.mcmc.moves import scaled_trial_core
from vaemolsim_tpu_torch.parallel.replica import _swap_partner_perm

Tensor = torch.Tensor

__all__ = ["HREXState", "make_hrex_step", "run_hrex"]


@dataclass
class HREXState:
    """R lambda-replicas x C chains: configurations (R, C, *event), each
    chain's reduced log density at its own lambda (R, C), the lambdas
    (R,), the generator, the step count that drives the pairing, and
    exact int64 local and swap trial / acceptance counts."""

    configs: Tensor
    energies: Tensor
    lambdas: Tensor
    generator: torch.Generator
    step_index: int
    num_trials: Tensor
    num_acc: Tensor
    num_swap_trials: Tensor
    num_swap_acc: Tensor

    @property
    def acceptance_rate(self) -> Tensor:
        return self.num_acc.double() / max(int(self.num_trials), 1)

    @property
    def swap_acceptance_rate(self) -> Tensor:
        return self.num_swap_acc.double() / max(int(self.num_swap_trials), 1)

    @classmethod
    def create(cls, configs: Tensor, log_prob_fn, lambdas,
               generator: torch.Generator) -> "HREXState":
        """``log_prob_fn(x, lam)`` must broadcast ``lam`` (R, 1) against
        the (R, C) energies."""
        lambdas = torch.as_tensor(lambdas, dtype=configs.dtype,
                                  device=configs.device)
        if lambdas.dim() != 1 or lambdas.shape[0] != configs.shape[0]:
            raise ValueError(
                f"lambdas must be ({configs.shape[0]},) to match the "
                f"replica axis of configs {tuple(configs.shape)}; got "
                f"{tuple(lambdas.shape)}")
        with torch.no_grad():
            energies = log_prob_fn(configs, lambdas[:, None])
        if energies.shape != configs.shape[:2]:
            raise ValueError(
                f"log_prob_fn returned {tuple(energies.shape)}; expected "
                f"the (R, C) = {tuple(configs.shape[:2])} energy shape")
        zero = torch.zeros((), dtype=torch.int64, device=configs.device)
        return cls(configs, energies, lambdas, generator, 0, zero,
                   zero.clone(), zero.clone(), zero.clone())


def make_hrex_step(log_prob_fn: Callable[[Tensor, Tensor], Tensor], *,
                   kind: str = "random_walk", scale=0.1,
                   n_leapfrog: int = 10, exchange_every: int = 1
                   ) -> Callable[[HREXState], HREXState]:
    """The local move on every replica, then on every ``exchange_every``-th
    step the Hamiltonian exchange.  ``scale`` is a scalar or one per
    replica, (R,)."""
    exchange_every = int(exchange_every)
    if exchange_every < 1:
        raise ValueError("exchange_every must be >= 1")

    def swaps(state: HREXState) -> bool:
        return (state.step_index % exchange_every == exchange_every - 1
                and state.configs.shape[0] >= 2)

    def draw(state: HREXState) -> dict:
        g, x, e = state.generator, state.configs, state.energies
        noise = dict(xi=torch.randn(x.shape, generator=g, dtype=x.dtype,
                                    device=x.device),
                     log_u=log_uniform(g, e.shape, e.dtype, e.device))
        if swaps(state):
            noise["u"] = torch.rand(e.shape, generator=g, dtype=e.dtype,
                                    device=e.device).clamp_min(1e-38)
        return noise

    def mc_phase(state: HREXState, noise: dict) -> HREXState:
        lam_col = state.lambdas[:, None]
        s = torch.as_tensor(scale, dtype=state.configs.dtype,
                            device=state.configs.device)
        if s.dim() == 1:
            s = s.reshape((s.shape[0],) + (1,) * (state.configs.dim() - 1))
        x, e, accept, _ = scaled_trial_core(
            kind, lambda x: log_prob_fn(x, lam_col), state.configs,
            state.energies, s, noise["xi"], noise["log_u"], n_leapfrog)
        return replace(state, configs=x, energies=e,
                       num_trials=state.num_trials + accept.numel(),
                       num_acc=state.num_acc
                       + accept.sum(dtype=torch.int64))

    def exchange_phase(state: HREXState, u: Tensor) -> HREXState:
        r = state.configs.shape[0]
        dev = state.configs.device
        odd = (state.step_index // exchange_every) % 2 == 1
        partner = _swap_partner_perm(r, odd, dev)
        idx = torch.arange(r, device=dev)
        x, e, lam = state.configs, state.energies, state.lambdas
        e_cross = log_prob_fn(x, lam[partner][:, None])
        e_p, e_cross_p, x_p = e[partner], e_cross[partner], x[partner]
        delta = (e_cross + e_cross_p) - (e + e_p)
        u_pair = u[torch.minimum(idx, partner)]
        has_partner = partner != idx
        accept = (torch.log(u_pair) <= delta) & has_partner[:, None]
        sel = accept.reshape(accept.shape + (1,) * (x.dim() - 2))
        # Pairs counted on the host: no device sync a round.
        n_att = len(range(1 if odd else 0, r - 1, 2)) * e.shape[1]
        return replace(
            state, configs=torch.where(sel, x_p, x),
            energies=torch.where(accept, e_cross_p, e),
            num_swap_trials=state.num_swap_trials + n_att,
            num_swap_acc=state.num_swap_acc
            + accept.sum(dtype=torch.int64) // 2)

    def move(state: HREXState, noise: dict) -> HREXState:
        do_swap = swaps(state)
        state = mc_phase(state, noise)
        if do_swap:
            state = exchange_phase(state, noise["u"])
        return replace(state, step_index=state.step_index + 1)

    @torch.no_grad()
    def step(state: HREXState) -> HREXState:
        return move(state, draw(state))

    step.draw, step.move = draw, move
    return step


def run_hrex(step_fn: Callable[[HREXState], HREXState], state: HREXState,
             n_steps: int, *, collect_every: Optional[int] = None
             ) -> Tuple[HREXState, Optional[Tensor]]:
    """``n_steps`` steps; with ``collect_every = k`` also every k-th
    step's configurations, (n_steps // k, R, C, *event)."""
    if collect_every is not None:
        k = int(collect_every)
        if k < 1 or n_steps % k:
            raise ValueError(f"collect_every={k} must be >= 1 and divide "
                             f"n_steps={n_steps}")
    xs = []
    for i in range(1, n_steps + 1):
        state = step_fn(state)
        if collect_every is not None and i % collect_every == 0:
            xs.append(state.configs)
    return state, (torch.stack(xs) if collect_every is not None else None)
