"""Replica-exchange (parallel-tempering) VAE-proposal Monte Carlo on one
device (port of ``vaemolsim_tpu/parallel/replica.py``).

``R`` temperature replicas of ``C`` chains each run tempered VAE-proposal
Metropolis steps, the replica axis a leading tensor axis: configurations
are ``(R, C, D)`` and the proposal runs on the whole batch (the kernel
wrappers take the leading axes).  Every ``exchange_every`` steps adjacent
replicas attempt per-chain swaps,

    A = min(1, exp((beta_i - beta_j) (l_j - l_i))),   l = log pi(x),

alternating even (0,1)(2,3)... and odd (1,2)(3,4)... pairings.  Each pair
draws one uniform, indexed by its lower replica, so both partners see
the same number.

A state sharded by ``parallel.shard_chain_state`` over a ``("replica",
"chain")`` mesh holds this rank's block of replicas and chains.  Its
proposals draw from the rank's own stream; the exchange all-gathers the
energies and configurations of every replica of its chains over the
``"replica"`` dimension (a swap needs the neighbour replica), draws the
swap uniforms in the global shape from the replicated generator and
keeps its own rows; the counters are all-reduced, so every rank reads
the global statistics.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Optional

import numpy as np
import torch

from vaemolsim_tpu_torch.config import default_device
from vaemolsim_tpu_torch.mcmc.engine import (counts, mh_propose,
                                             proposal_generator)
from vaemolsim_tpu_torch.parallel.distributed import all_gather_cat

Tensor = torch.Tensor

__all__ = ["REMCState", "make_remc_step", "run_remc", "temperature_ladder",
           "remc_exchange_core"]


@dataclass
class REMCState:
    """R replicas x C chains.  ``energies`` holds the UNTEMPERED log
    target; counters are exact int64 (swap counts count each attempted
    pair once)."""

    configs: Tensor      # (R, C, D)
    energies: Tensor     # (R, C)
    betas: Tensor        # (R,)
    generator: torch.Generator
    step_index: int      # drives the even/odd pairing
    num_trials: Tensor
    num_acc: Tensor
    num_swap_trials: Tensor
    num_swap_acc: Tensor
    shard: Optional[Any] = None  # parallel.sharding.ChainShard

    @property
    def acceptance_rate(self) -> Tensor:
        return self.num_acc.double() / max(int(self.num_trials), 1)

    @property
    def swap_acceptance_rate(self) -> Tensor:
        return self.num_swap_acc.double() / max(int(self.num_swap_trials), 1)

    @classmethod
    def create(cls, configs: Tensor, log_target_fn, betas,
               generator: torch.Generator) -> "REMCState":
        zero = torch.zeros((), dtype=torch.int64, device=configs.device)
        with torch.no_grad():
            energies = log_target_fn(configs)
        return cls(configs, energies,
                   torch.as_tensor(betas, dtype=configs.dtype,
                                   device=configs.device),
                   generator, 0, zero, zero.clone(), zero.clone(),
                   zero.clone())


def temperature_ladder(n_replicas: int, beta_min: float = 0.2,
                       beta_max: float = 1.0, device=None) -> Tensor:
    """Geometric inverse-temperature ladder, replica 0 coldest, on
    ``device`` (by default the CUDA card)."""
    return torch.as_tensor(
        np.geomspace(beta_max, beta_min, n_replicas).astype(np.float32),
        device=default_device(device))


def _swap_partner_perm(R: int, odd_phase: bool, device=None) -> Tensor:
    """Partner of each replica in the even pairing (0,1)(2,3)... or the
    odd one (1,2)(3,4)...; an unpaired replica is its own partner."""
    first = 1 if odd_phase else 0
    partner = list(range(R))
    for lo in range(first, R - 1, 2):
        partner[lo], partner[lo + 1] = lo + 1, lo
    return torch.tensor(partner, dtype=torch.int64, device=device)


@torch.no_grad()
def remc_exchange_core(state: REMCState, u: Tensor,
                       odd_phase: bool) -> REMCState:
    """The exchange phase on given uniforms ``u`` (R, C) in (0, 1]."""
    R, C = state.energies.shape
    if R < 2:
        return state
    dev = state.configs.device
    partner = _swap_partner_perm(R, odd_phase, dev)
    idx = torch.arange(R, device=dev)
    l, x, beta = state.energies, state.configs, state.betas
    l_p, x_p, beta_p = l[partner], x[partner], beta[partner]
    delta = (beta[:, None] - beta_p[:, None]) * (l_p - l)
    u_pair = u[torch.minimum(idx, partner)]
    has_partner = partner != idx
    accept = (torch.log(u_pair) <= delta) & has_partner[:, None]
    sel = accept.reshape(accept.shape + (1,) * (x.dim() - 2))
    n_pairs = int(has_partner.sum()) // 2
    return replace(
        state, configs=torch.where(sel, x_p, x),
        energies=torch.where(accept, l_p, l),
        num_swap_trials=state.num_swap_trials + n_pairs * C,
        num_swap_acc=state.num_swap_acc
        + accept.sum(dtype=torch.int64) // 2)


def _gather_replicas(t: Tensor, shard) -> Tensor:
    """Every replica's rows of this rank's chains: ``t``'s replica blocks
    all-gathered over the ``"replica"`` mesh dimension, in rank order."""
    return all_gather_cat(t, shard.group(shard.dims[0]))


def _sharded_exchange(state: REMCState, u: Tensor,
                      odd_phase: bool) -> REMCState:
    """The exchange of a sharded state: ``u`` holds every replica's
    uniforms for this rank's chains."""
    shard = state.shard
    full = state
    if shard.dims[0] is not None:
        full = replace(state, configs=_gather_replicas(state.configs, shard),
                       energies=_gather_replicas(state.energies, shard),
                       betas=_gather_replicas(state.betas, shard))
    done = remc_exchange_core(replace(full, shard=None), u, odd_phase)
    r0, r = shard.starts[0], state.energies.shape[0]
    # Every rank of a chain block counted its block's swaps over all
    # replicas: sum the increments over the chain dimension only.
    d_trials = done.num_swap_trials - state.num_swap_trials
    d_acc = done.num_swap_acc - state.num_swap_acc
    if shard.dims[1] is not None:
        both = shard.all_sum(torch.stack([d_trials, d_acc]), [shard.dims[1]])
        d_trials, d_acc = both[0], both[1]
    return replace(state, configs=done.configs[r0:r0 + r],
                   energies=done.energies[r0:r0 + r],
                   num_swap_trials=state.num_swap_trials + d_trials,
                   num_swap_acc=state.num_swap_acc + d_acc)


def make_remc_step(encoder_fn: Callable[[Tensor], Any],
                   prior_fn: Callable[[Tensor], Any],
                   decoder_fn: Callable[[Tensor], Any],
                   log_target_fn: Callable[[Tensor], Tensor],
                   exchange_every: int = 1, mesh=None
                   ) -> Callable[[REMCState], REMCState]:
    """The tempered VAE-MH step over all replicas at once (``log_acc =
    beta (l2 - l1) + reverse - forward``), then every ``exchange_every``
    steps the exchange.  The step follows the state's placement (see
    the module docstring); ``mesh``, if given, must be the mesh the
    state was sharded over."""

    @torch.no_grad()
    def step(state: REMCState) -> REMCState:
        shard = state.shard
        if mesh is not None and (shard is None or shard.mesh is not mesh):
            raise ValueError("make_remc_step(mesh=...) takes a state "
                             "sharded over that mesh: "
                             "parallel.shard_chain_state(state, mesh)")
        x1, l1 = state.configs, state.energies
        x2, l2, accept = mh_propose(encoder_fn, prior_fn, decoder_fn,
                                    log_target_fn, x1, l1,
                                    proposal_generator(state),
                                    beta=state.betas[:, None])
        sel = accept.reshape(accept.shape + (1,) * (x1.dim() - 2))
        trials, acc = counts(shard, accept)
        state = replace(
            state, configs=torch.where(sel, x2, x1),
            energies=torch.where(accept, l2, l1),
            num_trials=state.num_trials + trials,
            num_acc=state.num_acc + acc)
        if state.step_index % exchange_every == exchange_every - 1:
            R, C = ((state.energies.shape) if shard is None
                    else shard.totals)
            u = torch.rand((R, C), generator=state.generator,
                           dtype=state.energies.dtype,
                           device=state.energies.device).clamp_min(1e-38)
            odd = (state.step_index // exchange_every) % 2 == 1
            if shard is None:
                state = remc_exchange_core(state, u, odd)
            else:
                c0 = shard.starts[1]
                state = _sharded_exchange(
                    state, u[:, c0:c0 + state.energies.shape[1]], odd)
        return replace(state, step_index=state.step_index + 1)

    return step


def run_remc(step_fn: Callable[[REMCState], REMCState], state: REMCState,
             n_steps: int) -> REMCState:
    for _ in range(n_steps):
        state = step_fn(state)
    return state
