"""Composable MC move sets: local random-walk, MALA and HMC moves, their
step-size tuner, and mixtures and cycles of moves (port of
``vaemolsim_tpu/mcmc/moves.py``).

Every move has the engine's contract ``step(MCMCState) -> MCMCState``,
so moves mix with the VAE step and run under ``run_mcmc``.  One trial
is :func:`scaled_trial_core`, which takes its noise as tensors (the
normals ``xi`` and the accept draw ``log_u``); :func:`_scaled_trial`
draws them from the chains' generator.  The production moves, the tuner,
simulated tempering and AIS all run that one core.

On a state sharded by ``parallel.shard_chain_state`` the moves and the
tuner draw the noise of all the global chains from the replicated
generator and take this rank's slice, and count (and tune on) the
global acceptances: a sharded run equals the one-device run.

``run_mcmc`` runs under ``torch.no_grad()``.  MALA and HMC need the
gradient of the log target inside the step: the core takes it under
``torch.enable_grad()`` on a detached leaf (the ones-seeded gradient of
the per-chain log densities, which is each chain's own gradient since
chains are independent) and returns detached tensors, so no graph grows
across steps.  Configurations may have any event rank, ``(chains, dofs)``
or ``(chains, atoms, 3)``: the event axes are those beyond the energies'.
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Callable, Optional, Sequence, Tuple

import torch

from vaemolsim_tpu_torch.mcmc.engine import MCMCState, counts, log_uniform

Tensor = torch.Tensor

__all__ = ["make_random_walk_step", "make_mala_step", "make_hmc_step",
           "mix_moves", "cycle_moves", "tune_scale", "scaled_trial_core"]

_KINDS = ("random_walk", "mala", "hmc")


def _log_prob_and_grad(log_target_fn, x: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-chain log densities and their gradients with respect to x,
    detached, whatever the caller's grad mode."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        e = log_target_fn(xg)
        (g,) = torch.autograd.grad(e, xg, torch.ones_like(e))
    return e.detach(), g.detach()


@torch.no_grad()
def scaled_trial_core(kind: str, log_target_fn: Callable[[Tensor], Tensor],
                      x1: Tensor, e1: Tensor, scale, xi: Tensor,
                      log_u: Tensor, n_leapfrog: int = 10
                      ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """One MH trial of a local-move family on given noise: ``xi`` the
    standard normals (x1's shape; HMC's momenta), ``log_u`` the accept
    draws (e1's shape).  ``scale`` is a Python float or a 0-d tensor (the
    tuner's).  Returns ``(x_new, e_new, accept, log_acc)`` with the
    accept/reject select applied."""
    event_axes = tuple(range(e1.dim(), x1.dim()))
    if kind not in _KINDS:
        raise ValueError(f"unknown move kind {kind!r}")
    if kind == "hmc" and n_leapfrog < 1:
        raise ValueError("n_leapfrog must be >= 1 (0 leapfrog steps is "
                         "the identity kernel: acceptance 1.0, no "
                         "movement, and a diverging tuner)")

    def sum_event(t):
        return t.sum(event_axes) if event_axes else t

    if kind == "random_walk":
        x2 = x1 + scale * xi
        e2 = log_target_fn(x2)
        log_acc = e2 - e1
    elif kind == "mala":
        _, g1 = _log_prob_and_grad(log_target_fn, x1)
        x2 = x1 + scale * g1 + (2.0 * scale) ** 0.5 * xi
        e2, g2 = _log_prob_and_grad(log_target_fn, x2)

        def log_q(x_to, x_from, g_from):
            mean = x_from + scale * g_from
            return -sum_event((x_to - mean) ** 2) / (4.0 * scale)

        log_acc = (e2 - e1) + log_q(x1, x2, g2) - log_q(x2, x1, g1)
    else:
        # Leapfrog with identity mass: a half kick, n_leapfrog (drift,
        # kick) pairs, then the surplus half kick backed off; n_leapfrog
        # + 1 gradients.  H = -log pi(x) + |p|^2 / 2; accept on -dH.
        p1 = xi
        _, g = _log_prob_and_grad(log_target_fn, x1)
        x, p, e2 = x1, p1 + 0.5 * scale * g, e1
        for _ in range(n_leapfrog):
            x = x + scale * p
            e2, g = _log_prob_and_grad(log_target_fn, x)
            p = p + scale * g
        x2 = x
        p = p - 0.5 * scale * g

        def kinetic(p):
            return 0.5 * sum_event(p.to(e1.dtype) ** 2)

        log_acc = (e2 - e1) + kinetic(p1) - kinetic(p)
    accept = log_acc >= log_u
    sel = accept.reshape(accept.shape + (1,) * len(event_axes))
    return (torch.where(sel, x2, x1), torch.where(accept, e2, e1), accept,
            log_acc)


def _scaled_trial(kind: str, log_target_fn, x1: Tensor, e1: Tensor, scale,
                  generator: torch.Generator, n_leapfrog: int = 10,
                  shard=None):
    """:func:`scaled_trial_core` on noise drawn from ``generator``:
    ``(x_new, e_new, accept)``.  With a ``shard`` (a ``ChainShard``)
    the noise of all the global chains is drawn and this rank's slice
    taken."""
    n = x1.shape[0] if shard is None else shard.totals[0]
    xi = torch.randn((n,) + tuple(x1.shape[1:]), generator=generator,
                     dtype=x1.dtype, device=x1.device)
    log_u = log_uniform(generator, (n,) + tuple(e1.shape[1:]), e1.dtype,
                        e1.device)
    if shard is not None:
        xi, log_u = shard.local(xi), shard.local(log_u)
    return scaled_trial_core(kind, log_target_fn, x1, e1, scale, xi, log_u,
                             n_leapfrog)[:3]


def _make_local_step(kind: str, log_target_fn, scale: float,
                     n_leapfrog: int = 10
                     ) -> Callable[[MCMCState], MCMCState]:
    def step(state: MCMCState) -> MCMCState:
        x, e, accept = _scaled_trial(kind, log_target_fn, state.configs,
                                     state.energies, scale, state.generator,
                                     n_leapfrog, state.shard)
        trials, acc = counts(state.shard, accept)
        return replace(state, configs=x, energies=e,
                       num_trials=state.num_trials + trials,
                       num_acc=state.num_acc + acc)

    return step


def make_random_walk_step(log_target_fn: Callable[[Tensor], Tensor],
                          scale: float = 0.1
                          ) -> Callable[[MCMCState], MCMCState]:
    """Symmetric Gaussian random-walk Metropolis move."""
    return _make_local_step("random_walk", log_target_fn, float(scale))


def make_mala_step(log_target_fn: Callable[[Tensor], Tensor],
                   step_size: float = 0.05
                   ) -> Callable[[MCMCState], MCMCState]:
    """Metropolis-adjusted Langevin move: ``x' = x + eps grad log pi(x) +
    sqrt(2 eps) xi`` with the exact asymmetric-proposal MH correction;
    two gradient evaluations a step."""
    return _make_local_step("mala", log_target_fn, float(step_size))


def make_hmc_step(log_target_fn: Callable[[Tensor], Tensor],
                  step_size: float = 0.1, n_leapfrog: int = 10
                  ) -> Callable[[MCMCState], MCMCState]:
    """Hamiltonian Monte Carlo move: ``n_leapfrog`` leapfrog steps of
    ``step_size`` with identity mass, Metropolis-corrected on the
    Hamiltonian error; ``n_leapfrog + 1`` gradient evaluations a step."""
    if n_leapfrog < 1:
        raise ValueError("n_leapfrog must be >= 1")
    return _make_local_step("hmc", log_target_fn, float(step_size),
                            int(n_leapfrog))


def tune_scale(log_target_fn: Callable[[Tensor], Tensor],
               state: MCMCState, *, kind: str = "random_walk",
               target_accept: Optional[float] = None,
               init_scale: float = 0.1, rounds: int = 30,
               steps_per_round: int = 20,
               n_leapfrog: int = 10) -> Tuple[float, MCMCState]:
    """Adapt a local move's step size to a target acceptance rate:
    Robbins-Monro on the log scale, ``log s += 2 (rate - target) /
    sqrt(1 + r)`` after round r of ``steps_per_round`` trials.  Defaults
    target the optima 0.234 (random walk), 0.574 (MALA) and 0.651 (HMC).
    The scale stays a float32 tensor on the chains' device throughout:
    one host read at the end.  Returns ``(scale, warmed_state)``; the
    warm-up trials are not counted in the state's counters.  On a
    sharded state the rate is the global chains' (one all-reduce a
    trial), so every rank tunes to the same scale."""
    if kind not in _KINDS:
        raise ValueError(f"unknown move kind {kind!r}")
    if target_accept is None:
        target_accept = {"mala": 0.574, "hmc": 0.651}.get(kind, 0.234)
    x, e = state.configs, state.energies
    log_s = torch.log(torch.tensor(init_scale, dtype=torch.float32,
                                   device=x.device))
    for r in range(rounds):
        scale = torch.exp(log_s).to(x.dtype)
        acc_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for _ in range(steps_per_round):
            x, e, accept = _scaled_trial(kind, log_target_fn, x, e, scale,
                                         state.generator, n_leapfrog,
                                         state.shard)
            trials, acc = counts(state.shard, accept)
            acc_sum = acc_sum + acc.float() / trials
        log_s = log_s + 2.0 * (acc_sum / steps_per_round
                               - target_accept) / math.sqrt(1.0 + r)
    return float(torch.exp(log_s)), replace(state, configs=x, energies=e)


def mix_moves(steps: Sequence[Callable[[MCMCState], MCMCState]],
              probs: Sequence[float]) -> Callable[[MCMCState], MCMCState]:
    """Random mixture of move kernels: each step, one move is chosen with
    the given probabilities (one draw from the chains' generator and
    one host read a step, to pick the branch)."""
    if len(steps) != len(probs):
        raise ValueError("one probability per move")
    p = torch.tensor(probs, dtype=torch.float32)
    p = p / p.sum()

    def step(state: MCMCState) -> MCMCState:
        dev_p = p.to(state.configs.device)
        idx = int(torch.multinomial(dev_p, 1, generator=state.generator))
        return steps[idx](state)

    return step


def cycle_moves(steps: Sequence[Callable[[MCMCState], MCMCState]]
                ) -> Callable[[MCMCState], MCMCState]:
    """Deterministic cycle of move kernels applied in sequence each step
    (for example one VAE jump followed by local relaxations)."""

    def step(state: MCMCState) -> MCMCState:
        for s in steps:
            state = s(state)
        return state

    return step
