"""VAE-proposal Metropolis Monte Carlo (port of
``vaemolsim_tpu/mcmc/engine.py``).

One MC step is propose -> decode -> log-prob -> Metropolis over every
chain at once (chains are the batch axis of every distribution call);
``run_mcmc`` is a Python loop of steps.  Sign convention, kept from the
reference: ``energy_func`` / ``log_target_fn`` returns the LOG TARGET
DENSITY, and

    log_acc = log_pi(x2) + log q(reverse) - log_pi(x1) - log q(forward).

Proposal structure:
    forward: z1 ~ q(.|x1),  z2 ~ p,  x2 ~ q(.|z2)
    reverse: log q(z2|x2) + log p(z1) + log q(x1|z1)
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Optional, Tuple

import torch

Tensor = torch.Tensor

__all__ = ["MCMCState", "apply_mh", "counts", "mh_propose",
           "proposal_generator", "make_mcmc_step",
           "run_mcmc", "run_mcmc_checkpointed", "vae_proposal_fns", "MCMC",
           "log_uniform"]


def log_uniform(generator: torch.Generator, shape, dtype=torch.float32,
                device=None) -> Tensor:
    """The MH accept draw ``log U``, ``U ~ Uniform(1e-38, 1)``: the clamp
    keeps ``log`` finite in float32, so a zero draw can never
    force-accept via ``-inf >= -inf``."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return torch.log(torch.clamp_min(u, 1e-38))


@dataclass
class MCMCState:
    """Chain state: configurations, log target densities, the generator
    the chains draw from, and exact int64 trial / acceptance counts
    (exact far past float32's 2^24, like the JAX two-word counter).
    ``shard`` is set by ``parallel.shard_chain_state``: the state then
    holds this rank's chains and global counts."""

    configs: Tensor  # (n_chains, *event)
    energies: Tensor  # (n_chains,) log target density
    generator: torch.Generator
    num_trials: Tensor  # () int64
    num_acc: Tensor  # () int64
    shard: Optional[Any] = None  # parallel.sharding.ChainShard

    @property
    def acceptance_rate(self) -> Tensor:
        return self.num_acc.double() / self.num_trials.double()

    @classmethod
    def create(cls, configs: Tensor, energies: Tensor,
               generator: torch.Generator) -> "MCMCState":
        zero = torch.zeros((), dtype=torch.int64, device=configs.device)
        return cls(configs, energies, generator, zero, zero.clone())


def counts(shard, accept: Tensor, dims=None):
    """Trials and acceptances of one accept mask, int64 on its device:
    summed over the ranks of a sharded state (one all-reduce), so every
    rank counts the global chains."""
    if shard is None:
        return accept.numel(), accept.sum(dtype=torch.int64)
    c = shard.all_sum(torch.stack([
        torch.full((), accept.numel(), dtype=torch.int64,
                   device=accept.device), accept.sum(dtype=torch.int64)]),
        dims)
    return c[0], c[1]


def apply_mh(state: MCMCState, x2: Tensor, e2: Tensor,
             accept: Tensor) -> MCMCState:
    """Shared accept/select/bookkeeping tail of every MH kernel; the
    configurations may have any number of event axes after accept's."""
    sel = accept.reshape(accept.shape
                         + (1,) * (state.configs.dim() - accept.dim()))
    trials, acc = counts(state.shard, accept)
    return replace(
        state, configs=torch.where(sel, x2, state.configs),
        energies=torch.where(accept, e2, state.energies),
        num_trials=state.num_trials + trials,
        num_acc=state.num_acc + acc)


def proposal_generator(state) -> torch.Generator:
    """The generator a generic proposal draws from: the state's own, or
    on a sharded state the rank's own stream (``ChainShard.generator``)."""
    return state.generator if state.shard is None else state.shard.generator


def mh_propose(encoder_fn: Callable[[Tensor], Any],
               prior_fn: Callable[[Tensor], Any],
               decoder_fn: Callable[[Tensor], Any],
               log_target_fn: Callable[[Tensor], Tensor], x1: Tensor,
               l1: Tensor, generator: torch.Generator, beta=1.0
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """One VAE-proposed Metropolis-Hastings trial: ``(x2, l2, accept)``,
    ``l2`` the untempered log target at the proposal and ``accept`` the
    per-chain decision of ``beta*(l2 - l1) + reverse - forward``."""
    z1, log_z1_given_x1 = encoder_fn(x1).sample_and_log_prob(generator)
    prior1 = prior_fn(z1)
    # A static prior has no chain axis of its own: draw one latent PER
    # CHAIN (a shared draw would correlate every chain's move).
    if tuple(prior1.batch_shape) == ():
        z2, log_z2 = prior1.sample_and_log_prob(generator, z1.shape[:-1])
    else:
        z2, log_z2 = prior1.sample_and_log_prob(generator)
    x2, log_x2_given_z2 = decoder_fn(z2).sample_and_log_prob(generator)
    forward_log_p = log_z1_given_x1 + log_z2 + log_x2_given_z2

    reverse_log_p = (encoder_fn(x2).log_prob(z2)
                     + prior_fn(z2).log_prob(z1)
                     + decoder_fn(z1).log_prob(x1))

    l2 = log_target_fn(x2)
    log_acc = beta * (l2 - l1) + reverse_log_p - forward_log_p
    return x2, l2, log_acc >= log_uniform(generator, log_acc.shape,
                                          log_acc.dtype, log_acc.device)


def make_mcmc_step(encoder_fn, prior_fn, decoder_fn, log_target_fn
                   ) -> Callable[[MCMCState], MCMCState]:
    """One MC step from distribution factories (each maps a batched
    tensor to a distribution, chains on the batch axis).  On a sharded
    state each rank proposes for its chains from its own stream, so a
    sharded run is the one-device run's statistical equal, not its
    copy (the fused step is its copy)."""

    def step(state: MCMCState) -> MCMCState:
        x2, e2, accept = mh_propose(encoder_fn, prior_fn, decoder_fn,
                                    log_target_fn, state.configs,
                                    state.energies,
                                    proposal_generator(state))
        return apply_mh(state, x2, e2, accept)

    return step


@torch.no_grad()
def run_mcmc(step_fn: Callable[[MCMCState], MCMCState], state: MCMCState,
             n_steps: int, collect_every: int = 0
             ) -> Tuple[MCMCState, Optional[Tensor]]:
    """Run ``n_steps`` steps.  With ``collect_every=k > 0`` also return
    the configurations of every k-th step, ``(n_steps//k, chains, dofs)``."""
    if collect_every and n_steps % collect_every != 0:
        raise ValueError("n_steps must be a multiple of collect_every")
    traj = []
    for i in range(n_steps):
        state = step_fn(state)
        if collect_every and (i + 1) % collect_every == 0:
            traj.append(state.configs)
    return state, (torch.stack(traj) if collect_every else None)


def run_mcmc_checkpointed(step_fn: Callable[[MCMCState], MCMCState],
                          state: MCMCState, n_steps: int,
                          checkpoint_every: int, manager) -> MCMCState:
    """Run ``n_steps`` steps in segments of ``checkpoint_every``, saving
    the whole chain state after each through ``manager`` (a
    ``train.CheckpointManager``): configurations, energies, the exact
    counters and the generator's state (``Generator.get_state()``), which
    is all a step draws from (the fused step's Philox key words too).
    Resume by restoring the latest state into a template
    (``manager.restore(state)``) and calling again with the remaining
    steps: the run then goes on bit for bit as if it had not stopped.
    Step ids continue from ``manager.latest_step()``, so a resumed run
    never reuses an id."""
    if checkpoint_every < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got "
                         f"{checkpoint_every}")
    base = manager.latest_step() or 0
    done = 0
    while done < n_steps:
        seg = min(checkpoint_every, n_steps - done)
        state, _ = run_mcmc(step_fn, state, seg)
        done += seg
        manager.save(base + done, state)
    return state


def vae_proposal_fns(vae, train: bool = False):
    """Standard wiring of a ``models.VAE`` into the engine."""

    def encoder_fn(x):
        return vae.encoder(x, train=train)

    def prior_fn(z):
        return vae._prior_dist(z, train)

    def decoder_fn(z):
        return vae.decoder(z, train=train)

    return encoder_fn, prior_fn, decoder_fn


class MCMC:
    """Driver with the reference API: ``single_step``, ``run``,
    ``acceptance_rate`` and ``reset``.  ``energy_func`` returns the LOG
    target density (see the module docstring)."""

    def __init__(self, vae, energy_func: Callable[[Tensor], Tensor],
                 random_seed: Optional[int] = None, device=None):
        self.vae = vae
        self.energy_func = energy_func
        self.device = torch.device(
            device or next(vae.parameters()).device)
        self._step = make_mcmc_step(*vae_proposal_fns(vae), energy_func)
        self.reset(random_seed)

    @property
    def acceptance_rate(self) -> float:
        if self._num_trials == 0:
            return float("nan")
        return self._num_acc / self._num_trials

    def reset(self, random_seed: Optional[int] = None) -> None:
        self._num_trials = 0  # Python ints: exact at any count
        self._num_acc = 0
        self._generator = torch.Generator(device=self.device).manual_seed(
            0 if random_seed is None else random_seed)

    def run(self, configs, energies=None, n_steps: int = 1):
        configs = torch.as_tensor(configs, dtype=torch.float32,
                                  device=self.device)
        with torch.no_grad():
            if energies is None:
                energies = self.energy_func(configs)
        state = MCMCState.create(configs, torch.as_tensor(energies),
                                 self._generator)
        state, _ = run_mcmc(self._step, state, n_steps)
        self._num_trials += int(state.num_trials)
        self._num_acc += int(state.num_acc)
        return state.configs, state.energies

    def single_step(self, configs, energies=None):
        return self.run(configs, energies, 1)
