"""``run_mcmc_checkpointed`` on the CPU: a run stopped after a
checkpoint, its state dropped, restored from the manager into a fresh
template and run to the end, equals the uninterrupted run bit for bit
(configurations, energies, counters and the generator's state), for the
generic VAE-proposal step and the fused step (the proposal kernel's
plain version, whose Philox key words come from the chains' generator);
and the step ids continue from ``manager.latest_step()``, as the JAX
package's do."""

import jax
import jax.numpy as jnp
import pytest
import torch

from vaemolsim_tpu.mcmc import MCMCState as JState
from vaemolsim_tpu.mcmc import run_mcmc_checkpointed as j_run_ckpt
from vaemolsim_tpu_torch.config import flagship_experiment_config
from vaemolsim_tpu_torch.mcmc import (MCMCState, make_fused_vae_step,
                                      make_mcmc_step, run_mcmc_checkpointed,
                                      vae_proposal_fns)
from vaemolsim_tpu_torch.train import CheckpointManager

torch.set_num_threads(1)

CHAINS, STEPS, EVERY = 64, 12, 3


def log_target(x):
    return -0.5 * (x * x).sum(-1)


@pytest.fixture(scope="module")
def vae():
    return flagship_experiment_config().build("cpu")


def _state():
    x = torch.randn(CHAINS, 2, generator=torch.Generator().manual_seed(0))
    return MCMCState.create(x, log_target(x),
                            torch.Generator().manual_seed(11))


def _step(vae, kind):
    if kind == "fused":
        return make_fused_vae_step(vae, log_target)
    return make_mcmc_step(*vae_proposal_fns(vae), log_target)


@pytest.mark.parametrize("kind", ["generic", "fused"])
def test_resumed_run_equals_the_uninterrupted_run(vae, kind, tmp_path):
    step = _step(vae, kind)
    whole = run_mcmc_checkpointed(step, _state(), STEPS, EVERY,
                                  CheckpointManager(str(tmp_path / "a")))
    manager = CheckpointManager(str(tmp_path / "b"), max_to_keep=10)
    run_mcmc_checkpointed(step, _state(), STEPS // 2, EVERY, manager)
    # A fresh template: other configurations and a generator elsewhere.
    template = MCMCState.create(torch.zeros(CHAINS, 2), torch.zeros(CHAINS),
                                torch.Generator().manual_seed(99))
    resumed = manager.restore(template)
    assert resumed.generator is template.generator
    resumed = run_mcmc_checkpointed(step, resumed, STEPS - STEPS // 2,
                                    EVERY, manager)
    assert torch.equal(resumed.configs, whole.configs)
    assert torch.equal(resumed.energies, whole.energies)
    assert int(resumed.num_trials) == int(whole.num_trials) == CHAINS * STEPS
    assert int(resumed.num_acc) == int(whole.num_acc)
    assert torch.equal(resumed.generator.get_state(),
                       whole.generator.get_state())
    assert manager.all_steps() == list(range(EVERY, STEPS + 1, EVERY))


class _Recorder:
    """A manager that records the step ids it is given."""

    def __init__(self, latest=None):
        self.latest, self.saved = latest, []

    def latest_step(self):
        return self.latest

    def save(self, step, state):
        self.saved.append(int(step))


@pytest.mark.parametrize("latest,n_steps,every", [(None, 10, 4), (8, 7, 3),
                                                  (50, 100, 50)])
def test_step_ids_continue_as_in_jax(latest, n_steps, every):
    jrec, trec = _Recorder(latest), _Recorder(latest)
    jstate = JState.create(jnp.zeros((4, 2)), jnp.zeros(4),
                           jax.random.PRNGKey(0))
    j_run_ckpt(lambda s: s, jstate, n_steps, every, jrec)
    run_mcmc_checkpointed(lambda s: s, _state(), n_steps, every, trec)
    assert trec.saved == jrec.saved
    assert trec.saved[-1] == (latest or 0) + n_steps
