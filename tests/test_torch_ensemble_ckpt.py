"""The port's ensemble training, streamed ``fit`` and checkpoints, on the
CPU: ``fit_ensemble``'s per-member losses against the JAX package's (no
shuffle, a deterministic maximum-likelihood loss), ``stack_models`` and
``unstack_model``, ``fit`` over a callable stream, and checkpoint round
trips, with a resumed run that continues bit for bit.

The members are example 09's flows at a small width (1-D
RQSSplineRealNVP, 2 blocks, 8 bins, hidden 16, over a standard normal),
built by JAX and carried across with ``from_jax(..., "cpu")``.  Losses
to 1e-5 (absolute and relative) after Adam steps in float32, trained
weights to 1e-4.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vaemolsim_tpu.dists import StaticFlowedDistribution as JStatic
from vaemolsim_tpu.flows import RQSSplineRealNVP as JRealNVP
from vaemolsim_tpu.ops import distributions as jd
from vaemolsim_tpu.train import fit_ensemble as jfit_ensemble
from vaemolsim_tpu.train import stack_models as jstack_models
from vaemolsim_tpu_torch import config as tconfig
from vaemolsim_tpu_torch.convert import from_jax
from vaemolsim_tpu_torch.mcmc import MCMCState
from vaemolsim_tpu_torch.parallel import REMCState, temperature_ladder
from vaemolsim_tpu_torch.train import (CheckpointManager, fit, fit_ensemble,
                                       make_train_step, restore_checkpoint,
                                       save_checkpoint, stack_models,
                                       unstack_model)

torch.set_num_threads(1)

RQS = {"num_bins": 8, "hidden_dim": 16, "bin_range": [-4.0, 4.0]}


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def jmember(seed):
    return JStatic(
        flow=JRealNVP.create(jax.random.PRNGKey(seed), 1, num_blocks=2,
                             rqs_params=dict(RQS)),
        base=jd.Independent(jd.Normal(jnp.zeros(1), jnp.ones(1)), 1))


def mixture_data(n, seed):
    rng = np.random.default_rng(seed)
    return (np.array([-2.0, 0.0, 2.0])[rng.integers(0, 3, n)]
            + 0.3 * rng.normal(size=n)).astype(np.float32)[:, None]


def nll(f, batch, g):
    return -f().log_prob(batch).mean()


def adam_on_the_flow(lr):
    """optax Adam on the flow's leaves only.  The JAX package's optimizers
    also move a static base's loc and scale (pytree leaves); the port
    keeps the fixed base as buffers, so the comparison freezes them."""

    def labels(m):
        return m.replace(flow=jax.tree_util.tree_map(lambda _: "adam",
                                                     m.flow),
                         base=jax.tree_util.tree_map(lambda _: "fixed",
                                                     m.base))

    return optax.multi_transform({"adam": optax.adam(lr),
                                  "fixed": optax.set_to_zero()}, labels)


def test_fit_ensemble_member_losses_match_jax():
    """Three members, no shuffle, the MLE loss: every epoch's (K,) mean
    loss to 1e-5, and every member's trained weights through log_prob to
    1e-4 (the gradients' tolerance: twelve Adam steps, whose normalised
    early updates carry the gradients' float32 differences into the
    weights)."""
    K = 3
    jstack = jstack_models([jmember(100 + i) for i in range(K)])
    members = [from_jax(jmember(100 + i), "cpu") for i in range(K)]
    x = mixture_data(256, 1)
    jstack, jhist = jfit_ensemble(
        jstack, lambda f, b, k: -jnp.mean(f().log_prob(b)), jnp.asarray(x),
        key=jax.random.PRNGKey(2), num_epochs=3, batch_size=64,
        optimizer=adam_on_the_flow(3e-3), shuffle=False)
    stack, hist = fit_ensemble(stack_models(members), nll, t(x),
                               generator=torch.Generator().manual_seed(2),
                               num_epochs=3, batch_size=64,
                               learning_rate=3e-3, shuffle=False)
    assert len(hist["loss"]) == 3 and hist["loss"][0].shape == (K,)
    np.testing.assert_allclose(np.stack(hist["loss"]),
                               np.stack(jhist["loss"]), atol=1e-5,
                               rtol=1e-5)
    probe = mixture_data(64, 3)
    for i in range(K):
        jm = jax.tree_util.tree_map(lambda a: a[i], jstack)
        with torch.no_grad():
            got = unstack_model(stack, i)().log_prob(t(probe)).numpy()
        np.testing.assert_allclose(got, np.asarray(jm().log_prob(
            jnp.asarray(probe))), atol=1e-4, rtol=1e-4)


def test_stack_unstack_and_members_train_as_separate_fits():
    """stack_models keeps the members themselves; each member of
    fit_ensemble ends exactly where fit() on the same batches, with its
    own optimizer, would take it; metrics come back per member."""
    members = [from_jax(jmember(200 + i), "cpu") for i in range(2)]
    stack = stack_models(members)
    assert isinstance(stack, torch.nn.ModuleList)
    assert unstack_model(stack, 1) is members[1]
    alone = [from_jax(jmember(200 + i), "cpu") for i in range(2)]
    x = t(mixture_data(120, 4))

    def loss_fn(f, b, g):
        v = nll(f, b, g)
        return v, {"nll": v, "loss": v}

    stack, hist = fit_ensemble(stack, loss_fn, x,
                               generator=torch.Generator().manual_seed(5),
                               num_epochs=2, batch_size=40)
    assert hist["nll"][0].shape == (2,)
    # The same batches: replay the ensemble's shuffles.
    shuffles = torch.Generator().manual_seed(5)
    torch.randint(2 ** 62, (2,), generator=shuffles)  # the members' seeds
    orders = [torch.randperm(120, generator=shuffles) for _ in range(2)]
    batches = [x[o[b * 40:(b + 1) * 40]] for o in orders for b in range(3)]
    for m, member in zip(alone, stack):
        fit(m, nll, lambda g: iter(batches), generator=torch.Generator())
        for p, q in zip(m.parameters(), member.parameters()):
            assert torch.equal(p, q)
    with pytest.raises(ValueError, match="in-memory"):
        fit_ensemble(stack, nll, lambda g: iter([x]),
                     generator=torch.Generator())


def test_fit_on_a_callable_stream_matches_in_memory_fit():
    """A stream of the in-memory batches in order trains exactly as the
    in-memory fit without shuffling; the stream gets the fit's
    generator every epoch."""
    x = t(mixture_data(96, 6))
    runs, seen = [], []

    def stream(gen):
        seen.append(gen)
        return (x[b * 32:(b + 1) * 32] for b in range(3))

    for data in (x, stream):
        m = from_jax(jmember(300), "cpu")
        gen = torch.Generator().manual_seed(7)
        _, hist = fit(m, nll, data, generator=gen, num_epochs=2,
                      batch_size=32, shuffle=False)
        runs.append((m, hist["loss"]))
    assert len(seen) == 2 and all(g is gen for g in seen)
    assert runs[0][1] == runs[1][1]
    for p, q in zip(runs[0][0].parameters(), runs[1][0].parameters()):
        assert torch.equal(p, q)


def bn_flow_model(seed):
    return tconfig.ExperimentConfig(model=tconfig.FlowModelConfig(
        tconfig.FlowedDistConfig(
            tconfig.MAFConfig(data_dim=2, num_blocks=3, batch_norm=True,
                              rqs=tconfig.RQSParams(hidden_dim=8,
                                                    num_bins=4)),
            static_base_dim=2)), seed=seed).build("cpu")


def test_checkpoint_round_trip_and_bit_exact_resume(tmp_path):
    """A batch-norm flow model, its Adam state, the generator and MC
    chain states: restored into fresh objects they equal the saved ones,
    the file loads with weights_only=True, and a run resumed from the
    checkpoint gives the losses of the uninterrupted run, bit for bit."""
    x = t(np.random.default_rng(8).normal(size=(512, 2)))

    def run(model, opt, gen, steps):
        step = make_train_step(lambda m, b, g: -m.log_prob(b).mean(), opt)
        losses = []
        for _ in range(steps):
            batch = x[torch.randint(512, (64,), generator=gen)]
            losses.append(float(step(model, batch, gen)[0]))
            model.flowed_dist.flow.update_batch_stats(batch)
        return losses

    model = bn_flow_model(0)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    gen = torch.Generator().manual_seed(9)
    run(model, opt, gen, 4)
    chains = MCMCState.create(torch.randn(6, 2, generator=gen),
                              torch.zeros(6), torch.Generator().manual_seed(1))
    remc = REMCState.create(torch.randn(3, 4, 2), lambda c: -c.pow(2).sum(-1),
                            temperature_ladder(3, device="cpu"),
                            torch.Generator().manual_seed(2))
    path = tmp_path / "ckpt" / "state.pt"
    save_checkpoint(str(path), {"model": model, "opt": opt, "gen": gen,
                                "chains": chains, "remc": [remc, 7]})
    assert isinstance(torch.load(path, weights_only=True), dict)
    uninterrupted = run(model, opt, gen, 4)

    fresh = bn_flow_model(1)
    fresh_opt = torch.optim.Adam(fresh.parameters(), lr=1e-2)
    fresh_gen = torch.Generator()
    template = {"model": fresh, "opt": fresh_opt, "gen": fresh_gen,
                "chains": MCMCState.create(torch.zeros(6, 2), torch.ones(6),
                                           torch.Generator()),
                "remc": [REMCState.create(torch.zeros(3, 4, 2),
                                          lambda c: c.sum(-1),
                                          torch.ones(3), torch.Generator()),
                         0]}
    restored = restore_checkpoint(str(path), template)
    assert restored["model"] is fresh and restored["gen"] is fresh_gen
    assert torch.equal(restored["chains"].configs, chains.configs)
    assert torch.equal(restored["chains"].generator.get_state(),
                       chains.generator.get_state())
    r = restored["remc"][0]
    assert restored["remc"][1] == 7 and r.step_index == remc.step_index
    assert torch.equal(r.betas, remc.betas)
    assert torch.equal(r.energies, remc.energies)
    assert run(fresh, fresh_opt, fresh_gen, 4) == uninterrupted
    for (n, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), n


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "run"), max_to_keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(ValueError, match="no checkpoints"):
        mgr.restore({"w": torch.zeros(2)})
    for step in (1, 5, 9, 12):
        mgr.save(step, {"w": torch.full((2,), float(step))})
    assert mgr.all_steps() == [9, 12] and mgr.latest_step() == 12
    assert float(mgr.restore({"w": torch.zeros(2)})["w"][0]) == 12.0
    assert float(mgr.restore({"w": torch.zeros(2)}, step=9)["w"][0]) == 9.0
    with pytest.raises(ValueError, match="template"):
        mgr.restore({"w": torch.nn.Linear(2, 2)})
    mgr.close()


def test_stack_holds_each_tensor_once_with_a_member_axis():
    """The stacked form: every parameter and buffer once, (K, ...), under
    the members' own names; each member's tensors are views of its slice
    (an update of the stack is the member's, and the reverse); moving the
    stack re-points the members; a copy is independent; a member stacked
    again is copied, so the first stack keeps its views."""
    members = [from_jax(jmember(400 + i), "cpu") for i in range(3)]
    shapes = {n: p.shape for n, p in members[0].named_parameters()}
    stack = stack_models(members)
    assert len(stack) == 3 and list(stack) == members
    state = stack.state()
    assert set(state) == set(shapes) | {n for n, _ in
                                        members[0].named_buffers()}
    for n, shape in shapes.items():
        assert state[n].shape == (3,) + tuple(shape)
    assert len(list(stack.parameters())) == len(shapes)
    assert all(k.startswith("stacked.") for k in stack.state_dict())
    name = next(iter(shapes))
    with torch.no_grad():
        stack.stacked.get_parameter(name).add_(1.0)
        assert torch.equal(members[1].get_parameter(name), state[name][1])
        members[2].get_parameter(name).mul_(2.0)
    assert torch.equal(stack.state()[name][2],
                       members[2].get_parameter(name))
    twin = copy.deepcopy(stack)
    with torch.no_grad():
        twin.stacked.get_parameter(name).zero_()
    assert float(members[0].get_parameter(name).detach().abs().sum()) > 0
    again = stack_models([members[0], members[0]])
    assert again[0] is not members[0] and again[1] is not again[0]
    with torch.no_grad():
        again.stacked.get_parameter(name).zero_()
    assert torch.equal(members[0].get_parameter(name), stack.state()[name][0])
    stack.to(torch.float64)
    assert members[0].get_parameter(name).dtype == torch.float64
    assert (members[0].get_parameter(name).data_ptr()
            == stack.stacked.get_parameter(name).data_ptr())


def test_stack_checkpoint_round_trip(tmp_path):
    """A trained stack and its optimizer restored into a stack of other
    seeds: the stacked tensors, and so every member, equal the saved."""
    x = t(mixture_data(64, 8))
    stack, _ = fit_ensemble(
        stack_models([from_jax(jmember(500 + i), "cpu") for i in range(2)]),
        nll, x, generator=torch.Generator().manual_seed(1), batch_size=32)
    path = tmp_path / "stack.pt"
    save_checkpoint(str(path), {"stack": stack})
    fresh = stack_models([from_jax(jmember(600 + i), "cpu")
                          for i in range(2)])
    restored = restore_checkpoint(str(path), {"stack": fresh})
    assert restored["stack"] is fresh
    for (n, a), b in zip(stack.state().items(), fresh.state().values()):
        assert torch.equal(a, b), n
    for m, f in zip(stack, fresh):
        with torch.no_grad():
            assert torch.equal(m().log_prob(x), f().log_prob(x))


def test_fit_ensemble_draws_come_from_each_members_generator():
    """``draw`` makes each member's random inputs from its own generator
    outside the vmapped call (stacked on the member axis); the trained
    members equal fits that replay each member's draws.  A loss that
    draws inside the vmapped call raises instead."""
    x = t(mixture_data(64, 9))

    def noisy(f, b, d):
        return nll(f, b + 0.05 * d, None)

    stack, _ = fit_ensemble(
        stack_models([from_jax(jmember(700 + i), "cpu") for i in range(2)]),
        noisy, x, generator=torch.Generator().manual_seed(2),
        batch_size=32, shuffle=False,
        draw=lambda g: torch.randn(32, 1, generator=g))
    seeds = torch.randint(2 ** 62, (2,),
                          generator=torch.Generator().manual_seed(2))
    for i, member in enumerate(stack):
        g = torch.Generator().manual_seed(int(seeds[i]))
        alone = from_jax(jmember(700 + i), "cpu")
        batches = [x[:32] + 0.05 * torch.randn(32, 1, generator=g),
                   x[32:] + 0.05 * torch.randn(32, 1, generator=g)]
        fit(alone, nll, lambda gen: iter(batches),
            generator=torch.Generator())
        for p, q in zip(alone.parameters(), member.parameters()):
            torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-7)
    with pytest.raises(RuntimeError, match="random"):
        fit_ensemble(stack, lambda f, b, d: nll(
            f, b + torch.randn(b.shape), None), x,
            generator=torch.Generator(), batch_size=32)
