"""The port's committee uncertainty against the JAX package, on the CPU.

JAX committees stacked by the JAX ``stack_models`` come across with
``convert.from_jax_stack`` (a ``ModuleList`` of members); SchNet and
PaiNN committees, with and without a padding mask and a box.
Tolerances, float32: every statistic of ``ensemble_energy_forces`` and
``max_force_uncertainty`` to 1e-5 of its largest |value|, the gradient
of the summed force spread in the frames to 1e-4; identical members give
a spread of exactly 0 (population statistics, ``correction=0``, as
``jnp.std``).  Inputs come from ``numpy.random.default_rng``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu.nn import PaiNNPotential as JPaiNN
from vaemolsim_tpu.nn import SchNetPotential as JSchNet
from vaemolsim_tpu.nn import ensemble_energy_forces as jensemble
from vaemolsim_tpu.nn import max_force_uncertainty as jmax_unc
from vaemolsim_tpu.train import stack_models as jstack
from vaemolsim_tpu_torch.convert import from_jax, from_jax_stack
from vaemolsim_tpu_torch.nn import (EnsemblePrediction, PaiNNPotential,
                                    SchNetPotential, ensemble_energy_forces,
                                    max_force_uncertainty)
from vaemolsim_tpu_torch.train import stack_models

torch.set_num_threads(1)

KINDS = {"schnet": (JSchNet, SchNetPotential),
         "painn": (JPaiNN, PaiNNPotential)}


def close(got, want, rtol):
    got = got.detach().numpy()
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def committee(kind, k=3):
    cls = KINDS[kind][0]
    return [cls.create(jax.random.PRNGKey(i), 1, features=12, num_blocks=1,
                       n_rbf=8, cutoff=2.5) for i in range(k)]


def frames(n_atoms=6, batch=4, seed=0):
    x = (1.1 * np.random.default_rng(seed).normal(
        size=(batch, n_atoms, 3))).astype(np.float32)
    return x, np.ones((n_atoms, 1), np.float32)


@pytest.mark.parametrize("kind", ["schnet", "painn"])
@pytest.mark.parametrize("masked", [False, True])
def test_committee_matches_jax(kind, masked):
    members = committee(kind)
    jst = jstack(members)
    st = from_jax_stack(jst, "cpu")
    assert isinstance(st, torch.nn.ModuleList) and len(st) == 3
    assert all(isinstance(m, KINDS[kind][1]) for m in st)
    x, sp = frames(seed=1 + masked)
    box = np.full(3, 4.0, np.float32) if masked else None
    mask = (np.arange(6) < 4) if masked else None
    args = (None if box is None else torch.as_tensor(box),
            None if mask is None else torch.as_tensor(mask))
    jargs = tuple(None if a is None else jnp.asarray(a) for a in (box, mask))
    xt, spt = torch.as_tensor(x), torch.as_tensor(sp)
    with torch.no_grad():
        pred = ensemble_energy_forces(st, xt, spt, *args)
        mu = max_force_uncertainty(st, xt, spt, *args)
    assert isinstance(pred, EnsemblePrediction)
    jpred, jmu = jax.jit(lambda xx: (jensemble(jst, xx, jnp.asarray(sp),
                                               *jargs),
                                     jmax_unc(jst, xx, jnp.asarray(sp),
                                              *jargs)))(jnp.asarray(x))
    for got, want in zip(pred, jpred):
        close(got, want, 1e-5)
    close(mu, jmu, 1e-5)
    assert not pred.forces.requires_grad
    if masked:
        assert float(pred.forces[:, 4:].abs().max()) == 0.0
    # The stack's members are the members: each one alone as from_jax.
    one = from_jax(members[1], "cpu")
    with torch.no_grad():
        np.testing.assert_array_equal(st[1](xt, spt, *args).numpy(),
                                      one(xt, spt, *args).numpy())


def test_force_spread_gradient_matches_jax():
    """Under grad mode the forces keep their graph: d sum(force_std) / dx
    against JAX's."""
    jst = jstack(committee("painn"))
    st = from_jax_stack(jst, "cpu")
    x, sp = frames(n_atoms=5, batch=2, seed=3)
    xt = torch.as_tensor(x).requires_grad_(True)
    pred = ensemble_energy_forces(st, xt, torch.as_tensor(sp))
    (g,) = torch.autograd.grad(pred.force_std.sum(), xt)
    jg = jax.jit(jax.grad(lambda xx: jnp.sum(
        jensemble(jst, xx, jnp.asarray(sp)).force_std)))(jnp.asarray(x))
    close(g, jg, 1e-4)


@pytest.mark.parametrize("kind", ["schnet", "painn"])
def test_identical_members_give_zero_spread(kind):
    member = KINDS[kind][1].create(torch.Generator().manual_seed(0), 1,
                                   features=12, num_blocks=1, n_rbf=8,
                                   cutoff=2.5, device="cpu")
    st = stack_models([member, member, member])
    x, sp = frames(batch=5, seed=4)
    xt, spt = torch.as_tensor(x), torch.as_tensor(sp)
    mask = torch.as_tensor(np.arange(6) < 5)
    with torch.no_grad():
        for m in (None, mask):
            pred = ensemble_energy_forces(st, xt, spt, mask=m)
            assert float(pred.energy_std.abs().max()) == 0.0
            assert float(pred.force_std.abs().max()) == 0.0
            assert float(max_force_uncertainty(st, xt, spt, mask=m)
                         .abs().max()) == 0.0
        np.testing.assert_allclose(pred.energy.numpy(),
                                   member(xt, spt, mask=mask).numpy(),
                                   rtol=1e-6)
    xg = xt.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(member(xg, spt).sum(), xg)
    np.testing.assert_allclose(
        ensemble_energy_forces(st, xt, spt).forces.detach().numpy(),
        -g.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["schnet", "painn"])
def test_from_jax_stack_gives_the_stacked_form(kind):
    """A JAX committee comes across as the port's stacked form: each
    leaf once with the leading member axis, equal to the JAX leaf, and
    member i equal to the JAX member i unstacked."""
    members = committee(kind)
    jst = jstack(members)
    st = from_jax_stack(jst, "cpu")
    one = from_jax(members[1], "cpu")
    state = st.state()
    assert {n for n, _ in one.named_parameters()} <= set(state)
    for n, p in one.named_parameters():
        assert state[n].shape == (3,) + tuple(p.shape)
        torch.testing.assert_close(state[n][1], p.detach(), rtol=0, atol=0)
    x, sp = frames(batch=2, seed=5)
    with torch.no_grad():
        torch.testing.assert_close(st[1](torch.as_tensor(x),
                                         torch.as_tensor(sp)),
                                   one(torch.as_tensor(x),
                                       torch.as_tensor(sp)))


@pytest.mark.parametrize("kind", ["schnet", "painn"])
def test_force_loss_gradient_under_func_grad_equals_autograd(kind):
    """energy_force_loss takes the force by torch.func.grad: its weight
    gradient by loss.backward() and by torch.func.grad over the
    functional call agree (what the vmapped committee trainer takes)."""
    from vaemolsim_tpu_torch.nn import energy_force_loss
    member = from_jax(committee(kind, 1)[0], "cpu")
    x, sp = frames(batch=3, seed=6)
    rng = np.random.default_rng(6)
    e, f = (torch.as_tensor(rng.normal(size=(3,)).astype(np.float32)),
            torch.as_tensor(rng.normal(size=x.shape).astype(np.float32)))
    args = (torch.as_tensor(x), torch.as_tensor(sp), e, f)
    energy_force_loss(member, *args, w_energy=0.1).backward()
    params = {n: p.detach() for n, p in member.named_parameters()}
    grads = torch.func.grad(lambda ps: energy_force_loss(
        lambda *a: torch.func.functional_call(member, ps, a), *args,
        w_energy=0.1))(params)
    for n, p in member.named_parameters():
        close(grads[n], p.grad.numpy(), 1e-5)


@pytest.mark.parametrize("kind", ["schnet", "painn"])
@pytest.mark.parametrize("form", ["sequence", "stack"])
def test_weight_gradient_through_the_committee_equals_member_by_member(
        kind, form):
    """Under grad mode the committee keeps its graph to the members'
    weights: the gradient of the summed energy and force spread in every
    weight (a sequence's members' own parameters, or a stack's stacked
    ones, member i's slice) equals the one of the same statistics built
    member by member with autograd (``create_graph`` forces), to 1e-4 of
    its largest |value|.  A sequence's members are left as they are: the
    same parameter objects, not views of a stack."""
    members = committee(kind)
    x, sp = frames(n_atoms=5, batch=2, seed=7)
    xt, spt = torch.as_tensor(x), torch.as_tensor(sp)
    if form == "stack":
        st = from_jax_stack(jstack(members), "cpu")
        named = [dict(st.stacked.named_parameters())]
    else:
        st = [from_jax(m, "cpu") for m in members]
        named = [dict(m.named_parameters()) for m in st]
        before = [{n: (id(p), p.data_ptr()) for n, p in d.items()}
                  for d in named]
    pred = ensemble_energy_forces(st, xt, spt)
    (pred.energy_std.sum() + pred.force_std.sum()
     + pred.energy.sum()).backward()
    if form == "sequence":
        assert [{n: (id(p), p.data_ptr()) for n, p in m.named_parameters()}
                for m in st] == before
        assert all(p._base is None for d in named for p in d.values())

    ref = [from_jax(m, "cpu") for m in members]
    es, fs = [], []
    for m in ref:
        xg = xt.clone().requires_grad_(True)
        e = m(xg, spt)
        (g,) = torch.autograd.grad(e.sum(), xg, create_graph=True)
        es.append(e)
        fs.append(-g)
    e_k, f_k = torch.stack(es), torch.stack(fs)
    (e_k.std(0, correction=0).sum()
     + torch.sqrt(f_k.var(0, correction=0).mean((-2, -1))).sum()
     + e_k.mean(0).sum()).backward()
    for i, m in enumerate(ref):
        for n, p in m.named_parameters():
            got = (named[0][n].grad[i] if form == "stack"
                   else named[i][n].grad)
            close(got, p.grad.numpy(), 1e-4)
