"""The member axis on the CPU, against the JAX package: example 30's
committee trainer step (``train.EnsembleAdam``: one vmapped gradient of
``energy_force_loss`` over a stacked SchNet committee, then optax's Adam
written out) against JAX's vmapped ``member_step`` built inline from
``vaemolsim_tpu.nn.energy_force_loss`` and ``optax.adam``, with the
batch indices handed to both sides; the committee-mean potential and its
forces; the rule that a member's whole loss runs inside its functional
call (a flow's distribution is lazy: evaluated outside, every member
would be member 0); and ``_build._PlainGrad`` under ``torch.func.vmap``
of ``torch.func.grad``, the plain version standing in for the kernel
and its member-batched launch.

Members are built by JAX and carried across by ``convert.from_jax_stack``;
data come from numpy seeds.  Float32: losses and trained parameters to
1e-5 relative (three Adam steps carry the gradients' float32 differences
into the weights at about lr times their relative size).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vaemolsim_tpu import potentials as jpot
from vaemolsim_tpu.dists import StaticFlowedDistribution as JStatic
from vaemolsim_tpu.flows import RQSSplineRealNVP as JRealNVP
from vaemolsim_tpu.nn import SchNetPotential as JSchNet
from vaemolsim_tpu.nn import energy_force_loss as jloss
from vaemolsim_tpu.ops import distributions as jd
from vaemolsim_tpu.train import stack_models as jstack
from vaemolsim_tpu_torch import _build
from vaemolsim_tpu_torch.convert import from_jax, from_jax_stack
from vaemolsim_tpu_torch.nn import energy_force_loss
from vaemolsim_tpu_torch.nn.schnet import energy_and_forces
from vaemolsim_tpu_torch.train import EnsembleAdam, stack_models

torch.set_num_threads(1)

K, N, RHO, BATCH, STEPS = 3, 8, 0.4, 8, 3
BOX = (N / RHO) ** (1.0 / 3.0)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def close(got, want, rtol=1e-5):
    """Relative to the largest |want| (1e-6 floor)."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def labelled_frames(n, seed):
    """n frames of N atoms in the box, labelled by the JAX package's
    periodic LJ (cutoff 2.2): positions, energies, forces."""
    rng = np.random.default_rng(seed)
    x = (BOX * rng.uniform(size=(n, N, 3))).astype(np.float32)
    pot = jpot.lennard_jones(box=jnp.full((3,), BOX), cutoff=2.2)
    xj = jnp.asarray(x)
    e = pot(xj)
    f = -jax.grad(lambda c: jnp.sum(pot(c)))(xj)
    # Random frames hold close pairs: clip the labels to a trainable range.
    return x, np.clip(np.asarray(e), -50, 50), np.clip(np.asarray(f), -50, 50)


def jcommittee():
    return [JSchNet.create(jax.random.PRNGKey(10 + i), 1, features=8,
                           num_blocks=1, n_rbf=12, cutoff=2.2)
            for i in range(K)]


def test_committee_trainer_step_matches_jax_member_step():
    """Three steps of the vmapped committee trainer on a SchNet stack
    (features 8, one block), each member on its own batch of 8 (indices
    drawn here and handed to both sides): every step's (K,) losses and
    the trained stacked parameters to 1e-5 relative."""
    x, e, f = labelled_frames(24, 0)
    rng = np.random.default_rng(1)
    idx = np.stack([np.stack([rng.choice(24, BATCH, replace=False)
                              for _ in range(K)]) for _ in range(STEPS)])
    species = np.ones((N, 1), np.float32)
    box = np.full((3,), BOX, np.float32)

    jst = jstack(jcommittee())
    opt = optax.adam(3e-3)

    def member_step(m, s, ix, xx, ee, ff):
        loss, g = jax.value_and_grad(lambda mm: jloss(
            mm, xx[ix], jnp.asarray(species), ee[ix], ff[ix],
            box=jnp.asarray(box), w_energy=0.1, w_force=1.0))(m)
        up, s = opt.update(g, s)
        return optax.apply_updates(m, up), s, loss

    vstep = jax.jit(jax.vmap(member_step, in_axes=(0, 0, 0, None, None,
                                                   None)))
    states = jax.vmap(opt.init)(jst)
    jlosses = []
    for k in range(STEPS):
        jst, states, loss = vstep(jst, states, jnp.asarray(idx[k]),
                                  jnp.asarray(x), jnp.asarray(e),
                                  jnp.asarray(f))
        jlosses.append(np.asarray(loss))

    st = from_jax_stack(jstack(jcommittee()), "cpu")
    xt, et, ft, sp, bx = t(x), t(e), t(f), t(species), t(box)
    trainer = EnsembleAdam(st, lambda m, ix: energy_force_loss(
        m, xt[ix], sp, et[ix], ft[ix], box=bx, w_energy=0.1,
        w_force=1.0), learning_rate=3e-3)
    state = trainer.init()
    for k in range(STEPS):
        state, loss = trainer.update(state, torch.as_tensor(idx[k]),
                                     in_dims=(0,))
        assert loss.shape == (K,)
        close(loss, jlosses[k])
    want = from_jax_stack(jst, "cpu").state()
    for name, p in state["params"].items():
        close(p, want[name].numpy())
    trainer.write(state)
    for i, member in enumerate(st):
        torch.testing.assert_close(member.species_net.kernel,
                                   state["params"]["species_net.kernel"][i],
                                   rtol=0, atol=0)


def test_committee_mean_potential_and_forces_match_jax():
    """Example 30's committee-mean potential (the members' energies
    averaged, one vmapped call) and its forces, against JAX's vmap."""
    members = jcommittee()
    jst = jstack(members)
    st = from_jax_stack(jst, "cpu")
    x, _, _ = labelled_frames(6, 2)
    species = jnp.ones((N, 1))
    box = jnp.full((3,), BOX)

    def jpot_mean(xx):
        return jnp.mean(jax.vmap(lambda m: m(xx, species, box))(jst), 0)

    je = jpot_mean(jnp.asarray(x))
    jf = -jax.grad(lambda c: jnp.sum(jpot_mean(c)))(jnp.asarray(x))
    sp, bx = torch.ones(N, 1), t(np.asarray(box))
    e, f = st.vmap(lambda m, xx: energy_and_forces(m, xx, sp, bx), t(x))
    close(e.mean(0), je)
    close(f.mean(0), jf)


def jflow(seed):
    return JStatic(
        flow=JRealNVP.create(jax.random.PRNGKey(seed), 1, num_blocks=2,
                             rqs_params={"num_bins": 8, "hidden_dim": 16,
                                         "bin_range": [-4.0, 4.0]}),
        base=jd.Independent(jd.Normal(jnp.zeros(1), jnp.ones(1)), 1))


def nll(f, batch, draws):
    return -f().log_prob(batch).mean()


def test_each_members_loss_and_gradient_through_the_member_axis():
    """Three flows (example 09's member, small): each member's loss and
    gradient through the stack's member axis equal that member's own,
    bit for bit (the CPU takes one member at a time).  The stacked flows
    return lazy distributions: had the loss been evaluated outside the
    member's functional call, every member would give member 0's value,
    as the last assertion shows the mistake would."""
    members = [from_jax(jflow(300 + i), "cpu") for i in range(3)]
    alone = [from_jax(jflow(300 + i), "cpu") for i in range(3)]
    st = stack_models(members)
    batch = t(np.random.default_rng(3).normal(size=(64, 1)))
    losses = st.vmap(nll, batch, None)
    state = st.state()
    grads = torch.func.vmap(torch.func.grad(
        lambda s, b: st.call(nll, s, b, None)), in_dims=(0, None),
        chunk_size=1)(state, batch)
    own = []
    for i, m in enumerate(alone):
        loss = nll(m, batch, None)
        loss.backward()
        own.append(float(loss.detach()))
        assert float(losses[i]) == own[i]
        for name, p in m.named_parameters():
            assert torch.equal(grads[name][i], p.grad), name
    assert len(set(own)) == 3
    # The mistake: the distribution built inside the call, evaluated
    # after it has put the stacked tensors back.
    dists = [torch.func.functional_call(
        members[0], {n: v[i] for n, v in state.items()}, ())
        for i in range(3)]
    leaked = [float(-d.log_prob(batch).mean().detach()) for d in dists]
    assert leaked == [own[0]] * 3


def no_grad(fn):
    def run(*a):
        with torch.no_grad():
            return fn(*a)
    return run


def plain_layer(x, w, b):
    return torch.tanh(x @ w + b).pow(2).sum(-1)


@pytest.mark.parametrize("with_member_fn", [True, False])
def test_plain_grad_under_vmap_of_grad(with_member_fn):
    """``_PlainGrad`` inside ``torch.func.vmap(torch.func.grad(...))``
    over three members' weights (x shared), the plain version standing in
    for the kernel: the member-batched form is called once with a
    leading member axis on every tensor; first and second derivatives
    (``grad`` of ``grad``) equal per-member autograd's to float32
    rounding.  Without a member-batched form the CPU stand-in is
    vmapped."""
    rng = np.random.default_rng(5)
    x, W, b = (t(rng.normal(size=(6, 4))), t(rng.normal(size=(3, 4, 5))),
               t(rng.normal(size=(3, 5))))
    calls = []

    def members(xm, wm, bm):
        calls.append((xm.shape, wm.shape, bm.shape))
        return torch.func.vmap(plain_layer)(xm, wm, bm)

    def loss(w, bb):
        return _build.call_with_plain_grad(
            no_grad(plain_layer), plain_layer, x, w, bb,
            member_fn=members if with_member_fn else None).sum()

    g = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)))(W, b)
    gg = torch.func.vmap(torch.func.grad(
        lambda w, bb: sum(v.pow(2).sum() for v in torch.func.grad(
            loss, argnums=(0, 1))(w, bb))))(W, b)
    if with_member_fn:
        assert calls and all(c == ((3, 6, 4), (3, 4, 5), (3, 5))
                             for c in calls)
    else:
        assert not calls
    for i in range(3):
        w = W[i].clone().requires_grad_(True)
        bb = b[i].clone().requires_grad_(True)
        gw, gb = torch.autograd.grad(plain_layer(x, w, bb).sum(), (w, bb),
                                     create_graph=True)
        (ggw,) = torch.autograd.grad(gw.pow(2).sum() + gb.pow(2).sum(), w)
        close(g[0][i], gw.detach().numpy())
        close(g[1][i], gb.detach().numpy())
        close(gg[i], ggw.numpy())
