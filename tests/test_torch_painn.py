"""The port's PaiNN potential against the JAX package, on the CPU.

Weights come across with ``convert.from_jax``.  Tolerances, float32:
energies, atom energies and forces to 1e-5 of the largest |value|, with
a box, a padding mask and batched species; ``energy_force_loss`` to 1e-5
relative and its weight gradients (a second derivative through the
forces) to 1e-4 of each gradient's largest entry; the box gradient of
``as_potential_for_box`` to 1e-5; the port's own invariances to 1e-4
(JAX's test bounds), the gradient at the cutoff under 1e-6; and the first
20 Adam losses of tests/test_painn.py's three-body fit: two in float32
to 1e-5, sixteen in float64 to 1e-8 and all twenty to 0.1 (Adam's gain
of lr / eps on gradients of ~1e-9 makes the fit diverge tenfold a step
from any rounding difference; see that test).  Inputs come from
``numpy.random.default_rng``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vaemolsim_tpu.nn.painn import PaiNNPotential as JPaiNN
from vaemolsim_tpu.nn.schnet import energy_force_loss as jefl
from vaemolsim_tpu_torch.convert import from_jax
from vaemolsim_tpu_torch.nn import (PaiNNBlock, PaiNNPotential,
                                    energy_force_loss)

torch.set_num_threads(1)


def t(a):
    return torch.as_tensor(np.array(a, dtype=np.float32))


def close(got, want, rtol):
    """|got - want| within rtol of the largest |want|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def models(seed=0, species_dim=2, **kw):
    kw.setdefault("features", 16)
    kw.setdefault("num_blocks", 2)
    kw.setdefault("n_rbf", 8)
    kw.setdefault("cutoff", 2.5)
    jm = JPaiNN.create(jax.random.PRNGKey(seed), species_dim, **kw)
    return jm, from_jax(jm, "cpu")


def system(n=8, batch=3, scale=1.2, seed=1, species_dim=2,
           batched_species=False):
    rng = np.random.default_rng(seed)
    x = (scale * rng.normal(size=(batch, n, 3))).astype(np.float32)
    shape = (batch, n) if batched_species else (n,)
    sp = np.eye(species_dim, dtype=np.float32)[
        rng.integers(0, species_dim, shape)]
    return x, sp


def rotation(seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    return q.astype(np.float32)


@pytest.mark.parametrize("case", ["open", "box", "mask", "batched_species"])
def test_energies_and_forces_match_jax(case):
    jm, m = models()
    assert isinstance(m, PaiNNPotential)
    assert all(isinstance(b, PaiNNBlock) for b in m.blocks)
    x, sp = system(batched_species=case == "batched_species")
    box = np.full(3, 4.0, np.float32) if case == "box" else None
    mask = (np.arange(8) < 6) if case == "mask" else None
    args = [None if a is None else t(a) if a.dtype != bool
            else torch.as_tensor(a) for a in (box, mask)]
    jargs = [None if a is None else jnp.asarray(a) for a in (box, mask)]
    xt = t(x).requires_grad_(True)
    ea = m.atom_energies(xt, t(sp), *args)
    (g,) = torch.autograd.grad(ea.sum(), xt)
    jea, jg = jax.jit(lambda c: (
        jm.atom_energies(c, jnp.asarray(sp), *jargs),
        jax.grad(lambda cc: jnp.sum(jm(cc, jnp.asarray(sp), *jargs)))(c)))(
            jnp.asarray(x))
    close(ea, jea, 1e-5)
    close(m(t(x), t(sp), *args), jnp.sum(jea, -1), 1e-5)
    close(-g, -jg, 1e-5)
    if mask is not None:
        assert float(ea[:, 6:].abs().max()) == 0.0


def test_energy_force_loss_and_gradients_match_jax():
    jm, m = models(seed=3)
    x, sp = system(n=6, batch=4, seed=4)
    box, mask = np.full(3, 3.5, np.float32), np.arange(6) < 5
    rng = np.random.default_rng(5)
    e_ref = rng.normal(size=4).astype(np.float32)
    f_ref = rng.normal(size=x.shape).astype(np.float32)
    loss = energy_force_loss(m, t(x), t(sp), t(e_ref), t(f_ref), box=t(box),
                             mask=torch.as_tensor(mask), w_energy=0.7,
                             w_force=0.3)
    jloss, jg = jax.jit(jax.value_and_grad(lambda mm: jefl(
        mm, jnp.asarray(x), jnp.asarray(sp), jnp.asarray(e_ref),
        jnp.asarray(f_ref), box=jnp.asarray(box), mask=jnp.asarray(mask),
        w_energy=0.7, w_force=0.3)))(jm)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    loss.backward()
    pairs = [(m.e_scale, jg.e_scale), (m.e_ref, jg.e_ref),
             (m.species_net.kernel, jg.species_net.kernel),
             (m.out1.kernel, jg.out1.kernel), (m.out2.bias, jg.out2.bias)]
    for b, jb in zip(m.blocks, jg.blocks):
        pairs += [(b.U, jb.U), (b.V, jb.V)]
        pairs += [(getattr(b, f).kernel, getattr(jb, f).kernel)
                  for f in ("phi1", "phi2", "filter_net", "upd1", "upd2")]
        pairs += [(b.upd2.bias, jb.upd2.bias)]
    for p, want in pairs:
        close(p.grad, want, 1e-4)


def test_box_gradient_matches_jax():
    jm, m = models(seed=6)
    x, sp = system(n=6, batch=2, scale=1.4, seed=7)
    box = t(np.full(3, 5.0)).requires_grad_(True)
    e = m.as_potential_for_box(t(sp))(box)(t(x)).sum()
    (g,) = torch.autograd.grad(e, box)
    je, jgb = jax.jit(jax.value_and_grad(lambda b: jnp.sum(
        jm.as_potential_for_box(jnp.asarray(sp))(b)(jnp.asarray(x)))))(
            jnp.full(3, 5.0))
    close(g, jgb, 1e-5)
    close(m.as_potential(t(sp), box=box)(t(x)).sum(), je, 1e-5)


def test_invariances_and_equivariance():
    _, m = models(seed=0)
    x, sp = system()
    with torch.no_grad():
        e = m(t(x), t(sp))
        np.testing.assert_allclose(m(t(x) + 7.3, t(sp)), e, atol=1e-4)
        np.testing.assert_allclose(m(t(x @ rotation(3)), t(sp)), e,
                                   atol=1e-4)
        x_ref = x.copy()
        x_ref[..., 0] *= -1.0
        np.testing.assert_allclose(m(t(x_ref), t(sp)), e, atol=1e-4)
        perm = np.random.default_rng(0).permutation(8)
        np.testing.assert_allclose(m(t(x[:, perm]), t(sp[perm])), e,
                                   atol=1e-4)
        mask = torch.as_tensor(np.arange(8) < 5)
        np.testing.assert_allclose(m(t(x), t(sp), mask=mask),
                                   m(t(x[:, :5]), t(sp[:5])), atol=1e-5)

    def forces(c):
        c = t(c).requires_grad_(True)
        return -torch.autograd.grad(m(c, t(sp)).sum(), c)[0]

    R = rotation(11)
    np.testing.assert_allclose(forces(x @ R), forces(x) @ t(R), atol=2e-4)
    # A fresh model's vector features start at zero: gradients stay finite.
    fresh = PaiNNPotential.create(torch.Generator().manual_seed(0), 2,
                                  features=8, num_blocks=2, n_rbf=6,
                                  device="cpu")
    xg = t(x).requires_grad_(True)
    loss = energy_force_loss(fresh, xg, t(sp), torch.zeros(3),
                             torch.zeros(x.shape))
    loss.backward()
    assert all(torch.isfinite(p.grad).all() for p in fresh.parameters())


def test_zero_gradient_at_the_cutoff():
    jm, m = models(seed=1, species_dim=1, cutoff=2.0)
    sp = torch.ones(2, 1)

    def e_of_r(r):
        x = torch.stack([torch.zeros(3), torch.tensor([1.0, 0.0, 0.0]) * r])
        return m(x[None], sp)[0]

    def grad_at(r):
        r = torch.tensor(float(r), requires_grad=True)
        return float(torch.autograd.grad(e_of_r(r), r)[0])

    assert abs(grad_at(2.0)) < 1e-6
    eps = 1e-3
    for r in (1.9995, 2.0005, 1.5):
        fd = (float(e_of_r(torch.tensor(r + eps)))
              - float(e_of_r(torch.tensor(r - eps)))) / (2 * eps)
        assert abs(grad_at(r) - fd) < 5e-4
    with torch.no_grad():
        assert float(e_of_r(torch.tensor(2.3))) == pytest.approx(
            float(e_of_r(torch.tensor(5.0))), abs=1e-7)
    jgrad = jax.jit(jax.grad(lambda r: jm(jnp.stack(
        [jnp.zeros(3), jnp.array([1.0, 0.0, 0.0]) * r])[None],
        jnp.ones((2, 1)))[0]))
    np.testing.assert_allclose(grad_at(1.5), float(jgrad(1.5)), rtol=1e-4,
                               atol=1e-6)


def three_body_data():
    """tests/test_painn.py's angular three-body target: 48 bends at unit
    bond lengths, each rotated by its own random rotation; energies and
    forces."""

    def target(x):
        ra = x[..., 1, :] - x[..., 0, :]
        rb = x[..., 2, :] - x[..., 0, :]
        cos = (jnp.sum(ra * rb, -1)
               / jnp.sqrt(jnp.sum(ra * ra, -1) * jnp.sum(rb * rb, -1)))
        return 3.0 * (cos + 1.0 / 3.0) ** 2

    def conf(theta):
        a = jnp.stack([jnp.cos(theta / 2), jnp.sin(theta / 2), 0.0 * theta])
        b = jnp.stack([jnp.cos(theta / 2), -jnp.sin(theta / 2),
                       0.0 * theta])
        return jnp.stack([jnp.zeros_like(a), a, b])

    x_train = jax.vmap(conf)(jnp.linspace(0.6, 2.9, 48))
    keys = jax.random.split(jax.random.PRNGKey(9), 48)
    Rs = jax.vmap(lambda k: jnp.linalg.qr(
        jax.random.normal(k, (3, 3)))[0])(keys)
    x_train = jnp.einsum("bnd,bde->bne", x_train, Rs)
    e_ref = target(x_train)
    f_ref = -jax.vmap(jax.grad(lambda c: target(c[None])[0]))(x_train)
    return [np.asarray(a) for a in (x_train, jnp.ones((3, 1)), e_ref, f_ref)]


def adam_losses(jm, m, data, steps, dtype):
    """``steps`` losses of the fit's optimizer, Adam under cosine decay
    from 5e-3 over 800 steps, through JAX (optax) and the port
    (torch.optim.Adam under the same schedule as a LambdaLR), in
    ``dtype``."""
    jdata = [jnp.asarray(a, dtype) for a in data]
    jm = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), jm)
    opt = optax.adam(optax.cosine_decay_schedule(5e-3, 800))

    @jax.jit
    def jstep(mdl, s):
        lv, g = jax.value_and_grad(lambda mm: jefl(
            mm, *jdata, w_energy=1.0, w_force=0.3))(mdl)
        up, s = opt.update(g, s)
        return optax.apply_updates(mdl, up), s, lv

    state, want = opt.init(jm), []
    for _ in range(steps):
        jm, state, lv = jstep(jm, state)
        want.append(float(lv))
    m = m.to(getattr(torch, np.dtype(dtype).name))
    tdata = [torch.as_tensor(np.array(a)).to(m.e_scale.dtype) for a in data]
    topt = torch.optim.Adam(m.parameters(), lr=5e-3)
    sched = torch.optim.lr_scheduler.LambdaLR(topt, lambda k: 0.5 * (
        1.0 + math.cos(math.pi * min(k, 800) / 800)))
    got = []
    for _ in range(steps):
        loss = energy_force_loss(m, *tdata, w_energy=1.0, w_force=0.3)
        topt.zero_grad()
        loss.backward()
        topt.step()
        sched.step()
        got.append(loss.item())
    return np.array(got), np.array(want)


def test_three_body_fit_first_adam_losses_match_jax():
    """The first 20 Adam losses of tests/test_painn.py's three-body fit
    (its data, model and optimizer).  Adam moves a parameter whose
    gradient is ~1e-9 (many of U's and V's are) by lr g / (|g| + eps), a
    gain of lr / eps = 5e5 on any difference in g: in float32 the
    gradients agree to ~1e-7 and the losses to 1e-5 for two steps only;
    in float64 the relative difference grows about tenfold a step, from
    1e-16 at step 1 to 2e-9 at step 16 and 1e-2 by step 19 (on both
    sides the fit is that sensitive).  So: two float32 losses to 1e-5,
    sixteen float64 losses to 1e-8, all twenty to 0.1, and the loss
    halved by step 20 on both sides."""
    data = three_body_data()
    jm = JPaiNN.create(jax.random.PRNGKey(2), 1, features=24, num_blocks=2,
                       n_rbf=12, cutoff=2.5)
    got, want = adam_losses(jm, from_jax(jm, "cpu"), data, 2, np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    with jax.enable_x64(True):
        got, want = adam_losses(jm, from_jax(jm, "cpu"), data, 20,
                                np.float64)
    np.testing.assert_allclose(got[:16], want[:16], rtol=1e-8)
    np.testing.assert_allclose(got, want, rtol=0.1)
    assert got[-1] < 0.5 * got[0] and want[-1] < 0.5 * want[0]
