"""The port's CG force matching and relative-entropy fitting against the
JAX package's on the CPU, float32.

- ``force_aggregation_matrix`` exactly and ``map_forces`` to rtol 1e-6.
- ``force_matching_loss`` of a ``convert.from_jax`` SchNet potential, with
  and without a mask, to rtol 1e-5, and its gradient with respect to every
  weight to 1e-4 of the largest entry of that weight's gradient (a second
  derivative through the SchNet filters, summed over frames).
- ``rel_entropy_loss``, its ESS and gradient to rtol 1e-5.
- ``rel_entropy_fit`` against JAX's with a deterministic ``sample_fn``
  (the same numpy-made frames each round): the parameters to rtol 1e-5,
  the chained-gauge loss history and the ESS history to rtol 1e-4, and
  the strict ESS guard: a step under the floor moves neither the
  parameters nor Adam's state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import cg as jcg
from vaemolsim_tpu.nn import SchNetPotential as JSchNetPotential
from vaemolsim_tpu_torch import cg
from vaemolsim_tpu_torch.convert import from_jax

torch.set_num_threads(1)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def close(got, want, rtol=1e-5, atol=0.0, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def test_aggregation_matrix_and_mapped_forces_match_jax():
    nums = [3, 2, 4]
    agg = cg.force_aggregation_matrix(nums, device="cpu")
    jagg = jcg.force_aggregation_matrix(nums)
    assert agg.dtype == torch.float32
    np.testing.assert_array_equal(agg.numpy(), np.asarray(jagg))
    f = np.random.default_rng(0).normal(size=(2, 5, 9, 3)).astype(
        np.float32)
    out = cg.map_forces(agg, t(f))
    assert out.shape == (2, 5, 3, 3)
    close(out, jcg.map_forces(jagg, jnp.asarray(f)), rtol=1e-6, atol=1e-6)


def _schnet(seed=3):
    jm = JSchNetPotential.create(jax.random.PRNGKey(seed), species_dim=1,
                                 features=16, num_blocks=2, n_rbf=8,
                                 cutoff=2.5)
    jm = jm.replace(e_scale=jnp.asarray(1.3))
    return jm, from_jax(jm, "cpu")


def _get(tree, name):
    for part in name.split("."):
        tree = tree[int(part)] if part.isdigit() else getattr(tree, part)
    return tree


@pytest.mark.parametrize("masked", [False, True])
def test_force_matching_loss_and_weight_gradients_match_jax(masked):
    """Six periodic frames of 7 sites against noisy target forces; with a
    mask, the last site is padding and wrong target forces on it change
    nothing."""
    jm, tm = _schnet()
    rng = np.random.default_rng(1)
    box = np.full(3, 3.5, np.float32)
    R = rng.uniform(0.0, 3.5, size=(6, 7, 3)).astype(np.float32)
    f = rng.normal(size=(6, 7, 3)).astype(np.float32)
    sp = np.ones((7, 1), np.float32)
    mask = np.arange(7) < 6 if masked else None
    if masked:
        f_bad = f.copy()
        f_bad[:, 6] += 99.0
    kw_j = dict(box=jnp.asarray(box),
                mask=None if mask is None else jnp.asarray(mask))
    kw_t = dict(box=t(box), mask=None if mask is None else torch.tensor(mask))
    jl, jg = jax.value_and_grad(lambda m: jcg.force_matching_loss(
        m, jnp.asarray(R), jnp.asarray(sp), jnp.asarray(f), **kw_j))(jm)
    loss = cg.force_matching_loss(tm, t(R), t(sp), t(f), **kw_t)
    loss.backward()
    close(loss, jl, msg="loss")
    for name, p in tm.named_parameters():
        want = np.asarray(_get(jg, name))
        # e_ref is linear in the composition, so no force depends on it.
        got = torch.zeros_like(p) if p.grad is None else p.grad
        close(got, want, rtol=1e-4,
              atol=1e-4 * float(np.abs(want).max()), msg=name)
    if masked:
        bad = cg.force_matching_loss(tm, t(R), t(sp), t(f_bad), **kw_t)
        assert torch.equal(bad, loss)
    with torch.no_grad():
        again = cg.force_matching_loss(tm, t(R), t(sp), t(f), **kw_t)
    assert not again.requires_grad
    close(again, jl)


def test_force_matching_loss_is_zero_for_the_model_that_made_the_forces():
    jm, tm = _schnet(0)
    R = t(np.random.default_rng(2).normal(size=(5, 4, 3)))
    sp = torch.ones(4, 1)
    x = R.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(tm(x, sp).sum(), x)
    assert float(cg.force_matching_loss(tm, R, sp, -g).detach()) < 1e-10


# --- relative entropy ---------------------------------------------------

SIGMA_M = 0.7


def quad_j(theta, frames):
    return 0.5 * theta * jnp.sum(frames ** 2, axis=-1)


def quad_t(theta, frames):
    return 0.5 * theta * (frames ** 2).sum(-1)


def normals(seed, n, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=(n, 1))).astype(
        np.float32)


@pytest.mark.parametrize("theta", [1.7, 2.4])
def test_rel_entropy_loss_ess_and_gradient_match_jax(theta):
    """At the reference (theta 1.7: uniform weights, ESS = n) and away
    from it."""
    mapped = normals(0, 4096, SIGMA_M)
    cgf = normals(1, 4096, 1.0 / np.sqrt(1.7))
    u_ref_j = quad_j(jnp.asarray(1.7), jnp.asarray(cgf))
    (jl, jess), jg = jax.value_and_grad(
        lambda q: jcg.rel_entropy_loss(quad_j, q, jnp.asarray(mapped),
                                       jnp.asarray(cgf), u_ref_j, beta=1.0),
        has_aux=True)(jnp.asarray(theta))
    p = torch.tensor(theta, requires_grad=True)
    u_ref = quad_t(torch.tensor(1.7), t(cgf))
    loss, ess = cg.rel_entropy_loss(quad_t, p, t(mapped), t(cgf), u_ref,
                                    beta=1.0)
    (g,) = torch.autograd.grad(loss, p)
    close(loss, jl)
    close(ess, jess)
    close(g, jg)


REL_CASES = {
    # test_cg.py's fit, on fixed frames: no step trips the floor.
    "converging": dict(theta0=0.4, lr=0.05, ess_frac=0.5, inner=40),
    # Large steps: a mid-round step falls under the floor and is dropped.
    "guard_trips": dict(theta0=0.4, lr=0.6, ess_frac=0.8, inner=40),
}


def _rel_fit_pair(c, frames, optimizer=None):
    mapped = normals(5, 2048, SIGMA_M)

    def sample_j(theta, key, state):
        i = 0 if state is None else state + 1
        return jnp.asarray(frames[i]), i

    def sample_t(theta, generator, state):
        i = 0 if state is None else state + 1
        return t(frames[i]), i

    kw = dict(n_outer=len(frames), inner_steps=c["inner"],
              ess_frac=c["ess_frac"], learning_rate=c["lr"])
    jres = jcg.rel_entropy_fit(quad_j, jnp.asarray(c["theta0"]),
                               mapped_frames=jnp.asarray(mapped),
                               sample_fn=sample_j, beta=1.0,
                               key=jax.random.PRNGKey(0), **kw)
    res = cg.rel_entropy_fit(quad_t, torch.tensor(c["theta0"]),
                             mapped_frames=t(mapped), sample_fn=sample_t,
                             beta=1.0, generator=torch.Generator(),
                             optimizer=optimizer, **kw)
    return jres, res


@pytest.mark.parametrize("case", sorted(REL_CASES))
def test_rel_entropy_fit_matches_jax_on_the_same_frames(case):
    c = REL_CASES[case]
    frames = [normals(10 + r, 1024, 1.0 / np.sqrt(c["theta0"] + 0.3 * r))
              for r in range(4)]
    built = []

    def adam(ps):
        built.append(torch.optim.Adam(ps, lr=c["lr"]))
        return built[-1]

    jres, res = _rel_fit_pair(c, frames, adam)
    close(res.params, jres.params, rtol=1e-5)
    close(res.loss_history, jres.loss_history, rtol=1e-4, atol=1e-5)
    close(res.ess_history, jres.ess_history, rtol=1e-4)
    assert res.loss_history.shape == (4,) and len(built) == 1
    floor = c["ess_frac"] * 1024
    tripped = (res.ess_history < floor).numpy()
    assert tripped.any() == (case == "guard_trips")
    applied = next(iter(built[0].state.values()))["step"]
    if case == "converging":
        assert applied == 4 * 40        # 40 steps a round, all applied
    else:
        assert applied < 4 * 40         # the tripping steps were dropped


def test_rel_entropy_fit_discards_a_first_step_under_the_floor():
    """A floor above n: the first step of the first round is under it, so
    nothing moves, neither theta nor Adam's state, and the loop ends after
    that one step; the histories are JAX's."""
    c = dict(theta0=0.4, lr=0.05, ess_frac=1.5, inner=40)
    frames = [normals(20 + r, 512, 1.5) for r in range(2)]
    built = []

    def adam(ps):
        built.append(torch.optim.Adam(ps, lr=c["lr"]))
        return built[-1]

    jres, res = _rel_fit_pair(c, frames, adam)
    assert float(res.params) == float(np.float32(0.4)) == float(jres.params)
    assert len(built) == 1 and not built[0].state
    close(res.loss_history, jres.loss_history, rtol=1e-5, atol=1e-6)
    close(res.ess_history, [512.0, 512.0], rtol=1e-5)
