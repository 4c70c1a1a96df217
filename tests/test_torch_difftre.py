"""The port's DiffTRe against the JAX package's on the CPU, float32.

- The dense force-field factories take tensor parameters that keep their
  autograd graph: energies and parameter gradients of every repaired
  factory against ``jax.grad`` of the JAX factory, to rtol 1e-5 (atol 1e-5
  of the largest entry); a tensor that needs no gradient gives the float
  parameters' energy bit for bit.
- ``reweighted_observables`` and ``difftre_loss``, values and gradients,
  against JAX to rtol 1e-5, and the fluctuation identity (in float64, to
  rtol 1e-4: the float32 covariance cancels), and the
  reverse-over-forward gradient of a virial-pressure observable of a
  Lennard-Jones fluid (example 31's) to rtol 1e-4.
- ``difftre_fit`` against JAX's with a deterministic ``sample_fn`` (the
  same numpy-made frames each round, the key or generator ignored): the
  fitted parameters to rtol 1e-5, the fresh losses to rtol 1e-4, and the
  ESS at each stop and the inner step counts, for a fit that stops on the
  ESS floor and one that stops at the cap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import difftre as jdifftre
from vaemolsim_tpu import observables as jobs
from vaemolsim_tpu import potentials as jpot
from vaemolsim_tpu_torch import difftre, observables, potentials

torch.set_num_threads(1)

BETA = 1.0


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def close(got, want, rtol=1e-5, atol=0.0, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def lattice(seed, n=8, frames=3, spacing=1.15):
    """``frames`` jittered simple-cubic configurations of n atoms, and the
    box holding them."""
    rng = np.random.default_rng(seed)
    m = int(np.ceil(n ** (1.0 / 3.0)))
    grid = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)[:n] * spacing
    x = grid[None] + 0.12 * rng.normal(size=(frames, n, 3))
    return x.astype(np.float32), np.full(3, m * spacing, np.float32)


# --- the repair: dense factories differentiable in their parameters ----

def _factory_case(name, rng, n):
    """(build(params, module, tensor), params as numpy arrays, extra
    positional argument of the energy) for one dense factory."""
    bonds = np.array([[0, 1], [1, 2], [2, 3], [4, 5]])
    angles = np.array([[0, 1, 2], [1, 2, 3], [3, 4, 5]])
    quads = np.array([[0, 1, 2, 3], [1, 2, 3, 4], [4, 5, 6, 7]])
    u = lambda lo, hi, k: rng.uniform(lo, hi, k).astype(np.float32)
    if name == "lj_scalar":
        return (lambda p, m, box: m.lennard_jones(
            sigma=p[0], epsilon=p[1], box=box, cutoff=1.6),
                [np.float32(0.95), np.float32(1.2)], None)
    if name == "lj_per_atom":
        return (lambda p, m, box: m.lennard_jones(
            sigma=p[0], epsilon=p[1], box=box, cutoff=1.6),
                [u(0.9, 1.1, n), u(0.5, 1.5, n)], None)
    if name == "lj_pair":
        s = u(0.9, 1.1, n * n).reshape(n, n)
        e = u(0.5, 1.5, n * n).reshape(n, n)
        return (lambda p, m, box: m.lennard_jones(
            sigma=p[0], epsilon=p[1], box=box),
                [(s + s.T) / 2, (e + e.T) / 2], None)
    if name == "harmonic_bonds":
        return (lambda p, m, box: m.harmonic_bonds(bonds, k=p[0], r0=p[1]),
                [u(50, 150, 4), u(0.9, 1.3, 4)], None)
    if name == "harmonic_angles":
        return (lambda p, m, box: m.harmonic_angles(angles, k=p[0],
                                                    theta0=p[1]),
                [u(20, 80, 3), u(1.5, 2.2, 3)], None)
    if name == "periodic_torsions":
        return (lambda p, m, box: m.periodic_torsions(quads, k=p[0], n=p[1],
                                                      phase=p[2]),
                [u(0.5, 2.0, 3), np.array([1.0, 2.0, 3.0], np.float32),
                 u(-1.0, 1.0, 3)], None)
    if name == "morse_bonds":
        return (lambda p, m, box: m.morse_bonds(bonds, D=p[0], a=p[1],
                                                r0=p[2]),
                [u(2, 5, 4), u(1, 2, 4), u(0.9, 1.3, 4)], None)
    if name == "harmonic_impropers":
        return (lambda p, m, box: m.harmonic_impropers(quads, k=p[0],
                                                       phi0=p[1]),
                [u(5, 15, 3), u(-0.5, 0.5, 3)], None)
    if name == "lennard_jones_softcore":
        alch = np.zeros(n, bool)
        alch[2] = True
        return (lambda p, m, box: m.lennard_jones_softcore(
            sigma=p[0], epsilon=p[1], alchemical=alch, box=box),
                [u(0.9, 1.1, n), u(0.5, 1.5, n)], 0.6)
    if name == "coulomb":
        q = u(-1, 1, n)
        return (lambda p, m, box: m.coulomb(p[0], box=box, cutoff=1.6),
                [q - q.mean()], None)
    raise ValueError(name)


FACTORIES = ["lj_scalar", "lj_per_atom", "lj_pair", "harmonic_bonds",
             "harmonic_angles", "periodic_torsions", "morse_bonds",
             "harmonic_impropers", "lennard_jones_softcore", "coulomb"]


@pytest.mark.parametrize("name", FACTORIES)
def test_dense_factory_parameter_gradients_match_jax(name):
    x, box = lattice(0)
    n = x.shape[1]
    build, params, extra = _factory_case(name, np.random.default_rng(1), n)
    args = () if extra is None else (extra,)

    def jenergy(ps):
        return jnp.sum(build(ps, jpot, jnp.asarray(box))(jnp.asarray(x),
                                                          *args))

    je, jg = jax.value_and_grad(jenergy)([jnp.asarray(p) for p in params])
    tp = [t(p).requires_grad_(True) for p in params]
    pot = build(tp, _CPU, t(box))
    e = pot(t(x), *args).sum()
    grads = torch.autograd.grad(e, tp)
    close(e, je, msg="energy")
    for g, want in zip(grads, jg):
        close(g, want, atol=1e-5 * float(np.abs(np.asarray(want)).max()),
              msg="parameter gradient")


@pytest.mark.parametrize("name", FACTORIES)
def test_tensor_parameters_give_the_float_parameters_energy(name):
    """A tensor parameter that needs no gradient changes nothing: the
    energy equals the numpy parameters' bit for bit."""
    x, box = lattice(2)
    build, params, extra = _factory_case(name, np.random.default_rng(3),
                                         x.shape[1])
    args = () if extra is None else (extra,)
    want = build(params, _CPU, t(box))
    got = build([t(p) for p in params], _CPU, t(box))
    assert torch.equal(got(t(x), *args), want(t(x), *args))


class _CpuFactories:
    """``potentials``' factories, built on the CPU."""

    def __getattr__(self, name):
        fn = getattr(potentials, name)
        return lambda *a, **kw: fn(*a, device="cpu", **kw)


_CPU = _CpuFactories()


# --- reweighted observables and the loss ---------------------------------

def harmonic_j(params, x):
    return 0.5 * jnp.exp(params) * jnp.sum(x ** 2, axis=-1)


def harmonic_t(params, x):
    return 0.5 * torch.exp(params) * (x ** 2).sum(-1)


def gaussian_frames(k, seed, n=512, d=1):
    rng = np.random.default_rng(seed)
    return (np.sqrt(1.0 / (BETA * k))
            * rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("theta", [0.26, 0.6])
def test_reweighted_estimates_loss_and_gradient_match_jax(theta):
    """At the reference (uniform weights) and away from it: estimates,
    ESS, the weighted loss of a dict of observables (one explicitly
    parameter-dependent, one a vector) and its gradient."""
    x = gaussian_frames(1.3, 0)
    th0 = 0.26
    obs_j = {"o": lambda p, f: jnp.exp(p) * jnp.sum(f ** 2, -1),
             "v": lambda p, f: jnp.concatenate([f, f ** 2], -1)}
    obs_t = {"o": lambda p, f: torch.exp(p) * (f ** 2).sum(-1),
             "v": lambda p, f: torch.cat([f, f ** 2], -1)}
    tgt = {"o": 0.9, "v": np.array([0.1, 0.7], np.float32)}
    wts = {"o": 2.0, "v": 0.5}
    u_ref_j = harmonic_j(jnp.asarray(th0), jnp.asarray(x))
    (jl, (je, jess)), jg = jax.value_and_grad(
        lambda p: jdifftre.difftre_loss(harmonic_j, p, jnp.asarray(x),
                                        u_ref_j, BETA, obs_j, tgt, wts),
        has_aux=True)(jnp.asarray(theta))
    p = torch.tensor(theta, requires_grad=True)
    u_ref = harmonic_t(torch.tensor(th0), t(x))
    loss, (est, ess) = difftre.difftre_loss(harmonic_t, p, t(x), u_ref,
                                            BETA, obs_t, tgt, wts)
    (g,) = torch.autograd.grad(loss, p)
    close(loss, jl, msg="loss")
    close(ess, jess, msg="ess")
    close(est["o"], je["o"], msg="scalar estimate")
    close(est["v"], je["v"], msg="vector estimate")
    close(g, jg, msg="gradient")


def test_gradient_is_the_fluctuation_identity():
    """At params = params_ref, d<O>/dtheta = <dO/dtheta> - beta Cov(O,
    dU/dtheta) on the finite sample, and equals JAX's gradient."""
    x = gaussian_frames(1.3, 2)
    th0 = 0.26
    u_ref = harmonic_t(torch.tensor(th0), t(x))
    p = torch.tensor(th0, requires_grad=True)
    est, _ = difftre.reweighted_observables(
        harmonic_t, p, t(x), u_ref, BETA,
        (lambda q, f: torch.exp(q) * (f ** 2).sum(-1),))
    (got,) = torch.autograd.grad(est[0], p)
    x2 = (x.astype(np.float64) ** 2).sum(-1)
    o, do, du = np.exp(th0) * x2, np.exp(th0) * x2, 0.5 * np.exp(th0) * x2
    want = do.mean() - BETA * ((o * du).mean() - o.mean() * du.mean())
    close(got, want, rtol=1e-4)     # a float32 covariance against float64
    jgot = jax.grad(lambda q: jdifftre.reweighted_observables(
        harmonic_j, q, jnp.asarray(x),
        harmonic_j(jnp.asarray(th0), jnp.asarray(x)), BETA,
        (lambda r, f: jnp.exp(r) * jnp.sum(f ** 2, -1),))[0][0])(
            jnp.asarray(th0))
    close(got, jgot, rtol=1e-5)


def test_static_observable_composes_with_the_estimator():
    x = gaussian_frames(1.0, 4, n=64)
    u_ref = harmonic_t(torch.tensor(0.0), t(x))
    est, ess = difftre.reweighted_observables(
        harmonic_t, torch.tensor(0.0), t(x), u_ref, BETA,
        (difftre.static_observable(lambda f: (f ** 2).sum(-1)),))
    close(est[0], (x ** 2).sum(-1).mean(), rtol=1e-6)
    close(ess, 64.0, rtol=1e-5)


N_LJ, RHO, KT, CUT = 16, 0.65, 0.85, 2.2
L_BOX = (N_LJ / RHO) ** (1.0 / 3.0)


def _lj_pressure_case(x):
    """Example 31's loss on frames ``x``: static RDF-like bins and the
    virial pressure, in both packages."""
    edges = np.linspace(0.0, L_BOX / 2, 9).astype(np.float32)

    def rdf_j(f):
        d = f[..., :, None, :] - f[..., None, :, :]
        d = d - L_BOX * jnp.round(d / L_BOX)
        r = jnp.sqrt(jnp.maximum(jnp.sum(d * d, -1), 1e-12))
        return jnp.sum((r[..., None] >= edges[:-1])
                       & (r[..., None] < edges[1:]), (-3, -2)).astype(
                           jnp.float32) / N_LJ

    def rdf_t(f):
        d = f[..., :, None, :] - f[..., None, :, :]
        d = d - L_BOX * torch.round(d / L_BOX)
        r = torch.sqrt(((d * d).sum(-1)).clamp_min(1e-12))
        e = torch.as_tensor(edges)
        return ((r[..., None] >= e[:-1]) & (r[..., None] < e[1:])).sum(
            (-3, -2)).float() / N_LJ

    def pot_j(p, f):
        return jpot.lennard_jones(sigma=jnp.exp(p["log_sigma"]),
                                  epsilon=jnp.exp(p["log_eps"]),
                                  box=jnp.full((3,), L_BOX), cutoff=CUT)(f)

    def pot_t(p, f):
        return potentials.lennard_jones(
            sigma=torch.exp(p["log_sigma"]), epsilon=torch.exp(p["log_eps"]),
            box=torch.full((3,), L_BOX), cutoff=CUT, device="cpu")(f)

    def press_j(p, f):
        return jobs.virial_pressure(lambda b: jpot.lennard_jones(
            sigma=jnp.exp(p["log_sigma"]), epsilon=jnp.exp(p["log_eps"]),
            box=b, cutoff=CUT), f, box=jnp.full((3,), L_BOX), kt=KT)

    def press_t(p, f):
        return observables.virial_pressure(
            lambda b: potentials.lennard_jones(
                sigma=torch.exp(p["log_sigma"]),
                epsilon=torch.exp(p["log_eps"]), box=b, cutoff=CUT,
                device="cpu"), f, box=torch.full((3,), L_BOX), kt=KT)

    rdf_target = np.linspace(0.0, 1.0, 8).astype(np.float32)
    return ((pot_j, {"rdf": jdifftre.static_observable(rdf_j),
                     "pressure": press_j}),
            (pot_t, {"rdf": difftre.static_observable(rdf_t),
                     "pressure": press_t}),
            {"rdf": rdf_target, "pressure": 0.8})


def test_lj_pressure_loss_gradient_runs_reverse_over_forward():
    """Example 31's loss on 12 jittered LJ frames at parameters off the
    reference: the pressure observable's parameter gradient goes back
    through ``virial_pressure``'s forward-mode derivative; value and
    gradient against JAX."""
    rng = np.random.default_rng(5)
    m = 3
    grid = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)[:N_LJ] * (L_BOX / m)
    x = (grid[None] + 0.1 * rng.normal(size=(12, N_LJ, 3))).astype(
        np.float32)
    (pot_j, obs_j), (pot_t, obs_t), tgt = _lj_pressure_case(x)
    ref = {"log_eps": np.float32(np.log(0.8)),
           "log_sigma": np.float32(np.log(1.05))}
    at = {"log_eps": np.float32(np.log(0.85)),
          "log_sigma": np.float32(np.log(1.03))}
    jref = {k: jnp.asarray(v) for k, v in ref.items()}
    u_ref_j = pot_j(jref, jnp.asarray(x))
    (jl, _), jg = jax.value_and_grad(
        lambda p: jdifftre.difftre_loss(pot_j, p, jnp.asarray(x), u_ref_j,
                                        1.0 / KT, obs_j, tgt),
        has_aux=True)({k: jnp.asarray(v) for k, v in at.items()})
    p = {k: torch.tensor(v, requires_grad=True) for k, v in at.items()}
    with torch.no_grad():
        u_ref = pot_t({k: torch.tensor(v) for k, v in ref.items()}, t(x))
    loss, _ = difftre.difftre_loss(pot_t, p, t(x), u_ref, 1.0 / KT, obs_t,
                                   tgt)
    loss.backward()
    close(loss, jl, rtol=1e-4)
    for k in p:
        close(p[k].grad, jg[k], rtol=1e-4, msg=k)


# --- difftre_fit against JAX's, on the same frames ---------------------

def aniso(params, f, lib):
    k = lib.exp(params["logk"])
    return 0.5 * (k * f ** 2).sum(-1)


FIT_CASES = {
    # A large step and a high floor: every round stops on the ESS floor.
    "ess_floor": dict(n_frames=256, ess_frac=0.9, inner_steps=500, lr=0.3,
                      n_outer=3, target=(0.05, 0.05)),
    # Small steps: every round runs to the cap.
    "cap": dict(n_frames=1024, ess_frac=0.3, inner_steps=12, lr=0.02,
                n_outer=3, target=(0.5, 2.0)),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_difftre_fit_matches_jax_on_the_same_frames(case):
    c = FIT_CASES[case]
    rng = np.random.default_rng(11)
    frames = [(rng.normal(size=(c["n_frames"], 2))
               / np.sqrt([2.0, 0.5]) * (1.0 + 0.1 * r)).astype(np.float32)
              for r in range(c["n_outer"])]

    def sample_j(params, key, state):
        i = 0 if state is None else state + 1
        return jnp.asarray(frames[i]), i

    def sample_t(params, generator, state):
        i = 0 if state is None else state + 1
        return t(frames[i]), i

    target = np.asarray(c["target"], np.float32)
    obs_j = (lambda p, f: f ** 2,
             jdifftre.static_observable(lambda f: jnp.abs(f[:, 0])))
    obs_t = (lambda p, f: f ** 2,
             difftre.static_observable(lambda f: f[:, 0].abs()))
    targets = (target, 0.6)
    jres = jdifftre.difftre_fit(
        lambda p, f: aniso(p, f, jnp), {"logk": jnp.zeros(2)},
        sample_fn=sample_j, observable_fns=obs_j, targets=targets,
        beta=BETA, key=jax.random.PRNGKey(0), n_outer=c["n_outer"],
        inner_steps=c["inner_steps"], ess_frac=c["ess_frac"],
        learning_rate=c["lr"])
    res = difftre.difftre_fit(
        lambda p, f: aniso(p, f, torch), {"logk": torch.zeros(2)},
        sample_fn=sample_t, observable_fns=obs_t, targets=targets,
        beta=BETA, generator=torch.Generator().manual_seed(0),
        n_outer=c["n_outer"], inner_steps=c["inner_steps"],
        ess_frac=c["ess_frac"], learning_rate=c["lr"])
    jh, h = jres.history, res.history
    assert h["inner_steps"] == jh["inner_steps"]
    if case == "ess_floor":
        assert all(s < c["inner_steps"] for s in h["inner_steps"])
        assert all(e < c["ess_frac"] * c["n_frames"] for e in h["ess_end"])
    else:
        assert all(s == c["inner_steps"] for s in h["inner_steps"])
    close(res.params["logk"], jres.params["logk"], rtol=1e-5, atol=1e-6)
    close(np.array(h["loss"]), np.array(jh["loss"]), rtol=1e-4)
    close(np.array(h["ess_end"]), np.array(jh["ess_end"]), rtol=1e-4)
    for e, je in zip(h["estimates"], jh["estimates"]):
        close(e[0], je[0], rtol=1e-5)
        close(e[1], je[1], rtol=1e-5)


def test_difftre_fit_threads_state_detaches_params_and_keeps_adam():
    """``sample_fn`` sees the warm-start state and detached parameters;
    the optimizer factory is called once, so Adam's step count runs on
    across rounds; a static observable fits as its dynamic form does."""
    seen, built = [], []

    def sample_fn(params, generator, state):
        seen.append((state, params.requires_grad))
        x = torch.randn(256, 1, generator=generator) * torch.exp(
            -0.5 * params)
        return x, (0 if state is None else state + 1)

    def adam(ps):
        built.append(torch.optim.Adam(ps, lr=0.05))
        return built[-1]

    def fit(obs):
        return difftre.difftre_fit(
            harmonic_t, torch.tensor(0.0), sample_fn=sample_fn,
            observable_fns={"x2": obs}, targets={"x2": 0.5}, beta=BETA,
            generator=torch.Generator().manual_seed(9), n_outer=3,
            inner_steps=4, optimizer=adam)

    dyn = fit(lambda p, f: (f ** 2).sum(-1))
    assert seen == [(None, False), (0, False), (1, False)]
    assert len(built) == 1
    steps = sum(dyn.history["inner_steps"])
    assert next(iter(built[0].state.values()))["step"] == steps
    sta = fit(difftre.static_observable(lambda f: (f ** 2).sum(-1)))
    close(sta.params, dyn.params.numpy(), rtol=1e-6)
    assert not dyn.params.requires_grad
