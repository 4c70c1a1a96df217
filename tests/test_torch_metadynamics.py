"""The port's well-tempered metadynamics against the JAX package's on the
CPU: grid interpolation, bias value and derivative and ``deposit_hills``
on periodic and bounded grids to 1e-5 (tables relative to their largest
entry); ``metad_baoab`` for 200 steps on
the double well with JAX's own normals handed in (split from the key as
the JAX function splits it): positions, velocities, forces, the grid and
the CV trajectory to 1e-4; ``free_energy_from_bias`` on a JAX-filled grid
carried over by ``from_jax``, to 1e-5.  Inputs from numpy; float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import metadynamics as jmtd
from vaemolsim_tpu_torch import metadynamics as mtd
from vaemolsim_tpu_torch.convert import from_jax


def t(a):
    return torch.as_tensor(np.array(a))


def close(a, b, tol=1e-5):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                               atol=tol, rtol=tol)


def close_tables(a, b, tol=1e-5):
    """Grid tables: sums of many weighted Gaussians of both signs, so the
    tolerance is relative to the table's largest entry."""
    b = np.asarray(b)
    np.testing.assert_allclose(a.detach().numpy(), b,
                               atol=tol * max(1.0, np.abs(b).max()))


def double_well(x):
    s = x[..., 0, 0]
    return 8.0 * (s * s - 1.0) ** 2


def cv(x):
    return x[..., 0, 0]


def jax_draws(key, n_steps, shape):
    """metad_baoab's (and opes_baoab's) O-step normals: one key a step."""
    keys = jax.random.split(key, n_steps)
    return np.asarray(jax.vmap(lambda k: jax.random.normal(k, shape))(keys))


GRIDS = {"bounded": (-2.0, 2.0, 41, False),
         "periodic": (-np.pi, np.pi, 64, True)}


def filled(lo, hi, n, periodic, seed=0):
    """A JAX grid with hills deposited at random CVs, and the port's copy."""
    rng = np.random.default_rng(seed)
    g = jmtd.bias_grid(lo, hi, n, periodic=periodic)
    for _ in range(3):
        g = jmtd.deposit_hills(g, jnp.asarray(rng.uniform(lo, hi, 5),
                                              jnp.float32),
                               height=0.7, width=0.3, kT=1.2, gamma=6.0)
    return g, from_jax(g, "cpu")


@pytest.mark.parametrize("kind", sorted(GRIDS))
def test_grid_functions_match_jax(kind):
    lo, hi, n, periodic = GRIDS[kind]
    jg, g = filled(lo, hi, n, periodic)
    assert isinstance(g, mtd.BiasGrid) and g.periodic == periodic
    close(g.v, jg.v)
    close(mtd._grid_points(g), jmtd._grid_points(jg))
    s = np.random.default_rng(1).uniform(lo - 0.7, hi + 0.7, (3, 7)).astype(
        np.float32)
    close(mtd.bias_value(g, t(s)), jmtd.bias_value(jg, jnp.asarray(s)))
    close(mtd.bias_derivative(g, t(s)),
          jmtd.bias_derivative(jg, jnp.asarray(s)))
    got = mtd.deposit_hills(g, t(s), height=t(0.4), width=0.25, kT=0.8,
                            gamma=4.0)
    want = jmtd.deposit_hills(jg, jnp.asarray(s), height=0.4, width=0.25,
                              kT=0.8, gamma=4.0)
    close_tables(got.v, want.v)
    close_tables(got.dv, want.dv)


def test_metad_baoab_matches_jax_with_its_draws():
    rng = np.random.default_rng(2)
    x0 = (-1.0 + 0.05 * rng.normal(size=(4, 1, 1))).astype(np.float32)
    n_steps, every = 200, 20
    kw = dict(dt=0.01, n_steps=n_steps, deposit_every=every,
              hill_height=0.5, hill_width=0.2, kT=1.0, gamma=6.0,
              friction=2.0)
    key = jax.random.PRNGKey(3)
    jst, jg, jcvs = jax.jit(lambda x, k: jmtd.metad_baoab(
        double_well, cv, x, jnp.zeros_like(x), k,
        grid=jmtd.bias_grid(-2.0, 2.0, 61), **kw))(jnp.asarray(x0), key)
    st, g, cvs = mtd.metad_baoab(
        double_well, cv, t(x0), torch.zeros(4, 1, 1), None,
        grid=mtd.bias_grid(-2.0, 2.0, 61, device="cpu"),
        noise=t(jax_draws(key, n_steps, x0.shape)), **kw)
    assert cvs.shape == (n_steps // every, 4)
    for a, b in ((st.x, jst.x), (st.v, jst.v), (st.force, jst.force),
                 (g.v, jg.v), (g.dv, jg.dv), (cvs, jcvs)):
        close(a, b, 1e-4)


def test_free_energy_from_bias_on_a_jax_grid():
    jg, g = filled(-np.pi, np.pi, 64, True, seed=4)
    s, f = mtd.free_energy_from_bias(g, kT=1.2, gamma=6.0)
    js, jf = jmtd.free_energy_from_bias(jg, kT=1.2, gamma=6.0)
    close(s, js)
    close(f, jf)
    assert float(f.min()) == 0.0


def test_deposit_every_must_divide_n_steps():
    x = torch.zeros(2, 1, 1)
    with pytest.raises(ValueError, match="deposit_every"):
        mtd.metad_baoab(double_well, cv, x, x, torch.Generator(), dt=0.01,
                        n_steps=30, deposit_every=7,
                        grid=mtd.bias_grid(-2, 2, 11, device="cpu"),
                        hill_height=0.1, hill_width=0.2)
