"""The port's OPES against the JAX package's on the CPU: the estimate's
value and derivative (exactly 0 before the first deposit) and
``opes_deposit`` on bounded and periodic grids to 1e-5 (tables relative
to their largest entry); ``opes_baoab`` for
200 steps on the double well of ``tests/test_opes.py`` with JAX's own
normals handed in: positions, the estimate and the CV trajectory to 1e-4;
``free_energy_from_opes`` on a JAX-filled estimate carried over by
``from_jax``, to 1e-5.  Inputs from numpy; float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import opes as jopes
from vaemolsim_tpu_torch import opes
from vaemolsim_tpu_torch.convert import from_jax

from test_torch_metadynamics import (close, close_tables, cv, double_well,
                                     jax_draws, t)


def filled(periodic, seed=0):
    rng = np.random.default_rng(seed)
    lo, hi = (-np.pi, np.pi) if periodic else (-1.8, 1.8)
    g = jopes.opes_grid(lo, hi, 61, barrier=8.0, gamma=10.0, kT=1.1,
                        periodic=periodic)
    for _ in range(3):
        g = jopes.opes_deposit(g, jnp.asarray(rng.uniform(lo, hi, 6),
                                              jnp.float32), sigma=0.2)
    return g, from_jax(g, "cpu")


@pytest.mark.parametrize("periodic", [False, True])
def test_estimate_functions_match_jax(periodic):
    jg, g = filled(periodic)
    assert isinstance(g, opes.OPESBias) and g.barrier == 8.0
    s = np.random.default_rng(1).uniform(-2.5, 2.5, (2, 9)).astype(
        np.float32)
    close(opes.opes_bias_value(g, t(s)),
          jopes.opes_bias_value(jg, jnp.asarray(s)))
    close(opes.opes_bias_derivative(g, t(s)),
          jopes.opes_bias_derivative(jg, jnp.asarray(s)))
    got = opes.opes_deposit(g, t(s), sigma=0.15)
    want = jopes.opes_deposit(jg, jnp.asarray(s), sigma=0.15)
    close_tables(got.prob, want.prob)
    close_tables(got.dprob, want.dprob)
    close(got.sum_w, want.sum_w)


def test_zero_bias_before_the_first_deposit():
    g = opes.opes_grid(-2.0, 2.0, 61, barrier=10.0, device="cpu")
    s = torch.tensor([-1.0, 0.0, 1.5])
    assert torch.equal(opes.opes_bias_value(g, s), torch.zeros(3))
    assert torch.equal(opes.opes_bias_derivative(g, s), torch.zeros(3))
    with pytest.raises(ValueError, match="barrier"):
        opes.opes_grid(-1, 1, 5, barrier=0.0, device="cpu")


def test_opes_baoab_matches_jax_with_its_draws():
    rng = np.random.default_rng(2)
    x0 = (-1.0 + 0.05 * rng.normal(size=(4, 1, 1))).astype(np.float32)
    n_steps, every = 200, 20
    kw = dict(dt=0.01, n_steps=n_steps, deposit_every=every, sigma=0.12,
              friction=2.0)
    key = jax.random.PRNGKey(5)
    jst, jg, jcvs = jax.jit(lambda x, k: jopes.opes_baoab(
        double_well, cv, x, jnp.zeros_like(x), k,
        grid=jopes.opes_grid(-1.8, 1.8, 121, barrier=12.0, gamma=10.0),
        **kw))(jnp.asarray(x0), key)
    st, g, cvs = opes.opes_baoab(
        double_well, cv, t(x0), torch.zeros(4, 1, 1), None,
        grid=opes.opes_grid(-1.8, 1.8, 121, barrier=12.0, gamma=10.0,
                            device="cpu"),
        noise=t(jax_draws(key, n_steps, x0.shape)), **kw)
    for a, b in ((st.x, jst.x), (st.v, jst.v), (g.prob, jg.prob),
                 (g.dprob, jg.dprob), (g.sum_w, jg.sum_w), (cvs, jcvs)):
        close(a, b, 1e-4)


def test_free_energy_from_opes_on_a_jax_estimate():
    jg, g = filled(False, seed=3)
    s, f = opes.free_energy_from_opes(g)
    js, jf = jopes.free_energy_from_opes(jg)
    close(s, js)
    close(f, jf, 1e-4)
