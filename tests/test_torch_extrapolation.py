"""The port's thermodynamic extrapolation against the JAX package on the
CPU: Taylor coefficients, extrapolated means and reweighted means (with
their effective sample sizes) at orders 1 and 2, on numpy-made samples;
1e-5 relative to the largest of each set (a higher coefficient is a
difference of float32 moments, so its own digits are fewer)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import extrapolation as jx
from vaemolsim_tpu_torch import extrapolation as tx


def samples(seed, trailing=()):
    rng = np.random.default_rng(seed)
    u = (rng.normal(size=400) * 1.5 - 10.0).astype(np.float32)
    a = (0.3 * u.reshape((-1,) + (1,) * len(trailing))
         + rng.normal(size=(400,) + trailing)).astype(np.float32)
    return a, u


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("trailing", [(), (3,)])
def test_coefficients_and_extrapolation_match_jax(order, trailing):
    a, u = samples(order, trailing)
    want = np.asarray(jx.beta_extrapolation_coefficients(
        jnp.asarray(a), jnp.asarray(u), order))
    np.testing.assert_allclose(
        tx.beta_extrapolation_coefficients(torch.tensor(a), torch.tensor(u),
                                           order).numpy(),
        want, rtol=0, atol=1e-5 * np.abs(want).max())
    betas = [0.9, 1.0, 1.07, 1.2]
    np.testing.assert_allclose(
        tx.beta_extrapolate(torch.tensor(a), torch.tensor(u), 1.0, betas,
                            order).numpy(),
        np.asarray(jx.beta_extrapolate(jnp.asarray(a), jnp.asarray(u), 1.0,
                                       betas, order)), rtol=1e-5, atol=1e-6)
    got = tx.beta_extrapolate(torch.tensor(a), torch.tensor(u), 1.0, 1.1,
                              order)
    assert got.shape == a.shape[1:]


def test_reweighting_matches_jax():
    a, u = samples(5, (2,))
    betas = np.array([0.8, 1.0, 1.3], np.float32)
    est, ess = tx.beta_reweight(torch.tensor(a), torch.tensor(u), 1.0,
                                torch.tensor(betas))
    jest, jess = jx.beta_reweight(jnp.asarray(a), jnp.asarray(u), 1.0,
                                  jnp.asarray(betas))
    np.testing.assert_allclose(est.numpy(), np.asarray(jest), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ess.numpy(), np.asarray(jess), rtol=1e-5)
    e1, s1 = tx.beta_reweight(torch.tensor(a), torch.tensor(u), 1.0, 1.0)
    assert e1.shape == (2,) and abs(float(s1) - 400.0) < 1e-2
