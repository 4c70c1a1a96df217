"""The port's minimum-energy paths against the JAX package's on the CPU,
on example 32's Muller-Brown surface: ``climbing_neb`` and
``string_method`` for 200 steps (path, energies and the saddle to 1e-4;
the NEB's ``f_max``, a small difference of large forces, to 1e-2);
``_reparametrize`` and the ``jnp.interp`` rule under it (points outside
the range included) to 1e-5; ``harmonic_tst_rate`` at the minimum and
the NEB saddle to 1e-4 relative, and NaN at a point that is not a saddle.
float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import paths as jpaths
from vaemolsim_tpu_torch import paths

A = [-200.0, -100.0, -170.0, 15.0]
a_ = [-1.0, -1.0, -6.5, 0.7]
b_ = [0.0, 0.0, 11.0, 0.6]
c_ = [-10.0, -10.0, -6.5, 0.7]
X0 = [1.0, 0.0, -0.5, -1.0]
Y0 = [0.0, 0.5, 1.5, 1.0]
MIN_A = np.array([[-0.55822363, 1.44172584]], np.float32)
MIN_C = np.array([[0.62349942, 0.02803776]], np.float32)


def mb(conf):
    """Muller-Brown, (..., 1, 2) -> (...,), in either package."""
    lib = torch if isinstance(conf, torch.Tensor) else jnp
    c = [lib.asarray(np.array(v, np.float32)) for v in (A, a_, b_, c_, X0,
                                                        Y0)]
    dx = conf[..., 0, 0][..., None] - c[4]
    dy = conf[..., 0, 1][..., None] - c[5]
    return (c[0] * lib.exp(c[1] * dx * dx + c[2] * dx * dy
                           + c[3] * dy * dy)).sum(-1)


def close(a, b, tol):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=tol,
                               rtol=tol)


def start(n=12):
    return (paths.interpolate_path(torch.tensor(MIN_A), torch.tensor(MIN_C),
                                   n),
            jpaths.interpolate_path(jnp.asarray(MIN_A), jnp.asarray(MIN_C),
                                    n))


def test_interpolate_path_matches_jax():
    got, want = start(9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_climbing_neb_matches_jax():
    p0, jp0 = start()
    kw = dict(n_steps=200, k_spring=50.0, dt=0.002, climb_after=60)
    got = paths.climbing_neb(mb, p0, **kw)
    want = jpaths.climbing_neb(mb, jp0, **kw)
    close(got.path, want.path, 1e-4)
    close(got.energies, want.energies, 1e-4)
    # f_max is a small difference of forces of order 100 whose slope is
    # the surface's curvature (up to ~3000): paths equal to ~3e-6 give
    # f_max equal to ~1e-2.
    np.testing.assert_allclose(float(got.f_max), float(want.f_max),
                               atol=1e-2)
    close(got.saddle, want.saddle, 1e-4)
    close(got.barrier, want.barrier, 1e-4)


def test_string_method_matches_jax():
    p0, jp0 = start()
    got = paths.string_method(mb, p0, n_steps=200, step_size=2e-4)
    want = jpaths.string_method(mb, jp0, n_steps=200, step_size=2e-4)
    close(got.path, want.path, 1e-4)
    close(got.energies, want.energies, 1e-4)
    close(got.f_max, want.f_max, 1e-3)


def test_reparametrize_and_interp_match_jax():
    rng = np.random.default_rng(0)
    path = np.cumsum(rng.uniform(0.05, 0.5, (10, 2, 3)), 0).astype(
        np.float32)
    close(paths._reparametrize(torch.tensor(path)),
          jpaths._reparametrize(jnp.asarray(path)), 1e-5)
    xp = np.cumsum(rng.uniform(0.1, 1.0, 8)).astype(np.float32)
    fp = rng.normal(size=(8, 3)).astype(np.float32)
    x = np.concatenate([[xp[0] - 1.0, xp[-1] + 2.0], xp[[0, 3, 7]],
                        rng.uniform(xp[0], xp[-1], 20)]).astype(np.float32)
    got = paths._interp_columns(torch.tensor(x), torch.tensor(xp),
                                torch.tensor(fp))
    want = np.stack([np.asarray(jnp.interp(x, xp, fp[:, c]))
                     for c in range(3)], -1)
    close(got, want, 1e-5)


def test_harmonic_tst_rate_matches_jax_and_is_nan_off_a_saddle():
    saddle = np.array([[-0.82200156, 0.6243128]], np.float32)
    got = paths.harmonic_tst_rate(mb, torch.tensor(MIN_A),
                                  torch.tensor(saddle), kt=7.0)
    want = jpaths.harmonic_tst_rate(mb, jnp.asarray(MIN_A),
                                    jnp.asarray(saddle), kt=7.0)
    assert np.isfinite(float(want))
    close(got, want, 1e-4)
    bad = paths.harmonic_tst_rate(mb, torch.tensor(MIN_A),
                                  torch.tensor(MIN_C), kt=7.0)
    assert torch.isnan(bad)
    with pytest.raises(ValueError, match="n_images"):
        paths.climbing_neb(mb, torch.zeros(2, 1, 2), n_steps=1)
