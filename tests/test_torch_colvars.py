"""The port's collective variables against the JAX package's on the CPU:
every factory's value and ``cv_gradient`` to 1e-5 on random batched
configurations (numpy seed), with and without a box and with weighted
groups, and ``coordination_number`` at u = 1 - 1e-5, 1, 1 + 1e-5, 1 +
2e-4 and far away, with finite gradients there.  float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import colvars as jcv
from vaemolsim_tpu_torch import colvars as cv


def configs(seed, n=6, b=3):
    return (np.random.default_rng(seed).normal(size=(b, n, 3)) * 1.3
            ).astype(np.float32)


W = [1.0, 2.0, 0.5]
BOX = [2.5, 3.0, 2.0]

CASES = {
    "distance": lambda m: m.distance(0, 3),
    "distance_box": lambda m: m.distance(1, 4, box=BOX),
    "distance_groups": lambda m: m.distance([0, 1, 2], [3, 4], weights_i=W,
                                            weights_j=[1.0, 3.0]),
    "angle": lambda m: m.angle(0, 1, 2),
    "torsion": lambda m: m.torsion(0, 1, 2, 3),
    "projection": lambda m: m.projection([1, 2, 5], axis=(1.0, -2.0, 0.5),
                                         weights=W),
    "gyration": lambda m: m.gyration_radius(),
    "gyration_weighted": lambda m: m.gyration_radius([0, 2, 4],
                                                     weights=W),
    "coordination": lambda m: m.coordination_number([0, 1, 2], [1, 3, 4, 5],
                                                    r0=1.5),
    "coordination_box": lambda m: m.coordination_number(
        [0, 1], [2, 3, 4], r0=1.2, n=8, m=14, box=BOX, d0=0.1),
    "rmsd": lambda m: m.rmsd_to(configs(9, b=1)[0], weights=[1, 2, 1, 1, 3,
                                                             1]),
    "combination": lambda m: m.linear_combination(
        [m.distance(0, 1), m.torsion(2, 3, 4, 5)], [1.0, -0.5]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cv_value_and_gradient_match_jax(name):
    x = configs(1)
    s, g = cv.cv_gradient(CASES[name](cv))(torch.tensor(x))
    js, jg = jcv.cv_gradient(CASES[name](jcv))(jnp.asarray(x))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5,
                               rtol=1e-5)
    assert s.shape == (3,)


def test_torsion_sign_is_the_dihedral_convention():
    x = configs(2)
    got = cv.torsion(0, 1, 2, 3)(torch.tensor(x))
    from vaemolsim_tpu_torch.coords import dihedrals
    torch.testing.assert_close(got, dihedrals(torch.tensor(x),
                                              [[0, 1, 2, 3]])[..., 0])


@pytest.mark.parametrize("u", [1.0 - 1e-5, 1.0, 1.0 + 1e-5, 1.0 + 2e-4,
                               3.0])
def test_coordination_number_at_the_removable_singularity(u):
    r0, d0 = 1.5, 0.2
    x = np.zeros((1, 2, 3), np.float32)
    x[0, 1, 0] = d0 + u * r0
    f = lambda m: m.coordination_number([0], [1], r0=r0, d0=d0)  # noqa
    s, g = cv.cv_gradient(f(cv))(torch.tensor(x))
    js, jg = jcv.cv_gradient(f(jcv))(jnp.asarray(x))
    assert torch.isfinite(s).all() and torch.isfinite(g).all()
    if 1e-4 <= abs(u - 1.0) < 1e-2:
        # Just past the switch the far branch divides two float32
        # differences of ~1e-3: a rounding of u^n moves s by ~eps / 1e-3
        # ~ 1e-4, and its slope by ~10%, in both packages (their powers
        # round differently); the exact slope there is 1 / r0 * 1.5.
        np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-4)
        np.testing.assert_allclose(g[0, 0, 0].item(), 1.5 / r0, rtol=0.1)
    else:
        np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5)
    if u < 2:
        np.testing.assert_allclose(s.numpy(), [0.5], atol=2e-3)


def test_self_pairs_are_excluded_and_lengths_checked():
    x = torch.tensor(configs(3))
    same = cv.coordination_number([0, 1], [0, 1], r0=1.0)(x)
    cross = cv.coordination_number([0], [1], r0=1.0)(x)
    torch.testing.assert_close(same, 2 * cross)
    with pytest.raises(ValueError, match="coefficients"):
        cv.linear_combination([cv.distance(0, 1)], [1.0, 2.0])
