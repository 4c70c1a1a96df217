"""The port's L-BFGS polish (``minimize_energy(polish_lbfgs=)``) against
the JAX package's optax ``lbfgs()`` on the CPU.

Both start from the same clipped-Adam output (the JAX package's, handed
across), so the iterates compare step for step; then the LJ7 funnel
golden of tests/test_potentials.py::TestLBFGSPolish holds for the port
alone, and a configuration already at a minimum stays where it is.
float32 throughout; tolerances stated with each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vaemolsim_tpu import potentials as jpot
from vaemolsim_tpu_torch import potentials as tpot

torch.set_num_threads(1)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def lj7_start(n_cfg):
    return np.asarray(0.9 * jax.random.normal(jax.random.PRNGKey(0),
                                              (n_cfg, 7, 3)))


def test_polish_iterates_match_jax():
    """Polish steps 1..5 from JAX's 200-step Adam output on 6 LJ7
    clusters: every iterate equal to optax's to 1e-4."""
    jl = jpot.lennard_jones()
    tl = tpot.lennard_jones(device="cpu")
    x_adam = jpot.minimize_energy(jl, jnp.asarray(lj7_start(6)), steps=200,
                                  lr=0.02)
    for k in range(1, 6):
        want = jpot.minimize_energy(jl, x_adam, steps=0, polish_lbfgs=k)
        got = tpot.minimize_energy(tl, t(x_adam), steps=0, polish_lbfgs=k)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=0)


def test_polish_lj7_funnel_golden():
    """LJ7, 16 configurations, steps=200, lr=0.02, polish_lbfgs=40: the
    best energy within 1e-3 of -16.505384, a mean gain over Adam of more
    than 1.0, and a gradient below 1e-2 for at least 12 of 16."""
    tl = tpot.lennard_jones(device="cpu")
    x0 = t(lj7_start(16))
    e_adam = tl(tpot.minimize_energy(tl, x0, steps=200, lr=0.02))
    x_pol = tpot.minimize_energy(tl, x0, steps=200, lr=0.02,
                                 polish_lbfgs=40)
    e_pol = tl(x_pol)
    assert abs(float(e_pol.min()) + 16.505384) < 1e-3
    assert float(e_pol.mean()) < float(e_adam.mean()) - 1.0
    xg = x_pol.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(tl(xg).sum(), xg)
    per_cfg = g.abs().amax((1, 2))
    assert int((per_cfg < 1e-2).sum()) >= 12, per_cfg


def test_polish_leaves_a_converged_configuration():
    """A quadratic bowl's exact minimum (zero gradient) beside a displaced
    configuration, 12 polish steps: the minimum does not move (its search
    ends at once and is masked thereafter), the other converges onto
    it, and both equal optax's to 1e-6."""
    c = np.array([[0.5, -0.25, 1.0]] * 3, np.float32)
    w = np.array([1.0, 2.0, 3.0], np.float32)

    def tbowl(x):
        return ((x - t(c)) ** 2 * t(w)).sum((-2, -1))

    def jbowl(x):
        return jnp.sum((x - c) ** 2 * w, axis=(-2, -1))

    x = np.stack([c, c + 0.3])
    out = tpot.minimize_energy(tbowl, t(x), steps=0, polish_lbfgs=12)
    want = jpot.minimize_energy(jbowl, jnp.asarray(x), steps=0,
                                polish_lbfgs=12)
    assert torch.equal(out[0], t(c))
    torch.testing.assert_close(out[1], t(c), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-6)
