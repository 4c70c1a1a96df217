"""The port's eABF and CZAR against the JAX package's on the CPU:
``eabf_baoab`` for 200 steps on the 6 kT double well of
``tests/test_abf.py`` (bounded grid) and on a periodic CV, with JAX's own
normals handed in (each step's key split into the x and lam draws as the
JAX step splits it): positions, lam, the four tables and the collected
(s, lam) trajectory to 1e-4 (counts exactly); ``abf_free_energy`` and
``czar_free_energy`` on JAX-filled tables carried over by ``from_jax``,
to 1e-5.  Inputs from numpy; float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import abf as jabf
from vaemolsim_tpu_torch import abf
from vaemolsim_tpu_torch.convert import from_jax

from test_torch_metadynamics import close, t


def dw(x):
    s = x[..., 0, 0]
    return 6.0 * (s ** 2 - 1.0) ** 2


def cos3(x):
    return 1.5 * torch.cos(3.0 * x[..., 0, 0]) if isinstance(
        x, torch.Tensor) else 1.5 * jnp.cos(3.0 * x[..., 0, 0])


def cv(x):
    return x[..., 0, 0]


def jax_draws(key, n_steps, x_shape, lam_shape):
    """eabf_baoab's normals: a key a step, split into (for x, for lam)."""
    keys = jax.random.split(key, n_steps)

    def one(k):
        kx, kl = jax.random.split(k)
        return jax.random.normal(kx, x_shape), jax.random.normal(kl,
                                                                 lam_shape)

    nx, nl = jax.vmap(one)(keys)
    return t(nx), t(nl)


CASES = {"double_well": (dw, (-1.6, 1.6, 33, False), -1.0),
         "periodic": (cos3, (-np.pi, np.pi, 24, True), 3.0)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_eabf_baoab_matches_jax_with_its_draws(name):
    pot, (lo, hi, n, periodic), start = CASES[name]
    rng = np.random.default_rng(6)
    x0 = (start + 0.05 * rng.normal(size=(5, 1, 1))).astype(np.float32)
    kw = dict(dt=0.01, n_steps=200, kappa=200.0, kT=1.0, friction=2.0,
              friction_lam=3.0, lam_mass=2.0, ramp_count=50.0,
              collect_every=40)
    key = jax.random.PRNGKey(7)
    jst, jlam, jtbl, jtraj = jax.jit(lambda x, k: jabf.eabf_baoab(
        pot, cv, x, jnp.zeros_like(x), k,
        grid=jabf.abf_grid(lo, hi, n, periodic=periodic), **kw))(
            jnp.asarray(x0), key)
    st, lam, tbl, traj = abf.eabf_baoab(
        pot, cv, t(x0), torch.zeros(5, 1, 1), None,
        grid=abf.abf_grid(lo, hi, n, periodic=periodic, device="cpu"),
        noise=jax_draws(key, 200, x0.shape, (5,)), **kw)
    assert traj.shape == (5, 2, 5)
    for a, b in ((st.x, jst.x), (st.v, jst.v), (lam, jlam),
                 (tbl.f_sum, jtbl.f_sum), (tbl.delta_sum, jtbl.delta_sum),
                 (traj, jtraj)):
        close(a, b, 1e-4)
    for a, b in ((tbl.count, jtbl.count), (tbl.s_count, jtbl.s_count)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("periodic", [False, True])
def test_free_energies_on_jax_tables(periodic):
    lo, hi = (-np.pi, np.pi) if periodic else (-1.6, 1.6)
    x0 = jnp.asarray(np.linspace(lo + 0.3, hi - 0.3, 8,
                                 dtype=np.float32))[:, None, None]
    _, _, jtbl, _ = jabf.eabf_baoab(
        lambda x: 0.5 * jnp.sum(x ** 2, axis=(-1, -2)), cv, x0,
        jnp.zeros_like(x0), jax.random.PRNGKey(8), dt=0.02, n_steps=300,
        grid=jabf.abf_grid(lo, hi, 20, periodic=periodic), kappa=60.0)
    tbl = from_jax(jtbl, "cpu")
    assert isinstance(tbl, abf.ABFState) and tbl.n_bins == 20
    for got, want in ((abf.abf_free_energy(tbl), jabf.abf_free_energy(jtbl)),
                      (abf.czar_free_energy(tbl, kappa=60.0, min_count=3.0),
                       jabf.czar_free_energy(jtbl, kappa=60.0,
                                             min_count=3.0))):
        close(got[0], want[0])
        close(got[1], want[1])
