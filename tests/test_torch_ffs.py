"""The port's forward flux sampling against the JAX package's on the CPU,
on numpy-seeded replicas of ``tests/test_ffs.py``'s double well, with
JAX's draws handed in (the step normals of ``split(key, n_steps)`` as
rows, the stage's categorical seed pick): ``basin_flux`` gives the same
crossing count and flux (exactly) and the same stored slots (mask
exactly, phase points to 1e-5); ``ffs_stage`` the same status per trial,
``n_success`` and ``n_unresolved`` (exactly); ``run_ffs``'s dead-ladder
short circuit, its bad-ladder ``ValueError`` and the empty-mask NaN as
JAX's; the slot ring's overflow as ``tests/test_ffs.py`` asserts it (an
exact count, every slot filled).  float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu.mcmc import basin_flux as jbasin_flux
from vaemolsim_tpu.mcmc import ffs_stage as jffs_stage
from vaemolsim_tpu.mcmc import run_ffs as jrun_ffs
from vaemolsim_tpu_torch.mcmc import (FFSResult, basin_flux, ffs_stage,
                                      run_ffs)

H, KT, DT, FRICTION = 2.0, 0.5, 0.01, 1.0


def jdwell(x):
    q = x[..., 0, 0]
    return H * (q * q - 1.0) ** 2


def dwell(x):
    q = x[..., 0, 0]
    return H * (q * q - 1.0) ** 2


def jwell(x):
    return 8.0 * jnp.sum(x * x, axis=(-2, -1))


def well(x):
    return 8.0 * (x * x).sum((-2, -1))


def lam(x):
    return x[..., 0, 0]


def t(a):
    return torch.as_tensor(np.array(a))


def normals(key, n, shape):
    """The normals the JAX scan draws: one ``normal(k, shape)`` per key of
    ``split(key, n)``."""
    keys = jax.random.split(key, n)
    return t(jax.vmap(lambda k: jax.random.normal(k, shape))(keys))


def replicas(r, seed):
    rng = np.random.default_rng(seed)
    x0 = (-1.0 + 0.15 * rng.normal(size=(r, 1, 1))).astype(np.float32)
    v0 = (np.sqrt(KT) * rng.normal(size=(r, 1, 1))).astype(np.float32)
    return x0, v0


def test_basin_flux_matches_jax_with_its_normals():
    r, n_steps, n_store = 48, 600, 64
    x0, v0 = replicas(r, 0)
    key = jax.random.PRNGKey(1)
    kw = dict(lambda0=-0.5, dt=DT, n_steps=n_steps, kT=KT,
              friction=FRICTION, n_store=n_store, lambda_a=-0.7)
    jfr = jax.jit(lambda x, v, k: jbasin_flux(jdwell, lam, x, v, k, **kw))(
        jnp.asarray(x0), jnp.asarray(v0), key)
    fr = basin_flux(dwell, lam, t(x0), t(v0), noise=normals(
        key, n_steps, (r, 1, 1)), **kw)
    n = int(jfr.n_crossings)
    assert 0 < n < n_store, n      # the parity case keeps the ring unwrapped
    assert int(fr.n_crossings) == n and fr.n_crossings.dtype == torch.int32
    assert float(fr.flux) == float(jfr.flux)
    np.testing.assert_array_equal(fr.stored.numpy(), np.asarray(jfr.stored))
    np.testing.assert_allclose(fr.x.numpy(), np.asarray(jfr.x), atol=1e-5)
    np.testing.assert_allclose(fr.v.numpy(), np.asarray(jfr.v), atol=1e-5)
    assert fr.x.shape == (n_store, 1, 1)


def test_slot_ring_overwrites():
    """More crossings than slots, several in one step: an exact count and
    every slot filled (which crosser wins a shared slot is unspecified in
    both packages)."""
    x0 = torch.zeros(256, 1, 1)
    v0 = torch.randn(256, 1, 1, generator=torch.Generator().manual_seed(5))
    fr = basin_flux(lambda x: 0.5 * (x * x).sum((-2, -1)), lam, x0, v0,
                    torch.Generator().manual_seed(6), lambda0=0.2, dt=0.01,
                    n_steps=400, kT=1.0, n_store=16)
    assert int(fr.n_crossings) > 16
    assert bool(fr.stored.all())


@pytest.fixture(scope="module")
def seeds():
    """A JAX flux stage's slots: the seeds of the stage below."""
    x0, v0 = replicas(64, 2)
    fr = jax.jit(lambda x, v, k: jbasin_flux(
        jdwell, lam, x, v, k, lambda0=-0.6, dt=DT, n_steps=800, kT=KT,
        friction=FRICTION, n_store=128))(jnp.asarray(x0), jnp.asarray(v0),
                                         jax.random.PRNGKey(3))
    assert int(fr.n_crossings) > 8
    return fr


def test_ffs_stage_matches_jax_with_its_draws(seeds):
    n_trials, max_steps = 96, 300
    key = jax.random.PRNGKey(4)
    kw = dict(lambda_next=-0.2, lambda_fail=-0.6, dt=DT,
              max_steps=max_steps, kT=KT, friction=FRICTION,
              n_trials=n_trials)
    jres = jax.jit(lambda k: jffs_stage(
        jdwell, lam, seeds.x, seeds.v, seeds.stored, k, **kw))(key)
    kc, kr = jax.random.split(key)
    logits = jnp.where(seeds.stored, 0.0, -jnp.inf)
    pick = t(jax.random.categorical(kc, logits, shape=(n_trials,)))
    res = ffs_stage(dwell, lam, t(seeds.x), t(seeds.v), t(seeds.stored),
                    pick=pick, noise=normals(kr, max_steps,
                                             (n_trials, 1, 1)), **kw)
    np.testing.assert_array_equal(res.success.numpy(),
                                  np.asarray(jres.success))
    assert int(res.n_success) == int(jres.n_success) > 0
    assert int(res.n_unresolved) == int(jres.n_unresolved)
    assert float(res.p) == float(jres.p)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), atol=1e-5)
    # Finished trials froze past their boundary.
    fin = lam(res.x).numpy()
    assert np.all(fin[res.success.numpy()] >= -0.2)


def test_empty_seed_mask_gives_nan():
    x = torch.zeros(8, 1, 1)
    kw = dict(lambda_next=1.0, lambda_fail=-1.0, dt=0.05, max_steps=10,
              kT=1.0, n_trials=16)
    res = ffs_stage(well, lam, x, x, torch.zeros(8, dtype=torch.bool),
                    torch.Generator().manual_seed(0), **kw)
    jres = jffs_stage(jwell, lam, jnp.zeros((8, 1, 1)), jnp.zeros((8, 1, 1)),
                      jnp.zeros(8, bool), jax.random.PRNGKey(0), **kw)
    assert np.isnan(float(res.p)) and np.isnan(float(jres.p))
    assert int(res.n_success) == int(jres.n_success) == 0
    assert not bool(res.success.any())


def test_dead_ladder_and_bad_ladder_match_jax():
    """An unreachable top interface: rate exactly 0, the later stages
    skipped with p = 0 and no NaN, as in JAX."""
    x0 = torch.zeros(32, 1, 1)
    v0 = 0.5 * torch.randn(32, 1, 1, generator=torch.Generator()
                           .manual_seed(18))
    kw = dict(interfaces=[0.3, 50.0, 100.0], dt=0.01, kT=0.5,
              flux_steps=200, max_steps=60, n_trials=32)
    res = run_ffs(well, lam, x0, v0, torch.Generator().manual_seed(19),
                  **kw)
    jres = jrun_ffs(jwell, lam, jnp.asarray(x0.numpy()),
                    jnp.asarray(v0.numpy()), jax.random.PRNGKey(19), **kw)
    assert isinstance(res, FFSResult)
    assert float(res.rate) == float(jres.rate) == 0.0
    assert float(res.p_stages[1]) == float(jres.p_stages[1]) == 0.0
    assert res.p_stages.shape == jres.p_stages.shape == (2,)
    assert torch.isfinite(res.p_stages).all()
    assert res.n_success.dtype == torch.int32
    for interfaces in ([0.5, 0.2], [0.5]):
        with pytest.raises(ValueError, match="increasing"):
            run_ffs(well, lam, x0, x0, torch.Generator(),
                    interfaces=interfaces, dt=0.01, kT=1.0, flux_steps=10,
                    max_steps=10)
        with pytest.raises(ValueError, match="increasing"):
            jrun_ffs(jwell, lam, jnp.zeros((4, 1, 1)), jnp.zeros((4, 1, 1)),
                     jax.random.PRNGKey(0), interfaces=interfaces, dt=0.01,
                     kT=1.0, flux_steps=10, max_steps=10)


def test_run_ffs_ladder_gives_a_rate():
    """The whole ladder on the port's own draws: a positive rate whose
    factors multiply out."""
    x0, v0 = replicas(64, 7)
    res = run_ffs(dwell, lam, t(x0), t(v0), torch.Generator().manual_seed(8),
                  interfaces=[-0.6, -0.2, 0.2], dt=DT, kT=KT,
                  flux_steps=400, max_steps=300, friction=FRICTION,
                  n_trials=64, n_store=64)
    assert float(res.rate) > 0.0
    np.testing.assert_allclose(float(res.rate), float(res.flux) * float(
        res.p_stages.prod()), rtol=1e-6)
