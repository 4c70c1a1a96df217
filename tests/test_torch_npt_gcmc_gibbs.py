"""The port's NPT, grand-canonical and Gibbs-ensemble Monte Carlo against
the JAX package, on the CPU.

Each sweep's draws are split from a JAX key exactly as the JAX step
splits it and handed to the port's ``step.move``, so both packages make
the same proposals and the acceptance rules, slot bookkeeping and counts
are compared sweep for sweep (coordinates to 1e-5, masks and counts
exactly).  Inputs come from ``numpy.random.default_rng``; float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import potentials as jp
from vaemolsim_tpu.mcmc import gcmc as jg
from vaemolsim_tpu.mcmc import gibbs as jgb
from vaemolsim_tpu.mcmc import npt as jn
from vaemolsim_tpu.mcmc.engine import log_uniform as jlog_uniform
from vaemolsim_tpu_torch import potentials as tp
from vaemolsim_tpu_torch.mcmc import gcmc, gibbs, npt

torch.set_num_threads(1)


def t(a):
    return torch.as_tensor(np.array(a))


def count(c):
    """A JAX two-word counter as an int."""
    return int(c.lo) + (int(c.hi) << 30)


def lattice(chains, per_side, spacing, seed):
    g = np.stack(np.meshgrid(*[np.arange(per_side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    rng = np.random.default_rng(seed)
    return (spacing * (g + 0.5) + 0.05 * rng.normal(
        size=(chains,) + g.shape)).astype(np.float32)


# --------------------------------------------------------------------- NPT

def npt_draws(key, x, e, box, n_disp, anisotropic):
    key, k_vol = jax.random.split(key)
    disp = []
    for _ in range(n_disp):
        key, k1, k2 = jax.random.split(key, 3)
        disp.append((t(jax.random.normal(k1, x.shape, x.dtype)),
                     t(jlog_uniform(k2, e.shape, e.dtype))))
    k3, k4 = jax.random.split(k_vol)
    vol = jax.random.normal(k3, box.shape if anisotropic else e.shape,
                            x.dtype)
    return dict(disp=disp, vol=t(vol), vol_logu=t(jlog_uniform(
        k4, e.shape, e.dtype)))


@pytest.mark.parametrize("anisotropic", [False, True])
def test_npt_sweeps_match_jax(anisotropic):
    """Four sweeps (two displacement trials each) of 6 chains of 8 LJ
    atoms at P = 2 with a min_box wall: coordinates, boxes and energies
    to 1e-5, the four counts exactly."""
    x = lattice(6, 2, 1.6, 0)
    kw = dict(pressure=2.0, beta=1.0, dx_scale=0.08, dlnv_scale=0.06,
              n_disp=2, min_box=3.0, anisotropic=anisotropic)

    def tfac(b):
        return tp.lennard_jones(box=b, cutoff=1.5, device="cpu")

    def jfac(b):
        return jp.lennard_jones(box=b, cutoff=1.5)

    step = npt.make_npt_step(tfac, **kw)
    jstep = jn.make_npt_step(jfac, **kw)
    key = jax.random.PRNGKey(4)
    js = jn.npt_init(jfac, jnp.asarray(x), [3.2] * 3, key)
    s = npt.npt_init(tfac, t(x), [3.2] * 3, torch.Generator())
    for _ in range(4):
        noise = npt_draws(js.key, js.x, js.energy, js.box, 2, anisotropic)
        with torch.no_grad():
            s = step.move(s, noise)
        js = jstep(js)
        np.testing.assert_allclose(s.x.numpy(), np.asarray(js.x), atol=1e-5)
        np.testing.assert_allclose(s.box.numpy(), np.asarray(js.box),
                                   rtol=1e-6)
        np.testing.assert_allclose(s.energy.numpy(), np.asarray(js.energy),
                                   rtol=1e-5, atol=1e-5)
    assert [int(s.disp_trials), int(s.disp_acc), int(s.vol_trials),
            int(s.vol_acc)] == [count(js.disp_trials), count(js.disp_acc),
                                count(js.vol_trials), count(js.vol_acc)]
    assert 0 < int(s.vol_acc) < int(s.vol_trials)


def test_run_npt_collects_finite_states():
    """``run_npt`` over 20 sweeps, collecting every 5th: shapes (4, ...),
    finite energies, counts in range, the wall respected."""
    def fac(b):
        return tp.lennard_jones(box=b, cutoff=1.5, device="cpu")

    step = npt.make_npt_step(fac, pressure=1.0, min_box=3.0)
    s = npt.npt_init(fac, t(lattice(3, 2, 1.6, 1)), [3.2] * 3,
                     torch.Generator().manual_seed(0))
    s, (xs, boxes) = npt.run_npt(step, s, 20, collect_every=5)
    assert xs.shape == (4, 3, 8, 3) and boxes.shape == (4, 3, 3)
    assert bool(torch.isfinite(s.energy).all())
    assert 0 <= int(s.vol_acc) <= int(s.vol_trials) == 60
    assert float(boxes.min()) >= 3.0


# -------------------------------------------------------------------- GCMC

def gcmc_draws(key, active, n_disp, dim):
    chains = active.shape[:-1]
    disp = []
    for _ in range(n_disp):
        key, k_pick, k_move, k_mh = jax.random.split(key, 4)
        disp.append((t(jax.random.gumbel(k_pick, active.shape, jnp.float32)),
                     t(jax.random.normal(k_move, chains + (dim,))),
                     t(jlog_uniform(k_mh, chains, jnp.float32))))
    key, k_which, k_pos, k_pick, k_mh = jax.random.split(key, 5)
    return dict(disp=disp,
                insert=t(jax.random.bernoulli(k_which, 0.5, chains)),
                pos=t(jax.random.uniform(k_pos, chains + (dim,))),
                pick=t(jax.random.gumbel(k_pick, active.shape, jnp.float32)),
                logu=t(jlog_uniform(k_mh, chains, jnp.float32)))


def test_gcmc_sweeps_match_jax():
    """Six sweeps of 8 chains (capacity 12, 4 to 9 active) at per-chain
    chemical potentials: slot coordinates to 1e-5, active masks and the
    six counts exactly; ``total_energy`` to 1e-5."""
    rng = np.random.default_rng(2)
    x = (rng.random((8, 12, 3)) * 4.0).astype(np.float32)
    active = np.arange(12)[None, :] < rng.integers(4, 10, size=(8, 1))
    mu = np.linspace(-3.0, 1.0, 8).astype(np.float32)
    u = gcmc.lj_pair_u(cutoff=1.8)
    ju = jg.lj_pair_u(cutoff=1.8)
    kw = dict(box=[4.0] * 3, beta=1.2, dx_scale=0.2, n_disp=2)
    step = gcmc.make_gcmc_step(u, mu=t(mu), **kw)
    jstep = jg.make_gcmc_step(ju, mu=jnp.asarray(mu), **kw)
    js = jg.gcmc_init(jnp.asarray(x), jnp.asarray(active),
                      jax.random.PRNGKey(5))
    s = gcmc.gcmc_init(t(x), t(active), torch.Generator())
    for _ in range(6):
        noise = gcmc_draws(js.key, js.active, 2, 3)
        with torch.no_grad():
            s = step.move(s, noise)
        js = jstep(js)
        np.testing.assert_array_equal(s.active.numpy(),
                                      np.asarray(js.active))
        np.testing.assert_allclose(s.x.numpy(), np.asarray(js.x), atol=1e-5)
    assert [int(getattr(s, f)) for f in (
        "disp_trials", "disp_acc", "ins_trials", "ins_acc", "del_trials",
        "del_acc")] == [count(getattr(js, f)) for f in (
            "disp_trials", "disp_acc", "ins_trials", "ins_acc",
            "del_trials", "del_acc")]
    np.testing.assert_allclose(
        gcmc.total_energy(s, u, [4.0] * 3).numpy(),
        np.asarray(jg.total_energy(js, ju, [4.0] * 3)), rtol=1e-5, atol=1e-5)


def test_gcmc_slot_bookkeeping():
    """An insertion that must be accepted (an empty box, mu = 10) writes
    the first free slot of each chain; a deletion that must be accepted
    clears exactly the slot the Gumbel draw picks, and nothing else."""
    active = torch.tensor([[True, False, True, False],
                           [False, False, False, False],
                           [True, True, True, False]])
    x = torch.zeros(3, 4, 3)
    u = gcmc.lj_pair_u(sigma=0.01, cutoff=0.02)
    step = gcmc.make_gcmc_step(u, box=[5.0] * 3, mu=10.0, n_disp=0)
    s = gcmc.gcmc_init(x, active, torch.Generator())
    pos = torch.full((3, 3), 0.5)
    ins = dict(disp=[], insert=torch.ones(3, dtype=torch.bool), pos=pos,
               pick=torch.zeros(3, 4), logu=torch.full((3,), -1e30))
    s1 = step.move(s, ins)
    assert s1.active.tolist() == [[True, True, True, False],
                                  [True, False, False, False],
                                  [True, True, True, True]]
    assert torch.equal(s1.x[0, 1], torch.full((3,), 2.5))
    assert torch.equal(s1.x[1, 0], torch.full((3,), 2.5))
    pick = torch.tensor([[0.0, 0.0, 5.0, 0.0], [0.0] * 4,
                         [0.0, 9.0, 0.0, 0.0]])
    step = gcmc.make_gcmc_step(u, box=[5.0] * 3, mu=-10.0, n_disp=0)
    dele = dict(ins, insert=torch.zeros(3, dtype=torch.bool), pick=pick)
    s2 = step.move(s, dele)
    assert s2.active.tolist() == [[True, False, False, False],
                                  [False, False, False, False],
                                  [True, False, True, False]]
    assert int(s2.del_acc) == 2 and int(s2.del_trials) == 3


def test_run_gcmc_ideal_gas_counts():
    """An ideal gas (u = 0) at z V = 6: after 400 sweeps of 200 chains
    the mean of N over the last 200 (every 10th) is within 5% of 6 and
    the capacity 30 never binds; counters in range."""
    step = gcmc.make_gcmc_step(lambda r2: 0.0 * r2, box=[2.0] * 3,
                               mu=float(np.log(6.0 / 8.0)), n_disp=1)
    s = gcmc.gcmc_init(torch.zeros(200, 30, 3),
                       torch.zeros(200, 30, dtype=torch.bool),
                       torch.Generator().manual_seed(1))
    s, _ = gcmc.run_gcmc(step, s, 200)
    s, ns = gcmc.run_gcmc(step, s, 200, collect_every=10)
    assert ns.shape == (20, 200)
    assert abs(float(ns.double().mean()) / 6.0 - 1.0) < 0.05
    assert int(ns.max()) < 30
    assert 0 <= int(s.ins_acc) <= int(s.ins_trials)
    assert 0 <= int(s.disp_acc) <= int(s.disp_trials)


# ------------------------------------------------------------------- Gibbs

def gibbs_draws(key, act_a, act_b, n_disp, dim):
    chains = act_a.shape[:-1]

    def box_disp(k, act):
        k_pick, k_move, k_mh = jax.random.split(k, 3)
        return (t(jax.random.gumbel(k_pick, act.shape, jnp.float32)),
                t(jax.random.normal(k_move, chains + (dim,))),
                t(jlog_uniform(k_mh, chains, jnp.float32)))

    disp = []
    for _ in range(n_disp):
        key, ka, kb = jax.random.split(key, 3)
        disp.append((box_disp(ka, act_a), box_disp(kb, act_b)))
    key, k_v, k_vmh = jax.random.split(key, 3)
    key, k_dir, k_pa, k_pb, k_pos, k_xmh = jax.random.split(key, 6)
    return dict(disp=disp, vol=t(jax.random.normal(k_v, chains)),
                vol_logu=t(jlog_uniform(k_vmh, chains, jnp.float32)),
                a_to_b=t(jax.random.bernoulli(k_dir, 0.5, chains)),
                pick_a=t(jax.random.gumbel(k_pa, act_a.shape, jnp.float32)),
                pick_b=t(jax.random.gumbel(k_pb, act_b.shape, jnp.float32)),
                pos=t(jax.random.uniform(k_pos, chains + (dim,))),
                xfer_logu=t(jlog_uniform(k_xmh, chains, jnp.float32)))


def test_gibbs_sweeps_match_jax():
    """Six sweeps of 6 chains (capacity 14 a box): both boxes' slot
    coordinates to 1e-5, masks and edges and the six counts exactly
    (edges to 1e-6)."""
    rng = np.random.default_rng(3)
    x_a = (rng.random((6, 14, 3)) * 3.5).astype(np.float32)
    x_b = (rng.random((6, 14, 3)) * 4.5).astype(np.float32)
    act_a = np.arange(14)[None, :] < rng.integers(5, 10, size=(6, 1))
    act_b = np.arange(14)[None, :] < rng.integers(2, 6, size=(6, 1))
    u = gcmc.lj_pair_u(cutoff=1.6)
    ju = jg.lj_pair_u(cutoff=1.6)
    kw = dict(beta=1.1, dx_scale=0.2, dlnv_scale=0.2, n_disp=2,
              min_box=3.2)
    step = gibbs.make_gibbs_step(u, **kw)
    jstep = jgb.make_gibbs_step(ju, **kw)
    js = jgb.gibbs_init(jnp.asarray(x_a), jnp.asarray(act_a),
                        jnp.asarray(x_b), jnp.asarray(act_b), 3.5, 4.5,
                        jax.random.PRNGKey(6))
    s = gibbs.gibbs_init(t(x_a), t(act_a), t(x_b), t(act_b), 3.5, 4.5,
                         torch.Generator())
    for _ in range(6):
        noise = gibbs_draws(js.key, js.act_a, js.act_b, 2, 3)
        with torch.no_grad():
            s = step.move(s, noise)
        js = jstep(js)
        for f in ("act_a", "act_b"):
            np.testing.assert_array_equal(getattr(s, f).numpy(),
                                          np.asarray(getattr(js, f)))
        for f in ("x_a", "x_b"):
            np.testing.assert_allclose(getattr(s, f).numpy(),
                                       np.asarray(getattr(js, f)),
                                       atol=1e-5)
        for f in ("box_a", "box_b"):
            np.testing.assert_allclose(getattr(s, f).numpy(),
                                       np.asarray(getattr(js, f)),
                                       rtol=1e-6)
    names = ("disp_trials", "disp_acc", "vol_trials", "vol_acc",
             "xfer_trials", "xfer_acc")
    assert [int(getattr(s, f)) for f in names] == [
        count(getattr(js, f)) for f in names]
    assert int(s.xfer_acc) > 0 and int(s.vol_acc) > 0


def test_run_gibbs_conserves_particles_and_volume():
    """``run_gibbs`` over 30 sweeps of 4 chains, collecting every 10th:
    N_A + N_B and V_A + V_B stay fixed, densities finite, shapes (3,
    4)."""
    rng = np.random.default_rng(4)
    x = torch.as_tensor((rng.random((4, 16, 3)) * 4.0).astype(np.float32))
    act = torch.arange(16)[None, :] < 8
    s = gibbs.gibbs_init(x, act.expand(4, 16), x.clone(), act.expand(4, 16),
                         4.0, 4.0, torch.Generator().manual_seed(2))
    step = gibbs.make_gibbs_step(gcmc.lj_pair_u(cutoff=1.6), min_box=3.2,
                                 dlnv_scale=0.1)
    s, (ra, rb) = gibbs.run_gibbs(step, s, 30, collect_every=10)
    assert ra.shape == rb.shape == (3, 4)
    assert (s.n_a + s.n_b).tolist() == [16] * 4
    np.testing.assert_allclose((s.box_a ** 3 + s.box_b ** 3).numpy(),
                               128.0, rtol=1e-5)
    assert bool(torch.isfinite(ra).all() and torch.isfinite(rb).all())
