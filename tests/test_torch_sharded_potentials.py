"""The port's sharded cell grid (``lennard_jones_cell_neighbor(mesh=)``)
and slab-decomposed PME (``pme_coulomb(mesh=)``) against the JAX package.

The rank cases run once, in a module fixture, on 4 gloo ranks spawned by
``tests/torch_ranks.py`` (the "potentials" cases).  The cell grid: a box
of 10 with cutoff 2.5 and skin 0.5 (27 cells, which 4 does not divide),
150 jittered lattice atoms with Lorentz-Berthelot species, Ewald charges
and bonded exclusions (tests/test_torch_cell_lj.py's "all" branch): the
sharded energy and gradient against the unsharded port call (1e-6
relative, 1e-6 of the largest component: the same per-cell sums, added
in another order) and against JAX's unsharded XLA path
(tests/test_torch_cell_lj.py's tolerances, 1e-5).  PME: tests/
test_pme_sharded.py's system (n = 50, exclusions, ``full`` and
``recip_only``, the grid JAX's 8-way mesh chose), energy and forces
against JAX's ``pme_coulomb(mesh=...)`` at that test's tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import potentials as jp
from vaemolsim_tpu.parallel.sharding import make_mesh as jmesh

import torch_ranks

WORLD = 4
L, CUT, SKIN, CAP, N = 10.0, 2.5, 0.5, 32, 150
GEOM = dict(box=[L] * 3, cutoff=CUT, skin=SKIN, capacity=CAP)
BOX = [9.0, 8.0, 10.0]


def cell_system():
    rng = np.random.default_rng(0)
    g = np.stack(np.meshgrid(np.arange(5), np.arange(5), np.arange(6),
                             indexing="ij"), -1).reshape(-1, 3)[:N]
    x = ((g + 0.5) * (L / np.array([5, 5, 6]))
         + 0.2 * rng.normal(size=(N, 3))).astype(np.float32)
    sig = np.where(np.arange(N) % 3 == 0, 0.88, 1.0)
    eps = np.where(sig == 1.0, 1.0, 0.5)
    q = np.tile([0.5, -0.5], N // 2)
    triples = [[3 * k, 3 * k + 1] for k in range(N // 3)] + \
        [[3 * k + 1, 3 * k + 2] for k in range(N // 3)]
    excl = jp.exclusions_from_bonds(N, triples)
    np.fill_diagonal(excl, False)
    kw = dict(sigma=sig, epsilon=eps, charges=q, coulomb_alpha=0.9,
              exclude=excl)
    return x, kw


def pme_system():
    rng = np.random.default_rng(0)
    n = 50
    q = rng.normal(size=n).astype(np.float32)
    q -= q.mean()
    x = (rng.uniform(size=(n, 3)) * np.asarray(BOX)).astype(np.float32)
    excl = np.asarray([[2 * i, 2 * i + 1] for i in range(10)])
    return q, x, excl


@pytest.fixture(scope="module")
def jax_results():
    x, kw = cell_system()
    jb, je = jp.lennard_jones_cell_neighbor(backend="xla", **GEOM, **kw)
    xj = jnp.asarray(x)
    nl = jb(xj)
    e, g = jax.value_and_grad(lambda y: je(nl, y))(xj)
    cell = dict(x=x, kw=kw, e=float(e), grad=np.asarray(g))
    q, xp, excl = pme_system()
    mesh = jmesh({"atoms": len(jax.devices())})
    pme = dict(q=q, x=xp, excl=excl, box=BOX, grid={})
    for name, pkw in (("full", {}),
                      ("recip_only", {"include_real_space": False})):
        e_sh = jp.pme_coulomb(q, box=BOX, r_cutoff=3.0, tolerance=1e-4,
                              exclude=excl, mesh=mesh, mesh_axis="atoms",
                              **pkw)
        ej, gj = jax.jit(jax.value_and_grad(e_sh))(jnp.asarray(xp))
        pme[name] = (float(ej), np.asarray(gj))
        pme["grid"][name] = e_sh.grid_shape
    return cell, pme


@pytest.fixture(scope="module")
def records(tmp_path_factory, jax_results):
    tmp = tmp_path_factory.mktemp("potentials")
    cell, pme = jax_results
    torch.save(dict(x=cell["x"], kw=cell["kw"], geom=GEOM),
               tmp / "cell_system.pt")
    torch.save(dict(q=pme["q"], x=pme["x"], excl=pme["excl"], box=BOX,
                    grid=pme["grid"]), tmp / "pme_system.pt")
    return torch_ranks.spawn("potentials", WORLD, tmp)


def case(records, name):
    out = []
    for r, rec in enumerate(records):
        assert "error" not in rec[name], f"rank {r}:\n{rec[name]['error']}"
        out.append(rec[name])
    return out


def test_sharded_cell_grid_matches_unsharded_and_jax(records, jax_results):
    cell, _ = jax_results
    recs = case(records, "cell")
    scale = np.abs(cell["grad"]).max()
    for rec in recs:
        sh, un = rec["sharded"], rec["unsharded"]
        np.testing.assert_allclose(sh["e"], un["e"], rtol=1e-6)
        np.testing.assert_allclose(sh["grad"], un["grad"], rtol=0,
                                   atol=1e-6 * scale)
        np.testing.assert_allclose(sh["e"], cell["e"], rtol=1e-5)
        np.testing.assert_allclose(sh["grad"], cell["grad"], rtol=0,
                                   atol=1e-5 * scale)
        # every rank holds the whole energy and gradient
        np.testing.assert_array_equal(sh["grad"], recs[0]["sharded"]["grad"])
        # the slabs evaluated one after another in one process
        np.testing.assert_allclose(rec["by_slabs"]["e"], sh["e"], rtol=1e-6)
        np.testing.assert_allclose(rec["by_slabs"]["grad"], sh["grad"],
                                   rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("name", ["full", "recip_only"])
def test_sharded_pme_matches_jax_sharded(records, jax_results, name):
    _, pme = jax_results
    je, jg = pme[name]
    for rec in case(records, "pme"):
        got = rec[f"{name}_sharded"]
        assert abs(got["e"] - je) < 1e-4 * max(1.0, abs(je)), (got["e"], je)
        np.testing.assert_allclose(got["grad"], jg, rtol=1e-4, atol=1e-5)
        un = rec[f"{name}_unsharded"]
        assert abs(got["e"] - un["e"]) < 1e-4 * max(1.0, abs(un["e"]))
        np.testing.assert_allclose(got["grad"], un["grad"], rtol=1e-4,
                                   atol=1e-5)


def test_sharded_pme_grid_rules_and_refusals(records):
    for rec in case(records, "pme"):
        gx, gy, _ = rec["auto_grid"]
        assert gx % WORLD == 0 and gy % WORLD == 0
        assert "divisible" in rec["refusals"]["divisible"]
        assert "orthorhombic" in rec["refusals"]["orthorhombic"]
