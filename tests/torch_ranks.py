"""Multi-rank cases of the port, run in a gloo process group on the CPU.

``spawn(cases, world, tmp)`` starts ``world`` copies of this file, one
rank each, meeting through a ``file://`` rendezvous in ``tmp``; each
runs the case group ``cases`` (a function below) and writes its records
(a dict of case name -> dict of numbers and arrays, or the case's
traceback) to ``tmp``.  The group is joined with a timeout and killed if
it runs over, so a hang fails its test instead of the run.  The worker
imports torch and the port only; the tests compare the records with the
JAX package in their own process.  Inputs the parent made (converted
weights, systems) travel as ``torch.save`` files in ``tmp``.

Run by hand:  python tests/torch_ranks.py <cases> <rank> <world> <tmp>
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spawn(cases: str, world: int, tmp, timeout: float = 150.0) -> list:
    """Run case group ``cases`` on ``world`` gloo ranks; the per-rank
    records, rank by rank."""
    tmp = str(tmp)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), cases, str(r),
         str(world), tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1.0))
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise RuntimeError(f"{cases}: {world} ranks ran over {timeout} s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"{cases}: rank {r} exited {p.returncode}:\n"
                               f"{out[-4000:]}")
    return [torch.load(os.path.join(tmp, f"{cases}.rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _run(records: dict, name: str, fn, *args) -> None:
    """Case ``name``: its record, or its traceback under "error"."""
    try:
        records[name] = fn(*args)
    except Exception:  # noqa: BLE001 - reported by the test that reads it
        records[name] = {"error": traceback.format_exc()}


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


# ---------------------------------------------------------------------------
# tests/test_torch_sharding.py
# ---------------------------------------------------------------------------


def _flagship(seed: int = 0):
    from vaemolsim_tpu_torch.config import flagship_experiment_config
    import dataclasses

    cfg = dataclasses.replace(flagship_experiment_config(), seed=seed)
    return cfg.build("cpu")


def _mesh_case(rank, world):
    from vaemolsim_tpu_torch import parallel

    out = {}
    m = parallel.make_mesh()
    out["default"] = (m.mesh_dim_names, tuple(m.mesh.shape))
    m = parallel.make_mesh({"replica": 2, "chain": -1})
    out["2d"] = (m.mesh_dim_names, tuple(m.mesh.shape))
    try:
        parallel.make_mesh({"chain": 3})
        out["bad"] = None
    except ValueError as e:
        out["bad"] = str(e)
    m = parallel.make_hybrid_mesh({"replica": 2}, {"chain": -1})
    out["hybrid"] = (m.mesh_dim_names, tuple(m.mesh.shape))
    m = parallel.make_hybrid_mesh({"replica": -1}, {"chain": 2})
    out["hybrid_wild"] = (m.mesh_dim_names, tuple(m.mesh.shape))
    return out


def _shard_case(rank, world):
    from vaemolsim_tpu_torch import parallel
    from vaemolsim_tpu_torch.mcmc import MCMCState

    mesh = parallel.make_mesh()
    gen = torch.Generator().manual_seed(5)
    x = torch.arange(32.0).reshape(16, 2)
    st = parallel.shard_chain_state(
        MCMCState.create(x, -x.sum(-1), gen), mesh)
    rmesh = parallel.make_mesh({"replica": 2, "chain": -1})
    rs = parallel.REMCState.create(
        torch.arange(32.0).reshape(4, 8, 1), lambda c: -c[..., 0],
        torch.tensor([1.0, 0.7, 0.5, 0.3]), torch.Generator().manual_seed(1))
    rs = parallel.shard_chain_state(rs, rmesh)
    layer = torch.nn.Linear(3, 2)
    with torch.no_grad():
        layer.weight.fill_(float(rank))
    parallel.replicate(layer, mesh)
    return dict(configs=_np(st.configs), energies=_np(st.energies),
                starts=st.shard.starts, totals=st.shard.totals,
                gen_state=_np(st.generator.get_state()),
                rank_draw=float(torch.rand((), generator=st.shard.generator)),
                remc_configs=_np(rs.configs), remc_betas=_np(rs.betas),
                remc_starts=rs.shard.starts,
                replicated=_np(layer.weight))


def _log_target(x):
    return -0.5 * ((x - 0.5) ** 2 / torch.tensor([1.0, 0.6]) ** 2).sum(-1)


def _fused_case(rank, world):
    from vaemolsim_tpu_torch import parallel
    from vaemolsim_tpu_torch.mcmc import MCMCState, run_mcmc
    from vaemolsim_tpu_torch.mcmc.fused import make_fused_vae_step

    vae = _flagship()
    step = make_fused_vae_step(vae, _log_target)
    x0 = torch.randn(32, 2, generator=torch.Generator().manual_seed(2))

    def fresh():
        return MCMCState.create(x0, _log_target(x0),
                                torch.Generator().manual_seed(3))

    one, _ = run_mcmc(step, fresh(), 6)
    mesh = parallel.make_mesh()
    sh, _ = run_mcmc(step, parallel.shard_chain_state(fresh(), mesh), 6)
    return dict(one=_np(one.configs), one_e=_np(one.energies),
                one_acc=int(one.num_acc), sharded=_np(sh.configs),
                sharded_e=_np(sh.energies), start=sh.shard.starts[0],
                trials=int(sh.num_trials), acc=int(sh.num_acc))


def _generic_case(rank, world):
    from vaemolsim_tpu_torch import parallel
    from vaemolsim_tpu_torch.mcmc import (MCMCState, make_mcmc_step,
                                          run_mcmc, vae_proposal_fns)

    vae = _flagship()
    step = make_mcmc_step(*vae_proposal_fns(vae), _log_target)
    x0 = torch.zeros(64, 2)
    st = parallel.shard_chain_state(MCMCState.create(
        x0, _log_target(x0), torch.Generator().manual_seed(4)),
        parallel.make_mesh())
    st, _ = run_mcmc(step, st, 5)
    return dict(configs=_np(st.configs), trials=int(st.num_trials),
                rate=float(st.acceptance_rate),
                finite=bool(torch.isfinite(st.configs).all()))


def _local_case(rank, world):
    """Random walk, HMC, a mixture with MALA and the tuner on 32 chains
    that all start at one point: once on one device, once sharded."""
    from vaemolsim_tpu_torch import parallel
    from vaemolsim_tpu_torch.mcmc import (MCMCState, make_hmc_step,
                                          make_mala_step,
                                          make_random_walk_step, mix_moves,
                                          run_mcmc, tune_scale)

    mesh = parallel.make_mesh()
    x0 = torch.zeros(32, 2)
    steps = {"random_walk": make_random_walk_step(_log_target, 0.5),
             "hmc": make_hmc_step(_log_target, 0.7, 4),
             "mix": mix_moves([make_random_walk_step(_log_target, 0.5),
                               make_mala_step(_log_target, 0.1)],
                              [0.5, 0.5])}
    out = {}
    for name, step in steps.items():
        for where in ("one", "sharded"):
            st = MCMCState.create(x0, _log_target(x0),
                                  torch.Generator().manual_seed(6))
            if where == "sharded":
                st = parallel.shard_chain_state(st, mesh)
            st, _ = run_mcmc(step, st, 6)
            out[f"{name}_{where}"] = _np(st.configs)
            out[f"{name}_{where}_e"] = _np(st.energies)
            out[f"{name}_{where}_counts"] = (int(st.num_trials),
                                             int(st.num_acc))
    for where in ("one", "sharded"):
        st = MCMCState.create(x0, _log_target(x0),
                              torch.Generator().manual_seed(7))
        if where == "sharded":
            st = parallel.shard_chain_state(st, mesh)
        scale, st = tune_scale(_log_target, st, kind="hmc", rounds=3,
                               steps_per_round=4, n_leapfrog=3)
        out[f"tune_{where}"] = (scale, _np(st.configs))
    return out


def _remc_case(rank, world):
    from vaemolsim_tpu_torch import parallel
    from vaemolsim_tpu_torch.mcmc import vae_proposal_fns

    vae = _flagship()
    mesh = parallel.make_mesh({"replica": 2, "chain": 2})

    def target(x):
        return -0.5 * ((x[..., 0] - 1.0) / 0.75) ** 2 - 0.5 * x[..., 1] ** 2

    step = parallel.make_remc_step(*vae_proposal_fns(vae), target,
                                   exchange_every=2, mesh=mesh)
    st = parallel.REMCState.create(
        torch.zeros(4, 32, 2), target,
        parallel.temperature_ladder(4, device="cpu"),
        torch.Generator().manual_seed(0))
    st = parallel.run_remc(step, parallel.shard_chain_state(st, mesh), 20)
    try:
        parallel.make_remc_step(*vae_proposal_fns(vae), target,
                                mesh=mesh)(parallel.REMCState.create(
                                    torch.zeros(4, 32, 2), target,
                                    parallel.temperature_ladder(
                                        4, device="cpu"),
                                    torch.Generator()))
        refused = None
    except ValueError as e:
        refused = str(e)
    return dict(configs=_np(st.configs), energies=_np(st.energies),
                recomputed=_np(target(st.configs)),
                swap_trials=int(st.num_swap_trials),
                swap_acc=int(st.num_swap_acc), trials=int(st.num_trials),
                rate=float(st.acceptance_rate), starts=st.shard.starts,
                refused=refused)


def sharding(rank, world, tmp):
    records = {}
    _run(records, "mesh", _mesh_case, rank, world)
    _run(records, "shard", _shard_case, rank, world)
    _run(records, "fused", _fused_case, rank, world)
    _run(records, "generic", _generic_case, rank, world)
    _run(records, "local", _local_case, rank, world)
    _run(records, "remc", _remc_case, rank, world)
    return records


# ---------------------------------------------------------------------------
# tests/test_torch_distributed.py
# ---------------------------------------------------------------------------


def _helpers_case(rank, world):
    from vaemolsim_tpu_torch import parallel

    mesh = parallel.make_mesh()
    local = np.arange(8.0, dtype=np.float32).reshape(4, 2) + 100 * rank
    g = parallel.local_to_global(local, parallel.chain_sharding(mesh, 2))
    back = parallel.global_to_local(g)
    parallel.sync_processes("case")
    return dict(count=parallel.process_count(),
                index=parallel.process_index(),
                coordinator=parallel.is_coordinator(),
                global_shape=tuple(g.shape), full=_np(g.full_tensor()),
                back=back, local=local,
                mean=parallel.process_allmean({"x": float(rank)})["x"],
                bcast=parallel.broadcast_from_coordinator(
                    {"y": np.full(2, rank, np.float32)})["y"])


def _nll(f, batch, g):
    return -f().log_prob(batch).mean()


def _flat(model):
    return np.concatenate([_np(p).ravel() for p in model.parameters()])


def _fit_case(rank, world, tmp):
    from vaemolsim_tpu_torch import parallel
    from vaemolsim_tpu_torch.train import fit

    x = torch.load(os.path.join(tmp, "fit_data.pt"))
    probe = torch.load(os.path.join(tmp, "fit_probe.pt"))
    out = {}
    for name, mesh in (("one", None), ("mesh", parallel.make_mesh(
            {"batch": world}))):
        model = torch.load(os.path.join(tmp, "flow.pt"), weights_only=False)
        model, hist = fit(model, _nll, x,
                          generator=torch.Generator().manual_seed(2),
                          num_epochs=3, batch_size=64, learning_rate=3e-3,
                          shuffle=False, mesh=mesh)
        with torch.no_grad():
            lp = model().log_prob(probe)
        out[name] = dict(loss=hist["loss"], log_prob=_np(lp),
                         params=_flat(model))
    return out


def _elbo_case(rank, world):
    from vaemolsim_tpu_torch import parallel
    from vaemolsim_tpu_torch.train import fit

    vae = _flagship(seed=rank)  # replicated from rank 0 by fit
    data = torch.randn(256, 2, generator=torch.Generator().manual_seed(7))
    vae, hist = fit(vae, lambda m, b, g: m.elbo_loss(b, g), data,
                    generator=torch.Generator().manual_seed(8),
                    num_epochs=2, batch_size=64,
                    mesh=parallel.make_mesh({"batch": world}),
                    validation_data=data[:70])
    return dict(loss=hist["loss"], val=hist["val_loss"], params=_flat(vae))


def _local_data_case(rank, world):
    from vaemolsim_tpu_torch import parallel
    from vaemolsim_tpu_torch.train import fit

    mesh = parallel.make_mesh({"batch": world})
    data = torch.randn(128, 2, generator=torch.Generator().manual_seed(9))

    class Lin(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(2))

    def loss(m, b, g):
        return ((b @ m.w - 1.0) ** 2).mean()

    runs = {}
    for name, kw, d in (
            ("local", dict(process_local_data=True),
             data[rank * 32:(rank + 1) * 32]),
            ("global", {}, data)):
        m, h = fit(Lin(), loss, d, generator=torch.Generator().manual_seed(1),
                   num_epochs=3, batch_size=32, scan_epochs=True, mesh=mesh,
                   **kw)
        runs[name] = dict(loss=h["loss"], w=_np(m.w))
    refusals = {}
    for what, kw in (("scan_epochs", dict(mesh=mesh)),
                     ("mesh", dict(scan_epochs=True)),
                     ("divide", dict(mesh=mesh, scan_epochs=True,
                                     batch_size=30))):
        try:
            fit(Lin(), loss, data[:31] if what == "divide" else data,
                generator=torch.Generator(), process_local_data=True, **kw)
            refusals[what] = None
        except ValueError as e:
            refusals[what] = str(e)
    runs["refusals"] = refusals
    return runs


def _checkpoint_case(rank, world, tmp):
    from vaemolsim_tpu_torch import parallel
    from vaemolsim_tpu_torch.mcmc import MCMCState, run_mcmc
    from vaemolsim_tpu_torch.mcmc.fused import make_fused_vae_step
    from vaemolsim_tpu_torch.train import CheckpointManager

    mesh = parallel.make_mesh()
    vae = _flagship()
    step = make_fused_vae_step(vae, _log_target)
    x0 = torch.randn(16, 2, generator=torch.Generator().manual_seed(2))
    st = parallel.shard_chain_state(MCMCState.create(
        x0, _log_target(x0), torch.Generator().manual_seed(3)), mesh)
    st, _ = run_mcmc(step, st, 3)
    ck = CheckpointManager(os.path.join(tmp, "ck"), max_to_keep=1)
    ck.save(3, st)
    later, _ = run_mcmc(step, st, 2)
    ck.save(5, later)
    template = parallel.shard_chain_state(MCMCState.create(
        torch.zeros(16, 2), torch.zeros(16), torch.Generator()), mesh)
    back = ck.restore(template)
    equal = bool(torch.equal(back.configs, later.configs)
                 and torch.equal(back.energies, later.energies)
                 and int(back.num_trials) == int(later.num_trials)
                 and torch.equal(back.generator.get_state(),
                                 later.generator.get_state())
                 and torch.equal(back.shard.generator.get_state(),
                                 later.shard.generator.get_state()))
    trials = int(back.num_trials)
    again, _ = run_mcmc(step, back, 2)
    return dict(
        steps=ck.all_steps(), files=sorted(os.listdir(
            os.path.join(tmp, "ck", "ckpt_5"))), equal=equal,
        resumed=bool(torch.equal(again.configs,
                                 run_mcmc(step, later, 2)[0].configs)),
        trials=trials)


def distributed(rank, world, tmp):
    records = {}
    _run(records, "helpers", _helpers_case, rank, world)
    _run(records, "fit", _fit_case, rank, world, tmp)
    _run(records, "elbo", _elbo_case, rank, world)
    _run(records, "local_data", _local_data_case, rank, world)
    _run(records, "checkpoint", _checkpoint_case, rank, world, tmp)
    return records


# ---------------------------------------------------------------------------
# tests/test_torch_sharded_potentials.py
# ---------------------------------------------------------------------------


def _cell_case(rank, world, tmp):
    from vaemolsim_tpu_torch import parallel, potentials as tp

    sysd = torch.load(os.path.join(tmp, "cell_system.pt"), weights_only=False)
    mesh = parallel.make_mesh({"cells": world})
    x = torch.tensor(sysd["x"])
    out = {}
    for name, m in (("unsharded", None), ("sharded", mesh)):
        build, energy = tp.lennard_jones_cell_neighbor(
            device="cpu", mesh=m, **sysd["geom"], **sysd["kw"])
        nl = build(x)
        xg = x.clone().requires_grad_(True)
        e = energy(nl, xg)
        (g,) = torch.autograd.grad(e, xg)
        out[name] = dict(e=float(e), grad=_np(g))
    e_s, g_s = energy.by_slabs(nl, x, world)
    out["by_slabs"] = dict(e=float(e_s), grad=_np(g_s))
    return out


def _pme_case(rank, world, tmp):
    from vaemolsim_tpu_torch import parallel, potentials as tp

    sysd = torch.load(os.path.join(tmp, "pme_system.pt"), weights_only=False)
    mesh = parallel.make_mesh({"atoms": world})
    x = torch.tensor(sysd["x"])
    out = {}
    for name, kw in (("full", {}), ("recip_only",
                                    {"include_real_space": False})):
        for label, m in (("sharded", mesh), ("unsharded", None)):
            e_fn = tp.pme_coulomb(sysd["q"], box=sysd["box"], r_cutoff=3.0,
                                  tolerance=1e-4, exclude=sysd["excl"],
                                  grid_shape=sysd["grid"][name], mesh=m,
                                  device="cpu", **kw)
            xg = x.clone().requires_grad_(True)
            e = e_fn(xg)
            (g,) = torch.autograd.grad(e, xg)
            out[f"{name}_{label}"] = dict(e=float(e), grad=_np(g))
    auto = tp.pme_coulomb(sysd["q"], box=sysd["box"], r_cutoff=3.0,
                          tolerance=1e-4, mesh=mesh, device="cpu")
    out["auto_grid"] = auto.grid_shape
    refusals = {}
    for what, kw in (("divisible", dict(box=sysd["box"],
                                        grid_shape=(30, 30, 30))),
                     ("orthorhombic", dict(cell=np.diag(sysd["box"])))):
        try:
            tp.pme_coulomb(sysd["q"], r_cutoff=3.0, mesh=mesh, device="cpu",
                           **kw)
            refusals[what] = None
        except ValueError as e:
            refusals[what] = str(e)
    out["refusals"] = refusals
    return out


def potentials(rank, world, tmp):
    records = {}
    _run(records, "cell", _cell_case, rank, world, tmp)
    _run(records, "pme", _pme_case, rank, world, tmp)
    return records


CASES = {"sharding": sharding, "distributed": distributed,
         "potentials": potentials}


def main():
    cases, rank, world, tmp = (sys.argv[1], int(sys.argv[2]),
                               int(sys.argv[3]), sys.argv[4])
    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    from vaemolsim_tpu_torch import parallel

    parallel.initialize_distributed(
        f"file://{os.path.join(tmp, cases + '.rendezvous')}", world, rank,
        timeout=60.0)
    try:
        records = CASES[cases](rank, world, tmp)
        torch.save(records, os.path.join(tmp, f"{cases}.rank{rank}.pt"))
    finally:
        parallel.shutdown_distributed()


if __name__ == "__main__":
    main()
