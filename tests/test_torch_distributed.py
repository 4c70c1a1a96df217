"""The port's multi-process runtime (``vaemolsim_tpu_torch/parallel/
distributed.py``), data-parallel ``fit(mesh=...)`` and the collective
checkpoint, against the JAX package (tests/test_distributed.py,
tools/distributed_smoke.py).

Single-process cases run here; the multi-rank cases run once, in a
module fixture, on 4 gloo ranks spawned by ``tests/torch_ranks.py`` (the
"distributed" cases).  ``fit(mesh=...)`` with a deterministic loss (the
maximum likelihood of a 1-D RealNVP, no shuffle) is held to the
one-device ``fit`` and to the JAX package's ``fit(mesh=...)`` on the 8
virtual CPU devices from the same converted weights: losses to 1e-5 and
log-densities after training to 1e-4 (twelve Adam steps carry the
gradients' float32 differences into the weights, as in
tests/test_torch_ensemble_ckpt.py), and the weights of all ranks
bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vaemolsim_tpu.dists import StaticFlowedDistribution as JStatic
from vaemolsim_tpu.flows import RQSSplineRealNVP as JRealNVP
from vaemolsim_tpu.ops import distributions as jd
from vaemolsim_tpu.parallel import make_mesh as jmesh
from vaemolsim_tpu.train import fit as jfit
from vaemolsim_tpu_torch import parallel
from vaemolsim_tpu_torch.convert import from_jax
from vaemolsim_tpu_torch.train import fit

import torch_ranks

WORLD = 4
RQS = {"num_bins": 8, "hidden_dim": 16, "bin_range": [-4.0, 4.0]}


def jflow(seed=0):
    return JStatic(
        flow=JRealNVP.create(jax.random.PRNGKey(seed), 1, num_blocks=2,
                             rqs_params=dict(RQS)),
        base=jd.Independent(jd.Normal(jnp.zeros(1), jnp.ones(1)), 1))


def mixture_data(n, seed):
    rng = np.random.default_rng(seed)
    return (np.array([-2.0, 0.0, 2.0])[rng.integers(0, 3, n)]
            + 0.3 * rng.normal(size=n)).astype(np.float32)[:, None]


def adam_on_the_flow(lr):
    """optax Adam on the flow's leaves; the port keeps the static base as
    buffers, so the comparison freezes it."""

    def labels(m):
        return m.replace(flow=jax.tree_util.tree_map(lambda _: "adam",
                                                     m.flow),
                         base=jax.tree_util.tree_map(lambda _: "fixed",
                                                     m.base))

    return optax.multi_transform({"adam": optax.adam(lr),
                                  "fixed": optax.set_to_zero()}, labels)


@pytest.fixture(scope="module")
def jax_fit():
    x, probe = mixture_data(256, 1), mixture_data(64, 3)
    model, hist = jfit(jflow(), lambda f, b, k: -jnp.mean(f().log_prob(b)),
                       jnp.asarray(x), key=jax.random.PRNGKey(2),
                       num_epochs=3, batch_size=64,
                       optimizer=adam_on_the_flow(3e-3), shuffle=False,
                       mesh=jmesh({"batch": len(jax.devices())}))
    return x, probe, hist["loss"], np.asarray(model().log_prob(
        jnp.asarray(probe)))


@pytest.fixture(scope="module")
def records(tmp_path_factory, jax_fit):
    tmp = tmp_path_factory.mktemp("distributed")
    x, probe, _, _ = jax_fit
    torch.save(from_jax(jflow(), "cpu"), tmp / "flow.pt")
    torch.save(torch.tensor(x), tmp / "fit_data.pt")
    torch.save(torch.tensor(probe), tmp / "fit_probe.pt")
    return torch_ranks.spawn("distributed", WORLD, tmp)


def case(records, name):
    out = []
    for r, rec in enumerate(records):
        assert "error" not in rec[name], f"rank {r}:\n{rec[name]['error']}"
        out.append(rec[name])
    return out


class TestSingleProcessHelpers:
    """Without a process group the helpers are the one-process case
    (tests/test_distributed.py's single-process cases)."""

    def test_process_identity(self):
        assert parallel.process_count() == 1
        assert parallel.process_index() == 0
        assert parallel.is_coordinator()

    def test_allmean_broadcast_sync_degenerate(self):
        out = parallel.process_allmean({"x": 3.0})
        assert float(out["x"]) == 3.0
        t = parallel.broadcast_from_coordinator({"y": np.ones(2)})
        np.testing.assert_array_equal(t["y"], np.ones(2))
        parallel.sync_processes("noop")
        parallel.shutdown_distributed()  # no group: a no-op


def test_runtime_helpers_on_four_ranks(records):
    recs = case(records, "helpers")
    full = np.concatenate([rec["local"] for rec in recs])
    for r, rec in enumerate(recs):
        assert rec["count"] == WORLD and rec["index"] == r
        assert rec["coordinator"] == (r == 0)
        assert rec["global_shape"] == (16, 2)
        np.testing.assert_array_equal(rec["full"], full)
        np.testing.assert_array_equal(rec["back"], rec["local"])
        assert float(rec["mean"]) == 1.5
        np.testing.assert_array_equal(rec["bcast"], np.zeros(2))


def test_fit_mesh_equals_one_device_and_jax(records, jax_fit):
    _, _, jloss, jlogp = jax_fit
    recs = case(records, "fit")
    mesh0 = recs[0]["mesh"]
    for rec in recs:
        # every rank's weights bit-identical
        np.testing.assert_array_equal(rec["mesh"]["params"],
                                      mesh0["params"])
        assert rec["mesh"]["loss"] == mesh0["loss"]
    one = recs[0]["one"]
    np.testing.assert_allclose(mesh0["loss"], one["loss"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(mesh0["log_prob"], one["log_prob"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(mesh0["loss"], jloss, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mesh0["log_prob"], jlogp, rtol=1e-4,
                               atol=1e-4)
    assert mesh0["loss"][-1] < mesh0["loss"][0]


def test_elbo_fit_mesh_runs_and_validates_alike(records):
    """The ELBO (its draws from each rank's own stream) over 4 ranks:
    finite losses, the model made equal to rank 0's and kept so, and one
    validation loss on every rank."""
    recs = case(records, "elbo")
    for rec in recs:
        assert np.isfinite(rec["loss"]).all() and len(rec["loss"]) == 2
        np.testing.assert_array_equal(rec["params"], recs[0]["params"])
        assert rec["val"] == recs[0]["val"]
        assert rec["loss"] == recs[0]["loss"]


def test_process_local_data_equals_the_mesh_fit(records):
    """Each rank's shard of the data, assembled, trains as the global
    data set does; JAX's refusals kept."""
    recs = case(records, "local_data")
    for rec in recs:
        np.testing.assert_array_equal(rec["local"]["w"], rec["global"]["w"])
        assert rec["local"]["loss"] == rec["global"]["loss"]
        assert rec["local"]["loss"][-1] < rec["local"]["loss"][0]
        ref = rec["refusals"]
        assert "scan_epochs" in ref["scan_epochs"]
        assert "mesh" in ref["mesh"]
        assert "divide" in ref["divide"]


def test_process_local_data_in_a_one_rank_group(tmp_path):
    """process_local_data in a 1-rank group equals the plain mesh fit
    (tests/test_distributed.py::test_fit_process_local_single_process)."""
    parallel.initialize_distributed(f"file://{tmp_path / 'rdv'}", 1, 0,
                                    timeout=60.0)
    try:
        mesh = parallel.make_mesh({"batch": 1})
        data = torch.tensor(np.random.default_rng(0).normal(
            size=(64, 2)).astype(np.float32))

        class Lin(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.w = torch.nn.Parameter(torch.zeros(2))

        def loss(m, b, g):
            return ((b @ m.w - 1.0) ** 2).mean()

        runs = [fit(Lin(), loss, data, generator=torch.Generator(
            ).manual_seed(1), num_epochs=3, batch_size=32, scan_epochs=True,
            mesh=mesh, process_local_data=local) for local in (True, False)]
        np.testing.assert_allclose(runs[0][1]["loss"], runs[1][1]["loss"],
                                   rtol=1e-6)
        torch.testing.assert_close(runs[0][0].w, runs[1][0].w)
        assert runs[0][1]["loss"][-1] < runs[0][1]["loss"][0]
    finally:
        parallel.shutdown_distributed()


def test_sharded_checkpoint_round_trip(records):
    """Each rank writes its shard, rank 0 commits after a barrier; the
    restore gives every rank its shard back bit for bit (configurations,
    energies, counters, both generators) and the run goes on as if it
    had not stopped."""
    recs = case(records, "checkpoint")
    for rec in recs:
        assert rec["steps"] == [5]
        assert rec["files"] == [f"rank{r}.pt" for r in range(WORLD)]
        assert rec["equal"] and rec["resumed"]
        assert rec["trials"] == 16 * 5
