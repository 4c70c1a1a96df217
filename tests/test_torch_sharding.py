"""The port's device meshes and sharded chain states
(``vaemolsim_tpu_torch/parallel/sharding.py``, the sharded MC and REMC
steps) against the JAX package's ``parallel/sharding.py`` and its tests
(tests/test_parallel.py).

The mesh's axis sizes are compared with JAX's for the same requests over
the 8 virtual CPU devices (the pure resolvers ``mesh_shape`` and
``hybrid_mesh_shape``, on 8 ranks).  Everything that needs a process
group runs once, in a module fixture, on 4 gloo ranks spawned by
``tests/torch_ranks.py`` (the "sharding" cases); the tests read its
records.  Sharded fused MC is held bit for bit to the one-device run (the
kernel's Philox counter is the global chain index, and the accept
uniforms come from the replicated generator in the global shape), and
so are the local moves and their tuner (their normals and uniforms are
drawn likewise); the generic VAE step and REMC draw their proposals from
each rank's own stream and are held by their invariants.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from vaemolsim_tpu.parallel import make_hybrid_mesh as jhybrid
from vaemolsim_tpu.parallel import make_mesh as jmesh
from vaemolsim_tpu_torch.parallel import sharding as ts

import torch_ranks

WORLD = 4


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    return torch_ranks.spawn("sharding", WORLD,
                             tmp_path_factory.mktemp("sharding"))


def case(records, name):
    out = []
    for r, rec in enumerate(records):
        assert "error" not in rec[name], f"rank {r}:\n{rec[name]['error']}"
        out.append(rec[name])
    return out


@pytest.mark.parametrize("request_sizes", [
    None, {"replica": 4, "chain": -1}, {"replica": 2, "chain": 2,
                                        "batch": -1}])
def test_mesh_shape_matches_jax(request_sizes):
    want = jmesh(request_sizes)
    got = ts.mesh_shape(request_sizes, len(jax.devices()))
    assert tuple(got) == want.axis_names
    assert tuple(got.values()) == want.devices.shape


@pytest.mark.parametrize("dcn,ici", [
    ({"replica": 2}, {"chain": -1}), ({"replica": -1}, {"chain": 4}),
    ({"replica": -1}, {"chain": -1})])
def test_hybrid_mesh_shape_matches_jax(dcn, ici):
    want = jhybrid(dcn, ici)
    got = ts.hybrid_mesh_shape(dcn, ici, len(jax.devices()))
    assert tuple(got) == want.axis_names
    assert tuple(got.values()) == want.devices.shape


@pytest.mark.parametrize("dcn,ici,bad", [
    ({"replica": 3}, {"chain": 2}, True), ({"chain": 3}, None, False)])
def test_bad_mesh_sizes_raise_like_jax(dcn, ici, bad):
    n = len(jax.devices())
    if bad:
        with pytest.raises(ValueError):
            jhybrid(dcn, ici)
        with pytest.raises(ValueError, match="divide|does not use all"):
            ts.hybrid_mesh_shape(dcn, ici, n)
    else:
        with pytest.raises(ValueError):
            jmesh(dcn)
        with pytest.raises(ValueError, match="does not use all"):
            ts.mesh_shape(dcn, n)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        ts.make_mesh()


def test_device_meshes_on_four_ranks(records):
    """make_mesh / make_hybrid_mesh over 4 gloo ranks give the sizes the
    resolvers give for 4 devices; a mesh that leaves ranks out raises."""
    for rec in case(records, "mesh"):
        assert rec["default"] == (("chain",), (4,))
        assert rec["2d"] == (("replica", "chain"), (2, 2))
        assert "does not use all" in rec["bad"]
        assert rec["hybrid"] == (("replica", "chain"), (2, 2))
        assert rec["hybrid_wild"] == (("replica", "chain"), (2, 2))


def test_chain_sharding_placements_match_the_jax_spec(records):
    """chain_sharding splits the named axis and replicates the rest, as
    JAX's NamedSharding(mesh, P(None, "chain", None)) does."""
    del records  # the placements need no process group to compare
    from torch.distributed.tensor import Replicate, Shard

    class FakeMesh:
        mesh_dim_names = ("replica", "chain")

    s = ts.chain_sharding(FakeMesh(), 3, chain_axis=1, mesh_axis="chain")
    assert s.placements == (Replicate(), Shard(1))
    want = jax.sharding.NamedSharding(jmesh({"replica": 4, "chain": -1}),
                                      P(None, "chain", None))
    assert want.spec[1] == "chain"


def test_shard_chain_state_slices_and_replicates(records):
    recs = case(records, "shard")
    x = np.arange(32.0, dtype=np.float32).reshape(16, 2)
    for r, rec in enumerate(recs):
        np.testing.assert_array_equal(rec["configs"], x[4 * r:4 * r + 4])
        np.testing.assert_array_equal(rec["energies"],
                                      -x[4 * r:4 * r + 4].sum(-1))
        assert rec["starts"] == (4 * r,) and rec["totals"] == (16,)
        # generator replicated; the rank's own stream differs by rank
        np.testing.assert_array_equal(rec["gen_state"], recs[0]["gen_state"])
        rr, rc = divmod(r, 2)
        assert rec["remc_starts"] == (2 * rr, 4 * rc)
        full = np.arange(32.0, dtype=np.float32).reshape(4, 8, 1)
        np.testing.assert_array_equal(
            rec["remc_configs"], full[2 * rr:2 * rr + 2, 4 * rc:4 * rc + 4])
        np.testing.assert_allclose(rec["remc_betas"],
                                   [1.0, 0.7, 0.5, 0.3][2 * rr:2 * rr + 2])
        # replicate: every rank ends with rank 0's weights
        np.testing.assert_array_equal(rec["replicated"], 0.0)
    assert len({rec["rank_draw"] for rec in recs}) == WORLD


def test_sharded_fused_mc_equals_one_device_bit_for_bit(records):
    recs = case(records, "fused")
    one = recs[0]["one"]
    sharded = np.concatenate([rec["sharded"] for rec in recs])
    np.testing.assert_array_equal(sharded, one)
    np.testing.assert_array_equal(
        np.concatenate([rec["sharded_e"] for rec in recs]), recs[0]["one_e"])
    for r, rec in enumerate(recs):
        assert rec["start"] == 8 * r
        # the global counters, on every rank
        assert rec["trials"] == 32 * 6
        assert rec["acc"] == recs[0]["one_acc"]
    assert 0 < recs[0]["acc"] < 32 * 6


def test_sharded_generic_mc_counts_globally(records):
    recs = case(records, "generic")
    for rec in recs:
        assert rec["finite"]
        assert rec["trials"] == 64 * 5
        assert 0.0 < rec["rate"] < 1.0
        assert rec["rate"] == recs[0]["rate"]
    # the ranks' chains drew their own proposals
    assert not np.array_equal(recs[0]["configs"], recs[1]["configs"])


@pytest.mark.parametrize("move", ["random_walk", "hmc", "mix"])
def test_sharded_local_moves_equal_one_device(records, move):
    """Random walk, HMC and a random-walk / MALA mixture on a sharded
    state: every rank draws the global chains' noise from the replicated
    generator and takes its slice, so the chains (all started at one
    point) differ across ranks and together equal the one-device run bit
    for bit, and the counters are the global ones on every rank."""
    recs = case(records, "local")
    one = recs[0][f"{move}_one"]
    sharded = [rec[f"{move}_sharded"] for rec in recs]
    np.testing.assert_array_equal(np.concatenate(sharded), one)
    np.testing.assert_array_equal(
        np.concatenate([rec[f"{move}_sharded_e"] for rec in recs]),
        recs[0][f"{move}_one_e"])
    for r in range(1, WORLD):
        assert not np.array_equal(sharded[r], sharded[0])
    trials, acc = recs[0][f"{move}_one_counts"]
    assert trials == 32 * 6 and 0 < acc < trials
    for rec in recs:
        assert rec[f"{move}_sharded_counts"] == (trials, acc)


def test_sharded_tune_scale_equals_one_device(records):
    """tune_scale on a sharded state tunes on the global acceptance: the
    same scale on every rank as on one device, and the warmed chains
    the one-device run's."""
    recs = case(records, "local")
    scale, configs = recs[0]["tune_one"]
    np.testing.assert_array_equal(
        np.concatenate([rec["tune_sharded"][1] for rec in recs]), configs)
    for rec in recs:
        assert rec["tune_sharded"][0] == scale
    assert scale != 0.1


def test_remc_over_replica_chain_mesh(records):
    """REMC over a (2, 2) mesh (tests/test_parallel.py:138-151): finite,
    swaps made, energies consistent with the configurations, the
    counters global on every rank, and a mesh the state is not sharded
    over refused."""
    recs = case(records, "remc")
    for r, rec in enumerate(recs):
        assert np.isfinite(rec["energies"]).all()
        np.testing.assert_allclose(rec["energies"], rec["recomputed"],
                                   atol=1e-4)
        # 10 exchanges, even (2 pairs) and odd (1 pair) in turn, 32 chains
        assert rec["swap_trials"] == 5 * (2 + 1) * 32
        assert 0 < rec["swap_acc"] <= rec["swap_trials"]
        assert rec["swap_acc"] == recs[0]["swap_acc"]
        assert rec["trials"] == 4 * 32 * 20
        assert 0.0 < rec["rate"] < 1.0
        assert rec["starts"] == (2 * (r // 2), 16 * (r % 2))
        assert "shard_chain_state" in rec["refused"]
