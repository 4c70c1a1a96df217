"""Two repairs of the port's kernel routes, on the CPU.

1. The bfloat16 merged MAF conditioner against the JAX package's under
   ``set_compute_dtype(bfloat16)``: each product's operands rounded to
   bfloat16, the products summed in float32 (JAX's
   ``preferred_element_type=float32``), the bias and tanh in float32.
   Two float32 sums of the same exact products differ by their order
   only (~1e-7), but the tanh output is rounded to bfloat16 again before
   the second product, and where the two packages' float32 values of
   one hidden unit lie on either side of a bfloat16 rounding boundary,
   the rounded values differ by one bfloat16 step.  That happens to a
   handful of (row, unit) pairs in tens of thousands and moves the rows
   it touches by up to ~1e-4; the raw parameters are held to 1e-5 on
   every other row, and those rows are found by recomputing both
   packages' hidden layers.  The same test fails on the parent tree by
   ~3e-2 on every row.
2. The routing predicates that decide, from shapes alone, how a call on
   the card is split, or sent to the plain version, where a kernel's
   one-launch plan refuses it (dense stack: runs of launches, a wide
   layer in the wide regime; pair attention: the stream regime, and the
   plain layer where no regime fits; RQS: the walk; cell-pair LJ: runs
   of neighbour slots), at their
   boundary shapes, and the split paths run on the CPU with the plain
   versions in the kernels' place: each must equal the unsplit plain
   call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu.flows import RQSSplineMAF as JMAF
from vaemolsim_tpu.nn import core as jcore
from vaemolsim_tpu_torch.convert import from_jax
from vaemolsim_tpu_torch.nn import VectorAttention
from vaemolsim_tpu_torch.nn import core as tcore
from vaemolsim_tpu_torch.ops import attention as tpa
from vaemolsim_tpu_torch.ops import cell_lj, fused_mlp, rqs

torch.set_num_threads(1)

D, H, K, N = 8, 200, 32, 512


def _bf16_hidden_jax(x, k1, b1):
    bf = jnp.bfloat16
    h = jnp.tanh(jnp.dot(jnp.asarray(x).astype(bf), jnp.asarray(k1).astype(bf),
                         preferred_element_type=jnp.float32) + b1)
    return np.asarray(h.astype(bf).astype(jnp.float32))


def _bf16_hidden_torch(x, k1, b1):
    bf = torch.bfloat16
    h = torch.tanh(torch.tensor(x).to(bf).float()
                   @ torch.tensor(np.asarray(k1)).to(bf).float()
                   + torch.tensor(np.asarray(b1)))
    return h.to(bf).float().numpy()


@pytest.fixture()
def bf16():
    jcore.set_compute_dtype(jnp.bfloat16)
    tcore.set_compute_dtype(torch.bfloat16)
    yield
    jcore.set_compute_dtype(None)
    tcore.set_compute_dtype(None)


def _flow(seed):
    jflow = JMAF.create(jax.random.PRNGKey(seed), D, num_blocks=1,
                        rqs_params={"num_bins": K, "hidden_dim": H,
                                    "bin_range": [-5.0, 5.0]})
    return jflow, from_jax(jflow, "cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_conditioner_matches_jax(bf16, seed):
    """Raw spline parameters to 1e-5 abs off the rows a rounding
    boundary separates (see the module docstring), and those rows few."""
    jflow, tflow = _flow(seed)
    jc, tc = jflow.blocks[0].conditioner, tflow.blocks[0].conditioner
    x = (2.0 * np.random.default_rng(seed).normal(size=(N, D))
         ).astype(np.float32)
    k1, b1 = jc.merged_params()[:2]
    same = (_bf16_hidden_jax(x, k1, b1)
            == _bf16_hidden_torch(x, k1, b1)).all(-1)
    assert same.mean() > 0.9, f"{(~same).sum()} rows straddle a boundary"
    jraw = jax.jit(lambda v: jc._merged_raw(v, None))(jnp.asarray(x))
    traw = tc._merged_raw(torch.tensor(x), None)
    for name, a, b in zip(("widths", "heights", "slopes"), jraw, traw):
        err = np.abs(np.asarray(a) - b.detach().numpy())
        assert err[same].max() <= 1e-5, (name, err[same].max())
        assert err.max() <= 1e-3, (name, err.max())


def test_bf16_maf_log_prob_and_sample_match_jax(bf16):
    """A bf16 MAF block's density pass (conditioner at y) and its
    sampling pass at shared base draws, against JAX's.  The spline maps
    the raw parameters' ~1e-5 differences (the order of two float32
    sums) into x and the log-det amplified by its steepest bins: 1e-4
    there."""
    jflow, tflow = _flow(2)
    rng = np.random.default_rng(2)
    y = (2.0 * rng.normal(size=(N, D))).astype(np.float32)
    jc = jflow.blocks[0].conditioner
    k1, b1 = jc.merged_params()[:2]
    same = (_bf16_hidden_jax(y, k1, b1)
            == _bf16_hidden_torch(y, k1, b1)).all(-1)
    jx, jl = jax.jit(jflow.blocks[0].inverse_and_log_det)(jnp.asarray(y))
    tx, tl = tflow.blocks[0].inverse_and_log_det(torch.tensor(y))
    np.testing.assert_allclose(tx.detach().numpy()[same],
                               np.asarray(jx)[same], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tl.detach().numpy()[same],
                               np.asarray(jl)[same], atol=1e-4, rtol=1e-4)
    # Sampling evaluates the conditioner at D intermediate points, so the
    # rows a boundary separates are not known in advance: nearly all
    # rows agree to 1e-4, every row to 1e-3.
    z = rng.normal(size=(N, D)).astype(np.float32)
    js = np.asarray(jax.jit(jflow.blocks[0].forward)(jnp.asarray(z)))
    ts = tflow.blocks[0].forward(torch.tensor(z)).detach().numpy()
    err = np.abs(ts - js).max(-1)
    assert (err <= 1e-4 + 1e-4 * np.abs(js).max(-1)).mean() >= 0.95, \
        np.sort(err)[-20:]
    assert err.max() <= 1e-3


# ---------------------------------------------------------------------------
# Routing predicates at their boundary shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layers,runs", [
    (8, [(0, 8)]), (9, [(0, 8), (8, 9)]), (17, [(0, 8), (8, 16), (16, 17)])])
def test_dense_stack_runs_by_depth(layers, runs):
    assert fused_mlp.stack_runs(10_000, [4] + [32] * layers) == runs


@pytest.mark.parametrize("width,runs,regimes", [
    (807, [(0, 3)], ["tiled"]),
    (808, [(0, 1), (1, 2), (2, 3)], ["wide", "wide", "wide"])])
def test_dense_stack_runs_by_width(width, runs, regimes):
    """Width 808 at more than 16 rows is too wide for the tiled regime's
    shared memory: a launch of the wide regime a layer."""
    dims = [4, width, width, 8]
    assert fused_mlp.stack_runs(10_000, dims) == runs
    assert [fused_mlp.stack_regime(10_000, dims[lo:hi + 1])[0]
            for lo, hi in runs] == regimes
    # At 16 rows or fewer the small regime takes the wide stack.
    assert fused_mlp.stack_runs(16, [4, width, 8]) == [(0, 2)]
    assert fused_mlp.stack_regime(16, [4, width, 8])[0] == "small"


def test_dense_stack_runs_split_a_refused_plan():
    """A stack whose one-launch plan is refused splits into the longest
    runs the plan accepts; a single layer always has one (a layer of a
    width no other regime takes runs the wide one)."""
    dims = [4, 32, 32, 900, 32, 8]
    assert fused_mlp.stack_regime(10_000, dims)[0] == "refused"
    runs = fused_mlp.stack_runs(10_000, dims)
    assert runs == [(0, 2), (2, 3), (3, 4), (4, 5)]
    assert [fused_mlp.stack_regime(10_000, dims[lo:hi + 1])[0]
            for lo, hi in runs] == ["tiled", "wide", "wide", "tiled"]
    assert fused_mlp.stack_regime(4, [1, 30_000]) == ("wide", 0)
    assert fused_mlp.stack_regime(4, [1, 30_000, 1])[0] == "refused"


def _stack(rng, dims, dc):
    ks = [torch.tensor(rng.normal(size=(a, b)) / np.sqrt(a),
                       dtype=torch.float32) for a, b in zip(dims, dims[1:])]
    bs = [torch.tensor(rng.normal(size=b), dtype=torch.float32)
          for b in dims[1:]]
    cks = ([torch.tensor(rng.normal(size=(dc, b)), dtype=torch.float32)
            for b in dims[1:]] if dc else None)
    return ks, bs, cks


@pytest.mark.parametrize("dims,dc", [([3] + [16] * 9 + [2], 0),
                                     ([3, 16, 900, 16, 2], 2)])
def test_dense_stack_split_equals_the_whole_stack(dims, dc):
    """The split route on the CPU (each run through the plain version in
    the kernel's place) equals one plain call, conditional input
    included."""
    rng = np.random.default_rng(3)
    ks, bs, cks = _stack(rng, dims, dc)
    acts = ["tanh"] * (len(ks) - 1) + [None]
    x = torch.tensor(rng.normal(size=(40, dims[0])), dtype=torch.float32)
    cond = (torch.tensor(rng.normal(size=(40, dc)), dtype=torch.float32)
            if dc else None)
    want = fused_mlp.dense_stack_plain(x, ks, bs, acts, cond, cks)
    got = fused_mlp._split_call(fused_mlp.dense_stack_plain, x, ks, bs, acts,
                                cond, cks)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("n,takes", [(80, True), (100, True),
                                     (1552, True), (1553, True),
                                     (4096, True), (8192, True)])
def test_pair_attention_route_by_plan(n, takes):
    """B = 2000 frames, H = 40, Fo = 20: the plan takes N = 80 in the
    rows regime, and N = 100 (beyond the rows and grid regimes' shared
    memory) and every larger frame in the stream regime, whose shared
    memory does not grow with N (keys in chunks of 128).  On the CPU the
    layer gives the kernel route's plain version (compared at N <=
    100)."""
    g = torch.Generator().manual_seed(0)
    layer = VectorAttention.create(g, 20, 20, hidden_dim=40, device="cpu")
    assert layer.kernel_wiring
    plan = tpa.kernel_plan(2000, n, 40, 20)
    assert (not plan["refused"]) is takes
    assert plan["regime"] == ("rows" if n == 80 else "stream")
    n = min(n, 100)
    coords = torch.randn(2, n, 3, generator=g)
    values = torch.randn(2, n, 20, generator=g)
    mask = torch.rand(2, n, generator=g) < 0.8
    got = layer(coords, values, mask)
    want = layer.pair_grid(coords, values, mask.float())
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("bins,route", [(4469, "table"), (4470, "walk")])
def test_rqs_broadcast_row_route(bins, route):
    """One broadcast row: the knot table up to 4469 bins, the walk on the
    one row above, for any number of elements (a single one too); a row
    per element is always the walk's.  Every plan is a launch."""
    for n in (1, 50_000):
        plan = rqs.kernel_plan(n, bins, 1)
        assert plan["regime"] == route
        assert (plan["smem"] == 0) is (route == "walk")
        assert (plan["blocks"] - 1) * plan["threads"] < n
        assert n <= plan["blocks"] * plan["threads"]
    assert rqs.kernel_plan(50_000, bins, 50_000)["regime"] == "walk"


@pytest.mark.parametrize("K,most,n_runs", [
    (27 * 72, 10848, 1), (27 * 484, 13088, 1), (27 * 485, 13088, 2),
    (27 * 288, 7776, 1), (27 * 289, 7776, 2), (27 * 700, 7616, 3)])
def test_cell_lj_neighbour_runs(K, most, n_runs):
    """A neighbour block of K = 27 C slots: one launch while ``most``, the
    slots a launch takes (``csrc/cell_lj.cu``'s ``cell_lj_max_slots``; the
    values above are its answers at two exclusions a centre for C = 72
    with charges, C = 484 and 485 without species or charges, C = 288,
    289 and 700 with both, held on the card by
    ``test_cell_lj_max_slots``), allows, else equal runs of at most
    ``most`` that cover the block once."""
    runs = cell_lj.neighbour_runs(K, most)
    assert len(runs) == n_runs
    assert runs[0][0] == 0 and runs[-1][1] == K
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    sizes = [hi - lo for lo, hi in runs]
    assert max(sizes) <= most and max(sizes) - min(sizes) <= 1


def test_cell_lj_split_equals_the_whole_block(monkeypatch):
    """Half-energies and gradients of a block split into neighbour runs
    (the plain version in the kernel's place) add up to the unsplit
    block's, with species, charges and exclusions."""
    rng = np.random.default_rng(4)
    nc, C, n = 3, 6, 30
    Kn = 27 * C
    box = (6.0, 6.0, 6.0)
    f = lambda *s: torch.tensor(rng.uniform(0.0, 6.0, size=s),  # noqa: E731
                                dtype=torch.float32)
    cxt, nxt = f(nc, 3, C), f(nc, 3, Kn)
    cid = torch.tensor(rng.integers(0, n + 1, size=(nc, 1, C)),
                       dtype=torch.int32)
    nid = torch.tensor(rng.integers(0, n + 1, size=(nc, 1, Kn)),
                       dtype=torch.int32)
    sig = lambda s: torch.tensor(rng.uniform(0.9, 1.1, size=(nc, 1, s)),  # noqa: E731
                                 dtype=torch.float32)
    species = (sig(C), sig(Kn), sig(C), sig(Kn))
    charge = (sig(C) - 1.0, sig(Kn) - 1.0)
    excl = torch.tensor(rng.integers(-1, n, size=(nc, 2, C)),
                        dtype=torch.int32)
    kw = dict(n_atoms=n, sigma=1.0, epsilon=1.0, cutoff=2.5, box=box,
              coulomb_alpha=0.3)
    args = (cxt, nxt, cid, nid, species, charge, excl)
    want_e, want_g = cell_lj.cell_pair_energy_force_plain(*args, **kw)
    monkeypatch.setattr(cell_lj, "max_slots", lambda *a: 50)
    assert len(cell_lj.neighbour_runs(Kn, 50)) == 4
    got_e, got_g = cell_lj._split_call(cell_lj.cell_pair_energy_force_plain,
                                       *args, **kw)
    torch.testing.assert_close(got_e, want_e, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(got_g, want_g, atol=1e-4, rtol=1e-5)
