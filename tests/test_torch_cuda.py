"""The port's CUDA kernels against their plain versions, on a GPU.

Marked ``cuda``; without a card every test skips.  This file imports no
JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX).  chip_smoke.py
runs the same comparisons at the flagship's full shapes.
"""

import pytest
import torch

import copy

from vaemolsim_tpu_torch import _build
from vaemolsim_tpu_torch.config import backmapping_experiment_config
from vaemolsim_tpu_torch.flows.spline_flows import (
    MAFLayer, MaskedSplineConditioner, _bin_positions, _slopes)
from vaemolsim_tpu_torch.mcmc import fused as mf
from vaemolsim_tpu_torch.nn.attention import VectorAttention
from vaemolsim_tpu_torch.ops import attention as pa
from vaemolsim_tpu_torch.ops import maf_fused, rqs
from vaemolsim_tpu_torch.ops.fused_mlp import (dense_stack_plain,
                                               fused_dense_stack)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _spline(gen, dev, rows, K, spread=1.0):
    def raw(k):
        return spread * torch.randn(rows, k, generator=gen, device=dev)

    return (_bin_positions(raw(K), -5.0, 5.0, K),
            _bin_positions(raw(K), -5.0, 5.0, K), _slopes(raw(K - 1)))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("rows", ["per_row", "broadcast"])
def test_rqs_kernel_matches_plain(dev, inverse, rows):
    """Same knot sums in both: values to 1e-5 + 1e-5|y|, log-dets to
    1e-4 (FMA contraction and libm ulps; steep bins magnify them)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 3001
    params = _spline(gen, dev, n if rows == "per_row" else 1, 32)
    x = torch.rand(n, generator=gen, device=dev) * 14.0 - 7.0
    before = rqs.KERNEL.launches
    got = (rqs.rqs_inverse if inverse else rqs.rqs_forward)(x, *params, -5.0)
    assert rqs.KERNEL.launches == before + 1
    plain = rqs.rqs_inverse_plain if inverse else rqs.rqs_forward_plain
    want = plain(x, *params, -5.0)
    torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=0)


@pytest.mark.parametrize("act", ["relu", "tanh", None])
@pytest.mark.parametrize("cond_dim", [0, 3])
def test_dense_stack_kernel_matches_plain(dev, act, cond_dim):
    """Float32 sums of up to 200 terms in another order: 1e-4."""
    gen = torch.Generator(device=dev).manual_seed(1)
    dims = [2, 200, 64, 5]
    ks = [torch.randn(a, b, generator=gen, device=dev) / a ** 0.5
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [0.1 * torch.randn(b, generator=gen, device=dev) for b in dims[1:]]
    cks = ([0.3 * torch.randn(cond_dim, b, generator=gen, device=dev)
            for b in dims[1:]] if cond_dim else None)
    x = torch.randn(1001, dims[0], generator=gen, device=dev)
    c = torch.randn(1001, cond_dim, generator=gen, device=dev) \
        if cond_dim else None
    acts = [act, act, None]
    got = fused_dense_stack(x, ks, bs, acts, c, cks)
    want = dense_stack_plain(x, ks, bs, acts, c, cks)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def _stack(gen, dev, dims, dc):
    ks = [torch.randn(a, b, generator=gen, device=dev) / a ** 0.5
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [0.1 * torch.randn(b, generator=gen, device=dev) for b in dims[1:]]
    cks = ([0.3 * torch.randn(dc, b, generator=gen, device=dev)
            for b in dims[1:]] if dc else None)
    return ks, bs, cks


@pytest.mark.parametrize("dims,dc,acts", [
    ([1, 600, 95], 0, ["tanh", None]),          # the one-row conditioner
    ([2, 200, 2], 0, ["relu", None]),           # encoder
    ([20, 40, 9], 3, ["relu", "tanh"]),         # backmapping widths, cond
    ([4, 64, 8], 3, ["tanh", "relu"]),          # streaming, cond on both
    ([3, 64, 48, 33, 17, 9, 5, 4, 2], 2,        # 8 layers
     ["tanh", "relu", None, "tanh", "relu", "tanh", "relu", None]),
    ([5, 300, 95], 4, ["tanh", None]),          # wide head, cond
])
def test_dense_stack_regimes_match_plain(dev, dims, dc, acts):
    """Every regime of the kernel and its edges: N = 0, 1, 2 and the
    small-N limit 16 +- 1 (one cluster), 31, 33 (one tile +- 1), 777 and
    50k (streaming or tiled), each against the plain version, 1e-4 +
    1e-4|y|, one launch per call; ``stack_regime`` names the regime."""
    from vaemolsim_tpu_torch.ops import fused_mlp
    gen = torch.Generator(device=dev).manual_seed(9)
    ks, bs, cks = _stack(gen, dev, dims, dc)
    seen = set()
    for n in (0, 1, 2, 15, 16, 17, 31, 33, 777, 50_000):
        x = torch.randn(n, dims[0], generator=gen, device=dev)
        c = torch.randn(n, dc, generator=gen, device=dev) if dc else None
        before = fused_mlp.KERNEL.launches
        with torch.no_grad():
            got = fused_dense_stack(x, ks, bs, acts, c, cks)
        assert fused_mlp.KERNEL.launches == before + 1
        want = dense_stack_plain(x, ks, bs, acts, c, cks)
        assert got.shape == (n, dims[-1])
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4,
                                   msg=lambda m, n=n: f"N={n}: {m}")
        seen.add(fused_mlp.stack_regime(n, dims, dc)[0])
    assert "small" in seen and seen & {"stream", "tiled"}


def test_dense_stack_gradient_recomputes_through_plain(dev):
    gen = torch.Generator(device=dev).manual_seed(2)
    W1 = torch.randn(3, 16, generator=gen, device=dev).requires_grad_()
    W2 = torch.randn(16, 2, generator=gen, device=dev).requires_grad_()
    b1 = torch.zeros(16, device=dev, requires_grad=True)
    b2 = torch.zeros(2, device=dev, requires_grad=True)
    x = torch.randn(77, 3, generator=gen, device=dev)
    out = fused_dense_stack(x, [W1, W2], [b1, b2], ["tanh", None])
    got = torch.autograd.grad(out.square().sum(), [W1, W2, b1, b2])
    ref = dense_stack_plain(x, [W1, W2], [b1, b2], ["tanh", None])
    want = torch.autograd.grad(ref.square().sum(), [W1, W2, b1, b2])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def _proposal_model(gen, dev, H=64, K=16, B=2, d_x=2,
                    acts=("relu", "tanh")):
    """Flagship-shaped proposal weights, Glorot-scaled as the model's own
    initializer makes them, and spline tables of moderate bin contrast
    (raw parameters of spread 0.5; the model's init gives near-uniform
    bins).  Float32 densities are then well conditioned: against float64
    they err by under half the tolerances below.  (With unscaled weights
    a scale of softplus(-10) makes a log-density of -1e9, where roundoff
    alone exceeds any fixed tolerance.)"""
    def dense(i, o):
        return (torch.randn(i, o, generator=gen, device=dev)
                * (2.0 / (i + o)) ** 0.5,
                0.1 * torch.randn(o, generator=gen, device=dev))

    (ew1, eb1), (ew2, eb2) = dense(d_x, H), dense(H, 2)
    (dw1, db1), (dw2, db2) = dense(1, H), dense(H, 2 * d_x)
    return ((ew1, eb1, ew2, eb2), (dw1, db1, dw2, db2),
            _spline(gen, dev, B, K, spread=0.5),
            torch.tensor([0.0, 1.0], device=dev),
            mf._Spec(d_x, 1, acts[0], acts[1], K, -5.0))


def test_proposal_kernel_matches_plain(dev):
    """Flagship-shaped proposal (H = 64, K = 16) in Philox mode: both
    draw the same stream, so all five outputs agree (samples 1e-4,
    log-densities 1e-3)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    enc, dec, tables, base, spec = _proposal_model(gen, dev)
    x1 = torch.randn(2001, 2, generator=gen, device=dev)
    seed = torch.tensor([5, -6], dtype=torch.int32, device=dev)
    got = mf.fused_vae_proposal(x1, seed, enc, dec, tables, base, spec)
    want = mf.vae_proposal_plain(x1, seed, enc, dec, tables, base, spec)
    for name, g, w in zip(("x2", "fwd", "rev", "z1", "z2"), got, want):
        atol = 1e-3 if name in ("fwd", "rev") else 1e-4
        torch.testing.assert_close(g, w, atol=atol, rtol=1e-4,
                                   msg=lambda m, name=name: f"{name}: {m}")


def _close_but(name, got, want, atol, rtol, frac=1e-4):
    """got within atol + rtol|want| on all but a fraction ``frac`` of the
    elements (a value within roundoff of a spline knot may take the
    neighbouring bin), NaN where want is NaN."""
    bad = ~((got == want) | ((got - want).abs() <= atol + rtol * want.abs())
            | (got.isnan() & want.isnan()))
    assert int(bad.sum()) <= frac * got.numel(), (
        f"{name}: {int(bad.sum())} of {got.numel()} beyond atol={atol} "
        f"rtol={rtol}; max err {float((got - want).abs().nan_to_num().max())}")


@pytest.mark.parametrize("d_x", [1, 2, 5, 8])
@pytest.mark.parametrize("H", [1, 7, 64, 200, 300])
def test_proposal_kernel_edges(dev, d_x, H):
    """The lane groups' edges: R = 4 (d_x <= 4) and 2, H not a multiple
    of a step of 2R (zero-padded units), N = 1, 31 (one warp, part
    live), 2001 and 50 003 (ragged last block); relu and tanh, B = 1-3,
    K = 2, 16, 32, 64; noise-input and Philox modes.  All five outputs
    against the plain version at chip_smoke.py's tolerances: samples
    1e-4 + 1e-4|v|, log-densities 1e-3 + 1e-4|v|, a fraction 1e-4 of a
    large N may take a neighbouring spline bin at a knot."""
    case = [1, 2, 5, 8].index(d_x) + 4 * [1, 7, 64, 200, 300].index(H)
    acts = [("relu", "relu"), ("tanh", "relu"), ("relu", "tanh"),
            ("tanh", "tanh")][case % 4]
    B, K = 1 + case % 3, (2, 16, 32, 64)[case % 4]
    gen = torch.Generator(device=dev).manual_seed(100 + case)
    enc, dec, tables, base, spec = _proposal_model(gen, dev, H, K, B, d_x,
                                                   acts)
    seed = torch.tensor([case, -7], dtype=torch.int32, device=dev)
    for n in (1, 31, 2001, 50_003):
        x1 = torch.randn(n, d_x, generator=gen, device=dev)
        noise = torch.randn(n, 2 + d_x, generator=gen, device=dev)
        for nz in (noise, None):
            args = (x1, seed, enc, dec, tables, base, spec, nz)
            before = mf.KERNEL.launches
            got = mf.fused_vae_proposal(*args)
            assert mf.KERNEL.launches == before + 1
            want = mf.vae_proposal_plain(*args)
            for name, g, w in zip(("x2", "fwd", "rev", "z1", "z2"), got,
                                  want):
                assert g.shape == w.shape
                dens = name in ("fwd", "rev")
                _close_but(f"N={n} {'noise' if nz is not None else 'philox'}"
                           f" {name}", g, w, 1e-3 if dens else 1e-4, 1e-4)


@pytest.mark.parametrize("field,value", [
    ("R", 3), ("threads", 48), ("threads", 512), ("blocks", 1),
    ("smem", 1024)])
def test_proposal_launch_refuses_a_bad_plan(dev, monkeypatch, field, value):
    """The launch validates the plan it is given: R other than the
    compiled one, threads not a multiple of 32 or above 256, blocks
    short of N, shared bytes other than the shape's: each raises."""
    plan = mf.kernel_plan

    def bad(*a):
        got = dict(plan(*a))
        got[field] = value
        return got

    monkeypatch.setattr(mf, "kernel_plan", bad)
    gen = torch.Generator(device=dev).manual_seed(6)
    enc, dec, tables, base, spec = _proposal_model(gen, dev)
    x1 = torch.randn(5000, 2, generator=gen, device=dev)
    seed = torch.tensor([1, 2], dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="vae_proposal kernel launch"):
        mf.vae_proposal_cuda(x1, seed, enc, dec, tables, base, spec)


@pytest.mark.parametrize("K", [2, 8, 32, 128])
@pytest.mark.parametrize("rows", ["per_row", "broadcast"])
@pytest.mark.parametrize("inverse", [False, True])
def test_rqs_kernel_edges(dev, K, rows, inverse):
    """N = 1, 3, 4097 and 50 000, an input at an offset of one float,
    inputs on every knot of the
    row, NaN and +-inf: against the plain version at chip_smoke.py's
    tolerances (values 1e-5 + 1e-5|y|, log-dets 1e-4, NaN where it has
    NaN; a fraction 1e-4 of a large N may differ more: the inverse's
    root near a vanishing discriminant magnifies FMA contraction, 2 of
    50 000 on per-element rows at K = 8, where the kernel walks the bins),
    one launch a call."""
    gen = torch.Generator(device=dev).manual_seed(K)
    plain = rqs.rqs_inverse_plain if inverse else rqs.rqs_forward_plain
    fn = rqs.rqs_inverse if inverse else rqs.rqs_forward
    for n in (1, 3, 4097, 50_000):
        params = _spline(gen, dev, n if rows == "per_row" else 1, K)
        x = torch.rand(n + 1, generator=gen, device=dev) * 14.0 - 7.0
        kx, ky = rqs._knots(params[0][:1], params[1][:1], -5.0)
        on = torch.cat([kx[0], ky[0], torch.tensor(
            [float("nan"), float("inf"), -float("inf")], device=dev)])
        x[1:1 + min(n, on.numel())] = on[:n]
        for xin in (x[:n], x[1:]):
            before = rqs.KERNEL.launches
            got = fn(xin, *params, -5.0)
            assert rqs.KERNEL.launches == before + 1
            want = plain(xin, *params, -5.0)
            _close_but(f"N={n} y", got[0], want[0], 1e-5, 1e-5)
            _close_but(f"N={n} ldj", got[1], want[1], 1e-4, 0.0)


@pytest.mark.parametrize("field,value", [
    ("threads", 48), ("threads", 512), ("blocks", 1), ("smem", 1024)])
def test_rqs_launch_refuses_a_bad_plan(dev, monkeypatch, field, value):
    plan = rqs.kernel_plan

    def bad(*a):
        got = dict(plan(*a))
        got[field] = value
        return got

    monkeypatch.setattr(rqs, "kernel_plan", bad)
    gen = torch.Generator(device=dev).manual_seed(7)
    params = _spline(gen, dev, 1, 32)
    x = torch.rand(10_000, generator=gen, device=dev)
    with pytest.raises(RuntimeError, match="rqs kernel launch"):
        rqs.rqs_cuda(x, *params, -5.0, False)


def test_kernels_refuse_what_they_do_not_take(dev):
    """A CUDA tensor outside a kernel's contract raises; it never falls
    back to the plain version.  A dense stack no one launch takes raises
    in ``dense_stack_cuda``; its route splits it into launches."""
    gen = torch.Generator(device=dev).manual_seed(4)
    params = _spline(gen, dev, 1, 8)
    with pytest.raises(TypeError):
        rqs.rqs_forward(torch.zeros(4, device=dev, dtype=torch.float64),
                        *params, -5.0)
    wide = [torch.zeros(1, 30000, device=dev), torch.zeros(30000, 1,
                                                           device=dev)]
    wide_b = [torch.zeros(30000, device=dev), torch.zeros(1, device=dev)]
    from vaemolsim_tpu_torch.ops import fused_mlp
    with pytest.raises(ValueError, match="shared memory"):
        fused_mlp.dense_stack_cuda(torch.zeros(4, 1, device=dev), wide,
                                   wide_b, ["relu", None])
    # The route never sends that stack to a refused launch: it splits it
    # before any launch, a layer a launch (the wide regime).
    before = fused_mlp.KERNEL.launches
    got = fused_dense_stack(torch.zeros(4, 1, device=dev), wide, wide_b,
                            ["relu", None])
    assert fused_mlp.KERNEL.launches == before + 2
    assert torch.equal(got, torch.zeros(4, 1, device=dev))
    # What the wrapper mirrors, the kernel refuses itself: the same stack
    # straight through the launch returns cudaErrorInvalidValue.
    import ctypes
    x4, out = torch.zeros(4, 1, device=dev), torch.zeros(4, 1, device=dev)
    ptrs = ctypes.c_void_p * 2
    with pytest.raises(RuntimeError, match="dense_stack kernel launch"):
        fused_mlp.KERNEL.launch(
            dev, x4.data_ptr(), None, out.data_ptr(), 4, 2,
            (ctypes.c_int * 3)(1, 30000, 1), (ctypes.c_int * 2)(2, 0),
            ptrs(wide[0].data_ptr(), wide[1].data_ptr()),
            ptrs(wide[0].data_ptr(), out.data_ptr()), ptrs(None, None), 0,
            1)
    assert set(_build.launch_counts()) == {"rqs", "dense_stack",
                                           "vae_proposal", "maf_block",
                                           "pair_attention", "cell_lj"}


def _maf_layer(dev, D, cond_dim=None, circular=False, hidden=64, K=16):
    """A MAF block with weights scaled up from the init (which gives
    near-uniform bins) and non-zero biases."""
    gen = torch.Generator(device=dev).manual_seed(5 + D)
    cond = MaskedSplineConditioner.create(
        gen, D, bin_range=(-6.0, 6.0), num_bins=K, hidden_dim=hidden,
        conditional=cond_dim is not None, conditional_event_shape=cond_dim,
        input_order="left-to-right", circular=circular, device=dev)
    with torch.no_grad():
        for net in cond.nets:
            for k in net.kernels:
                k.mul_(4.0)
            for b in net.biases:
                b.add_(0.2 * torch.randn(b.shape, generator=gen, device=dev))
    return MAFLayer(cond)


@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("D,cond_dim,n", [(3, None, 2001), (8, None, 777),
                                          (3, 5, 1001), (1, 4, 513)])
def test_maf_block_kernel_matches_plain(dev, inverse, D, cond_dim, n):
    """The kernel against its plain version on the block's own merged
    weights, ragged row counts included: values to 1e-4 + 1e-4|v|,
    log-dets to 1e-3 + 1e-4|v| (sums of up to 200 products in another
    order than cuBLAS's, through steep bins)."""
    layer = _maf_layer(dev, D, cond_dim)
    cond = layer.conditioner
    gen = torch.Generator(device=dev).manual_seed(6)
    y = 3.0 * torch.randn(n, D, generator=gen, device=dev)
    ctx = (torch.randn(n, cond_dim, generator=gen, device=dev)
           if cond_dim else None)
    with torch.no_grad():
        params = [p for p in cond.merged_params() if p is not None]
        args = (y, params, ctx, D, cond.num_bins, cond.bin_min, cond.bin_max,
                inverse)
        before = maf_fused.KERNEL.launches
        got = maf_fused.maf_block_cuda(
            *args, degrees=cond.w_net.input_order_static)
        assert maf_fused.KERNEL.launches == before + 1
        want = maf_fused.maf_block_plain(*args)
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got[1], want[1], atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("order", ["left-to-right", "right-to-left",
                                   "random"])
@pytest.mark.parametrize("D,cond_dim", [(2, None), (3, None), (8, None),
                                        (2, 4), (3, 20), (8, 5)])
def test_maf_block_kernel_orders_and_sizes(dev, order, D, cond_dim):
    """The redesigned kernel (hidden units sorted by degree, the forward
    making each DOF once in order of degree) at D = 2, 3, 8, with and
    without a context, in all three input orders, at N = 1, 777 and 10k,
    both directions, against the plain version: values 1e-4 + 1e-4|v|,
    log-dets 1e-3 + 1e-4|v|; a fraction 1e-4 may land in a neighbouring
    bin at a knot."""
    from chip_smoke import compare
    gen = torch.Generator(device=dev).manual_seed(10 + D)
    io = (torch.randperm(D, generator=torch.Generator().manual_seed(D))
          .add(1).tolist() if order == "random" else order)
    cond = MaskedSplineConditioner.create(
        gen, D, bin_range=(-6.0, 6.0), num_bins=16, hidden_dim=64,
        conditional=cond_dim is not None, conditional_event_shape=cond_dim,
        input_order=io, device=dev)
    with torch.no_grad():
        for net in cond.nets:
            for k in net.kernels:
                k.mul_(4.0)
            for b in net.biases:
                b.add_(0.2 * torch.randn(b.shape, generator=gen, device=dev))
        params = [p for p in cond.merged_params() if p is not None]
        for n in (1, 777, 10_000):
            y = 3.0 * torch.randn(n, D, generator=gen, device=dev)
            ctx = (torch.randn(n, cond_dim, generator=gen, device=dev)
                   if cond_dim else None)
            for inverse in (True, False):
                args = (y, params, ctx, D, 16, -6.0, 6.0, inverse)
                got = maf_fused.maf_block_cuda(
                    *args, degrees=cond.w_net.input_order_static)
                want = maf_fused.maf_block_plain(*args)
                compare("x", got[0], want[0], 1e-4, 1e-4, 1e-4)
                compare("ldj", got[1], want[1], 1e-3, 1e-4, 1e-4)


@pytest.mark.parametrize("kind", ["D3", "D1 conditional", "D1", "circular",
                                  "3-D input"])
def test_maf_layer_routes_by_launch_counts(dev, kind):
    """Which route each kind of block takes on the card: the MAF-block
    kernel for a supported block (one launch per pass direction), the
    unfused route (dense stack, then RQS) for the 1-D unconditional
    block's constant spline, and the dense stack with the plain circular
    spline, or the dense stack and RQS for a 3-D input."""
    D = 1 if kind.startswith("D1") else 3
    cond_dim = 4 if kind == "D1 conditional" else None
    layer = _maf_layer(dev, D, cond_dim, circular=kind == "circular")
    shape = (2, 50, D) if kind == "3-D input" else (50, D)
    y = torch.randn(shape, device=dev)
    ctx = torch.randn(50, cond_dim, device=dev) if cond_dim else None
    _build.reset_launches()
    with torch.no_grad():
        layer.inverse_and_log_det(y, ctx)
        layer.forward_and_log_det(y, ctx)
    counts = _build.launch_counts()
    if kind in ("D3", "D1 conditional"):
        assert counts == {"rqs": 0, "dense_stack": 0, "vae_proposal": 0,
                          "maf_block": 2, "pair_attention": 0, "cell_lj": 0}
    else:
        assert counts["maf_block"] == 0 and counts["dense_stack"] > 0
        assert (counts["rqs"] > 0) == (kind != "circular")


def test_maf_layer_gradients_through_kernel_match_cpu(dev):
    """A training step's gradients through the kernel (recomputed through
    the plain version on the card) against a CPU copy of the block,
    for the density and the sampling pass, on rows away from the knots,
    of a batch-mean loss as in training: 1e-4 + 1e-3 relative.  (Run
    from the root of the checkout, which holds chip_smoke.py.)"""
    from chip_smoke import knot_safe
    layer = _maf_layer(dev, 4)
    cpu = copy.deepcopy(layer).to("cpu")
    y = 2.0 * torch.randn(300, 4, generator=torch.Generator(
        device=dev).manual_seed(7), device=dev)
    for name in ("inverse_and_log_det", "forward_and_log_det"):
        keep = knot_safe([cpu], y, name.startswith("inverse"))
        assert int(keep.sum()) > 250
        grads = []
        for m, t in ((layer, y[keep.to(dev)]), (cpu, y.cpu()[keep])):
            m.zero_grad()
            x, ldj = getattr(m, name)(t)
            ((x ** 2).sum(-1) + ldj).mean().backward()
            grads.append([p.grad.cpu() for p in m.parameters()])
        for g, w in zip(*grads):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-3)


def test_maf_block_kernel_refuses_what_it_does_not_take(dev):
    layer = _maf_layer(dev, 3)
    params = [p.detach() for p in layer.conditioner.merged_params()
              if p is not None]
    with pytest.raises(TypeError):
        maf_fused.maf_block_cuda(torch.zeros(4, 3, device=dev,
                                             dtype=torch.float64),
                                 params, None, 3, 16, -6.0, 6.0, True,
                                 degrees=(1, 2, 3))
    with pytest.raises(ValueError, match="degrees"):
        maf_fused.maf_block_cuda(torch.zeros(4, 3, device=dev), params, None,
                                 3, 16, -6.0, 6.0, True)
    with pytest.raises(ValueError, match="permutation"):
        maf_fused.maf_block_cuda(torch.zeros(4, 3, device=dev), params, None,
                                 3, 16, -6.0, 6.0, True, degrees=(1, 1, 2))
    big = [torch.zeros(3, 3 * 6000, device=dev),
           torch.zeros(3 * 6000, device=dev),
           torch.zeros(3 * 6000, 3 * 47, device=dev),
           torch.zeros(3 * 47, device=dev)]
    with pytest.raises(RuntimeError, match="maf_block kernel launch failed"):
        maf_fused.maf_block_cuda(torch.zeros(4, 3, device=dev), big, None, 3,
                                 16, -6.0, 6.0, True, degrees=(1, 2, 3))


@pytest.mark.parametrize("inverse", [True, False])
def test_maf_block_kernel_reads_only_diagonal_blocks_of_k2(dev, inverse):
    """The kernel's contract: k2 is block-diagonal over the three heads
    and MADE-masked, and it reads only the diagonal blocks' unmasked
    entries.  With noise off the diagonal blocks and in the masked
    entries its output is the plain version's on the clean k2 (1e-4 +
    1e-4|v|, log-dets 1e-3 + 1e-4|v|)."""
    layer = _maf_layer(dev, 3)
    cond = layer.conditioner
    with torch.no_grad():
        k1, b1, k2, b2 = [p for p in cond.merged_params() if p is not None]
        gen = torch.Generator(device=dev).manual_seed(8)
        off = torch.block_diag(*[n.masks[1] for n in cond.nets]) == 0
        noisy = torch.where(off, torch.randn(k2.shape, generator=gen,
                                             device=dev), k2)
        y = 3.0 * torch.randn(501, 3, generator=gen, device=dev)
        args = (3, cond.num_bins, cond.bin_min, cond.bin_max, inverse)
        got = maf_fused.maf_block_cuda(y, [k1, b1, noisy, b2], None, *args,
                                       degrees=(1, 2, 3))
        want = maf_fused.maf_block_plain(y, [k1, b1, k2, b2], None, *args)
    assert bool(off.any())
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got[1], want[1], atol=1e-3, rtol=1e-4)


def _attention(dev, N, H, B, seed, F=20, Fo=20, activation="relu"):
    """A create()-wired layer with its parameters moved off their init,
    a cloud of spread 1.5, values and a mask with a fully masked row
    (frame 0, particle 1) and a fully masked cloud (frame 1)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    attn = VectorAttention.create(gen, F, Fo, hidden_dim=H, device=dev,
                                  activation=activation)
    with torch.no_grad():
        for p in attn.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen, device=dev))
    c = 1.5 * torch.randn(B, N, 3, generator=gen, device=dev)
    v = torch.randn(B, N, F, generator=gen, device=dev)
    m = (torch.rand(B, N, generator=gen, device=dev) > 0.3).float()
    m[0, 1] = 0.0
    m[1] = 0.0
    return attn, c, v, m


@pytest.mark.parametrize("reduce", [False, True])
@pytest.mark.parametrize("N,H,B", [(10, 40, 2000), (50, 64, 200),
                                   (37, 40, 100)])
def test_pair_attention_kernel_matches_plain(dev, reduce, N, H, B):
    """At chip_smoke.py's shapes (the notebook's, the compute-dense one
    and a ragged N): 1e-5 + 1e-5|v| (LayerNorm, softmax and contraction
    sums in another order; the value head folded through the
    contraction); masked rows and clouds exactly zero."""
    attn, c, v, m = _attention(dev, N, H, B, N + H)
    attn.reduce = reduce
    with torch.no_grad():
        (c_, *nodes, mf_, weights), kw = attn.pair_args(c, v, m)
        before = pa.KERNEL.launches
        got = pa.pair_attention_cuda(c_, *nodes, mf_, *weights, **kw)
        assert pa.KERNEL.launches == before + 1
        want = pa.pair_attention_plain(c_, *nodes, mf_, *weights, **kw)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert float(got[1].abs().max()) == 0.0
    if not reduce:
        assert float(got[0, 1].abs().max()) == 0.0


@pytest.mark.parametrize("act", ["relu", "tanh", "linear"])
@pytest.mark.parametrize("reduce", [False, True])
@pytest.mark.parametrize("N,H,B", [
    (10, 40, 2000),   # 8 lanes of 5 units, 3 frames a block, B % 3 = 2
    (10, 64, 301),    # 16 lanes of 4 units
    (10, 20, 97),     # 4 lanes of 5 units
    (7, 16, 55),      # 4 lanes of 4 units
    (5, 3, 40),       # one lane a row, 4 units of which 1 is padding
    (12, 100, 64),    # 32 lanes of 4 units, 28 of them padding
    (6, 256, 33),     # 32 lanes of 8 units
    (50, 64, 20),     # the grid regime (one rows block of 16 groups)
    (37, 40, 9)])     # ragged N, one frame a block
def test_pair_attention_regimes_and_activations(dev, act, reduce, N, H, B):
    """Every lane-group shape the plan picks from H, frames per block
    from N and B, the grid regime at N = 50, H = 64, each activation, both
    modes: 1e-5 + 1e-5|v|; the fully masked row and cloud exactly zero."""
    attn, c, v, m = _attention(dev, N, H, B, 7 * N + H, activation=act)
    attn.reduce = reduce
    with torch.no_grad():
        (c_, *nodes, mf_, weights), kw = attn.pair_args(c, v, m)
        got = pa.pair_attention_cuda(c_, *nodes, mf_, *weights, **kw)
        want = pa.pair_attention_plain(c_, *nodes, mf_, *weights, **kw)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert float(got[1].abs().max()) == 0.0
    if not reduce:
        assert float(got[0, 1].abs().max()) == 0.0


@pytest.mark.parametrize("reduce", [False, True])
@pytest.mark.parametrize("regime", ["rows", "grid"])
@pytest.mark.parametrize("N,H,B", [
    (10, 40, 2000),   # the notebook's layer
    (24, 64, 97),     # between the regimes' shapes
    (37, 40, 9),      # ragged N
    (50, 64, 20)])    # compute-dense
def test_pair_attention_both_regimes(dev, monkeypatch, regime, reduce, N, H,
                                     B):
    """Each regime forced at shapes the rule gives to either one: 1e-5 +
    1e-5|v| against the plain version; the fully masked row and cloud
    exactly zero."""
    plan = pa.kernel_plan
    monkeypatch.setattr(pa, "kernel_plan",
                        lambda *a: plan(*a, regime=regime))
    attn, c, v, m = _attention(dev, N, H, B, 3 * N + H)
    attn.reduce = reduce
    with torch.no_grad():
        (c_, *nodes, mf_, weights), kw = attn.pair_args(c, v, m)
        got = pa.pair_attention_cuda(c_, *nodes, mf_, *weights, **kw)
        want = pa.pair_attention_plain(c_, *nodes, mf_, *weights, **kw)
    assert pa.kernel_plan(B, N, H, 20)["regime"] == regime
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert float(got[1].abs().max()) == 0.0
    if not reduce:
        assert float(got[0, 1].abs().max()) == 0.0


@pytest.mark.parametrize("act", ["relu", "tanh", "linear"])
@pytest.mark.parametrize("reduce", [False, True])
def test_pair_attention_takes_more_than_256_hidden_units(dev, act, reduce):
    """H = 300 is wider than a warp's lanes hold in the rows regime: the
    grid regime runs it, and a create()-wired VectorAttention launches the
    kernel once: 1e-5 + 1e-5|v| against the plain version."""
    attn, c, v, m = _attention(dev, 12, 300, 40, 5, activation=act)
    attn.reduce = reduce
    assert attn.kernel_wiring
    assert pa.kernel_plan(40, 12, 300, 20)["regime"] == "grid"
    with torch.no_grad():
        (c_, *nodes, mf_, weights), kw = attn.pair_args(c, v, m)
        want = pa.pair_attention_plain(c_, *nodes, mf_, *weights, **kw)
        _build.reset_launches()
        out = attn(c, v, m > 0.5)
    assert _build.launch_counts()["pair_attention"] == 1
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("field,value", [
    ("smem", 1024), ("lanes", 3), ("units", 3), ("frames", 9),
    ("lanes", 4)])
def test_pair_attention_launch_refuses_a_bad_plan(dev, monkeypatch, field,
                                                  value):
    """The launch validates the plan it is given: shared memory short of
    the frames' need, lanes not a power of two, units not compiled, more
    than 8 frames, lanes x units short of H: each raises."""
    plan = pa.kernel_plan

    def bad(*a):
        got = dict(plan(*a))
        got[field] = value
        return got

    monkeypatch.setattr(pa, "kernel_plan", bad)
    attn, c, v, m = _attention(dev, 10, 40, 16, 1)
    with torch.no_grad():
        (c_, *nodes, mf_, weights), kw = attn.pair_args(c, v, m)
        with pytest.raises(RuntimeError, match="pair_attention kernel"):
            pa.pair_attention_cuda(c_, *nodes, mf_, *weights, **kw)


@pytest.mark.parametrize("wiring", ["create", "value_d1_activation"])
def test_vector_attention_routes_by_launch_counts(dev, wiring):
    """A create()-wired layer on the card launches only the
    pair-attention kernel; one with an activation on value_net.d1 is not
    the kernel's wiring and launches nothing."""
    attn, c, v, m = _attention(dev, 10, 40, 64, 1)
    if wiring != "create":
        attn.value_net.d1.activation = "tanh"
    _build.reset_launches()
    with torch.no_grad():
        out = attn(c, v, m > 0.5)
    counts = _build.launch_counts()
    assert out.shape == (64, 10, 20)
    want = 1 if wiring == "create" else 0
    assert counts == {"rqs": 0, "dense_stack": 0, "vae_proposal": 0,
                      "maf_block": 0, "pair_attention": want, "cell_lj": 0}


def test_pair_attention_gradients_recompute_through_plain(dev):
    """Gradients through the kernel route (recomputed through the plain
    version) equal autograd through the plain version, for the values,
    the coordinates and every weight: 1e-4 + 1e-4|g|."""
    attn, c, v, m = _attention(dev, 10, 40, 300, 2)
    c.requires_grad_()
    v.requires_grad_()
    leaves = [c, v, *attn.parameters()]
    got = torch.autograd.grad(attn.pair_grid(c, v, m).square().sum(), leaves)
    want = torch.autograd.grad(
        attn.plain_call(c, v, m > 0.5).square().sum(), leaves)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def test_backmapping_path_launches_kernels_5_3_and_2(dev):
    """The notebook model, built with no device, on the card: log_prob,
    predict and one training step each launch the pair-attention, MAF
    block and dense-stack kernels and nothing else."""
    import numpy as np
    bm = backmapping_experiment_config().build()
    assert next(bm.parameters()).is_cuda
    rng = np.random.default_rng(3)
    ref, coords, info, tors = (torch.tensor(a, dtype=torch.float32,
                                            device=dev) for a in (
        0.3 * rng.normal(size=(256, 3)), 1.5 * rng.normal(size=(256, 30, 3)),
        rng.normal(size=(256, 30, 2)), rng.uniform(-3, 3, size=(256, 3))))
    gen = torch.Generator(device=dev).manual_seed(4)
    for name in ("log_prob", "predict", "train"):
        _build.reset_launches()
        if name == "log_prob":
            with torch.no_grad():
                out = bm.log_prob(ref, coords, info, tors)
            assert out.shape == (256,)
        elif name == "predict":
            with torch.no_grad():
                out = bm.predict(ref, coords, info, gen)
            assert out.shape == (256, 3)
        else:
            out = -bm.log_prob(ref, coords, info, tors).mean()
            out.backward()
        assert bool(torch.isfinite(out).all())
        counts = _build.launch_counts()
        assert counts["pair_attention"] == 3, (name, counts)
        assert counts["maf_block"] == 3 and counts["dense_stack"] > 0
        assert counts["rqs"] == counts["vae_proposal"] == 0
        assert counts["cell_lj"] == 0


# ---------------------------------------------------------------------------
# Kernel 6: the cell-pair LJ / Ewald real-space block
# ---------------------------------------------------------------------------


def _cell_system(dev, branch, box=(16.0, 16.0, 16.0), n=1800, capacity=48,
                 seed=9, cutoff=2.5):
    """A jittered-lattice system with numpy-made positions and a cell list
    of the given capacity on the card, in one branch of the kernel:
    scalar, species (sigma in {1, 0.88}, epsilon in {1, 0.5}), coulomb
    (+-0.5, alpha 1.2), exclusion (1-2 and 1-3 on triples) or all."""
    import numpy as np
    from vaemolsim_tpu_torch import potentials as tp
    rng = np.random.default_rng(seed)
    box = np.asarray(box)
    m = int(np.ceil(n ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n]
    x = (g + 0.5) * box / m + 0.15 * rng.normal(size=(n, 3))
    kw = {}
    if branch in ("species", "all"):
        sig = np.where(np.arange(n) % 3 == 0, 0.88, 1.0)
        kw.update(sigma=sig, epsilon=np.where(sig == 1.0, 1.0, 0.5))
    if branch in ("coulomb", "all"):
        kw.update(charges=np.tile([0.5, -0.5], n // 2), coulomb_alpha=1.2)
    if branch in ("exclusion", "all"):
        kw["exclude"] = np.array(
            [[3 * k, 3 * k + 1] for k in range(n // 3)]
            + [[3 * k + 1, 3 * k + 2] for k in range(n // 3)]
            + [[3 * k, 3 * k + 2] for k in range(n // 3)])
    build, energy = tp.lennard_jones_cell_neighbor(
        box=box.tolist(), cutoff=cutoff, skin=0.4, capacity=capacity,
        device=dev, **kw)
    return build, energy, torch.tensor(x, dtype=torch.float32, device=dev)


def _assert_cell_close(got, want):
    """Per-cell energies to 1e-5 relative (of the largest), gradients to
    1e-4 of the largest component + 1e-5: float32 sums of up to 27 C
    terms in another order, with the pair masks equal by construction."""
    (e, g), (ew, gw) = got, want
    assert bool(torch.isfinite(e).all() and torch.isfinite(g).all())
    torch.testing.assert_close(e, ew, rtol=1e-5,
                               atol=1e-5 * float(ew.abs().max()))
    torch.testing.assert_close(e.sum(), ew.sum(), rtol=1e-5, atol=0)
    torch.testing.assert_close(g, gw, rtol=0,
                               atol=1e-4 * float(gw.abs().max()) + 1e-5)


@pytest.mark.parametrize("branch", ["scalar", "species", "coulomb",
                                    "exclusion", "all"])
def test_cell_lj_kernel_matches_plain(dev, branch):
    from vaemolsim_tpu_torch.ops import cell_lj
    build, energy, x = _cell_system(dev, branch)
    args, kw = energy.cell_pair_inputs(build(x), x)
    before = cell_lj.KERNEL.launches
    got = cell_lj.cell_pair_energy_force_cuda(*args, **kw)
    assert cell_lj.KERNEL.launches == before + 1
    _assert_cell_close(got, cell_lj.cell_pair_energy_force_plain(*args, **kw))


def test_cell_lj_kernel_ragged_grid_and_capacity(dev):
    """A 5 x 6 x 7 grid (210 cells) at capacity 37 (not a multiple of the
    block's 12 warps), every branch on."""
    from vaemolsim_tpu_torch.ops import cell_lj
    build, energy, x = _cell_system(dev, "all", box=(14.5, 17.4, 20.3),
                                    n=3000, capacity=37)
    args, kw = energy.cell_pair_inputs(build(x), x)
    assert args[0].shape == (210, 3, 37)
    _assert_cell_close(cell_lj.cell_pair_energy_force_cuda(*args, **kw),
                       cell_lj.cell_pair_energy_force_plain(*args, **kw))


def test_cell_lj_coincident_atoms_stay_finite(dev):
    from vaemolsim_tpu_torch.ops import cell_lj
    build, energy, x = _cell_system(dev, "all")
    x[7] = x[3]
    args, kw = energy.cell_pair_inputs(build(x), x)
    _assert_cell_close(cell_lj.cell_pair_energy_force_cuda(*args, **kw),
                       cell_lj.cell_pair_energy_force_plain(*args, **kw))


@pytest.mark.parametrize("case", ["overflow", "drift"])
def test_cell_lj_invalid_list_is_nan_on_the_card(dev, case):
    """An overflowed build or a drift past skin / 2: NaN energy and NaN
    gradient through the kernel route."""
    from vaemolsim_tpu_torch.ops import cell_lj
    build, energy, x = _cell_system(dev, "scalar",
                                    capacity=4 if case == "overflow" else 48)
    nl = build(x)
    assert bool(nl.overflow) == (case == "overflow")
    if case == "drift":
        x = x.clone()
        x[11, 2] += 0.3
    x = x.requires_grad_()
    before = cell_lj.KERNEL.launches
    e = energy(nl, x)
    (g,) = torch.autograd.grad(e, x)
    assert cell_lj.KERNEL.launches == before + 1
    assert bool(torch.isnan(e)) and bool(torch.isnan(g).all())


def test_cell_energy_on_the_card_launches_only_kernel_6(dev):
    """A CUDA lennard_jones_cell_neighbor energy and its gradient: one
    launch of the cell-pair kernel and of nothing else; the gradient
    equals the plain block's mapped back to atom order."""
    from vaemolsim_tpu_torch.ops import cell_lj
    build, energy, x = _cell_system(dev, "all")
    nl = build(x)
    x = x.requires_grad_()
    _build.reset_launches()
    e = energy(nl, x)
    (g,) = torch.autograd.grad(e, x)
    counts = _build.launch_counts()
    assert counts == {"rqs": 0, "dense_stack": 0, "vae_proposal": 0,
                      "maf_block": 0, "pair_attention": 0, "cell_lj": 1}
    args, kw = energy.cell_pair_inputs(nl, x.detach())
    ew, gw = cell_lj.cell_pair_energy_force_plain(*args, **kw)
    gw = gw.transpose(1, 2).reshape(-1, 3)[nl.atom_slot.long()]
    torch.testing.assert_close(e, ew.sum(), rtol=1e-5, atol=0)
    torch.testing.assert_close(g, gw, rtol=0,
                               atol=1e-4 * float(gw.abs().max()) + 1e-5)


def _cell_blocks(dev, n_cells, C, K, n, *, seed, spread=6.0, real=0.6,
                 D=0, species=False, charges=False, alpha=1.2):
    """Hand-made cell-pair inputs (numpy-seeded): positions uniform in a
    cube of edge ``spread`` inside a box of 12, each slot real with
    probability ``real`` (padding id n anywhere in a block, not only at
    its end), exclusion lists of D random ids with -1 padding."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def ids(w):
        i = rng.integers(0, n, size=(n_cells, 1, w))
        return np.where(rng.random((n_cells, 1, w)) < real, i, n)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    def i32(a):
        return torch.tensor(np.asarray(a, np.int32), device=dev)

    args = [f32(rng.random((n_cells, 3, C)) * spread),
            f32(rng.random((n_cells, 3, K)) * spread), i32(ids(C)),
            i32(ids(K)), None, None, None]
    if species:
        args[4] = tuple(f32(rng.uniform(lo, hi, (n_cells, 1, w)))
                        for lo, hi, w in ((0.85, 1.0, C), (0.85, 1.0, K),
                                          (0.7, 1.0, C), (0.7, 1.0, K)))
    if charges:
        args[5] = (f32(rng.choice([-0.5, 0.5], (n_cells, 1, C))),
                   f32(rng.choice([-0.5, 0.5], (n_cells, 1, K))))
    if D:
        ex = rng.integers(0, n, size=(n_cells, D, C))
        args[6] = i32(np.where(rng.random(ex.shape) < 0.7, ex, -1))
    kw = dict(n_atoms=n, sigma=1.0, epsilon=1.0, cutoff=2.5,
              box=(12.0, 12.0, 12.0), shift=True,
              coulomb_alpha=alpha if charges else 0.0)
    return args, kw


@pytest.mark.parametrize("case", [
    "dense cluster", "empty cells", "full cells", "ragged C and K",
    "exclusions D=3", "coincident", "one block a cell",
    "eight blocks a cell"])
def test_cell_lj_kernel_schedule_cases(dev, case):
    """The compacted scan, the per-warp queue and the block split on
    hand-made blocks: every slot of a cluster inside the cutoff (the
    queue flushes every 32 pairs), cells with no real slot, cells with no
    padding, C = 37 and K = 999 (neither a multiple of the warp or of the
    block's 8 warps), exclusion lists of D = 3, coincident atoms, and the
    split at 1 and at 8 blocks a cell (from n_atoms / n_cells): same
    tolerances as on the paths' inputs."""
    from vaemolsim_tpu_torch.ops import cell_lj
    kw = dict(seed=sum(map(ord, case)))
    shape = dict(n_cells=6, C=24, K=27 * 24, n=400)
    if case == "dense cluster":
        kw.update(spread=1.2, real=1.0, species=True, charges=True, D=1)
    elif case == "empty cells":
        kw.update(real=0.0)
    elif case == "full cells":
        kw.update(real=1.0, charges=True)
    elif case == "ragged C and K":
        shape.update(C=37, K=999)
        kw.update(species=True, charges=True, D=2)
    elif case == "exclusions D=3":
        shape.update(n=60)
        kw.update(D=3, spread=3.0)
    elif case == "one block a cell":
        shape.update(n_cells=50, n=100)
    elif case == "eight blocks a cell":
        shape.update(n_cells=4, n=5000)
    args, ckw = _cell_blocks(dev, shape["n_cells"], shape["C"], shape["K"],
                             shape["n"], **kw)
    if case == "coincident":
        args[1][:, :, 5] = args[0][:, :, 2]
        args[1][:, :, 9] = args[1][:, :, 5]
    if case == "empty cells":
        args[2].fill_(shape["n"])
    got = cell_lj.cell_pair_energy_force_cuda(*args, **ckw)
    want = cell_lj.cell_pair_energy_force_plain(*args, **ckw)
    if case == "empty cells":
        assert float(got[0].abs().max()) == 0.0
        assert float(got[1].abs().max()) == 0.0
    else:
        _assert_cell_close(got, want)


def test_cell_lj_kernel_refuses_what_it_does_not_take(dev):
    from vaemolsim_tpu_torch.ops import cell_lj
    build, energy, x = _cell_system(dev, "scalar")
    (cxt, nxt, cid, nid, *_), kw = energy.cell_pair_inputs(build(x), x)
    with pytest.raises(TypeError):
        cell_lj.cell_pair_energy_force_cuda(cxt.double(), nxt, cid, nid, **kw)
    with pytest.raises(TypeError):
        cell_lj.cell_pair_energy_force_cuda(cxt, nxt, cid.long(), nid, **kw)
    # 27 * 600 neighbour slots need 282 KB of shared memory: refused.
    big = torch.zeros(2, 3, 600, device=dev)
    ids = torch.zeros(2, 1, 600, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="cell_lj kernel launch failed"):
        cell_lj.cell_pair_energy_force_cuda(
            big, torch.zeros(2, 3, 16200, device=dev), ids,
            torch.zeros(2, 1, 16200, dtype=torch.int32, device=dev), **kw)


def test_cell_lj_kernel_takes_wide_blocks(dev):
    """27 * 400 = 10 800 neighbour slots a cell (more than 32 occupancy
    bits a thread cover) fit shared memory: the kernel takes them, within
    the paths' tolerances."""
    from vaemolsim_tpu_torch.ops import cell_lj
    args, ckw = _cell_blocks(dev, 2, 400, 27 * 400, 3000, seed=11,
                             charges=True)
    got = cell_lj.cell_pair_energy_force_cuda(*args, **ckw)
    want = cell_lj.cell_pair_energy_force_plain(*args, **ckw)
    _assert_cell_close(got, want)


@pytest.mark.parametrize("split", [0, 9])
def test_cell_lj_launch_refuses_a_bad_split(dev, monkeypatch, split):
    """The launch validates the blocks per cell it is given (1 to 8)."""
    from vaemolsim_tpu_torch.ops import cell_lj
    monkeypatch.setattr(cell_lj, "cluster_split", lambda *a: split)
    args, ckw = _cell_blocks(dev, 3, 24, 27 * 24, 100, seed=2)
    with pytest.raises(RuntimeError, match="cell_lj kernel launch failed"):
        cell_lj.cell_pair_energy_force_cuda(*args, **ckw)


@pytest.mark.parametrize("dims,n", [
    ([1, 100, 95], 1),        # the 1-D RealNVP's one-row conditioner
    ([1, 64, 47], 20_000),    # the 2-D RealNVP's conditioner, a row each
])
def test_dense_stack_coupling_conditioner_shapes(dev, dims, n):
    """The RealNVP conditioners' stacks (tanh trunk, three linear heads
    merged) against the plain version: 1e-4 + 1e-4|y|, one launch."""
    from vaemolsim_tpu_torch.ops import fused_mlp
    gen = torch.Generator(device=dev).manual_seed(21)
    ks, bs, _ = _stack(gen, dev, dims, 0)
    x = torch.randn(n, dims[0], generator=gen, device=dev)
    before = fused_mlp.KERNEL.launches
    with torch.no_grad():
        got = fused_dense_stack(x, ks, bs, ["tanh", None])
    assert fused_mlp.KERNEL.launches == before + 1
    want = dense_stack_plain(x, ks, bs, ["tanh", None])
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("inverse", [False, True])
def test_rqs_kernel_per_element_rows_k16(dev, inverse):
    """Kernel 1's row per element at the 2-D RealNVP's shape (K = 16,
    N = 20k, bins on [-8, 8]): 1e-5 + 1e-5|y| on values, 1e-4 on
    log-dets, a fraction 1e-4 of rows allowed on a knot; one launch."""
    gen = torch.Generator(device=dev).manual_seed(22)
    n, K = 20_000, 16
    raw = [torch.randn(n, 1, k, generator=gen, device=dev)
           for k in (K, K, K - 1)]
    params = (_bin_positions(raw[0], -8.0, 8.0, K),
              _bin_positions(raw[1], -8.0, 8.0, K), _slopes(raw[2]))
    x = torch.randn(n, 1, generator=gen, device=dev) * 4.0
    before = rqs.KERNEL.launches
    got = (rqs.rqs_inverse if inverse else rqs.rqs_forward)(x, *params,
                                                           -8.0)
    assert rqs.KERNEL.launches == before + 1
    want = (rqs.rqs_inverse_plain if inverse else rqs.rqs_forward_plain)(
        x, *params, -8.0)
    for g_, w_, atol, rtol in ((got[0], want[0], 1e-5, 1e-5),
                               (got[1], want[1], 1e-4, 0.0)):
        bad = ((g_ - w_).abs() > atol + rtol * w_.abs()).float().mean()
        assert float(bad) <= 1e-4


def test_mala_in_a_cycle_with_the_vae_step_on_the_card(dev):
    """One cycled (VAE step, MALA) step of the flagship on the card: the
    VAE step launches kernels 1 and 2, MALA on an analytic target none;
    finite chains and exact counters."""
    from vaemolsim_tpu_torch.config import flagship_experiment_config
    from vaemolsim_tpu_torch.mcmc import (MCMCState, cycle_moves,
                                          make_mala_step, make_mcmc_step,
                                          run_mcmc, vae_proposal_fns)
    vae = flagship_experiment_config().build(dev)

    def log_p(x):
        return -0.5 * (x ** 2).sum(-1)

    gen = torch.Generator(device=dev).manual_seed(23)
    x = torch.randn(4096, 2, generator=gen, device=dev)
    st = MCMCState.create(x, log_p(x), gen)
    mala = make_mala_step(log_p, 0.3)
    _build.reset_launches()
    st, _ = run_mcmc(mala, st, 1)
    assert sum(_build.launch_counts().values()) == 0
    step = cycle_moves([make_mcmc_step(*vae_proposal_fns(vae), log_p), mala])
    st, _ = run_mcmc(step, st, 1)
    counts = _build.launch_counts()
    assert counts["rqs"] > 0 and counts["dense_stack"] > 0
    assert int(st.num_trials) == 3 * 4096
    assert bool(torch.isfinite(st.configs).all())


def test_remc_replica_axis_launches_kernels_1_and_2(dev):
    """REMC's (R, C, 2) proposal batch goes through the kernels (the
    wrappers take the leading axes): kernels 1 and 2 launch, trials and
    swap attempts are exact."""
    from vaemolsim_tpu_torch.config import flagship_experiment_config
    from vaemolsim_tpu_torch.mcmc import vae_proposal_fns
    from vaemolsim_tpu_torch.parallel import (REMCState, make_remc_step,
                                              run_remc, temperature_ladder)
    vae = flagship_experiment_config().build(dev)

    def log_p(x):
        return -0.5 * (x ** 2).sum(-1)

    gen = torch.Generator(device=dev).manual_seed(24)
    st = REMCState.create(torch.randn(4, 500, 2, generator=gen, device=dev),
                          log_p, temperature_ladder(4), gen)
    _build.reset_launches()
    st = run_remc(make_remc_step(*vae_proposal_fns(vae), log_p), st, 2)
    counts = _build.launch_counts()
    assert counts["rqs"] > 0 and counts["dense_stack"] > 0
    assert int(st.num_trials) == 2 * 4 * 500
    assert int(st.num_swap_trials) == (2 + 1) * 500


# ---------------------------------------------------------------------------
# Slice 9: the new shapes of kernels 2 and 3, the HVAE's second
# derivatives, and create() on the card by default
# ---------------------------------------------------------------------------


def test_dense_stack_at_the_autoregressive_made(dev):
    """Kernel 2 at the autoregressive head's MADE (3 DOFs, 8 parameters
    each: 3 -> 24 -> 24 tanh, masked weights) at 10k rows, and the
    AutoregressiveBlockwise distribution on the card launching it."""
    from vaemolsim_tpu_torch.dists import (AutoregressiveBlockwise,
                                           register_von_mises_mixture)
    gen = torch.Generator(device=dev).manual_seed(30)
    layer = AutoregressiveBlockwise.create(
        gen, 3, register_von_mises_mixture(2))
    made = layer.made
    assert made.kernels[0].is_cuda
    ks = [(k * m).detach() * 10.0 for k, m in zip(made.kernels, made.masks)]
    bs = [0.1 * torch.randn(b.shape, generator=gen, device=dev)
          for b in made.biases]
    x = torch.rand(10_000, 3, generator=gen, device=dev) * 6.0 - 3.0
    before = _build.KERNELS["dense_stack"].launches
    got = fused_dense_stack(x, ks, bs, ["tanh", None])
    assert _build.KERNELS["dense_stack"].launches == before + 1
    torch.testing.assert_close(got, dense_stack_plain(x, ks, bs,
                                                      ["tanh", None]),
                               atol=1e-4, rtol=1e-4)
    raw = torch.randn(10_000, 3, 8, generator=gen, device=dev)
    dist = layer(raw)
    _build.reset_launches()
    with torch.no_grad():
        s = dist.sample(gen)
        lp = dist.log_prob(s)
    assert _build.KERNELS["dense_stack"].launches == 4  # 3 passes + 1
    assert bool(torch.isfinite(lp).all())
    assert bool((s.abs() <= 3.1416).all())
    # The fixed point on a CUDA generator: a fourth pass on the same
    # noise changes nothing and leaves the generator where it was.
    g = torch.Generator(device=dev).manual_seed(31)
    start = g.get_state()
    with torch.no_grad():
        x = dist.sample(g)
        after = g.get_state()
        g.set_state(start)
        assert torch.equal(dist._dist_at(x).sample(g), x)
    assert torch.equal(g.get_state(), after)


def test_maf_block_between_batch_norms(dev):
    """A D=8, 3-block MAF with batch norm on either side of its middle
    block (permuted order): each block runs through kernel 3 in both
    modes, log_prob against a CPU copy, and update_batch_stats."""
    from vaemolsim_tpu_torch.config import MAFConfig, RQSParams
    from vaemolsim_tpu_torch.ops import distributions as td
    gen = torch.Generator(device=dev).manual_seed(32)
    flow = MAFConfig(data_dim=8, num_blocks=3, order_seed=3,
                     batch_norm=True, rqs=RQSParams()).build(gen)
    assert flow.blocks[1].conditioner.w_net.input_order_static != \
        tuple(range(1, 9))
    y = 2.0 + 1.5 * torch.randn(4096, 8, generator=gen, device=dev)
    cpu = copy.deepcopy(flow).to("cpu")
    for train in (True, False):
        base = td.Independent(td.Normal(torch.zeros(8, device=dev),
                                        torch.ones(8, device=dev)), 1)
        _build.reset_launches()
        with torch.no_grad():
            lp = flow(base, train=train).log_prob(y)
        assert _build.KERNELS["maf_block"].launches == 3
        cbase = td.Independent(td.Normal(torch.zeros(8), torch.ones(8)), 1)
        with torch.no_grad():
            want = cpu(cbase, train=train).log_prob(y.cpu())
        err = (lp.cpu() - want).abs()
        assert float((err > 1e-3 + 1e-4 * want.abs()).float().mean()) < 1e-3
    before = [bn.mean.clone() for bn in flow.bn_params]
    flow.update_batch_stats(y)
    cpu.update_batch_stats(y.cpu())
    for bn, cbn, old in zip(flow.bn_params, cpu.bn_params, before):
        assert not torch.equal(bn.mean, old)
        torch.testing.assert_close(bn.mean.cpu(), cbn.mean, atol=1e-4,
                                   rtol=1e-4)
        torch.testing.assert_close(bn.var.cpu(), cbn.var, atol=1e-4,
                                   rtol=1e-4)


def test_hvae_gradients_run_through_second_derivatives(dev):
    """The flagship VAE's HVAE bound at fixed draws (5 leapfrog steps of
    0.05): value and every parameter's gradient on the card (kernels 1
    and 2 forward, their plain recompute differentiated twice) against a
    CPU copy, 1e-4 + 1e-3|g|.  At steps of 0.1 this gradient is
    ill-conditioned in float32 itself (float32 and float64 disagree on
    the CPU beyond this tolerance), so the comparison takes 0.05."""
    from vaemolsim_tpu_torch.config import flagship_experiment_config
    vae = flagship_experiment_config().build()
    cpu = copy.deepcopy(vae).to("cpu")
    gen = torch.Generator(device=dev).manual_seed(33)
    x = torch.randn(512, 2, generator=gen, device=dev)
    eps = torch.randn(512, 1, generator=gen, device=dev)
    rho = torch.randn(512, 1, generator=gen, device=dev)

    def bound(m, d):
        enc = m.encoder(x.to(d), train=True)
        f = enc.families[0]
        z0 = f.loc + f.scale * eps.to(d)
        return m._hvae_loss(x.to(d), enc, z0, rho.to(d), 5, 0.05, True)[0]

    _build.reset_launches()
    loss = bound(vae, dev)
    got = torch.autograd.grad(loss, list(vae.parameters()))
    counts = _build.launch_counts()
    assert counts["rqs"] > 0 and counts["dense_stack"] > 0
    want_loss = bound(cpu, torch.device("cpu"))
    want = torch.autograd.grad(want_loss, list(cpu.parameters()))
    torch.testing.assert_close(loss.cpu(), want_loss, atol=1e-4, rtol=1e-4)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-3)


def test_create_without_a_device_builds_on_the_card(dev):
    """Every parameter-allocating create, given no device, builds on
    cuda, from a CPU or a CUDA generator."""
    from vaemolsim_tpu_torch.dists import AutoregressiveBlockwise
    from vaemolsim_tpu_torch.flows import RQSSplineMAF, RQSSplineRealNVP
    from vaemolsim_tpu_torch.nn import (MADE, BatchNorm, CGCentroid, Dense,
                                        FCDeepNN, LayerNorm,
                                        ParticleEmbedding)
    for g in (torch.Generator().manual_seed(0),
              torch.Generator(device=dev).manual_seed(0)):
        built = [Dense.create(g, 2, 3), LayerNorm.create(3),
                 BatchNorm.create(3), MADE.create(g, 3, 2, [6]),
                 FCDeepNN.create(g, 2, 3, 8, batch_norm=True),
                 CGCentroid.create([2, 1]),
                 VectorAttention.create(g, 3, 3, 4),
                 ParticleEmbedding.create(g, 2, 3, 4, 1),
                 MaskedSplineConditioner.create(g, 2, num_bins=4,
                                                hidden_dim=4),
                 RQSSplineMAF.create(g, 2, 2, batch_norm=True),
                 RQSSplineRealNVP.create(g, 2, 2, batch_norm=True),
                 AutoregressiveBlockwise.create(g, 2, "normal")]
        for m in built:
            ts = list(m.parameters()) + list(m.buffers())
            assert ts and all(t.is_cuda for t in ts), type(m).__name__


@pytest.mark.parametrize("D,ctx_dim", [(8, 0), (3, 5), (5, 0)])
def test_maf_block_bf16_mode_matches_plain_bf16(dev, D, ctx_dim):
    """Kernel 3's bf16 mode (operands rounded to bfloat16, products
    summed in float32) against the plain version in the same mode, both
    directions: values 1e-4 + 1e-4|v|, log-dets 1e-3 + 1e-4|v|, on all
    but a fraction 1e-2 of the rows: the kernel and cuBLAS sum the same
    exact products in another order, and a tanh output within that
    difference of a bfloat16 rounding boundary rounds a step apart.  The
    route of a bf16 MAFLayer on the card is the kernel, counted in its
    bf16 mode."""
    from vaemolsim_tpu_torch.nn.core import set_compute_dtype
    gen = torch.Generator(device=dev).manual_seed(60 + D)
    layer = MAFLayer(MaskedSplineConditioner.create(
        gen, D, conditional=bool(ctx_dim), conditional_event_shape=ctx_dim
        or None, device=dev))
    cond = layer.conditioner
    params = [p.detach() for p in cond.merged_params() if p is not None]
    deg = cond.w_net.input_order_static
    y = 3.0 * torch.randn(5000, D, generator=gen, device=dev)
    ctx = (torch.randn(5000, ctx_dim, generator=gen, device=dev)
           if ctx_dim else None)
    for inverse in (True, False):
        args = (y, params, ctx, D, cond.num_bins, cond.bin_min,
                cond.bin_max, inverse)
        got = maf_fused.maf_block_cuda(*args, degrees=deg,
                                       compute_dtype=torch.bfloat16)
        want = maf_fused.maf_block_plain(*args, compute_dtype=torch.bfloat16)
        f32 = maf_fused.maf_block_plain(*args)
        _close_but("bf16 x", got[0], want[0], 1e-4, 1e-4, 1e-2)
        _close_but("bf16 ldj", got[1], want[1], 1e-3, 1e-4, 1e-2)
        # The mode matters: float32 differs from both by far more.
        assert float((want[0] - f32[0]).abs().max()) > 1e-3
    set_compute_dtype(torch.bfloat16)
    try:
        before = maf_fused.KERNEL.mode_launches.get("bf16", 0)
        with torch.no_grad():
            layer.inverse_and_log_det(y, ctx)
        assert maf_fused.KERNEL.mode_launches["bf16"] == before + 1
    finally:
        set_compute_dtype(None)


def test_refused_plans_split_or_route_plain(dev):
    """The shapes whose one-launch plan the kernels refuse run on the
    card and match their plain versions: a 9-layer stack (two launches),
    FCDeepNN(hidden_dim=[1024, 1024]) (a launch of the wide regime a
    layer), a VectorAttention at N = 100 (one launch of the stream
    regime), an RQS broadcast row of 4470 bins (one launch of the walk,
    for 20 000 elements and for one) and a neighbour block of 27 x 600
    slots (one launch a run).  Every call launches its kernel: the
    launch counts are exactly those."""
    from vaemolsim_tpu_torch.nn import FCDeepNN
    from vaemolsim_tpu_torch.ops import cell_lj
    gen = torch.Generator(device=dev).manual_seed(70)
    _build.reset_launches()
    dims = [4] + [32] * 9
    ks = [torch.randn(a, b, generator=gen, device=dev) / a ** 0.5
          for a, b in zip(dims, dims[1:])]
    bs = [0.1 * torch.randn(b, generator=gen, device=dev) for b in dims[1:]]
    acts = ["tanh"] * 8 + [None]
    x = torch.randn(3000, 4, generator=gen, device=dev)
    torch.testing.assert_close(fused_dense_stack(x, ks, bs, acts),
                               dense_stack_plain(x, ks, bs, acts),
                               atol=1e-4, rtol=1e-4)
    assert _build.KERNELS["dense_stack"].launches == 2
    fc = FCDeepNN.create(gen, 20, 8, hidden_dim=[1024, 1024], device=dev)
    xf = torch.randn(3000, 20, generator=gen, device=dev)
    with torch.no_grad():
        got = fc(xf)
        want = dense_stack_plain(
            xf, [l.kernel for l in fc.layers] + [fc.head.kernel],
            [l.bias for l in fc.layers] + [fc.head.bias],
            ["relu", "relu", None])
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert _build.KERNELS["dense_stack"].launches == 2 + 3
    assert sum(_build.launch_counts().values()) == 2 + 3
    attn = VectorAttention.create(gen, 20, 20, hidden_dim=40, device=dev)
    c = torch.randn(2000, 100, 3, generator=gen, device=dev)
    v = torch.randn(2000, 100, 20, generator=gen, device=dev)
    m = torch.rand(2000, 100, generator=gen, device=dev) < 0.9
    with torch.no_grad():
        torch.testing.assert_close(attn(c, v, m), attn.plain_call(c, v, m),
                                   atol=1e-5, rtol=1e-5)
    assert pa.KERNEL.launches == 1
    K = 4470
    params = (_bin_positions(torch.randn(1, K, generator=gen, device=dev),
                             -50.0, 50.0, K),
              _bin_positions(torch.randn(1, K, generator=gen, device=dev),
                             -50.0, 50.0, K),
              _slopes(torch.randn(1, K - 1, generator=gen, device=dev)))
    xr = torch.rand(20_000, generator=gen, device=dev) * 120.0 - 60.0
    for inverse in (False, True):
        fn = rqs.rqs_inverse if inverse else rqs.rqs_forward
        plain = rqs.rqs_inverse_plain if inverse else rqs.rqs_forward_plain
        got, want = fn(xr, *params, -50.0), plain(xr, *params, -50.0)
        _close_but("K=4470 y", got[0], want[0], 1e-5, 1e-5)
        _close_but("K=4470 ldj", got[1], want[1], 1e-4, 0.0)
        one, one_want = fn(xr[:1], *params, -50.0), plain(xr[:1], *params,
                                                           -50.0)
        torch.testing.assert_close(one[0], one_want[0], atol=1e-5,
                                   rtol=1e-5)
    assert rqs.KERNEL.launches == 4 and pa.KERNEL.launches == 1
    nc, C, L = 3, 600, 60.0
    Kn = 27 * C
    cxt = torch.rand(nc, 3, C, generator=gen, device=dev) * L
    nxt = torch.rand(nc, 3, Kn, generator=gen, device=dev) * L
    cid = torch.randint(0, 4000, (nc, 1, C), generator=gen, device=dev,
                        dtype=torch.int32)
    nid = torch.randint(0, 4000, (nc, 1, Kn), generator=gen, device=dev,
                        dtype=torch.int32)
    kw = dict(n_atoms=3900, sigma=1.0, epsilon=1.0, cutoff=2.5,
              box=(L, L, L))
    e, g = cell_lj.cell_pair_energy_force(cxt, nxt, cid, nid, **kw)
    e_p, g_p = cell_lj.cell_pair_energy_force_plain(cxt, nxt, cid, nid, **kw)
    torch.testing.assert_close(e, e_p, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(g, g_p, atol=1e-3, rtol=1e-4)
    runs = len(cell_lj.neighbour_runs(Kn, cell_lj.max_slots(C)))
    assert runs > 1 and cell_lj.KERNEL.launches == runs
    assert {k: n for k, n in _build.launch_counts().items() if n} == {
        "dense_stack": 5, "pair_attention": 1, "rqs": 4, "cell_lj": runs}


@pytest.mark.parametrize("C,species,coulomb,most", [
    (72, False, True, 10848), (484, False, False, 13088),
    (288, True, True, 7776), (700, True, True, 7616)])
def test_cell_lj_max_slots(dev, C, species, coulomb, most):
    """The most neighbour slots a launch takes, from the kernel's own
    shared-memory layout at two exclusions a centre (the values that
    ``test_torch_routes.test_cell_lj_neighbour_runs`` splits by)."""
    from vaemolsim_tpu_torch.ops import cell_lj
    assert cell_lj.max_slots(C, 2, species, coulomb) == most


@pytest.mark.parametrize("N,H,reduce", [(100, 40, False), (100, 40, True),
                                        (37, 64, False), (37, 64, True),
                                        (300, 33, True)])
def test_pair_attention_stream_regime(dev, N, H, reduce):
    """Kernel 5's stream regime (no pair grid in shared memory) against
    its plain version, 1e-5 + 1e-5|v| as the other regimes: at N = 100
    (B = 300, the plan's own choice there), at a small frame forced into
    it, and at N = 300; fully masked rows and frames exactly zero."""
    gen = torch.Generator(device=dev).manual_seed(N + H)
    B = 300 if N <= 100 else 20
    attn = VectorAttention.create(gen, 20, 20, hidden_dim=H,
                                  reduce=reduce, device=dev)
    c = 1.5 * torch.randn(B, N, 3, generator=gen, device=dev)
    v = torch.randn(B, N, 20, generator=gen, device=dev)
    m = (torch.rand(B, N, generator=gen, device=dev) > 0.3).float()
    m[0, 1] = 0.0
    m[1] = 0.0
    (c_, *nodes, mf, weights), kw = attn.pair_args(c, v, m)
    args = (c_, *nodes, mf, *weights)
    want = pa.pair_attention_plain(*args, **kw)
    if N == 37:
        real = pa.kernel_plan
        pa.kernel_plan = lambda *a: real(*a, regime="stream")
        try:
            got = pa.pair_attention_cuda(*args, **kw)
        finally:
            pa.kernel_plan = real
    else:
        assert pa.kernel_plan(B, N, H, 20)["regime"] == "stream"
        got = pa.pair_attention_cuda(*args, **kw)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    empty = (m.sum(-1) == 0) if reduce else (m == 0)
    assert float(got[empty].abs().max()) == 0.0


def _chunked_stream_case(dev, B, N, H, reduce, activation="relu"):
    gen = torch.Generator(device=dev).manual_seed(N + H)
    attn = VectorAttention.create(gen, 20, 20, hidden_dim=H, reduce=reduce,
                                  activation=activation, device=dev)
    c = 1.5 * torch.randn(B, N, 3, generator=gen, device=dev)
    v = torch.randn(B, N, 20, generator=gen, device=dev)
    m = (torch.rand(B, N, generator=gen, device=dev) > 0.3).float()
    m[0, 1] = 0.0
    m[1] = 0.0
    (c_, *nodes, mf, weights), kw = attn.pair_args(c, v, m)
    args = (c_, *nodes, mf, *weights)
    plan = pa.kernel_plan(B, N, H, 20)
    assert plan["regime"] == "stream" and not plan["refused"]
    before = pa.KERNEL.launches
    with torch.no_grad():
        got = attn(c, v, m)
    assert pa.KERNEL.launches == before + 1
    with torch.no_grad():
        want = pa.pair_attention_plain(*args, **kw)
    del args, nodes, weights
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    empty = (m.sum(-1) == 0) if reduce else (m == 0)
    assert float(got[empty].abs().max()) == 0.0


@pytest.mark.parametrize("B,N,H,reduce", [
    (2, 1553, 40, False), (2, 1553, 40, True), (2, 4096, 40, False),
    (2, 4096, 40, True), (2, 400, 300, False), (2, 400, 300, True),
    (2, 1024, 512, False), (2, 1024, 512, True)])
def test_pair_attention_chunked_stream_regime(dev, B, N, H, reduce):
    """Kernel 5's stream regime beyond one key chunk and one warp's 8
    units: N = 1553 and 4096 at H = 40 (13 and 32 chunks of 128 keys),
    H = 300 at N = 400 (12 units a lane) and H = 512 at N = 1024 (16
    units a lane, 8 chunks), against its plain version, 1e-5 + 1e-5|v| as
    the other regimes; a fully masked row and frame exactly zero.  The
    plans refused all four before the online softmax."""
    _chunked_stream_case(dev, B, N, H, reduce)


@pytest.mark.parametrize("B,N,H,reduce", [
    (2, 400, 300, True), (2, 1024, 512, False)])
def test_pair_attention_chunked_stream_regime_tanh(dev, B, N, H, reduce):
    """The 12- and 16-unit stream kernels with tanh for the nets'
    activation, against the plain version, 1e-5 + 1e-5|v|."""
    _chunked_stream_case(dev, B, N, H, reduce, activation="tanh")


def test_pair_attention_8192_rows_equal_the_masked_4096_frame(dev):
    """N = 8192 (B = 1, H = 40), where the plain pair grid would take
    10.7 GB a trunk: with the last 4096 particles masked out, the valid
    rows equal the kernel's own N = 4096 output, 1e-5 + 1e-5|v| (only
    the order of the chunk merges differs)."""
    gen = torch.Generator(device=dev).manual_seed(8192)
    attn = VectorAttention.create(gen, 20, 20, hidden_dim=40, device=dev)
    c = 1.5 * torch.randn(1, 8192, 3, generator=gen, device=dev)
    v = torch.randn(1, 8192, 20, generator=gen, device=dev)
    m = torch.zeros(1, 8192, device=dev)
    m[:, :4096] = 1.0
    with torch.no_grad():
        big = attn(c, v, m)
        small = attn(c[:, :4096], v[:, :4096], m[:, :4096])
    torch.testing.assert_close(big[:, :4096], small, atol=1e-5, rtol=1e-5)
    assert float(big[:, 4096:].abs().max()) == 0.0


def test_vector_attention_beyond_the_stream_regime_raises(dev):
    """A CUDA call no regime takes (H = 520 > 512 on a frame beyond the
    grid regime) raises with the limit and launches nothing; it never
    runs the plain layer."""
    gen = torch.Generator(device=dev).manual_seed(5)
    attn = VectorAttention.create(gen, 4, 4, hidden_dim=520, device=dev)
    c = torch.randn(1, 400, 3, generator=gen, device=dev)
    v = torch.randn(1, 400, 4, generator=gen, device=dev)
    before = pa.KERNEL.launches
    with pytest.raises(ValueError, match="H=512"):
        with torch.no_grad():
            attn(c, v)
    assert pa.KERNEL.launches == before


def test_joint_backmapping_attention_on_the_card_matches_a_cpu_copy(dev):
    """JointBackmapping with the attention embedding on the card (kernel 5
    on B x R clouds, kernel 2 in the mapping) against a CPU copy: the
    log-density to 1e-4 + 1e-4|v| and every parameter's gradient to
    1e-4 + 1e-3|g|."""
    from vaemolsim_tpu_torch.dists import (IndependentBlockwise,
                                           JointBackmapping)
    gen = torch.Generator(device=dev).manual_seed(80)
    model = JointBackmapping.create(
        gen, 2, 1, IndependentBlockwise.create(2, "von_mises"), embed_dim=12,
        prefix_dim=8, cutoff=4.0, max_included=4, embedding="attention",
        device=dev)
    cpu = copy.deepcopy(model).to("cpu")
    t = torch.arange(6, dtype=torch.float32, device=dev)
    helix = torch.stack([torch.cos(0.9 * t), torch.sin(0.9 * t), 0.4 * t], -1)
    cg = helix + 0.25 * torch.randn(256, 6, 3, generator=gen, device=dev)
    info = (t / 6)[None, :, None].expand(256, 6, 1).contiguous()
    x = torch.rand(256, 6, 2, generator=gen, device=dev) * 6.0 - 3.0
    _build.reset_launches()
    lp = model(cg, info).log_prob(x)
    got = torch.autograd.grad(-lp.mean(), list(model.parameters()))
    assert pa.KERNEL.launches > 0 and _build.KERNELS["dense_stack"].launches
    lp_cpu = cpu(cg.cpu(), info.cpu()).log_prob(x.cpu())
    want = torch.autograd.grad(-lp_cpu.mean(), list(cpu.parameters()))
    torch.testing.assert_close(lp.cpu(), lp_cpu, atol=1e-4, rtol=1e-4)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("din,dout,dc,act", [
    (20, 1024, 0, "relu"), (1024, 1024, 3, "tanh"), (808, 9, 0, None),
    (3, 4096, 5, "tanh")])
def test_dense_stack_wide_regime_matches_plain(dev, din, dout, dc, act):
    """One layer too wide for the tiled regime (808 or more): the wide
    regime's 64 x 64 tiles at ragged edges of rows, columns and depth,
    with a conditional input, against the plain version, 1e-4 +
    1e-4|y|, one launch a call."""
    from vaemolsim_tpu_torch.ops import fused_mlp
    gen = torch.Generator(device=dev).manual_seed(din + dout)
    ks, bs, cks = _stack(gen, dev, [din, dout], dc)
    for n in (0, 17, 63, 65, 10_001):
        x = torch.randn(n, din, generator=gen, device=dev)
        c = torch.randn(n, dc, generator=gen, device=dev) if dc else None
        assert fused_mlp.stack_regime(n, [din, dout], dc)[0] == (
            "wide" if n > 16 else "small")
        before = fused_mlp.KERNEL.launches
        got = fused_mlp.dense_stack_cuda(x, ks, bs, [act], c, cks)
        assert fused_mlp.KERNEL.launches == before + 1
        torch.testing.assert_close(
            got, dense_stack_plain(x, ks, bs, [act], c, cks), atol=1e-4,
            rtol=1e-4)


def _rock_salt(dev, n_lat=12, rho=0.35, q_abs=1.5):
    """Example 15's --full start: 1728 ions on a rock-salt lattice."""
    import numpy as np
    n = n_lat ** 3
    L = float((n / rho) ** (1.0 / 3.0))
    g = np.stack(np.meshgrid(*[np.arange(n_lat)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    x = torch.tensor(g * (L / n_lat), dtype=torch.float32, device=dev)
    return L, x, np.where(g.sum(-1) % 2 == 0, q_abs, -q_abs)


def test_ewald_with_tf32_allowed_matches_tf32_off(dev):
    """ewald_coulomb at example 15's --full size (1728 ions, tolerance
    1e-5, ~3e4 modes) with TF32 allowed for matrix products equals the
    TF32-off energy and forces to 1e-5 relative: its phases are
    multiply-adds and its sums reductions, so no product is rounded."""
    from vaemolsim_tpu_torch import potentials
    L, x, q = _rock_salt(dev)
    x = x + 0.1 * torch.randn(x.shape, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    energy = potentials.ewald_coulomb(q, box=[L] * 3, r_cutoff=2.5,
                                      tolerance=1e-5, device=dev)
    out = {}
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            xg = x.clone().requires_grad_(True)
            e = energy(xg)
            (g,) = torch.autograd.grad(e, xg)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        out[tf32] = (e.detach(), g)
    torch.testing.assert_close(out[True][0], out[False][0], atol=0,
                               rtol=1e-5)
    scale = float(out[False][1].abs().max())
    torch.testing.assert_close(out[True][1], out[False][1],
                               atol=1e-5 * scale, rtol=0)


def test_cell_lj_at_example_15_shape_matches_plain(dev):
    """Kernel 6 in its Ewald real-space (erfc) mode at example 15's
    --full shape (1728 ions, capacity 32, cutoff 2.5, skin 0.4) against
    its plain version on the same gathered inputs: per-cell energies to
    1e-5 of the largest, the total to 1e-5 relative, gradients to 1e-4 of
    the largest + 1e-5; one launch."""
    from vaemolsim_tpu_torch import potentials
    from vaemolsim_tpu_torch.ops import cell_lj
    L, x, q = _rock_salt(dev)
    x = (x + 0.15 * torch.randn(x.shape, generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)) % L
    recip = potentials.ewald_coulomb(q, box=[L] * 3, r_cutoff=2.5,
                                     tolerance=1e-5,
                                     include_real_space=False, device=dev)
    build, energy = potentials.lennard_jones_cell_neighbor(
        box=[L] * 3, cutoff=2.5, skin=0.4, capacity=32, charges=q,
        coulomb_alpha=recip.ewald_alpha, device=dev)
    args, kw = energy.cell_pair_inputs(build(x), x)
    before = cell_lj.KERNEL.launches
    e, g = cell_lj.cell_pair_energy_force_cuda(*args, **kw)
    assert cell_lj.KERNEL.launches == before + 1
    ew, gw = cell_lj.cell_pair_energy_force_plain(*args, **kw)
    torch.testing.assert_close(e, ew, atol=1e-5 * float(ew.abs().max()),
                               rtol=1e-5)
    assert abs(float(e.sum()) - float(ew.sum())) <= 1e-5 * abs(
        float(ew.sum()))
    torch.testing.assert_close(g, gw, atol=1e-4 * float(gw.abs().max())
                               + 1e-5, rtol=0)


@pytest.mark.parametrize("replicas", [16, 8])
def test_bond_constraint_projections_replay_their_graphs(dev, replicas):
    """On the card SHAKE and RATTLE replay a CUDA graph of their 50 Jacobi
    sweeps, captured at the first call of a shape: results equal the
    eager sweeps' to 1e-6 (the same kernels; index_add's atomics may
    reorder a sum), a second call reuses the graph, and under autograd
    the projection runs eagerly."""
    from vaemolsim_tpu_torch import md
    import numpy as np
    M = 24
    bonds = np.concatenate([np.array([[0, 1], [0, 2], [1, 2]]) + 3 * m
                            for m in range(M)])
    lengths = np.tile([0.4, 0.4, 0.653], M)
    masses = np.tile([16.0, 1.0, 1.0], M)
    con = md.bond_constraints(bonds, lengths, 3 * M, masses, device=dev)
    gen = torch.Generator(device=dev).manual_seed(22)
    x = 3.0 * torch.randn(replicas, 3 * M, 3, generator=gen, device=dev)
    moved = x + 0.01 * torch.randn(x.shape, generator=gen, device=dev)
    v = torch.randn(x.shape, generator=gen, device=dev)
    got = con.shake_delta(x, moved)
    want = con._shake(x, moved)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(con.rattle(x, v), con._rattle(x, v)[0],
                               atol=1e-6, rtol=1e-6)
    assert len(con.graphs) == 2
    again = con.shake_delta(x, moved)
    torch.testing.assert_close(again[0], got[0], atol=1e-6, rtol=1e-6)
    assert len(con.graphs) == 2
    xg = x.clone().requires_grad_(True)
    out = con.rattle(xg, v)
    assert out.requires_grad and len(con.graphs) == 2


def _velocity_field(dev, seed=0):
    """Example 24's velocity field: 2-D events, 4 Fourier time features
    (input 11 wide), hidden (128, 128), gelu."""
    from vaemolsim_tpu_torch.flows import FlowMatching
    return FlowMatching.create(torch.Generator(device=dev).manual_seed(seed),
                               2, hidden_dim=(128, 128), device=dev)


@pytest.mark.parametrize("n", [1024, 2 * 1024, 7])
def test_dense_stack_gelu_at_the_velocity_field_shape_matches_plain(dev, n):
    """Kernel 2 with gelu (tanh form) at 11 -> 128 -> 128 -> 2, at the CFM
    batch, the divergence's two stacked copies and a few rows: 1e-4 +
    1e-4|y| against the plain version, one launch a call."""
    from vaemolsim_tpu_torch.ops import fused_mlp
    net = _velocity_field(dev).velocity.net
    ks = [l.kernel for l in net.layers] + [net.head.kernel]
    bs = [l.bias for l in net.layers] + [net.head.bias]
    acts = ["gelu", "gelu", None]
    x = torch.randn(n, 11, generator=torch.Generator(device=dev).manual_seed(
        n), device=dev)
    with torch.no_grad():
        before = fused_mlp.KERNEL.launches
        got = fused_mlp.dense_stack_cuda(x, ks, bs, acts)
        assert fused_mlp.KERNEL.launches == before + 1
        want = dense_stack_plain(x, ks, bs, acts)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_flow_matching_divergence_on_the_card_matches_a_cpu_copy(dev):
    """The exact divergence (two stacked copies through kernel 2, one
    gradient through the plain recompute), the velocity, the CFM loss and
    its gradients, and an 8-step ``sample_and_log_prob`` on the card
    against a CPU copy: 1e-4."""
    from vaemolsim_tpu_torch.flows.flow_matching import _divergence
    fm = _velocity_field(dev, 1)
    cpu = copy.deepcopy(fm).to("cpu")
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(512, 2, generator=gen, device=dev)
    tt = torch.rand(512, generator=gen, device=dev)
    before = _build.KERNELS["dense_stack"].launches
    v, div = _divergence(lambda xs: fm.velocity(xs, tt), x)
    assert _build.KERNELS["dense_stack"].launches > before
    vc, divc = _divergence(lambda xs: cpu.velocity(xs, tt.cpu()), x.cpu())
    torch.testing.assert_close(v.cpu(), vc, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(div.cpu(), divc, atol=1e-4, rtol=1e-4)
    x0 = torch.randn(512, 2, generator=gen, device=dev)
    loss = fm.loss(None, x, t=tt, x0=x0)
    got = torch.autograd.grad(loss, list(fm.parameters()))
    loss_c = cpu.loss(None, x.cpu(), t=tt.cpu(), x0=x0.cpu())
    want = torch.autograd.grad(loss_c, list(cpu.parameters()))
    torch.testing.assert_close(loss.cpu(), loss_c, atol=1e-4, rtol=1e-4)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-3)
    with torch.no_grad():
        x1, lp = fm.sample_and_log_prob(None, (512,), n_steps=8, x0=x0)
        x1c, lpc = cpu.sample_and_log_prob(None, (512,), n_steps=8,
                                           x0=x0.cpu())
    torch.testing.assert_close(x1.cpu(), x1c, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lp.cpu(), lpc, atol=1e-4, rtol=1e-4)


def test_triclinic_pme_on_the_card_matches_the_cpu(dev):
    """pme_coulomb(cell=...) on a sheared 512-ion rock-salt crystal with
    TF32 off: energy to 1e-5 relative and forces to 1e-5 of the largest
    against the same function on the CPU."""
    import numpy as np
    from vaemolsim_tpu_torch import potentials
    n_lat, a = 8, 1.3
    g = np.stack(np.meshgrid(*[np.arange(n_lat)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    q = np.where(g.sum(-1) % 2 == 0, 1.0, -1.0)
    shear = np.array([[1.0, 0.0, 0.0], [0.15, 1.0, 0.0], [-0.1, 0.2, 1.0]])
    cell = n_lat * a * shear
    x = (g * a) @ shear
    out = []
    for d in (dev, "cpu"):
        xt = torch.tensor(x, dtype=torch.float32, device=d)
        xt = (xt + 0.05 * torch.randn(xt.shape, generator=torch.Generator()
                                      .manual_seed(3)).to(d))
        xt.requires_grad_(True)
        e = potentials.pme_coulomb(q, cell=cell, r_cutoff=3.0,
                                   tolerance=1e-5, device=d)(xt)
        (f,) = torch.autograd.grad(e, xt)
        out.append((e.detach().cpu(), f.cpu()))
    torch.testing.assert_close(out[0][0], out[1][0], atol=0, rtol=1e-5)
    scale = float(out[1][1].abs().max())
    torch.testing.assert_close(out[0][1], out[1][1], atol=1e-5 * scale,
                               rtol=0)


# ---------------------------------------------------------------------------
# utils.scan_collect: captured chunks replayed on the card
# ---------------------------------------------------------------------------


def _dwell(x):
    s = x[..., 0, 0]
    return 8.0 * (s * s - 1.0) ** 2


def _flat(tree):
    from vaemolsim_tpu_torch.utils.scan import _leaves
    return _leaves(tree)


def _replay_and_eager(run):
    """run() replayed and run() under ``scan.eager()``: both results."""
    from vaemolsim_tpu_torch.utils import scan
    got = run()
    with scan.eager():
        want = run()
    torch.cuda.synchronize()
    return got, want


def _assert_same(got, want):
    a, b = _flat(got), _flat(want)
    assert len(a) == len(b) and a
    for g, w in zip(a, b):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=0, equal_nan=True)


def test_scan_collect_replays_a_baoab_step_as_the_eager_loop(dev):
    """Three chunks of ten BAOAB steps, the O-step's normals from a
    generator registered with the graph: the replay equals the eager loop
    on the same seed (to 1e-6; the same kernels draw the same stream)."""
    from vaemolsim_tpu_torch import md
    from vaemolsim_tpu_torch.utils import scan_collect
    force = md._force_fn(_dwell)
    x0 = torch.linspace(-1.2, 1.2, 64, device=dev)[:, None, None]
    _, f0 = force(x0)
    dt = torch.tensor(0.01, device=dev)

    def run():
        gen = torch.Generator(device=dev).manual_seed(31)

        def step(s):
            v = s.v + 0.5 * dt * s.force
            x = s.x + 0.5 * dt * v
            v = 0.98 * v + 0.2 * md._normal(gen, v)
            x = x + 0.5 * dt * v
            _, f = force(x)
            return md.MDState(x, v + 0.5 * dt * f, f)

        return scan_collect(step, md.MDState(x0, torch.zeros_like(x0), f0),
                            30, collect_every=5, snapshot_fn=lambda s: s.x,
                            chunk=10, generators=(gen,))

    got, want = _replay_and_eager(run)
    assert got[1].shape == (6, 64, 1, 1)
    _assert_same(got, want)


def test_metad_baoab_replays_deposits_as_the_eager_loop(dev):
    """Metadynamics with a deposit every 20 steps, two intervals a
    captured chunk, five chunks: state, grid and CV trajectory equal the
    eager loop's."""
    from vaemolsim_tpu_torch import metadynamics as mtd

    def run():
        gen = torch.Generator(device=dev).manual_seed(32)
        x0 = -torch.ones(16, 1, 1, device=dev)
        return mtd.metad_baoab(
            _dwell, lambda x: x[..., 0, 0], x0, torch.zeros_like(x0), gen,
            dt=0.01, n_steps=200, deposit_every=20,
            grid=mtd.bias_grid(-2.0, 2.0, 61, device=dev), hill_height=0.5,
            hill_width=0.2, gamma=6.0, friction=2.0)

    got, want = _replay_and_eager(run)
    assert got[2].shape == (10, 16)
    assert float(got[1].v.abs().max()) > 0
    _assert_same(got, want)


def test_tps_sweeps_and_committor_replay_as_the_eager_loop(dev):
    """Four one-way shooting sweeps (each one captured graph) and a
    committor run of 100 steps in two chunks: the replay equals the
    eager loop's paths, counters and labels."""
    from vaemolsim_tpu_torch import mcmc

    def in_a(x):
        return x[..., 0, 0] < -0.7

    def in_b(x):
        return x[..., 0, 0] > 0.7

    line = torch.linspace(-1.0, 1.0, 41, device=dev)[None, :, None, None]
    step = mcmc.make_tps_step(_dwell, in_a=in_a, in_b=in_b, dt=0.02,
                              kt=1.0, friction=0.5)

    def sweeps():
        gen = torch.Generator(device=dev).manual_seed(33)
        state = mcmc.tps_init(line.repeat(8, 1, 1, 1), generator=gen)
        return mcmc.run_tps(step, state, gen, 4, collect_every=2)

    def committor():
        gen = torch.Generator(device=dev).manual_seed(34)
        xs = torch.linspace(-0.5, 0.5, 5, device=dev)[:, None, None]
        return mcmc.first_hitting_committor(
            _dwell, xs, in_a=in_a, in_b=in_b, generator=gen, n_shots=64,
            max_steps=100, dt=0.01, kt=1.0, friction=5.0)

    for run in (sweeps, committor):
        got, want = _replay_and_eager(run)
        _assert_same(got, want)


def test_scan_collect_refuses_a_step_it_cannot_capture(dev):
    """A host read inside the step raises on the card, and the step ran
    only for the warm-up and the capture, never as the eager loop."""
    from vaemolsim_tpu_torch.utils import scan_collect
    calls = []

    def step(x):
        calls.append(1)
        return x * 0.5 if float(x.sum()) > 0 else x

    with pytest.raises(RuntimeError, match="cannot be captured"):
        scan_collect(step, torch.ones(4, device=dev), 100, chunk=10)
    assert len(calls) <= 20
    y, _ = scan_collect(lambda x: x * 0.5, torch.ones(4, device=dev), 4)
    assert torch.equal(y, torch.full((4,), 0.0625, device=dev))


def test_scan_collect_refuses_a_step_that_launches_a_port_kernel(dev):
    """Kernel launches are counted on the host, so a captured kernel would
    go uncounted in the replays: the capture raises."""
    from vaemolsim_tpu_torch.utils import scan_collect
    gen = torch.Generator(device=dev).manual_seed(35)
    params = _spline(gen, dev, 1, 16)

    def step(x):
        return rqs.rqs_forward(x, *params, -5.0)[0]

    with pytest.raises(RuntimeError, match="port kernel"):
        scan_collect(step, torch.rand(256, device=dev), 20, chunk=10)


def _we_step(dev):
    """Example 35's weighted-ensemble step at a small width: 20-step BAOAB
    segments through md's shared runner, recycling at the last bin."""
    from vaemolsim_tpu_torch import we
    from vaemolsim_tpu_torch.md import _BAOAB
    dyn = _BAOAB(_dwell, dt=0.01, kt=2.0, friction=1.0, masses=1.0)
    edges = torch.linspace(-1.4, 1.0, 9, device=dev)

    def propagate(walk, generator):
        s, _ = dyn.scan(dyn.start(*walk), 20, generator)
        return (s.x, s.v)

    def bin_fn(walk):
        return torch.searchsorted(edges, walk[0][..., 0, 0].contiguous())

    def recycle(walk):
        return (torch.full_like(walk[0], -1.0), torch.zeros_like(walk[1]))

    return we.make_we_step(propagate, bin_fn, n_bins=10, m_per_bin=8,
                           target_bin=9, recycle_fn=recycle)


def test_ffs_flux_and_stage_replay_as_the_eager_loop(dev):
    """A basin_flux run of 200 steps (four chunks) and an ffs_stage of 150
    steps from its slots: the replay equals the eager loop's count, slots,
    statuses and phase points."""
    from vaemolsim_tpu_torch import mcmc

    def lam(x):
        return x[..., 0, 0]

    x0 = -torch.ones(64, 1, 1, device=dev)
    kw = dict(dt=0.01, kT=2.0, friction=1.0)

    def flux():
        gen = torch.Generator(device=dev).manual_seed(36)
        return mcmc.basin_flux(_dwell, lam, x0, torch.zeros_like(x0), gen,
                               lambda0=-0.6, n_steps=200, n_store=32, **kw)

    fr, want = _replay_and_eager(flux)
    _assert_same(fr, want)
    assert int(fr.n_crossings) > 0

    def stage():
        gen = torch.Generator(device=dev).manual_seed(37)
        return mcmc.ffs_stage(_dwell, lam, fr.x, fr.v, fr.stored, gen,
                              lambda_next=-0.2, lambda_fail=-0.6,
                              max_steps=150, n_trials=128, **kw)

    got, want = _replay_and_eager(stage)
    _assert_same(got, want)


def test_we_iterations_replay_as_the_eager_loop(dev):
    """Five WE iterations, each one captured step (segment and
    resampling): walkers, weights and flux equal the eager loop's."""
    from vaemolsim_tpu_torch import we
    step = _we_step(dev)

    def run():
        gen = torch.Generator(device=dev).manual_seed(38)
        state = we.we_init((-torch.ones(16, 1, 1, device=dev),
                            torch.zeros(16, 1, 1, device=dev)), 10, 8)
        return we.run_we(step, state, gen, 5, collect_every=5)

    got, want = _replay_and_eager(run)
    _assert_same(got, want)
    assert abs(float(got[0].w.sum()) - 1.0) < 1e-5


def test_run_we_refuses_a_step_with_a_host_read(dev):
    """A WE step that reads the host (.item()) raises under run_we on the
    card instead of running eagerly."""
    from vaemolsim_tpu_torch import we
    step = _we_step(dev)

    def reads_the_host(state, generator):
        state = step(state, generator)
        if state.w.sum().item() > 2.0:
            raise AssertionError("weight grew")
        return state

    state = we.we_init((-torch.ones(16, 1, 1, device=dev),
                        torch.zeros(16, 1, 1, device=dev)), 10, 8)
    with pytest.raises(RuntimeError, match="cannot be captured"):
        we.run_we(reads_the_host, state,
                  torch.Generator(device=dev).manual_seed(39), 10)


def test_vampnet_create_without_a_device_builds_on_the_card(dev):
    from vaemolsim_tpu_torch.vamp import VAMPNet
    for g in (torch.Generator().manual_seed(0),
              torch.Generator(device=dev).manual_seed(0)):
        net = VAMPNet.create(g, 2, 3)
        assert all(p.is_cuda for p in net.parameters())
        y = net(torch.zeros(4, 2, device=dev))
        assert y.is_cuda and y.shape == (4, 3)


def _lj16(dev, chains=8, seed=0):
    """16 LJ particles at density 0.65 on a jittered grid, ``chains``
    copies: coordinates and the box edge."""
    L = (16 / 0.65) ** (1.0 / 3.0)
    g = torch.Generator().manual_seed(seed)
    ax = torch.arange(3, dtype=torch.float32) * (L / 3)
    grid = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"),
                       -1).reshape(-1, 3)[:16]
    x = grid + 0.05 * torch.randn(chains, 16, 3, generator=g)
    return x.to(dev), L


def test_lennard_jones_takes_card_parameters_that_require_grad(dev):
    """sigma and epsilon as CUDA tensors in an autograd graph, scalar and
    per-atom: the energy and its parameter gradients on the card equal a
    CPU copy's (float32, to 1e-5 relative)."""
    from vaemolsim_tpu_torch import potentials
    x, L = _lj16(dev)
    g = torch.Generator().manual_seed(1)
    for sig, eps in ((torch.tensor(1.02), torch.tensor(0.9)),
                     (1.0 + 0.05 * torch.rand(16, generator=g),
                      0.5 + torch.rand(16, generator=g))):
        out = []
        for d in (dev, torch.device("cpu")):
            s = sig.to(d).requires_grad_(True)
            e = eps.to(d).requires_grad_(True)
            pot = potentials.lennard_jones(
                sigma=s, epsilon=e, box=torch.full((3,), L, device=d),
                cutoff=2.2, device=d)
            energy = pot(x.to(d)).sum()
            out.append([energy, *torch.autograd.grad(energy, (s, e))])
        assert out[0][0].is_cuda and out[0][1].is_cuda
        for a, b in zip(*out):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


def test_force_matching_loss_on_the_card_matches_a_cpu_copy(dev):
    """The force-matching loss of a SchNet potential and its weight
    gradients (a second derivative) on the card against a CPU copy, to
    1e-4 relative."""
    from vaemolsim_tpu_torch import cg
    from vaemolsim_tpu_torch.nn import SchNetPotential
    gen = torch.Generator().manual_seed(2)
    model = SchNetPotential.create(gen, 1, features=16, num_blocks=2,
                                   n_rbf=12, cutoff=2.5, device="cpu")
    card = copy.deepcopy(model).to(dev)
    R = 3.6 * torch.rand(12, 12, 3, generator=gen)
    f = torch.randn(12, 12, 3, generator=gen)
    sp, box = torch.ones(12, 1), torch.full((3,), 3.6)
    mask = torch.arange(12) < 11
    got = cg.force_matching_loss(card, R.to(dev), sp.to(dev), f.to(dev),
                                 box=box.to(dev), mask=mask.to(dev))
    want = cg.force_matching_loss(model, R, sp, f, box=box, mask=mask)
    got.backward()
    want.backward()
    torch.testing.assert_close(got.cpu(), want.detach(), rtol=1e-4,
                               atol=1e-6)
    for (name, a), b in zip(card.named_parameters(), model.parameters()):
        if b.grad is None:          # e_ref: no force depends on it
            assert a.grad is None, name
            continue
        scale = float(b.grad.abs().max())
        torch.testing.assert_close(a.grad.cpu(), b.grad, rtol=1e-4,
                                   atol=1e-4 * scale, msg=name)


def test_difftre_round_replays_as_the_eager_loop(dev):
    """One DiffTRe round of example 31's kind whose sample_fn runs md's
    shared runner (replayed CUDA graphs): the frames, the fitted
    parameters and the history equal the same round under scan.eager()."""
    from vaemolsim_tpu_torch import difftre, md, potentials
    x0, L = _lj16(dev)
    box = torch.full((3,), L, device=dev)

    def make_pot(p):
        return potentials.lennard_jones(
            sigma=torch.exp(p["log_sigma"]), epsilon=torch.exp(p["log_eps"]),
            box=box, cutoff=2.2, device=dev)

    def run():
        gen = torch.Generator(device=dev).manual_seed(40)
        seen = []

        def sample_fn(p, g, state):
            dyn = md._BAOAB(make_pot(p), dt=0.003, kt=0.85, friction=1.0,
                            masses=1.0)
            s, traj = dyn.scan(dyn.start(x0, torch.zeros_like(x0)), 200, g,
                               collect_every=25,
                               snapshot_fn=lambda st: st.x)
            seen.append(traj)
            return traj[2:].reshape(-1, 16, 3), s.x

        params = {"log_eps": torch.full((), -0.4, device=dev),
                  "log_sigma": torch.full((), 0.1, device=dev)}
        res = difftre.difftre_fit(
            lambda p, f: make_pot(p)(f), params, sample_fn=sample_fn,
            observable_fns={"u": lambda p, f: make_pot(p)(f) / 16},
            targets={"u": -2.0}, beta=1.0 / 0.85, generator=gen, n_outer=1,
            inner_steps=5, learning_rate=0.05)
        return (seen, res.params, res.history["loss"],
                res.history["ess_end"], res.history["inner_steps"])

    got, want = _replay_and_eager(run)
    _assert_same(got[:2], want[:2])
    assert got[2:] == want[2:]
    assert got[4][0] >= 1


def _diffusion(dev, seed=0, cond_dim=0):
    """Example 28's model (11 -> 128 -> 128 -> 2, gelu) with a small random
    head in place of its zero one, so that the noise net is not constant."""
    from vaemolsim_tpu_torch.flows import Diffusion
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = Diffusion.create(gen, 2, hidden_dim=(128, 128),
                             cond_dim=cond_dim, device=dev)
    with torch.no_grad():
        head = model.eps_net.net.head.kernel
        head.copy_(0.05 * torch.randn(head.shape, generator=gen, device=dev))
    return model


@pytest.mark.parametrize("n", [2048, 4000, 2 * 4000, 2 * 41 * 41])
def test_dense_stack_gelu_at_the_diffusion_rows_matches_plain(dev, n):
    """Kernel 2 at example 28's noise net and the path's row counts (the
    DSM batch, the SDE's chains, the divergence's two copies of the MH
    chains and of the 41 x 41 grid): 1e-4 + 1e-4|y| against the plain
    version, one launch a call."""
    from vaemolsim_tpu_torch.ops import fused_mlp
    net = _diffusion(dev).eps_net.net
    ks = [l.kernel for l in net.layers] + [net.head.kernel]
    bs = [l.bias for l in net.layers] + [net.head.bias]
    acts = ["gelu", "gelu", None]
    x = torch.randn(n, 11, generator=torch.Generator(device=dev).manual_seed(
        n), device=dev)
    with torch.no_grad():
        before = fused_mlp.KERNEL.launches
        got = fused_mlp.dense_stack_cuda(x, ks, bs, acts)
        assert fused_mlp.KERNEL.launches == before + 1
        want = dense_stack_plain(x, ks, bs, acts)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_diffusion_on_the_card_matches_a_cpu_copy(dev):
    """The DSM loss and its weight gradients at fixed draws, the SDE
    sampler on handed-in noise and an 8-step ``sample_and_log_prob`` on
    the card (kernel 2 launched) against a CPU copy: 1e-4, relative to the
    largest |value| for the samples and densities."""
    model = _diffusion(dev, 1)
    cpu = copy.deepcopy(model).to("cpu")
    gen = torch.Generator(device=dev).manual_seed(3)
    x0 = torch.randn(512, 2, generator=gen, device=dev)
    draws = dict(u=torch.rand(512, generator=gen, device=dev),
                 strata=torch.randperm(512, generator=gen,
                                       device=dev).float(),
                 eps=torch.randn(512, 2, generator=gen, device=dev))
    before = _build.KERNELS["dense_stack"].launches
    loss = model.loss(None, x0, **draws)
    assert _build.KERNELS["dense_stack"].launches > before
    got = torch.autograd.grad(loss, list(model.parameters()))
    loss_c = cpu.loss(None, x0.cpu(), **{k: v.cpu() for k, v in
                                         draws.items()})
    want = torch.autograd.grad(loss_c, list(cpu.parameters()))
    torch.testing.assert_close(loss.cpu(), loss_c, atol=1e-4, rtol=1e-4)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-3)
    x1 = torch.randn(256, 2, generator=gen, device=dev)
    noise = torch.randn(16, 256, 2, generator=gen, device=dev)
    with torch.no_grad():
        outs = (model.sample(None, n_steps=16, x1=x1, noise=noise),
                *model.sample_and_log_prob(None, n_steps=8, x1=x1))
        outs_c = (cpu.sample(None, n_steps=16, x1=x1.cpu(),
                             noise=noise.cpu()),
                  *cpu.sample_and_log_prob(None, n_steps=8, x1=x1.cpu()))
    for a, b in zip(outs, outs_c):
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


def _painn(dev, seed=0, features=32):
    from vaemolsim_tpu_torch.nn import PaiNNPotential
    return PaiNNPotential.create(torch.Generator().manual_seed(seed), 1,
                                 features=features, num_blocks=2, n_rbf=16,
                                 cutoff=2.5, device=dev)


def test_painn_baoab_replays_as_the_eager_loop(dev):
    """100 BAOAB steps of 16 replicas of 16 LJ-dense atoms on a PaiNN
    potential through md's shared runner (two captured chunks of 50): the
    replay equals the eager loop on the same seed, to 1e-6."""
    from vaemolsim_tpu_torch import md
    model = _painn(dev)
    for p in model.parameters():
        p.requires_grad_(False)
    x0, L = _lj16(dev, chains=16)
    pot = model.as_potential(torch.ones(16, 1, device=dev),
                             box=torch.full((3,), L, device=dev))

    def run():
        dyn = md._BAOAB(pot, dt=0.002, kt=1.0, friction=1.0, masses=1.0)
        gen = torch.Generator(device=dev).manual_seed(5)
        return dyn.run(x0, torch.zeros_like(x0), 100, gen, True, 50)

    got, want = _replay_and_eager(run)
    _assert_same(got, want)


def test_committee_on_the_card_matches_a_cpu_copy(dev):
    """A committee of three PaiNNs (stack_models) on 64 frames of 16 atoms
    in a box, with and without a padding mask: every statistic of
    ensemble_energy_forces and max_force_uncertainty on the card against a
    CPU copy, to 1e-4 of the largest |value|; three identical members
    spread exactly 0."""
    from vaemolsim_tpu_torch.nn import (ensemble_energy_forces,
                                        max_force_uncertainty)
    from vaemolsim_tpu_torch.train import stack_models
    stack = stack_models([_painn(dev, s, 16) for s in range(3)])
    cpu = copy.deepcopy(stack).to("cpu")
    x, L = _lj16(dev, chains=64)
    sp, box = torch.ones(16, 1), torch.full((3,), L)
    for mask in (None, torch.arange(16) < 13):
        args = (sp, box, mask)
        dargs = tuple(None if a is None else a.to(dev) for a in args)
        with torch.no_grad():
            got = (*ensemble_energy_forces(stack, x, *dargs),
                   max_force_uncertainty(stack, x, *dargs))
            want = (*ensemble_energy_forces(cpu, x.cpu(), *args),
                    max_force_uncertainty(cpu, x.cpu(), *args))
        for a, b in zip(got, want):
            torch.testing.assert_close(a.cpu(), b, rtol=0,
                                       atol=1e-4 * float(b.abs().max()))
    same = stack_models([stack[0]] * 3)
    with torch.no_grad():
        pred = ensemble_energy_forces(same, x, sp.to(dev), box.to(dev))
    assert float(pred.energy_std.abs().max()) == 0.0
    assert float(pred.force_std.abs().max()) == 0.0


# ---------------------------------------------------------------------------
# Slice 14b: the parallel layer in a world-size-1 NCCL group, kernel 6's
# slabs, kernel 4's chain offset, the pipeline's side-stream copies and
# ``checked`` on a kernel's output
# ---------------------------------------------------------------------------


@pytest.fixture
def nccl(dev, tmp_path):
    """A world-size-1 NCCL group (the card is one rank), destroyed after
    the test."""
    from vaemolsim_tpu_torch import parallel

    parallel.initialize_distributed(f"file://{tmp_path / 'rdv'}", 1, 0,
                                    timeout=120.0)
    try:
        yield parallel
    finally:
        parallel.shutdown_distributed()


def test_kernel4_at_a_chain_offset_is_the_whole_launchs_rows(dev):
    from vaemolsim_tpu_torch.config import flagship_experiment_config

    vae = flagship_experiment_config().build(dev)
    enc_w, enc_act, _, d_z = mf._extract_mlp(vae.encoder, "encoder")
    dec_w, dec_act, _, d_x = mf._extract_mlp(vae.decoder, "decoder")
    tables_fn, base = mf._extract_prior(vae.prior)
    tables, rmin = tables_fn()
    spec = mf._Spec(d_x, d_z, enc_act, dec_act, tables[0].shape[-1],
                    float(rmin))
    rest = ([t.detach() for t in enc_w], [t.detach() for t in dec_w],
            [t.detach() for t in tables], base.detach(), spec)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(1000, 2, generator=gen, device=dev)
    seed = torch.tensor([7, -9], dtype=torch.int32, device=dev)
    whole = mf.vae_proposal_cuda(x, seed, *rest)
    part = mf.vae_proposal_cuda(x[600:].contiguous(), seed, *rest,
                                chain0=600)
    for w, p in zip(whole, part):
        assert torch.equal(w[600:], p)


def test_nccl_sharded_fused_mc_fit_remc_on_the_card(nccl, dev):
    """World size 1: the sharded fused run equals the unsharded one,
    fit(mesh=) trains on the kernels, REMC runs over a ("replica",
    "chain") mesh, the backend is NCCL."""
    import torch.distributed as dist

    from vaemolsim_tpu_torch.config import flagship_experiment_config
    from vaemolsim_tpu_torch.mcmc import (MCMCState, run_mcmc,
                                          vae_proposal_fns)
    from vaemolsim_tpu_torch.parallel import (REMCState, make_remc_step,
                                              run_remc, temperature_ladder)
    from vaemolsim_tpu_torch.train import fit

    assert dist.get_backend() == "nccl"
    vae = flagship_experiment_config().build(dev)
    target = lambda x: -0.5 * (x ** 2).sum(-1)  # noqa: E731
    step = mf.make_fused_vae_step(vae, target)
    x0 = torch.randn(512, 2, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(1))

    def fresh():
        return MCMCState.create(x0, target(x0),
                                torch.Generator(device=dev).manual_seed(2))

    mesh = nccl.make_mesh({"chain": -1})
    one, _ = run_mcmc(step, fresh(), 5)
    sh, _ = run_mcmc(step, nccl.shard_chain_state(fresh(), mesh), 5)
    assert torch.equal(one.configs, sh.configs)
    assert int(sh.num_trials) == 512 * 5
    before = _build.KERNELS["dense_stack"].launches
    _, hist = fit(vae, lambda m, b, g: m.elbo_loss(b, g),
                  torch.randn(1024, 2, device=dev),
                  generator=torch.Generator(device=dev).manual_seed(3),
                  batch_size=256, mesh=nccl.make_mesh({"batch": -1}))
    assert _build.KERNELS["dense_stack"].launches > before
    assert all(torch.isfinite(torch.tensor(hist["loss"])))
    rmesh = nccl.make_mesh({"replica": 1, "chain": -1})
    st = REMCState.create(torch.zeros(4, 64, 2, device=dev), target,
                          temperature_ladder(4),
                          torch.Generator(device=dev).manual_seed(4))
    st = run_remc(make_remc_step(*vae_proposal_fns(vae), target,
                                 mesh=rmesh),
                  nccl.shard_chain_state(st, rmesh), 6)
    assert int(st.num_swap_trials) == 3 * (2 + 1) * 64
    assert bool(torch.isfinite(st.energies).all())


def test_cell_grid_slabs_and_sharded_pme_on_the_card(nccl, dev):
    """Kernel 6's four slabs one after another (four launches a call of
    one run) and the mesh path sum to the unsharded call; PME over an
    "atoms" mesh equals the unsharded PME."""
    import numpy as np

    from vaemolsim_tpu_torch import potentials as tp
    from vaemolsim_tpu_torch.ops import cell_lj

    rng = np.random.default_rng(0)
    g = np.stack(np.meshgrid(np.arange(5), np.arange(5), np.arange(6),
                             indexing="ij"), -1).reshape(-1, 3)
    x = torch.tensor((g + 0.5) * (10.0 / np.array([5, 5, 6]))
                     + 0.2 * rng.normal(size=(150, 3)), dtype=torch.float32,
                     device=dev)
    q = np.tile([0.5, -0.5], 75)
    bonds = np.array([[2 * k, 2 * k + 1] for k in range(75)])
    kw = dict(box=[10.0] * 3, cutoff=2.5, skin=0.5, capacity=32, charges=q,
              coulomb_alpha=0.9, exclude=bonds)
    build, energy = tp.lennard_jones_cell_neighbor(**kw)
    _, mesh_energy = tp.lennard_jones_cell_neighbor(
        mesh=nccl.make_mesh({"cells": -1}), **kw)
    nl = build(x)
    xg = x.clone().requires_grad_(True)
    e = energy(nl, xg)
    (gr,) = torch.autograd.grad(e, xg)
    before = cell_lj.KERNEL.launches
    e4, g4 = energy.by_slabs(nl, x, 4)
    assert cell_lj.KERNEL.launches == before + 4
    xm = x.clone().requires_grad_(True)
    em = mesh_energy(nl, xm)
    (gm,) = torch.autograd.grad(em, xm)
    scale = float(gr.abs().max())
    e = float(e.detach())
    for ev, gv in ((e4, g4), (em, gm)):
        assert abs(float(ev.detach()) - e) <= 1e-6 * abs(e)
        assert float((gv - gr).abs().max()) <= 1e-6 * scale
    xp = torch.tensor(rng.uniform(size=(50, 3)) * [9.0, 8.0, 10.0],
                      dtype=torch.float32, device=dev)
    qp = rng.normal(size=50)
    qp -= qp.mean()
    out = []
    for m in (None, nccl.make_mesh({"atoms": -1})):
        fn = tp.pme_coulomb(qp, box=[9.0, 8.0, 10.0], r_cutoff=3.0,
                            tolerance=1e-4, exclude=bonds[:10], mesh=m)
        xv = xp.clone().requires_grad_(True)
        ev = fn(xv)
        out.append((float(ev.detach()), torch.autograd.grad(ev, xv)[0]))
    assert abs(out[0][0] - out[1][0]) < 1e-5 * max(1.0, abs(out[0][0]))
    torch.testing.assert_close(out[1][1], out[0][1], rtol=1e-4, atol=1e-5)


def test_prefetch_copies_on_a_side_stream_while_the_card_is_busy(dev):
    """The copies run on a side stream: with the current stream held by
    a device spin, every item is issued (the host is not blocked) and,
    once the stream waits for the copies, holds the right values."""
    import numpy as np

    from vaemolsim_tpu_torch.data import prefetch_to_device

    items = [np.full((4096, 64), i, np.float32) for i in range(6)]
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e8))  # ~0.1 s on the current stream
    got = [t for t in prefetch_to_device(iter(items), size=2)]
    sums = torch.stack([t.sum() for t in got])
    torch.cuda.synchronize()
    assert all(t.is_cuda for t in got)
    assert sums.tolist() == [4096 * 64 * float(i) for i in range(6)]


@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_dense_stack_carries_a_nan_row_as_plain_does(dev, act):
    """A NaN input row comes out NaN, the other rows unchanged, as in the
    plain chain (kernel 2's relu once took fmaxf, which returns 0 for a
    NaN, and so hid it)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    Ws = [torch.randn(2, 200, generator=gen, device=dev),
          torch.randn(200, 2, generator=gen, device=dev)]
    bs = [torch.randn(200, generator=gen, device=dev),
          torch.randn(2, generator=gen, device=dev)]
    x = torch.randn(1000, 2, generator=gen, device=dev)
    x[7] = float("nan")
    got = fused_dense_stack(x, Ws, bs, [act, None])
    want = dense_stack_plain(x, Ws, bs, [act, None])
    assert bool(torch.isnan(got[7]).all()) and bool(torch.isnan(want[7]).all())
    keep = torch.arange(1000, device=dev) != 7
    torch.testing.assert_close(got[keep], want[keep], rtol=1e-5, atol=1e-5)


def test_checked_names_kernel2_on_a_nan_it_writes(dev):
    from vaemolsim_tpu_torch.config import flagship_experiment_config
    from vaemolsim_tpu_torch.utils import CheckError, checked

    vae = flagship_experiment_config().build(dev)
    x = torch.randn(100, 2, device=dev)
    x[3] = float("nan")
    with torch.no_grad(), pytest.raises(CheckError,
                                        match="dense_stack kernel"):
        checked(lambda v: vae.encoder.mapping(v))(x)


# ---------------------------------------------------------------------------
# Slice 15: kernels 1 and 2's member axis, fit_ensemble as one vmapped step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M,n,dims,acts", [
    (8, 1, [1, 64, 47], ["tanh", None]),         # example 09 (small N)
    (3, 1024, [20, 40, 9], ["relu", None]),      # the tiled regime
    (3, 3000, [2, 50, 2], ["tanh", None]),       # the streaming regime
    (2, 300, [900, 5], ["relu"]),                # the wide regime
])
def test_dense_stack_member_axis_matches_plain(dev, M, n, dims, acts):
    """One launch for M stacks, each member's rows through its own
    weights, against the plain version member by member (1e-4, as the
    single stack); counted once, in the "members" mode."""
    from vaemolsim_tpu_torch.ops import fused_mlp
    gen = torch.Generator(device=dev).manual_seed(M + n)
    ks = [torch.randn(M, a, b, generator=gen, device=dev) / a ** 0.5
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [0.1 * torch.randn(M, b, generator=gen, device=dev)
          for b in dims[1:]]
    x = torch.randn(M, n, dims[0], generator=gen, device=dev)
    before = dict(fused_mlp.KERNEL.mode_launches)
    got = fused_mlp.dense_stack_members_cuda(x, ks, bs, acts)
    assert (fused_mlp.KERNEL.mode_launches.get("members", 0)
            == before.get("members", 0) + 1)
    for m in range(M):
        want = dense_stack_plain(x[m], [k[m] for k in ks],
                                 [b[m] for b in bs], acts)
        torch.testing.assert_close(got[m], want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("rows", ["broadcast", "per_element"])
def test_rqs_member_axis_matches_plain(dev, inverse, rows):
    """M = 8 splines of 16 bins on [-5, 5] over 1024 elements each in one
    launch: one knot row a member (the table regime) or a row per element
    (the walk).  Each member's values and log-dets equal the single
    spline's launch on that member's parameters bit for bit, and the
    plain version's at the single spline's tolerances (values to 1e-5 +
    1e-5|y|, log-dets to 1e-4) on all but 2 of the 8192 log-dets: the
    inverse's root near a vanishing discriminant magnifies FMA
    contraction (test_rqs_kernel_edges: 2 of 50 000; here 1.3e-4 at one
    input of the inverse, in the single launch as in the member one)."""
    M, n, K = 8, 1024, 16
    gen = torch.Generator(device=dev).manual_seed(8)
    shape = (M, 1, 1) if rows == "broadcast" else (M, n, 1)

    def raw(k):
        return torch.randn(shape + (k,), generator=gen, device=dev)

    params = (_bin_positions(raw(K), -5.0, 5.0, K),
              _bin_positions(raw(K), -5.0, 5.0, K), _slopes(raw(K - 1)))
    x = torch.rand(M, n, 1, generator=gen, device=dev) * 14.0 - 7.0
    y, ldj = rqs.rqs_members_cuda(x, *params, -5.0, inverse)
    plain = rqs.rqs_inverse_plain if inverse else rqs.rqs_forward_plain
    want = [torch.stack(v) for v in zip(*[
        plain(x[m], *(p[m] for p in params), -5.0) for m in range(M)])]
    for m in range(M):
        one = rqs.rqs_cuda(x[m], *(p[m] for p in params), -5.0, inverse)
        assert torch.equal(y[m], one[0]) and torch.equal(ldj[m], one[1])
    torch.testing.assert_close(y, want[0], atol=1e-5, rtol=1e-5)
    _close_but("ldj", ldj, want[1], 1e-4, 0.0, frac=2 / (M * n))


def _ens_member(seed, dev):
    from vaemolsim_tpu_torch.dists import StaticFlowedDistribution
    from vaemolsim_tpu_torch.flows import RQSSplineRealNVP
    from vaemolsim_tpu_torch.ops import distributions as dist
    base = dist.Independent(dist.Normal(torch.zeros(1, device=dev),
                                        torch.ones(1, device=dev)), 1)
    return StaticFlowedDistribution(RQSSplineRealNVP.create(
        torch.Generator(device=dev).manual_seed(seed), 1, num_blocks=4,
        rqs_params={"num_bins": 16, "hidden_dim": 64,
                    "bin_range": [-5.0, 5.0]}, device=dev), base)


def test_vmapped_fit_ensemble_step_matches_member_by_member(dev):
    """One fit_ensemble step of example 09's members on the card (one
    vmapped gradient: a member-batched launch of kernels 1 and 2 a block)
    against each member's own step (make_train_step with its own Adam:
    single-member launches): losses and weights to 1e-5 relative."""
    from vaemolsim_tpu_torch.ops import fused_mlp
    from vaemolsim_tpu_torch.train import (fit_ensemble, make_train_step,
                                           stack_models)
    K = 4
    gen = torch.Generator(device=dev).manual_seed(3)
    batch = torch.randn(1024, 1, generator=gen, device=dev)

    def loss(f, b, g):
        return -f().log_prob(b).mean()

    before = [dict(k.mode_launches) for k in (rqs.KERNEL, fused_mlp.KERNEL)]
    stack, hist = fit_ensemble(
        stack_models([_ens_member(100 + i, dev) for i in range(K)]), loss,
        batch, generator=gen, batch_size=1024, shuffle=False,
        learning_rate=3e-3)
    for k, was in zip((rqs.KERNEL, fused_mlp.KERNEL), before):
        assert (k.mode_launches.get("members", 0)
                - was.get("members", 0)) == 4
    for i in range(K):
        alone = _ens_member(100 + i, dev)
        opt = torch.optim.Adam(alone.parameters(), lr=3e-3)
        got, _ = make_train_step(loss, opt)(alone, batch, None)
        torch.testing.assert_close(
            torch.as_tensor(hist["loss"][0][i]), got.cpu(), rtol=1e-5,
            atol=1e-6)
        for p, q in zip(stack[i].parameters(), alone.parameters()):
            torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-6)


def test_vmap_of_a_kernel_without_a_member_axis_raises(dev):
    """A kernel route given no member-batched form raises under
    torch.func.vmap on a CUDA tensor: no quiet member loop."""
    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(8, 4, generator=gen, device=dev)
    w = torch.randn(3, 4, 5, generator=gen, device=dev)

    def route(wm):
        return _build.call_with_plain_grad(lambda a, b: a @ b,
                                           lambda a, b: a @ b, x, wm)

    with pytest.raises(RuntimeError, match="no member axis"):
        torch.func.vmap(route)(w)
