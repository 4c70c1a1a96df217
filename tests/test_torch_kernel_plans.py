"""What the dense-stack, MAF-block and pair-attention kernels take from
Python, on the CPU: the MADE's hidden-unit degrees and their sorted
order (which the MAF-block kernel prunes by), a plain-PyTorch emulation
of the kernel's pruned passes against the plain version and JAX, the
dense-stack regimes that the wrapper mirrors to raise where the kernel
refuses, and the pair-attention kernel's lane plan with an emulation of
its once-per-(pair, unit) order against the plain version and JAX.

The emulation follows ``csrc/maf_block.cu`` step by step: hidden units
sorted by degree; each DOF's heads over the prefix of units of lower
degree only; the forward in order of degree, pass p computing only the
hidden units of degree p - 1 and only the DOF of degree p.  If the
degrees or the order the kernel is given were wrong, the emulation
would drop non-zero terms and miss the plain version.  JAX runs as its
own tests run it (the Pallas kernel in interpret mode).  Float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vaemolsim_tpu.flows import spline_flows as jsf
from vaemolsim_tpu.nn import attention as ja
from vaemolsim_tpu.ops import maf_fused as jmf
from vaemolsim_tpu_torch.convert import from_jax
from vaemolsim_tpu_torch.flows.spline_flows import MaskedSplineConditioner
from vaemolsim_tpu_torch.nn.core import _made_masks
from vaemolsim_tpu_torch.ops import attention as tpa
from vaemolsim_tpu_torch.ops import fused_mlp as tfm
from vaemolsim_tpu_torch.ops import maf_fused as tmf
from vaemolsim_tpu_torch.ops.rqs import rqs_forward_plain, rqs_inverse_plain

torch.set_num_threads(1)

K, HIDDEN, BIN_MIN, BIN_MAX = 8, 20, -4.0, 4.0


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def j(a):
    return jnp.asarray(np.asarray(a, np.float32))


@pytest.mark.parametrize("D,H", [(1, 7), (2, 5), (3, 40), (8, 200),
                                 (8, 3)])
def test_hidden_degrees_order_and_starts_match_the_made_masks(D, H):
    """The degrees the masks imply (a hidden unit of degree g sees the g
    inputs of degree <= g), their stable sort, the kernel's in-kernel
    formula for it (group g: units g - 1 + m (D - 1)), and the prefix
    counts the kernel is given."""
    masks = _made_masks(tuple(range(1, D + 1)), (H,), 3)
    deg = tmf.hidden_degrees(D, H)
    np.testing.assert_array_equal(deg, masks[0].sum(0))
    # An output of degree p reads exactly the units of degree < p.
    out_deg = np.repeat(np.arange(1, D + 1), 3)
    np.testing.assert_array_equal(masks[1], deg[:, None] < out_deg[None, :])
    order = tmf.hidden_order(D, H)
    starts = tmf.hidden_degree_starts(D, H)
    assert starts[0] == 0 and starts[D] == H and len(starts) == D + 1
    assert np.all(np.diff(deg[order]) >= 0)
    for g in range(D):
        np.testing.assert_array_equal(
            order[starts[g]:starts[g + 1]], np.flatnonzero(deg == g))
    in_kernel = []
    for k in range(H):
        g = 0
        while starts[g + 1] <= k:
            g += 1
        m = k - starts[g]
        in_kernel.append(g - 1 + m * (D - 1) if D > 1 else m)
    np.testing.assert_array_equal(order, in_kernel)


def block_params(seed, D, order, cond_dim=None):
    """Merged weights of a JAX conditioner in the given input order,
    weights doubled and biases made non-zero (the masks' zeros stay)."""
    cond = jsf.MaskedSplineConditioner.create(
        jax.random.PRNGKey(seed), D, bin_range=(BIN_MIN, BIN_MAX),
        num_bins=K, hidden_dim=HIDDEN, conditional=cond_dim is not None,
        conditional_event_shape=cond_dim, input_order=order)
    rng = np.random.default_rng(seed)
    out = []
    for i, p in enumerate(cond.merged_params()):
        if p is None:
            continue
        p = np.asarray(p, np.float32)
        out.append(p + 0.2 * rng.normal(size=p.shape).astype(np.float32)
                   if i in (1, 3) else 2.0 * p)
    return out, [int(d) for d in cond.w_net.input_order_static]


def pruned_block(y, params, ctx, D, degrees, inverse):
    """The kernel's algorithm in plain PyTorch."""
    k1, b1, k2, b2 = params[:4]
    H = k1.shape[1] // 3
    span = BIN_MAX - BIN_MIN - K * 1e-2
    order = torch.as_tensor(tmf.hidden_order(D, H))
    starts = tmf.hidden_degree_starts(D, H)
    cols = torch.cat([hd * H + order for hd in range(3)])
    k1s, b1s, k2s = k1[:, cols], b1[cols], k2[cols]
    c1s = None if ctx is None else params[4][:, cols]
    n = y.shape[0]
    h = torch.zeros(n, 3, H)
    cur, ldj = y.clone(), torch.zeros(n, D)

    def hidden(lo, hi):
        for hd in range(3):
            sl = slice(hd * H + lo, hd * H + hi)
            pre = cur @ k1s[:, sl] + b1s[sl]
            if ctx is not None:
                pre = pre + ctx @ c1s[:, sl]
            h[:, hd, lo:hi] = torch.tanh(pre)

    def dof(d):
        lk = starts[degrees[d]]
        raw = []
        for hd, kh in enumerate((K, K, K - 1)):
            c0 = hd * D * K + d * kh
            out = (h[:, hd, :lk] @ k2s[hd * H:hd * H + lk, c0:c0 + kh]
                   + b2[c0:c0 + kh])
            if ctx is not None:
                out = out + ctx @ params[5][:, c0:c0 + kh]
            raw.append(out[:, None, :])
        w = torch.softmax(raw[0], -1) * span + 1e-2
        hh = torch.softmax(raw[1], -1) * span + 1e-2
        s = F.softplus(raw[2]) + 1e-2
        fn = rqs_inverse_plain if inverse else rqs_forward_plain
        xd, ld = fn(y[:, d:d + 1], w, hh, s, BIN_MIN)
        cur[:, d], ldj[:, d] = xd[:, 0], ld[:, 0]

    if inverse:
        hidden(0, H)
        for d in range(D):
            dof(d)
    else:
        dof_of = {p: d for d, p in enumerate(degrees)}
        for p in range(1, D + 1):
            hidden(starts[p - 1], starts[p])
            dof(dof_of[p])
    return cur, ldj.sum(-1)


ORDERS = {"left-to-right": "left-to-right",
          "right-to-left": "right-to-left",
          "random": np.random.default_rng(11).permutation(4) + 1}


@pytest.mark.parametrize("order", list(ORDERS))
def test_pruned_forward_matches_plain_and_jax(order):
    """D = 4, hidden 20, 8 bins: the pruned forward (each DOF made once,
    in order of degree) against ``maf_block_plain``'s D-pass fixed point
    and JAX's ``maf_block_forward_fused`` in interpret mode, 1e-5 (sums
    in another order, the skipped terms exact zeros); the pruned inverse
    against the plain inverse likewise."""
    D = 4
    params, degrees = block_params(20 + len(order), D, ORDERS[order])
    rng = np.random.default_rng(21)
    y = (2.0 * rng.normal(size=(48, D))).astype(np.float32)
    tparams = [t(p) for p in params]
    with torch.no_grad():
        got = pruned_block(t(y), tparams, None, D, degrees, inverse=False)
        plain = tmf.maf_block_plain(t(y), tparams, None, D, K, BIN_MIN,
                                    BIN_MAX, False)
        got_inv = pruned_block(t(y), tparams, None, D, degrees, inverse=True)
        plain_inv = tmf.maf_block_plain(t(y), tparams, None, D, K, BIN_MIN,
                                        BIN_MAX, True)
    want = jmf.maf_block_forward_fused(j(y), tuple(j(p) for p in params),
                                       None, D, K, BIN_MIN, BIN_MAX,
                                       jnp.float32, True)
    for g, p, w in zip(got, plain, want):
        np.testing.assert_allclose(g.numpy(), p.numpy(), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
    for g, p in zip(got_inv, plain_inv):
        np.testing.assert_allclose(g.numpy(), p.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_pruned_block_with_context_and_one_dof():
    """A conditional D = 3 block (random order) and the conditional D = 1
    block (hidden units of degree 0, the heads over all of them), the
    port's own conditioners with scaled weights, both directions, against
    the plain version: 1e-5."""
    rng = np.random.default_rng(22)
    gen = torch.Generator().manual_seed(22)
    for D, order in ((3, np.array([2, 3, 1])), (1, "left-to-right")):
        cond = MaskedSplineConditioner.create(
            gen, D, bin_range=(BIN_MIN, BIN_MAX), num_bins=K,
            hidden_dim=HIDDEN, conditional=True, conditional_event_shape=2,
            input_order=order, device="cpu")
        params = [2.0 * p.detach() for p in cond.merged_params()]
        params[1] = params[1] + 0.2 * torch.randn(params[1].shape,
                                                  generator=gen)
        degrees = list(cond.w_net.input_order_static)
        y = t(2.0 * rng.normal(size=(40, D)))
        ctx = t(rng.normal(size=(40, 2)))
        for inverse in (True, False):
            with torch.no_grad():
                got = pruned_block(y, params, ctx, D, degrees, inverse)
                want = tmf.maf_block_plain(y, params, ctx, D, K, BIN_MIN,
                                           BIN_MAX, inverse)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5,
                                           rtol=1e-5)


def test_maf_degree_arguments_are_checked():
    """The wrapper refuses missing or malformed degrees before a launch,
    and MAFLayer hands the conditioner's own order to the kernel."""
    with pytest.raises(ValueError, match="degrees"):
        tmf._degree_args(None, 3)
    with pytest.raises(ValueError, match="permutation"):
        tmf._degree_args([1, 1, 2], 3)
    with pytest.raises(ValueError, match="at most"):
        tmf._degree_args(list(range(1, tmf.MAX_DOFS + 2)), tmf.MAX_DOFS + 1)
    assert tmf._degree_args((3, 1, 2), 3) == [3, 1, 2]


@pytest.mark.parametrize("n,dims,dc,regime", [
    (1, [1, 600, 95], 0, "small"),       # the one-row MAF conditioner
    (16, [1, 600, 95], 0, "small"),      # the small-N limit
    (17, [1, 600, 95], 0, "tiled"),      # ... plus one
    (0, [1, 600, 95], 0, "small"),
    (50_000, [2, 200, 2], 0, "stream"),  # encoder
    (50_000, [1, 200, 4], 0, "stream"),  # decoder
    (10_000, [20, 40, 9], 0, "tiled"),   # backmapping decoder
    (10_000, [1, 200, 95], 3, "tiled"),  # wide head
    (777, [2, 200, 64, 5], 3, "tiled"),  # three layers
    (777, [4, 40, 8], 3, "stream"),      # din + dc + 1 = 8, dout = 8
    (777, [5, 40, 8], 3, "tiled"),       # din + dc + 1 = 9
    (777, [2, 40, 9], 0, "tiled"),       # dout = 9
    (4, [1, 30000, 1], 0, "refused"),
    (4, [1, 2000, 1], 0, "small"),
    (400, [1, 3000, 3000, 1], 0, "refused"),
])
def test_dense_stack_regimes(n, dims, dc, regime):
    """The regime and shared memory ``stack_regime`` mirrors from
    ``csrc/dense_stack.cu`` (small N first, then streaming, then tiled;
    refused where none fits the 227 KB a block may use)."""
    got, smem = tfm.stack_regime(n, dims, dc)
    assert got == regime
    assert (smem <= tfm._MAX_SMEM) == (regime != "refused")


def test_dense_stack_wrapper_refuses_where_the_kernel_would():
    """A CPU tensor is refused first; the shared-memory refusal is the
    mirror's (its message names the bytes)."""
    x = torch.zeros(4, 1)
    wide = [torch.zeros(1, 30000), torch.zeros(30000, 1)]
    with pytest.raises(ValueError, match="CUDA"):
        tfm.dense_stack_cuda(x, wide, [torch.zeros(30000), torch.zeros(1)],
                             ["relu", None])
    assert tfm.stack_regime(4, [1, 30000, 1])[1] > tfm._MAX_SMEM


# ---------------------------------------------------------------------------
# The pair-attention kernel: lane plan and the once-per-(pair, unit) order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N,H,B,plan", [
    (10, 40, 2000, ("rows", 8, 5, 3, 667)),     # the notebook's layer
    (10, 40, 10_000, ("rows", 8, 5, 3, 3334)),  # serving at 10k sites
    (10, 40, 128, ("rows", 8, 5, 1, 128)),      # training: a frame a block
    (50, 64, 1000, ("grid", None, None, 1, 1000)),  # compute-dense
    (37, 40, 300, ("rows", 8, 5, 1, 300)),      # ragged
    (44, 64, 1000, ("rows", 16, 4, 1, 1000)),   # two 96 KB blocks an SM
    (50, 40, 1000, ("rows", 8, 5, 1, 1000)),
    (64, 40, 1000, ("rows", 8, 5, 1, 1000)),    # one block of 32 groups
    (37, 128, 1000, ("grid", None, None, 1, 1000)),  # one block of 8
    (6, 16, 5000, ("rows", 4, 4, 8, 625)),      # at most 8 frames a block
    (5, 3, 40, ("rows", 1, 4, 1, 40)),
    (6, 100, 33, ("rows", 32, 4, 1, 33)),
    (6, 256, 33, ("rows", 32, 8, 1, 33)),
    (6, 300, 33, ("grid", None, None, 1, 33)),  # wider than a warp's units
    (400, 300, 2, ("stream", 32, 12, 1, 2)),    # 12 units a lane
    (1024, 512, 1, ("stream", 32, 16, 1, 1)),   # the widest stream frame
    (8192, 40, 1, ("stream", 8, 5, 1, 1)),      # 64 key chunks
])
def test_pair_attention_plan(N, H, B, plan):
    """Regime, lanes per row, units per lane, frames per block and
    blocks, as ``kernel_plan`` decides them for ``csrc/pair_attention.cu``
    (whose launch only validates them): rows where H <= 256 and two
    blocks fit an SM or a block holds 32 lane groups, the grid otherwise;
    the notebook shape fits several blocks of
    34 KB on an SM; a frame too large for both takes the stream regime
    (no pair grid in shared memory, keys in chunks of 128, up to 16 units
    a lane) where H <= 512 and is refused above."""
    got = tpa.kernel_plan(B, N, H, 20)
    assert (got["regime"], got["lanes"], got["units"], got["frames"],
            got["blocks"]) == plan
    assert not got["refused"] and got["smem"] <= tpa._MAX_SMEM
    if got["regime"] in ("rows", "stream"):
        assert got["lanes"] * got["units"] >= H
    if (N, H) == (10, 40):
        assert got["smem"] < 48 * 1024
    big = tpa.kernel_plan(1, 400, 64, 20)
    assert big["regime"] == "stream" and not big["refused"]
    assert (big["lanes"], big["units"], big["frames"]) == (16, 4, 1)
    wide = tpa.kernel_plan(1, 400, 300, 20)
    assert wide["regime"] == "stream" and not wide["refused"]
    assert tpa.kernel_plan(1, 400, 520, 20)["refused"]
    assert tpa.kernel_plan(1, 8192, 40, 20)["smem"] == tpa.kernel_plan(
        1, 1553, 40, 20)["smem"]
    forced = tpa.kernel_plan(B, N, H, 20, regime="grid")
    assert forced["regime"] == "grid"
    if H <= 256 and N <= 64:
        assert tpa.kernel_plan(B, N, H, 20, regime="rows")["regime"] == "rows"


def _group_sum(v):
    """The lane group's xor-shuffle sum over the last axis (lanes)."""
    L = v.shape[-1]
    o = L // 2
    while o:
        v = v + v[..., torch.arange(L) ^ o]
        o //= 2
    return v[..., 0]


def emulate_pair_attention(coords, ni_s, nj_s, ni_v, nj_v, mask, wq_s,
                           b1_s, w2_s, b2_s, wq_v, b1_v, ln_g, ln_b, w2_v,
                           b2_v, *, reduce, act=None, ln_eps=1e-3):
    """``csrc/pair_attention.cu``'s order of operations in plain PyTorch:
    lane b of a row's group holds units b + L m (m < U, zero weights past
    H); per pair each lane's units of the score trunk, summed over its
    units in m order and over the group by the butterfly; per pair of
    non-zero weight the value trunk evaluated once per unit, the
    LayerNorm's mean and variance as two group sums of the held values,
    act(LN) applied once and accumulated with alpha over j in order; the
    value head once per row (folded through the contraction)."""
    B, N, _ = coords.shape
    H, Fo = wq_s.shape[1], w2_v.shape[1]
    plan = tpa.kernel_plan(B, N, H, Fo, regime="rows")
    L, U = plan["lanes"], plan["units"]
    k = torch.arange(L)[None, :] + L * torch.arange(U)[:, None]  # (U, L)
    ok = k < H
    kc = k.clamp(max=H - 1)

    def units(w):       # (..., H) -> (..., U, L), zero past H
        return torch.where(ok, w[..., kc], 0.0)

    act_fn = {"relu": torch.relu, "tanh": torch.tanh}.get(act, lambda v: v)
    q = tpa.pair_invariants(coords)                          # (B, N, N, 4)

    def trunk(ni, nj, wq, b1):
        h = (units(ni + b1)[:, :, None] + units(nj)[:, None, :])
        for m in range(4):
            h = h + q[..., m, None, None] * units(wq[m])
        return h                                             # (B,N,N,U,L)

    pm = mask[:, :, None] * mask[:, None, :]
    hs = act_fn(trunk(ni_s, nj_s, wq_s, b1_s)) * units(w2_s)
    part = hs[..., 0, :]
    for m in range(1, U):
        part = part + hs[..., m, :]
    s = torch.where(pm > 0.5, _group_sum(part) + b2_s[0], -1e9)
    if reduce:
        e = torch.exp(s - s.amax((1, 2), keepdim=True)) * pm
        alpha = e / e.sum((1, 2), keepdim=True).clamp_min(1e-30)
    else:
        e = torch.exp(s - s.amax(-1, keepdim=True)) * pm
        alpha = e / e.sum(-1, keepdim=True).clamp_min(1e-30)
    hv = trunk(ni_v, nj_v, wq_v, b1_v)
    tot = hv[..., 0, :]
    for m in range(1, U):
        tot = tot + hv[..., m, :]
    mu = _group_sum(tot) / H
    d = hv - mu[..., None, None]
    sq = torch.where(ok, d * d, 0.0)
    var = sq[..., 0, :]
    for m in range(1, U):
        var = var + sq[..., m, :]
    rs = 1.0 / torch.sqrt(_group_sum(var) / H + ln_eps)
    t = act_fn(d * rs[..., None, None] * units(ln_g) + units(ln_b))
    acc = torch.zeros(B, N, U, L)
    for j in range(N):
        a = alpha[:, :, j, None, None]
        acc = torch.where(a != 0, acc + a * t[:, :, j], acc)
    A = torch.zeros(B, N, H)
    A[..., kc[ok]] = acc[..., ok]
    rsum = alpha.sum(-1)
    if reduce:
        return A.sum(1) @ w2_v + b2_v * rsum.sum(-1, keepdim=True)
    return A @ w2_v + b2_v * rsum[..., None]


@pytest.mark.parametrize("reduce", [False, True])
@pytest.mark.parametrize("act,H", [("relu", 40), ("tanh", 16),
                                   ("linear", 20), ("relu", 3)])
def test_pair_attention_order_matches_plain_and_jax(reduce, act, H):
    """The emulated order against the plain version, and at the
    notebook's H = 40 against the JAX Pallas kernel in interpret mode, at
    1e-5 + 1e-5|v| (the kernel's card tolerance), with a fully masked row
    and a fully masked cloud exactly zero; H = 40 and 20 fill lane groups
    of 8 and 4 exactly, H = 16 and 3 leave padding units."""
    jattn = ja.VectorAttention.create(jax.random.PRNGKey(H), 5, 7,
                                      hidden_dim=H, reduce=reduce,
                                      activation=act)
    leaves, tree = jax.tree_util.tree_flatten(jattn)
    rng = np.random.default_rng(H)
    jattn = jax.tree_util.tree_unflatten(tree, [
        leaf + 0.1 * rng.normal(size=leaf.shape).astype(np.float32)
        for leaf in leaves])
    tattn = from_jax(jattn, "cpu")
    c = (1.3 * rng.normal(size=(4, 7, 3))).astype(np.float32)
    v = rng.normal(size=(4, 7, 5)).astype(np.float32)
    m = (rng.random((4, 7)) > 0.3).astype(np.float32)
    m[0, 1] = 0.0
    m[1] = 0.0
    with torch.no_grad():
        (c_, *nodes, mf_, weights), kw = tattn.pair_args(t(c), t(v), t(m))
        got = emulate_pair_attention(c_, *nodes, mf_, *weights, **kw)
        want = tpa.pair_attention_plain(c_, *nodes, mf_, *weights, **kw)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    if H == 40:
        pallas = np.asarray(ja._va_fused_impl(jattn, j(c), j(v), j(m),
                                              interpret=True))
        np.testing.assert_allclose(got.numpy(), pallas, atol=1e-5,
                                   rtol=1e-5)
    assert float(got[1].abs().max()) == 0.0
    if not reduce:
        assert float(got[0, 1].abs().max()) == 0.0
