"""What the dense-stack and MAF-block kernels take from Python, on the
CPU: the MADE's hidden-unit degrees and their sorted order (which the
MAF-block kernel prunes by), a plain-PyTorch emulation of the kernel's
pruned passes against the plain version and JAX, and the dense-stack
regimes that the wrapper mirrors to raise where the kernel refuses.

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
from vaemolsim_tpu.ops import maf_fused as jmf
from vaemolsim_tpu_torch.flows.spline_flows import MaskedSplineConditioner
from vaemolsim_tpu_torch.nn.core import _made_masks
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
            input_order=order)
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
