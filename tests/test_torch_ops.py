"""The port's kernel modules against the JAX package, on the CPU.

Each module of ``vaemolsim_tpu_torch`` that holds a CUDA kernel runs its
plain PyTorch version here (the tensors lie on the CPU) and is held to
the JAX reference on the same numpy-made inputs: the RQS spline against
the XLA path, the Pallas kernel in interpret mode and the 30-digit
mpmath goldens; the dense stack against the Pallas kernel in interpret
mode.  All comparisons are float32 against float32.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu.flows.spline_flows import _bin_positions, _slopes
from vaemolsim_tpu.ops import rqs as jrqs
from vaemolsim_tpu.ops.fused_mlp import fused_dense_stack as j_fused_stack
from vaemolsim_tpu.ops.rqs_pallas import (rqs_forward_pallas,
                                          rqs_inverse_pallas)
from vaemolsim_tpu_torch import _build
from vaemolsim_tpu_torch.flows.spline_flows import (
    _bin_positions as t_bin_positions, _slopes as t_slopes)
from vaemolsim_tpu_torch.mcmc.fused import philox4x32_10
from vaemolsim_tpu_torch.ops import rqs as trqs
from vaemolsim_tpu_torch.ops.fused_mlp import (dense_stack_cuda,
                                               dense_stack_plain,
                                               fused_dense_stack)

torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "goldens", "rqs_mpmath.json")


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def spline_params(rng, rows, K, lo=-5.0, hi=5.0):
    """Activated spline parameters (numpy) through the JAX activations."""
    w = _bin_positions(jnp.asarray(rng.normal(size=(rows, K)), jnp.float32),
                       lo, hi, K)
    h = _bin_positions(jnp.asarray(rng.normal(size=(rows, K)), jnp.float32),
                       lo, hi, K)
    s = _slopes(jnp.asarray(rng.normal(size=(rows, K - 1)), jnp.float32))
    return np.asarray(w), np.asarray(h), np.asarray(s)


# ---------------------------------------------------------------------------
# RQS spline (kernel 1's module)
# ---------------------------------------------------------------------------

# N = 301 is not a multiple of any tile.  Inputs span the range and both
# identity tails ([-5, 5] range, x in [-7, 7]); random continuous inputs
# land within float32 roundoff of a knot with probability ~1e-5, so every
# element is held.  The port sums knots in the XLA path's order, so
# against XLA values agree to 2e-6 and log-dets to 2e-6 (float32
# roundoff at |x| <= 7 and of a log).  The Pallas kernel places knots as
# offsets from range_min (rqs_pallas.py:73), a different rounding of the
# same knots that a bin of slope up to ~50 magnifies: 5e-5 and 1e-4.
N, K = 301, 8


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("rows", ["per_row", "broadcast"])
def test_rqs_plain_matches_xla_and_pallas(inverse, rows):
    rng = np.random.default_rng(0)
    w, h, s = spline_params(rng, N if rows == "per_row" else 1, K)
    x = rng.uniform(-7.0, 7.0, size=(N,)).astype(np.float32)
    xla = jrqs._rqs_inverse_xla if inverse else jrqs._rqs_forward_xla
    pallas = rqs_inverse_pallas if inverse else rqs_forward_pallas
    port = trqs.rqs_inverse if inverse else trqs.rqs_forward
    got_y, got_l = port(t(x), t(w), t(h), t(s), -5.0)
    for ref, atol_y, atol_l in (
            (xla(jnp.asarray(x), w, h, s, -5.0), 2e-6, 2e-6),
            (pallas(jnp.asarray(x), w, h, s, -5.0, True), 5e-5, 1e-4)):
        np.testing.assert_allclose(got_y.numpy(), np.asarray(ref[0]),
                                   rtol=0, atol=atol_y)
        np.testing.assert_allclose(got_l.numpy(), np.asarray(ref[1]),
                                   rtol=0, atol=atol_l)
    tails = np.abs(x) > 5.0
    assert tails.sum() > 20
    np.testing.assert_array_equal(got_y.numpy()[tails], x[tails])
    np.testing.assert_array_equal(got_l.numpy()[tails], 0.0)


def test_rqs_round_trip_and_trailing_broadcast():
    """Inverse(forward(x)) = x with log-dets that cancel; parameters of
    shape (D, K) broadcast against x of shape (N, D)."""
    rng = np.random.default_rng(1)
    D = 3
    w, h, s = spline_params(rng, D, K)
    x = t(rng.uniform(-4.9, 4.9, size=(N, D)))
    y, fl = trqs.rqs_forward(x, t(w), t(h), t(s), -5.0)
    xb, il = trqs.rqs_inverse(y, t(w), t(h), t(s), -5.0)
    assert y.shape == (N, D)
    # Round trip: float32 roundoff of y divided by the local slope.
    np.testing.assert_allclose(xb.numpy(), x.numpy(), atol=5e-5)
    np.testing.assert_allclose((fl + il).numpy(), 0.0, atol=5e-4)
    ref_y, ref_l = jrqs._rqs_forward_xla(jnp.asarray(x.numpy()), w, h, s,
                                         -5.0)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=2e-6)
    np.testing.assert_allclose(fl.numpy(), np.asarray(ref_l), atol=2e-6)


def test_rqs_against_mpmath_goldens():
    """The port's float32 spline against the 30-digit oracle, with the
    bounds tests/test_rqs_oracle.py holds the JAX package to: values to
    2e-5, log-dets at float32-roundoff scale for most points (median
    < 5e-5) and within 5e-4 plus the knot-conditioning spread for all
    (that spread measured here by perturbing the input by 1e-5)."""
    with open(GOLDENS) as f:
        cases = json.load(f)["cases"]
    errs = []
    for case in cases:
        lo, hi = case["bin_range"]
        Kc = case["num_bins"]
        w = t_bin_positions(t(case["raw_w"]), lo, hi, Kc)[None]
        h = t_bin_positions(t(case["raw_h"]), lo, hi, Kc)[None]
        s = t_slopes(t(case["raw_s"]))[None]
        x = t(case["x"])
        for fn, val, ldj_key in ((trqs.rqs_forward, "forward_y",
                                  "forward_ldj"),
                                 (trqs.rqs_inverse, "inverse_x",
                                  "inverse_ildj")):
            v, l = fn(x, w, h, s, lo)
            np.testing.assert_allclose(v.numpy(), case[val], atol=2e-5,
                                       rtol=1e-5)
            spread = np.maximum(
                np.abs((fn(x + 1e-5, w, h, s, lo)[1] - l).numpy()),
                np.abs((fn(x - 1e-5, w, h, s, lo)[1] - l).numpy()))
            err = np.abs(l.numpy().astype(np.float64)
                         - np.asarray(case[ldj_key]))
            assert np.all(err <= 5e-4 + 4.0 * spread), (case["config"],
                                                        err.max())
            errs.extend(err.tolist())
    assert np.median(errs) < 5e-5


def test_rqs_gradient_recomputes_through_plain():
    """The kernel's autograd wrapper (here with the plain version in the
    kernel's place, since no card is present) gives the plain version's
    gradients."""
    rng = np.random.default_rng(2)
    w, h, s = (t(a).requires_grad_() for a in spline_params(rng, 1, K))
    x = t(rng.uniform(-6, 6, size=(64, 1))).requires_grad_()

    def plain(*a):
        return trqs.rqs_forward_plain(*a, -5.0)

    y, l = _build.call_with_plain_grad(plain, plain, x, w, h, s)
    got = torch.autograd.grad((y.sum() + l.sum()), (x, w, h, s))
    y2, l2 = plain(x, w, h, s)
    want = torch.autograd.grad((y2.sum() + l2.sum()), (x, w, h, s))
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r)


@pytest.mark.parametrize("inverse", [False, True])
def test_rqs_circular_matches_jax(inverse):
    """The circle spline (plain PyTorch in the port, as on the TPU) over
    several periods: values to 2e-5 (the winding adds |t| <= 25 back),
    log-dets to 2e-5."""
    rng = np.random.default_rng(6)
    w, h, _ = spline_params(rng, 1, K, -3.0, 3.0)
    s = np.asarray(_slopes(jnp.asarray(rng.normal(size=(1, K)),
                                       jnp.float32)))
    x = rng.uniform(-25.0, 25.0, size=(N,)).astype(np.float32)
    jfn = jrqs.rqs_inverse_circular if inverse else jrqs.rqs_forward_circular
    tfn = trqs.rqs_inverse_circular if inverse else trqs.rqs_forward_circular
    want = jfn(jnp.asarray(x), w, h, s, -3.0)
    got = trqs.RationalQuadraticSpline(t(w), t(h), t(s), -3.0, True)
    got = (got.inverse_and_log_det if inverse
           else got.forward_and_log_det)(t(x))
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5)
    for g, r in zip(tfn(t(x), t(w), t(h), t(s), -3.0), got):
        torch.testing.assert_close(g, r)


def test_spline_conditioner_matches_jax():
    """SplineConditioner after from_jax, on a batch and on the zero-width
    input that a 1-D coupling feeds it (replaced by ones)."""
    import jax
    from vaemolsim_tpu.flows.spline_flows import SplineConditioner
    from vaemolsim_tpu_torch.convert import from_jax
    x = np.random.default_rng(7).normal(size=(33, 2)).astype(np.float32)
    for in_dim in (2, 0):
        jc = SplineConditioner.create(jax.random.PRNGKey(in_dim), in_dim, 3,
                                      num_bins=K, hidden_dim=16,
                                      bin_range=(-4.0, 4.0))
        xin = x[:, :in_dim]
        js, ts = jc(jnp.asarray(xin)), from_jax(jc, "cpu")(t(xin))
        for a in ("bin_widths", "bin_heights", "knot_slopes"):
            np.testing.assert_allclose(getattr(ts, a).detach().numpy(),
                                       np.asarray(getattr(js, a)),
                                       atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# Bijectors and distributions
# ---------------------------------------------------------------------------


def test_bijector_composition_matches_jax():
    """Chain(Block(Shift), Block(Scale), Inverse(Block(Shift))) and
    Identity: values and event-summed log-dets, both directions."""
    from vaemolsim_tpu.ops import bijectors as jb
    from vaemolsim_tpu_torch.ops import bijectors as tb
    sh = np.array([0.5, -1.0, 2.0], np.float32)
    sc = np.array([2.0, -0.5, 3.0], np.float32)
    jchain = jb.Chain((jb.Block(jb.Shift(jnp.asarray(sh)), 1),
                       jb.Block(jb.Scale(jnp.asarray(sc)), 1),
                       jb.Inverse(jb.Block(jb.Shift(jnp.asarray(sh * 3)),
                                           1))))
    tchain = tb.Chain((tb.Block(tb.Shift(t(sh)), 1),
                       tb.Block(tb.Scale(t(sc)), 1),
                       tb.Inverse(tb.Block(tb.Shift(t(sh * 3)), 1))))
    x = np.random.default_rng(8).normal(size=(10, 3)).astype(np.float32)
    for name in ("forward_and_log_det", "inverse_and_log_det"):
        jv, jl = getattr(jchain, name)(jnp.asarray(x))
        tv, tl = getattr(tchain, name)(t(x))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6)
    y, l = tb.Identity().forward_and_log_det(t(x))
    assert torch.equal(y, t(x)) and not l.any()
    torch.testing.assert_close(tchain.inverse(tchain(t(x))), t(x))


def test_distributions_match_jax():
    """Log-densities of the ported distributions at shared points, and a
    mixed-family Blockwise whose DOFs are permuted by family (float32
    roundoff: 1e-6)."""
    from vaemolsim_tpu.dists import IndependentBlockwise as JIB
    from vaemolsim_tpu.ops import distributions as jd
    from vaemolsim_tpu_torch.dists import IndependentBlockwise as TIB
    from vaemolsim_tpu_torch.ops import distributions as td
    rng = np.random.default_rng(9)
    loc, scale = rng.normal(size=4), rng.uniform(0.5, 2.0, size=4)
    x = rng.normal(size=(6, 4)).astype(np.float32)
    pairs = [
        (jd.Independent(jd.Normal(jnp.asarray(loc, jnp.float32),
                                  jnp.asarray(scale, jnp.float32)), 1),
         td.Independent(td.Normal(t(loc), t(scale)), 1)),
        (jd.Uniform(jnp.full(4, -1.0), jnp.full(4, 1.0)),
         td.Uniform(torch.full((4,), -1.0), torch.full((4,), 1.0))),
    ]
    for jdist, tdist in pairs:
        np.testing.assert_allclose(tdist.log_prob(t(x)).numpy(),
                                   np.asarray(jdist.log_prob(jnp.asarray(x))),
                                   atol=1e-6)
    fams = ["normal", "deterministic", "normal", "deterministic"]
    raw = rng.normal(size=(6, 6)).astype(np.float32)
    jbw, tbw = JIB.create(4, fams)(jnp.asarray(raw)), TIB.create(4, fams)(
        t(raw))
    xd = x.copy()
    xd[:, 1], xd[:, 3] = raw[:, 2], raw[:, 5]  # on the Dirac atoms
    for f in ("log_prob", "log_prob_per_dof"):
        np.testing.assert_allclose(
            getattr(tbw, f)(t(xd)).numpy(),
            np.asarray(getattr(jbw, f)(jnp.asarray(xd))), atol=1e-6)
    draw = tbw.sample(torch.Generator().manual_seed(0), (5,))
    assert draw.shape == (5, 6, 4)
    np.testing.assert_array_equal(draw[:, :, 3].numpy(),
                                  np.broadcast_to(raw[:, 5], (5, 6)))
    assert torch.isinf(tbw.log_prob(t(x))).all()


# ---------------------------------------------------------------------------
# Dense stack (kernel 2's module)
# ---------------------------------------------------------------------------


def make_stack(rng, dims, cond_dim):
    ks = [rng.normal(size=(a, b)).astype(np.float32) * 0.3
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [rng.normal(size=(b,)).astype(np.float32) * 0.1 for b in dims[1:]]
    cks = (None if not cond_dim else
           [rng.normal(size=(cond_dim, b)).astype(np.float32) * 0.2
            for b in dims[1:]])
    return ks, bs, cks


@pytest.mark.parametrize("act", ["relu", "tanh", None])
@pytest.mark.parametrize("cond_dim", [0, 3])
def test_dense_stack_plain_matches_pallas_interpret(act, cond_dim):
    """Float32 products in both: agreement to 1e-5 (sums of 32 terms of
    O(1) magnitude, summed in different orders)."""
    rng = np.random.default_rng(3)
    dims = [2, 32, 32, 5]
    ks, bs, cks = make_stack(rng, dims, cond_dim)
    x = rng.normal(size=(77, 2)).astype(np.float32)
    c = rng.normal(size=(77, cond_dim)).astype(np.float32)
    acts = [act, act, None]
    want = j_fused_stack(
        jnp.asarray(x), [jnp.asarray(k) for k in ks],
        [jnp.asarray(b) for b in bs], acts,
        cond=jnp.asarray(c) if cond_dim else None,
        cond_kernels=[jnp.asarray(k) for k in cks] if cond_dim else None,
        interpret=True)
    args = (t(x), [t(k) for k in ks], [t(b) for b in bs], acts,
            t(c) if cond_dim else None,
            [t(k) for k in cks] if cond_dim else None)
    np.testing.assert_allclose(fused_dense_stack(*args).numpy(),
                               np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dense_stack_plain(*args).numpy(),
                               np.asarray(want), atol=1e-5, rtol=1e-5)


def test_dense_stack_unsupported_activation_takes_plain_path():
    rng = np.random.default_rng(4)
    ks, bs, _ = make_stack(rng, [2, 8, 3], 0)
    x = t(rng.normal(size=(10, 2)))
    out = fused_dense_stack(x, [t(k) for k in ks], [t(b) for b in bs],
                            ["gelu", None])
    want = dense_stack_plain(x, [t(k) for k in ks], [t(b) for b in bs],
                             ["gelu", None])
    torch.testing.assert_close(out, want)


# ---------------------------------------------------------------------------
# Kernel wrappers on the CPU
# ---------------------------------------------------------------------------


def test_kernel_wrappers_refuse_cpu_tensors_and_count_nothing():
    """A CPU tensor never reaches a kernel: the dispatchers run the plain
    version (no launch counted) and the CUDA wrappers refuse it."""
    _build.reset_launches()
    rng = np.random.default_rng(5)
    w, h, s = (t(a) for a in spline_params(rng, 1, K))
    x = t(rng.normal(size=(16, 1)))
    trqs.rqs_forward(x, w, h, s, -5.0)
    ks, bs, _ = make_stack(rng, [1, 8, 2], 0)
    fused_dense_stack(x, [t(k) for k in ks], [t(b) for b in bs],
                      ["relu", None])
    assert all(v == 0 for v in _build.launch_counts().values())
    assert set(_build.KERNELS) == {"rqs", "dense_stack", "vae_proposal",
                                   "maf_block", "pair_attention", "cell_lj"}
    with pytest.raises(ValueError, match="CUDA"):
        trqs.rqs_cuda(x, w, h, s, -5.0, False)
    with pytest.raises(ValueError, match="CUDA"):
        dense_stack_cuda(x, [t(k) for k in ks], [t(b) for b in bs],
                         ["relu", None])
    from vaemolsim_tpu_torch.ops.maf_fused import maf_block_cuda
    y2 = torch.zeros(4, 2)
    k1, k2 = torch.zeros(2, 3 * 8), torch.zeros(3 * 8, 2 * (3 * K - 1))
    with pytest.raises(ValueError, match="CUDA"):
        maf_block_cuda(y2, [k1, torch.zeros(3 * 8), k2,
                            torch.zeros(2 * (3 * K - 1))], None, 2, K, -5.0,
                       5.0, True)
    from vaemolsim_tpu_torch.ops.attention import pair_attention_cuda
    H = 4
    with pytest.raises(ValueError, match="CUDA"):
        pair_attention_cuda(
            torch.zeros(2, 3, 3), *[torch.zeros(2, 3, H)] * 4,
            torch.ones(2, 3), torch.zeros(4, H), torch.zeros(H),
            torch.zeros(H), torch.zeros(1), torch.zeros(4, H), torch.zeros(H),
            torch.ones(H), torch.zeros(H), torch.zeros(H, 2), torch.zeros(2),
            reduce=False, act="relu")
    from vaemolsim_tpu_torch.ops.cell_lj import cell_pair_energy_force_cuda
    with pytest.raises(ValueError, match="CUDA"):
        cell_pair_energy_force_cuda(
            torch.zeros(27, 3, 2), torch.zeros(27, 3, 54),
            torch.zeros(27, 1, 2, dtype=torch.int32),
            torch.zeros(27, 1, 54, dtype=torch.int32), n_atoms=4, sigma=1.0,
            epsilon=1.0, cutoff=2.5, box=(9.0, 9.0, 9.0))


# ---------------------------------------------------------------------------
# Philox4x32-10 (the proposal kernel's generator)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ctr,key,want", [
    ([0, 0, 0, 0], [0, 0],
     [0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8]),
    ([0xFFFFFFFF] * 4, [0xFFFFFFFF] * 2,
     [0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd]),
    ([0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344],
     [0xa4093822, 0x299f31d0],
     [0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1]),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's known-answer vectors for Philox4x32-10."""
    c = [torch.tensor([v], dtype=torch.int64) for v in ctr]
    k = [torch.tensor(v, dtype=torch.int64) for v in key]
    assert [int(o) for o in philox4x32_10(*c, *k)] == want
