"""The port's CUDA kernels against their plain versions, on a GPU.

Marked ``cuda``; without a card every test skips.  This file imports no
JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX).  chip_smoke.py
runs the same comparisons at the flagship's full shapes.
"""

import pytest
import torch

from vaemolsim_tpu_torch import _build
from vaemolsim_tpu_torch.flows.spline_flows import _bin_positions, _slopes
from vaemolsim_tpu_torch.mcmc import fused as mf
from vaemolsim_tpu_torch.ops import rqs
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


def _proposal_model(gen, dev, H=64, K=16, B=2):
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

    (ew1, eb1), (ew2, eb2) = dense(2, H), dense(H, 2)
    (dw1, db1), (dw2, db2) = dense(1, H), dense(H, 4)
    return ((ew1, eb1, ew2, eb2), (dw1, db1, dw2, db2),
            _spline(gen, dev, B, K, spread=0.5),
            torch.tensor([0.0, 1.0], device=dev),
            mf._Spec(2, 1, "relu", "tanh", K, -5.0))


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


def test_kernels_refuse_what_they_do_not_take(dev):
    """A CUDA tensor outside a kernel's contract raises; it never falls
    back to the plain version."""
    gen = torch.Generator(device=dev).manual_seed(4)
    params = _spline(gen, dev, 1, 8)
    with pytest.raises(TypeError):
        rqs.rqs_forward(torch.zeros(4, device=dev, dtype=torch.float64),
                        *params, -5.0)
    wide = [torch.zeros(1, 30000, device=dev), torch.zeros(30000, 1,
                                                           device=dev)]
    with pytest.raises(ValueError, match="shared memory"):
        fused_dense_stack(torch.zeros(4, 1, device=dev), wide,
                          [torch.zeros(30000, device=dev),
                           torch.zeros(1, device=dev)], ["relu", None])
    assert set(_build.launch_counts()) == {"rqs", "dense_stack",
                                           "vae_proposal"}
