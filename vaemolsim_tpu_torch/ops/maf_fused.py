"""One masked-autoregressive RQS block in one kernel (port of
``vaemolsim_tpu/ops/maf_fused.py`` and of its TPU kernel ``_maf_kernel``).

For one MAF block on ``(N, D)`` rows the merged three-net MADE

    h   = tanh(y @ K1 [+ ctx @ C1] + b1)      # K1 (D, 3H)
    out = h @ K2 [+ ctx @ C2] + b2            # K2 (3H, D*(3K-1)), block-diagonal

gives per DOF K widths, K heights and K-1 knot slopes (columns
``[D*K widths | D*K heights | D*(K-1) slopes]``, each row-major over
(dof, param)); widths and heights are ``softmax * span + 1e-2`` with
``span = bin_max - bin_min - K*1e-2``, slopes ``softplus + 1e-2``; then
the RQS of each DOF, identity outside the bins.  The inverse (density)
is one pass; the forward (sampling) is the D-pass fixed point.  Both
return ``(x (N, D), ldj (N,))`` with the log-det summed over DOFs.
``params`` is ``(k1, b1, k2, b2)``, or ``(k1, b1, k2, b2, c1, c2)`` with
a context ``(N, C)``; the layout is ``MaskedSplineConditioner
.merged_params()``'s.  ``k2`` must be block-diagonal, as
``merged_params()`` builds it: the kernel reads only its three diagonal
blocks (rows ``[iH, (i+1)H)`` of head i's columns), while the plain
version multiplies the whole of it, so the two agree only on such a
``k2``.

:func:`maf_block_plain` is the plain version, on the port's plain RQS
(knots summed left to right).  :func:`maf_block_cuda` launches
``csrc/maf_block.cu`` on float32 CUDA tensors.  The entries
:func:`maf_block_inverse_fused` / :func:`maf_block_forward_fused` run the
plain version on a CPU tensor; on a CUDA tensor they launch the kernel
(or raise), differentiable by recomputing through the plain version, as
the JAX ``custom_vjp`` recomputes through XLA.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from vaemolsim_tpu_torch import _build
from vaemolsim_tpu_torch.ops.rqs import rqs_forward_plain, rqs_inverse_plain

Tensor = torch.Tensor

__all__ = ["maf_block_plain", "maf_block_cuda", "maf_block_inverse_fused",
           "maf_block_forward_fused", "KERNEL"]

KERNEL = _build.Kernel(
    "maf_block", "csrc/maf_block.cu", "maf_block_launch",
    [ctypes.c_void_p] * 10 + [ctypes.c_longlong] + [ctypes.c_int] * 4
    + [ctypes.c_float, ctypes.c_float, ctypes.c_int],
    replaces="vaemolsim_tpu/ops/maf_fused.py:171")


def _span(bin_min: float, bin_max: float, num_bins: int) -> float:
    return bin_max - bin_min - num_bins * 1e-2


def maf_block_plain(y: Tensor, params: Sequence[Tensor],
                    ctx: Optional[Tensor], data_dim: int, num_bins: int,
                    bin_min: float, bin_max: float, inverse: bool
                    ) -> Tuple[Tensor, Tensor]:
    """The block in plain PyTorch (the reference and the gradient path)."""
    k1, b1, k2, b2 = params[:4]
    D, K = data_dim, num_bins
    span = _span(bin_min, bin_max, K)

    def conditioner(t):
        h = t @ k1
        if ctx is not None:
            h = h + ctx @ params[4]
        h = torch.tanh(h + b1)
        out = h @ k2
        if ctx is not None:
            out = out + ctx @ params[5]
        out = out + b2
        lead = out.shape[:-1]
        raw_w = out[..., :D * K].reshape(lead + (D, K))
        raw_h = out[..., D * K:2 * D * K].reshape(lead + (D, K))
        raw_s = out[..., 2 * D * K:].reshape(lead + (D, K - 1))
        return (torch.softmax(raw_w, -1) * span + 1e-2,
                torch.softmax(raw_h, -1) * span + 1e-2,
                F.softplus(raw_s) + 1e-2)

    if inverse:
        x, ldj = rqs_inverse_plain(y, *conditioner(y), bin_min)
        return x, ldj.sum(-1)
    cur = y
    for _ in range(D - 1):
        cur = rqs_forward_plain(y, *conditioner(cur), bin_min)[0]
    x, ldj = rqs_forward_plain(y, *conditioner(cur), bin_min)
    return x, ldj.sum(-1)


def maf_block_cuda(y: Tensor, params: Sequence[Tensor],
                   ctx: Optional[Tensor], data_dim: int, num_bins: int,
                   bin_min: float, bin_max: float, inverse: bool
                   ) -> Tuple[Tensor, Tensor]:
    """Launch ``csrc/maf_block.cu`` on float32 CUDA tensors.  ``k2``'s
    entries off its three diagonal blocks are not read (see the module
    docstring).  A block whose 4-row tile does not fit shared memory is
    refused by the kernel's launch, which raises."""
    if y.dim() != 2 or y.shape[1] != data_dim:
        raise ValueError(f"the MAF-block kernel takes (N, {data_dim}) rows, "
                         f"got {tuple(y.shape)}")
    D, K = data_dim, num_bins
    if K < 2:
        raise ValueError(f"the MAF-block kernel needs num_bins >= 2, got {K}")
    n = y.shape[0]
    y = _build.require(y.contiguous(), "y")
    k1 = _build.require(params[0], "k1")
    if k1.shape[0] != D or k1.shape[1] % 3:
        raise ValueError(f"k1: expected shape ({D}, 3H), got "
                         f"{tuple(k1.shape)}")
    H = k1.shape[1] // 3
    P = D * (3 * K - 1)
    b1 = _build.require(params[1], "b1", (3 * H,))
    k2 = _build.require(params[2], "k2", (3 * H, P))
    b2 = _build.require(params[3], "b2", (P,))
    C = 0
    c1 = c2 = None
    if ctx is not None:
        if ctx.dim() != 2:
            raise ValueError(f"ctx: expected (N, C), got {tuple(ctx.shape)}")
        C = ctx.shape[1]
        ctx = _build.require(ctx.contiguous(), "ctx", (n, C))
        c1 = _build.require(params[4], "c1", (C, 3 * H))
        c2 = _build.require(params[5], "c2", (C, P))
    x = torch.empty_like(y)
    ldj = torch.empty(n, dtype=y.dtype, device=y.device)
    KERNEL.launch(y.device, y.data_ptr(), _build.ptr(ctx), k1.data_ptr(),
                  b1.data_ptr(), k2.data_ptr(), b2.data_ptr(),
                  _build.ptr(c1), _build.ptr(c2), x.data_ptr(),
                  ldj.data_ptr(), n, D, H, K, C, float(bin_min),
                  float(_span(bin_min, bin_max, K)), int(inverse))
    return x, ldj


def _call(kernel_fn: Callable, y: Tensor, params: Sequence[Tensor],
          ctx: Optional[Tensor], data_dim: int, num_bins: int,
          bin_min: float, bin_max: float, inverse: bool):
    """``kernel_fn`` on the block, differentiable through the plain
    version with respect to y, every merged parameter and the context."""
    n_par = len(params)
    has_ctx = ctx is not None

    def unpack(fn):
        def run(*ts):
            return fn(ts[0], ts[1:1 + n_par], ts[1 + n_par] if has_ctx
                      else None, data_dim, num_bins, bin_min, bin_max,
                      inverse)
        return run

    tensors = [y, *params] + ([ctx] if has_ctx else [])
    return _build.call_with_plain_grad(unpack(kernel_fn),
                                       unpack(maf_block_plain), *tensors)


def _dispatch(y, params, ctx, data_dim, num_bins, bin_min, bin_max,
              inverse):
    if not y.is_cuda:
        return maf_block_plain(y, params, ctx, data_dim, num_bins, bin_min,
                               bin_max, inverse)
    return _call(maf_block_cuda, y, params, ctx, data_dim, num_bins,
                 bin_min, bin_max, inverse)


def maf_block_inverse_fused(y: Tensor, params: Sequence[Tensor],
                            ctx: Optional[Tensor], data_dim: int,
                            num_bins: int, bin_min: float, bin_max: float
                            ) -> Tuple[Tensor, Tensor]:
    """The block's inverse (density) pass: (x, ldj summed over DOFs).
    ``params[2]`` (k2) must be block-diagonal over the three heads."""
    return _dispatch(y, params, ctx, data_dim, num_bins, bin_min, bin_max,
                     True)


def maf_block_forward_fused(y: Tensor, params: Sequence[Tensor],
                            ctx: Optional[Tensor], data_dim: int,
                            num_bins: int, bin_min: float, bin_max: float
                            ) -> Tuple[Tensor, Tensor]:
    """The block's forward (sampling) pass, the D-pass fixed point:
    (x, ldj summed over DOFs).  ``params[2]`` (k2) must be block-diagonal
    over the three heads."""
    return _dispatch(y, params, ctx, data_dim, num_bins, bin_min, bin_max,
                     False)
