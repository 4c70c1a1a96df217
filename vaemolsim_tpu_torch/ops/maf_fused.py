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
With ``compute_dtype=torch.bfloat16`` (the JAX kernel's bf16 mode) the
conditioner's operands, y or the context, K1, C1, the tanh output, K2
and C2, are each rounded to bfloat16 (round to nearest even) before
their products, which accumulate in float32; the biases, the tanh, the
spline and its log-det stay float32, and so do the outputs.
``params`` is ``(k1, b1, k2, b2)``, or ``(k1, b1, k2, b2, c1, c2)`` with
a context ``(N, C)``; the layout is ``MaskedSplineConditioner
.merged_params()``'s.  The kernel takes the weights as
``merged_params()`` builds them, block-diagonal and MADE-masked for the
input ``degrees`` it is given (the conditioner's input order, a
permutation of 1..D): it reads only the three diagonal blocks of ``k2``
and, of each DOF's columns, only the rows of hidden units of lower
degree (:func:`hidden_degree_starts`), while the plain version
multiplies the whole of it, so the two agree only on such weights.  The
forward pass makes each DOF once, in order of degree.

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

import numpy as np
import torch
import torch.nn.functional as F

from vaemolsim_tpu_torch import _build
from vaemolsim_tpu_torch.ops.rqs import rqs_forward_plain, rqs_inverse_plain

Tensor = torch.Tensor

__all__ = ["maf_block_plain", "maf_block_cuda", "maf_block_inverse_fused",
           "maf_block_forward_fused", "hidden_degrees",
           "hidden_degree_starts", "hidden_order", "MAX_DOFS",
           "COMPUTE_DTYPES", "KERNEL"]

KERNEL = _build.Kernel(
    "maf_block", "csrc/maf_block.cu", "maf_block_launch",
    [ctypes.c_void_p] * 10 + [ctypes.c_longlong] + [ctypes.c_int] * 4
    + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
       ctypes.c_void_p, ctypes.c_void_p],
    replaces="vaemolsim_tpu/ops/maf_fused.py:171")

# csrc/maf_block.cu's kMaxDofs: the per-DOF degrees ride in the launch's
# parameter block.
MAX_DOFS = 64
# The compute dtypes the kernel takes: float32 (None is float32) and its
# bf16 mode.
COMPUTE_DTYPES = (None, torch.float32, torch.bfloat16)


def _bf16(compute_dtype) -> bool:
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"the MAF block takes the compute dtypes "
                         f"{COMPUTE_DTYPES}, got {compute_dtype}")
    return compute_dtype == torch.bfloat16


def hidden_degrees(data_dim: int, hidden: int) -> np.ndarray:
    """Degrees of a one-hidden-layer MADE's hidden units, as
    ``nn.core._made_masks`` assigns them: cycling over 1..D-1 (all 0
    when D = 1)."""
    if data_dim == 1:
        return np.zeros(hidden, np.int64)
    return np.arange(hidden) % (data_dim - 1) + 1


def hidden_degree_starts(data_dim: int, hidden: int) -> Tuple[int, ...]:
    """``start[g]`` for g = 0..D: the number of hidden units of degree
    < g.  With the units sorted by degree, an output of a DOF of degree
    p reads the prefix ``[0, start[p])`` and the units of degree g are
    ``[start[g], start[g + 1])`` (the kernel's layout)."""
    deg = hidden_degrees(data_dim, hidden)
    return tuple(int((deg < g).sum()) for g in range(data_dim + 1))


def hidden_order(data_dim: int, hidden: int) -> np.ndarray:
    """Hidden units sorted by degree, stable: the unit at each sorted
    position, as the kernel computes it (group g holds units g - 1 + m
    (D - 1), or m when D = 1)."""
    return np.argsort(hidden_degrees(data_dim, hidden), kind="stable")


def _degree_args(degrees: Optional[Sequence[int]], D: int):
    if degrees is None:
        raise ValueError("the MAF-block kernel needs the MADE's input "
                         "degrees (the conditioner's input order)")
    deg = [int(d) for d in degrees]
    if sorted(deg) != list(range(1, D + 1)):
        raise ValueError(f"degrees must be a permutation of 1..{D}, got "
                         f"{deg}")
    if D > MAX_DOFS:
        raise ValueError(f"the MAF-block kernel takes at most {MAX_DOFS} "
                         f"DOFs, got {D}")
    return deg


def _span(bin_min: float, bin_max: float, num_bins: int) -> float:
    return bin_max - bin_min - num_bins * 1e-2


def maf_block_plain(y: Tensor, params: Sequence[Tensor],
                    ctx: Optional[Tensor], data_dim: int, num_bins: int,
                    bin_min: float, bin_max: float, inverse: bool,
                    compute_dtype=None) -> Tuple[Tensor, Tensor]:
    """The block in plain PyTorch (the reference and the gradient path).
    In bf16 mode each product's operands are rounded to bfloat16 and
    widened again, so that the float32 matmul sums exact products."""
    k1, b1, k2, b2 = params[:4]
    D, K = data_dim, num_bins
    span = _span(bin_min, bin_max, K)
    if _bf16(compute_dtype):
        def mm(a, b):
            return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()
    else:
        def mm(a, b):
            return a @ b

    def conditioner(t):
        h = mm(t, k1)
        if ctx is not None:
            h = h + mm(ctx, params[4])
        h = torch.tanh(h + b1)
        out = mm(h, k2)
        if ctx is not None:
            out = out + mm(ctx, params[5])
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
                   bin_min: float, bin_max: float, inverse: bool,
                   degrees: Optional[Sequence[int]] = None,
                   compute_dtype=None) -> Tuple[Tensor, Tensor]:
    """Launch ``csrc/maf_block.cu`` on float32 CUDA tensors, for weights
    MADE-masked for the input ``degrees`` (required; see the module
    docstring for the entries of ``k2`` that are not read), in the
    kernel's bf16 mode when ``compute_dtype`` is ``torch.bfloat16``.  A
    block whose 4-row tile does not fit shared memory is refused by the
    kernel's launch, which raises."""
    bf16 = _bf16(compute_dtype)
    if y.dim() != 2 or y.shape[1] != data_dim:
        raise ValueError(f"the MAF-block kernel takes (N, {data_dim}) rows, "
                         f"got {tuple(y.shape)}")
    D, K = data_dim, num_bins
    if K < 2:
        raise ValueError(f"the MAF-block kernel needs num_bins >= 2, got {K}")
    n = y.shape[0]
    y = _build.require(y.contiguous(), "y")
    deg = _degree_args(degrees, D)
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
                  float(_span(bin_min, bin_max, K)), int(inverse),
                  int(bf16), (ctypes.c_int * D)(*deg),
                  (ctypes.c_int * (D + 1))(*hidden_degree_starts(D, H)),
                  mode="bf16" if bf16 else None, outputs=(x, ldj))
    return x, ldj


def _call(kernel_fn: Callable, y: Tensor, params: Sequence[Tensor],
          ctx: Optional[Tensor], data_dim: int, num_bins: int,
          bin_min: float, bin_max: float, inverse: bool,
          degrees: Optional[Sequence[int]] = None, compute_dtype=None):
    """``kernel_fn`` on the block (given ``degrees=`` where it takes
    them), differentiable through the plain version with respect to y,
    every merged parameter and the context."""
    n_par = len(params)
    has_ctx = ctx is not None

    def unpack(fn, **kw):
        def run(*ts):
            return fn(ts[0], ts[1:1 + n_par], ts[1 + n_par] if has_ctx
                      else None, data_dim, num_bins, bin_min, bin_max,
                      inverse, **kw)
        return run

    mode = {} if compute_dtype is None else {"compute_dtype": compute_dtype}
    kw = {} if degrees is None else {"degrees": degrees}
    tensors = [y, *params] + ([ctx] if has_ctx else [])
    return _build.call_with_plain_grad(unpack(kernel_fn, **kw, **mode),
                                       unpack(maf_block_plain, **mode),
                                       *tensors)


def _dispatch(y, params, ctx, data_dim, num_bins, bin_min, bin_max,
              inverse, degrees, compute_dtype):
    if not y.is_cuda:
        return maf_block_plain(y, params, ctx, data_dim, num_bins, bin_min,
                               bin_max, inverse, compute_dtype)
    return _call(maf_block_cuda, y, params, ctx, data_dim, num_bins,
                 bin_min, bin_max, inverse,
                 _degree_args(degrees, data_dim), compute_dtype)


def maf_block_inverse_fused(y: Tensor, params: Sequence[Tensor],
                            ctx: Optional[Tensor], data_dim: int,
                            num_bins: int, bin_min: float, bin_max: float,
                            degrees: Optional[Sequence[int]] = None,
                            compute_dtype=None) -> Tuple[Tensor, Tensor]:
    """The block's inverse (density) pass: (x, ldj summed over DOFs).
    On CUDA the weights must be block-diagonal and MADE-masked for the
    input ``degrees``, which the kernel then needs."""
    return _dispatch(y, params, ctx, data_dim, num_bins, bin_min, bin_max,
                     True, degrees, compute_dtype)


def maf_block_forward_fused(y: Tensor, params: Sequence[Tensor],
                            ctx: Optional[Tensor], data_dim: int,
                            num_bins: int, bin_min: float, bin_max: float,
                            degrees: Optional[Sequence[int]] = None,
                            compute_dtype=None) -> Tuple[Tensor, Tensor]:
    """The block's forward (sampling) pass, the D-pass fixed point:
    (x, ldj summed over DOFs).  On CUDA the weights must be
    block-diagonal and MADE-masked for the input ``degrees``, which the
    kernel then needs."""
    return _dispatch(y, params, ctx, data_dim, num_bins, bin_min, bin_max,
                     False, degrees, compute_dtype)
