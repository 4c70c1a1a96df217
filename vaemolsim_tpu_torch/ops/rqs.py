"""Rational-quadratic spline transform (port of ``vaemolsim_tpu/ops/rqs.py``
and of the TPU kernel ``ops/rqs_pallas.py``).

``bin_widths`` (..., K) and ``bin_heights`` (..., K) are positive and
start at ``range_min``; ``knot_slopes`` (..., K-1) are the interior knot
derivatives, the two boundary derivatives are 1, and outside
``[range_min, range_min + sum(widths)]`` the map is the identity with
log-det 0.  Parameters may carry more leading batch axes than the input;
the output shape is the broadcast of both.

:func:`rqs_forward` / :func:`rqs_inverse` run the plain PyTorch version
on a CPU tensor and the CUDA kernel ``csrc/rqs.cu`` on a CUDA tensor
(float32 only; anything else raises).  The kernel's gradient recomputes
through the plain version.  One broadcast row whose knot table does not
fit a block's shared memory (more than 4469 bins) runs the same kernel's
walk, which has no such limit (:func:`kernel_plan`).  The circular
splines stay plain PyTorch, as
on the TPU, where the kernel had no circular branch either.

Under ``torch.func.vmap`` (a member axis: ``fit_ensemble``'s K flows,
each with its own spline parameters) a CUDA call launches once for all
members (:func:`rqs_members_cuda`).  Which route takes which case, from
one member's shapes: one broadcast row a member (example 09's 1-D
RealNVP) takes the table regime with the members on the grid's second
axis, each block building its member's knot table; anything else (a row
per element, a row per trailing block, or a broadcast row too wide for
a table) takes the walk, with the members folded into the elements and
their rows (member m's element i reads its row m * P + i % P).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from vaemolsim_tpu_torch import _build
from vaemolsim_tpu_torch.ops.bijectors import Bijector

Tensor = torch.Tensor

__all__ = ["rqs_forward", "rqs_inverse", "rqs_forward_plain",
           "rqs_inverse_plain", "rqs_cuda", "rqs_members_cuda",
           "kernel_plan", "table_floats",
           "rqs_forward_circular", "rqs_inverse_circular",
           "RationalQuadraticSpline", "KERNEL"]

KERNEL = _build.Kernel(
    "rqs", "csrc/rqs.cu", "rqs_members_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
                             ctypes.c_int, ctypes.c_longlong,
                             ctypes.c_longlong, ctypes.c_int],
    replaces="vaemolsim_tpu/ops/rqs_pallas.py:52")

# The H100's SMs and the most dynamic shared memory a block may take.
SMS, MAX_SMEM = 132, 232448


def table_floats(K: int) -> int:
    """Floats of one knot table (``csrc/rqs.cuh`` ``rqs_table_floats``):
    x- and y-knots, K + 1 each rounded up to a multiple of 4, and an
    8-float record per bin."""
    return 2 * ((K + 4) & ~3) + 8 * K


def kernel_plan(n: int, K: int, p_rows: int,
                threads: int | None = None, members: int = 1) -> dict:
    """How ``csrc/rqs.cu`` runs a call, decided here and only validated
    by the kernel's launch: a thread an element.  One broadcast row
    (``p_rows == 1``) whose knot table fits a block's shared memory (K up
    to 4469): the ``"table"`` regime, ``threads`` a block a multiple of
    32, at least K + 1 (each knot of the table one thread's sum) and at
    least 128, at most 256 (128 and 256 were the fastest at 10k and 50k
    elements, chip_turns.py's sweep), and the shared bytes of the row's
    knot table and the row itself.  A given ``threads`` is taken as it
    is, to measure one plan at a shape.  Otherwise (a row per element,
    or a broadcast row of more bins) the ``"walk"``: 256 threads a
    block, no shared memory, each thread walking its element's row.
    ``members`` M: ``n`` and ``p_rows`` are one member's; the table
    regime's blocks cover one member (the grid's second axis the
    members), the walk's all M n elements."""
    smem = 4 * (table_floats(K) + 3 * K)
    if p_rows == 1 and smem <= MAX_SMEM:
        if threads is None:
            threads = min(256, max(128, 32 * -(-(K + 1) // 32)))
        return dict(regime="table", threads=threads,
                    blocks=-(-n // threads), smem=smem)
    return dict(regime="walk", threads=256, blocks=-(-(members * n) // 256),
                smem=0)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _running_sum(p: Tensor) -> Tensor:
    """Inclusive prefix sum added strictly left to right: the rounding of
    XLA's cumsum on the CPU and of the CUDA kernel's running sum
    (torch.cumsum associates differently, which a steep bin amplifies
    into visible knot shifts)."""
    sums = [p[..., 0]]
    for k in range(1, p.shape[-1]):
        sums.append(sums[-1] + p[..., k])
    return torch.stack(sums, -1)


def _knots(widths: Tensor, heights: Tensor, range_min: float):
    """Knot positions with a leading range_min knot: (..., K+1)."""
    zero = torch.zeros_like(widths[..., :1])
    x_knots = range_min + torch.cat([zero, _running_sum(widths)], -1)
    y_knots = range_min + torch.cat([zero, _running_sum(heights)], -1)
    return x_knots, y_knots


def _pad_slopes(slopes: Tensor) -> Tensor:
    ones = torch.ones_like(slopes[..., :1])
    return torch.cat([ones, slopes, ones], -1)


def _bin_params(t: Tensor, knots_in: Tensor, x_knots, y_knots, widths,
                heights, d):
    """Clamped input and the containing bin's (xk, yk, wk, hk, dk, dk1)."""
    batch = torch.broadcast_shapes(t.shape, knots_in.shape[:-1])
    total = knots_in[..., -1]
    t = t.expand(batch)
    t_safe = torch.minimum(torch.maximum(t, knots_in[..., 0]), total)
    K = widths.shape[-1]
    idx = (t_safe[..., None] >= knots_in[..., 1:-1]).sum(-1)
    idx = idx.clamp(0, K - 1)[..., None]

    def gather(p, offset=0):
        return torch.gather(p.expand(batch + p.shape[-1:]), -1,
                            idx + offset)[..., 0]

    inside = (t >= knots_in[..., 0]) & (t <= total)
    return (t, t_safe, inside, gather(x_knots), gather(y_knots),
            gather(widths), gather(heights), gather(d), gather(d, 1))


def _deriv(s, dk, dk1, xi, den):
    xi1m = 1.0 - xi
    return (s * s) * (dk1 * xi * xi + 2.0 * s * xi * xi1m
                      + dk * xi1m * xi1m) / (den * den)


def rqs_forward_plain(x: Tensor, widths: Tensor, heights: Tensor,
                      slopes: Tensor, range_min: float
                      ) -> Tuple[Tensor, Tensor]:
    """Forward spline in plain PyTorch: (y, elementwise log|dy/dx|)."""
    x_knots, y_knots = _knots(widths, heights, range_min)
    x, x_safe, inside, xk, yk, wk, hk, dk, dk1 = _bin_params(
        x, x_knots, x_knots, y_knots, widths, heights, _pad_slopes(slopes))
    s = hk / wk
    xi = (x_safe - xk) / wk
    xi1m = 1.0 - xi
    num = hk * (s * xi * xi + dk * xi * xi1m)
    den = s + (dk1 + dk - 2.0 * s) * xi * xi1m
    y = yk + num / den
    ldj = torch.log(_deriv(s, dk, dk1, xi, den))
    return (torch.where(inside, y, x),
            torch.where(inside, ldj, torch.zeros_like(ldj)))


def rqs_inverse_plain(y: Tensor, widths: Tensor, heights: Tensor,
                      slopes: Tensor, range_min: float
                      ) -> Tuple[Tensor, Tensor]:
    """Inverse spline in plain PyTorch: (x, elementwise log|dx/dy|)."""
    x_knots, y_knots = _knots(widths, heights, range_min)
    y, y_safe, inside, xk, yk, wk, hk, dk, dk1 = _bin_params(
        y, y_knots, x_knots, y_knots, widths, heights, _pad_slopes(slopes))
    s = hk / wk
    t = y_safe - yk
    dsum = dk1 + dk - 2.0 * s
    a = hk * (s - dk) + t * dsum
    b = hk * dk - t * dsum
    c = -s * t
    # Stable quadratic root in [0, 1]: xi = 2c / (-b - sqrt(b^2 - 4ac)).
    disc = torch.clamp_min(b * b - 4.0 * a * c, 0.0)
    xi = torch.clamp((2.0 * c) / (-b - torch.sqrt(disc)), 0.0, 1.0)
    x = xk + xi * wk
    den = s + dsum * xi * (1.0 - xi)
    ldj = -torch.log(_deriv(s, dk, dk1, xi, den))
    return (torch.where(inside, x, y),
            torch.where(inside, ldj, torch.zeros_like(ldj)))


# ---------------------------------------------------------------------------
# Kernel wrapper and dispatch
# ---------------------------------------------------------------------------


def _param_rows(p: Tensor, out_batch: torch.Size, width: int,
                members: int = 0) -> Tensor:
    """(P, width) parameter rows such that element i of the flattened
    output uses row i % P: P = 1 for one shared row, P = the size of
    the parameters' batch when it is a trailing block of the output's
    batch; otherwise the rows are expanded to the full output.  With
    ``members`` M, ``p`` has a leading member axis and ``out_batch`` is
    one member's: (M P, width), member m's rows after member m-1's."""
    m = (members,) if members else ()
    pb = list(p.shape[len(m):-1])
    while pb and pb[0] == 1:
        pb.pop(0)
    if pb == list(out_batch[len(out_batch) - len(pb):]):
        return p.reshape(-1, width).contiguous()
    return _lift(p, members, len(out_batch) + 1).expand(
        m + tuple(out_batch) + (width,)).reshape(-1, width).contiguous()


def _lift(t: Tensor, members: int, ndim: int) -> Tensor:
    """``t`` with singleton axes after its member axis (if any) up to
    ``ndim`` axes a member, so that it broadcasts member by member."""
    if not members:
        return t
    return t.reshape((members,) + (1,) * (ndim + 1 - t.dim()) + t.shape[1:])


def rqs_cuda(x: Tensor, widths: Tensor, heights: Tensor, slopes: Tensor,
             range_min: float, inverse: bool) -> Tuple[Tensor, Tensor]:
    """Launch ``csrc/rqs.cu``: (out, ldj) with the broadcast shape of x
    and the parameters' batch axes."""
    return _launch(x, widths, heights, slopes, range_min, inverse, 0)


def rqs_members_cuda(x: Tensor, widths: Tensor, heights: Tensor,
                     slopes: Tensor, range_min: float, inverse: bool
                     ) -> Tuple[Tensor, Tensor]:
    """M splines of one shape in one launch of ``csrc/rqs.cu`` (the
    kernel's member axis): every tensor has a leading member axis and
    member m's x goes through member m's parameters, broadcast as
    :func:`rqs_cuda` broadcasts one member's.  Counted as the kernel's
    ``"members"`` mode."""
    return _launch(x, widths, heights, slopes, range_min, inverse,
                   x.shape[0])


def _launch(x, widths, heights, slopes, range_min, inverse,
            members: int) -> Tuple[Tensor, Tensor]:
    """The launch behind both wrappers (the kernel's one entry, which
    takes a member count); ``members`` 0 for one spline without a member
    axis, launched as one member."""
    K = widths.shape[-1]
    if heights.shape[-1] != K or slopes.shape[-1] != K - 1:
        raise ValueError(f"expected (..., K), (..., K), (..., K-1) "
                         f"parameters, got {tuple(widths.shape)}, "
                         f"{tuple(heights.shape)}, {tuple(slopes.shape)}")
    m = (members,) if members else ()
    M = max(members, 1)
    k = len(m)
    batch = torch.broadcast_shapes(x.shape[k:], widths.shape[k:-1],
                                   heights.shape[k:-1], slopes.shape[k:-1])
    xf = _build.require(_lift(x, members, len(batch)).expand(
        m + batch).contiguous().reshape(-1), "x")
    w = _build.require(_param_rows(widths, batch, K, members), "bin_widths")
    rows = w.shape[0] // M
    h = _build.require(_param_rows(heights, batch, K, members),
                       "bin_heights", (M * rows, K))
    s = _build.require(_param_rows(slopes, batch, K - 1, members),
                       "knot_slopes", (M * rows, K - 1))
    n = xf.numel() // M
    plan = (kernel_plan(n, K, rows, members=M) if members
            else kernel_plan(n, K, rows))
    out = torch.empty_like(xf)
    ldj = torch.empty_like(xf)
    KERNEL.launch(x.device, xf.data_ptr(), w.data_ptr(), h.data_ptr(),
                  s.data_ptr(), out.data_ptr(), ldj.data_ptr(), n,
                  K, rows, float(range_min), int(inverse), plan["threads"],
                  plan["blocks"], plan["smem"], M,
                  mode="members" if members else None, outputs=(out, ldj))
    return out.reshape(m + batch), ldj.reshape(m + batch)


def _dispatch(x, widths, heights, slopes, range_min, inverse):
    plain = rqs_inverse_plain if inverse else rqs_forward_plain
    if not x.is_cuda:
        return plain(x, widths, heights, slopes, range_min)
    return _build.call_with_plain_grad(
        lambda *a: rqs_cuda(*a, range_min, inverse),
        lambda *a: plain(*a, range_min), x, widths, heights, slopes,
        member_fn=lambda *a: rqs_members_cuda(*a, range_min, inverse))


def rqs_forward(x: Tensor, widths: Tensor, heights: Tensor, slopes: Tensor,
                range_min: float) -> Tuple[Tensor, Tensor]:
    """Forward spline: (y, elementwise log|dy/dx|)."""
    return _dispatch(x, widths, heights, slopes, range_min, False)


def rqs_inverse(y: Tensor, widths: Tensor, heights: Tensor, slopes: Tensor,
                range_min: float) -> Tuple[Tensor, Tensor]:
    """Inverse spline: (x, elementwise log|dx/dy|)."""
    return _dispatch(y, widths, heights, slopes, range_min, True)


# ---------------------------------------------------------------------------
# Circular spline (plain PyTorch)
# ---------------------------------------------------------------------------


def _rqs_circular(t: Tensor, widths: Tensor, heights: Tensor,
                  slopes: Tensor, range_min: float, inverse: bool):
    """Circle diffeomorphism lifted to the line (Rezende et al. 2020):
    ``slopes`` has K entries with d_K = d_0, inputs wrap into the base
    period and the winding is added back."""
    x_knots, y_knots = _knots(widths, heights, range_min)
    d = torch.cat([slopes, slopes[..., :1]], -1)
    period = x_knots[..., -1] - range_min
    t_wrap = range_min + torch.remainder(t - range_min, period)
    winding = t - t_wrap
    knots_in = y_knots if inverse else x_knots
    _, t_w, _, xk, yk, wk, hk, dk, dk1 = _bin_params(
        t_wrap, knots_in, x_knots, y_knots, widths, heights, d)
    s = hk / wk
    if not inverse:
        xi = (t_w - xk) / wk
        xi1m = 1.0 - xi
        den = s + (dk1 + dk - 2.0 * s) * xi * xi1m
        out = yk + hk * (s * xi * xi + dk * xi * xi1m) / den
    else:
        tt = t_w - yk
        dsum = dk1 + dk - 2.0 * s
        a = hk * (s - dk) + tt * dsum
        b = hk * dk - tt * dsum
        c = -s * tt
        disc = torch.clamp_min(b * b - 4.0 * a * c, 0.0)
        xi = torch.clamp((2.0 * c) / (-b - torch.sqrt(disc)), 0.0, 1.0)
        den = s + dsum * xi * (1.0 - xi)
        out = xk + xi * wk
    ldj = torch.log(_deriv(s, dk, dk1, xi, den))
    return out + winding, (-ldj if inverse else ldj)


def rqs_forward_circular(x, widths, heights, slopes, range_min):
    return _rqs_circular(x, widths, heights, slopes, range_min, False)


def rqs_inverse_circular(y, widths, heights, slopes, range_min):
    return _rqs_circular(y, widths, heights, slopes, range_min, True)


class RationalQuadraticSpline(Bijector):
    """Scalar-acting RQS bijector; parameters may carry leading batch
    axes.  ``circular=True`` selects the circle variant (``knot_slopes``
    then has K entries)."""

    def __init__(self, bin_widths: Tensor, bin_heights: Tensor,
                 knot_slopes: Tensor, range_min: float = -1.0,
                 circular: bool = False):
        self.bin_widths = bin_widths
        self.bin_heights = bin_heights
        self.knot_slopes = knot_slopes
        self.range_min = range_min
        self.circular = circular

    def _params(self):
        return (self.bin_widths, self.bin_heights, self.knot_slopes,
                self.range_min)

    def forward_and_log_det(self, x, context=None):
        if self.circular:
            return rqs_forward_circular(x, *self._params())
        return rqs_forward(x, *self._params())

    def inverse_and_log_det(self, y, context=None):
        if self.circular:
            return rqs_inverse_circular(y, *self._params())
        return rqs_inverse(y, *self._params())
