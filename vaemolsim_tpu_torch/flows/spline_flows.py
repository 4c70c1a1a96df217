"""Rational-quadratic-spline flows, coupling and masked-autoregressive
(port of ``vaemolsim_tpu/flows/spline_flows.py``).

Flows are ``nn.Module``s that act as bijectors and are polymorphic like
the JAX ones: called on a tensor they transform it, called on a
distribution they return a ``TransformedDistribution``.  Spline bin
positions are ``softmax(raw) * (bin_max - bin_min - K*1e-2) + 1e-2`` and
knot slopes ``softplus(raw) + 1e-2``.

Ported: SplineConditioner, CouplingLayer and RQSSplineRealNVP (the
reference's own flow family), MaskedSplineConditioner, MAFLayer and
RQSSplineMAF.  With ``batch_norm=True`` a ``BatchNormBijector`` sits
between consecutive blocks (``bn_params``), in batch-moment mode when the
flow is called with ``train=True``; ``update_batch_stats`` takes one EMA
step of their running moments from a batch, in place.

A coupling block evaluates its conditioner (1 or 2 layers) through the
dense-stack kernel and its spline through the RQS kernel on CUDA.  The
1-D RealNVP conditions on nothing: its conditioner sees a constant ones
row, so it runs on ONE row and the spline broadcasts it over the batch
(the dense stack's small-N regime, the RQS kernel's broadcast row).

MAFLayer runs a whole block through the MAF-block kernel
(``ops/maf_fused.py``, ``csrc/maf_block.cu``) on every CUDA input that
the kernel supports: a mergeable conditioner whose three nets share one
hidden width, a spline that is not circular, a 2-D input (and context),
the float32 or the bfloat16 compute dtype (the kernel's bf16 mode
rounds the conditioner's operands to bfloat16 and accumulates in
float32, as the merged conditioner does under
``set_compute_dtype(torch.bfloat16)``), at most ``maf_fused.MAX_DOFS``
DOFs (the kernel is given the conditioner's input degrees), and not the
1-D unconditional block, which keeps its constant-spline shortcut (one
conditioner row for the whole batch).  Every other block, and every CPU input, takes the unfused route
(conditioner through the dense-stack kernel, then the RQS kernel).
There is no switch: the JAX package's ``set_maf_fused`` /
``maf_fused_enabled`` chose a backend for the TPU, where its own study
measured the fused kernel slower than XLA; here the kernel is the route
whenever it applies.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from vaemolsim_tpu_torch.config import default_device
from vaemolsim_tpu_torch.nn.core import MADE, Dense
from vaemolsim_tpu_torch.ops import bijectors as bj
from vaemolsim_tpu_torch.ops import distributions as dist_lib
from vaemolsim_tpu_torch.ops.rqs import RationalQuadraticSpline

Tensor = torch.Tensor

__all__ = ["SplineConditioner", "CouplingLayer", "RQSSplineRealNVP",
           "MaskedSplineConditioner", "MAFLayer", "RQSSplineMAF"]


def _bin_positions(raw: Tensor, bin_min: float, bin_max: float,
                   num_bins: int) -> Tensor:
    return (torch.softmax(raw, -1) * (bin_max - bin_min - num_bins * 1e-2)
            + 1e-2)


def _slopes(raw: Tensor) -> Tensor:
    return F.softplus(raw) + 1e-2


class SplineConditioner(nn.Module):
    """Coupling-flow conditioner: Dense(tanh) trunk and three linear heads
    giving RQS parameters for ``data_dim`` outputs, evaluated as one
    fused two-layer stack.  A zero-width input is replaced by ones."""

    def __init__(self, trunk: Dense, w_head: Dense, h_head: Dense,
                 s_head: Dense, data_dim: int, bin_min: float = -10.0,
                 bin_max: float = 10.0, num_bins: int = 32,
                 circular: bool = False):
        super().__init__()
        self.trunk, self.w_head, self.h_head, self.s_head = (
            trunk, w_head, h_head, s_head)
        self.data_dim = data_dim
        self.bin_min, self.bin_max = float(bin_min), float(bin_max)
        self.num_bins = num_bins
        self.circular = circular

    @classmethod
    def create(cls, generator, in_dim: int, data_dim: int,
               bin_range: Sequence[float] = (-10.0, 10.0),
               num_bins: int = 32, hidden_dim: int = 200,
               circular: bool = False, kernel_initializer="truncated_normal",
               device=None) -> "SplineConditioner":
        device = default_device(device)
        n_slopes = num_bins if circular else num_bins - 1

        def dense(i, o, act=None):
            return Dense.create(generator, i, o, act, kernel_initializer,
                                device)

        return cls(dense(max(in_dim, 1), hidden_dim, "tanh"),
                   dense(hidden_dim, data_dim * num_bins),
                   dense(hidden_dim, data_dim * num_bins),
                   dense(hidden_dim, data_dim * n_slopes),
                   data_dim, bin_range[0], bin_range[1], num_bins, circular)

    def forward(self, x: Tensor) -> RationalQuadraticSpline:
        from vaemolsim_tpu_torch.ops.fused_mlp import fused_dense_stack
        if x.shape[-1] == 0:
            x = torch.ones(x.shape[:-1] + (1,), dtype=x.dtype,
                           device=x.device)
        heads = (self.w_head, self.h_head, self.s_head)
        out = fused_dense_stack(
            x, [self.trunk.kernel, torch.cat([h.kernel for h in heads], -1)],
            [self.trunk.bias, torch.cat([h.bias for h in heads], -1)],
            [self.trunk.activation, None])
        D, K = self.data_dim, self.num_bins
        n_slopes = K if self.circular else K - 1
        lead = out.shape[:-1]
        w = _bin_positions(out[..., :D * K].reshape(lead + (D, K)),
                           self.bin_min, self.bin_max, K)
        h = _bin_positions(out[..., D * K:2 * D * K].reshape(lead + (D, K)),
                           self.bin_min, self.bin_max, K)
        s = _slopes(out[..., 2 * D * K:].reshape(lead + (D, n_slopes)))
        return RationalQuadraticSpline(w, h, s, range_min=self.bin_min,
                                       circular=self.circular)


class CouplingLayer(bj.Bijector, nn.Module):
    """RealNVP coupling: ``num_masked`` DOFs pass through and condition an
    RQS transform of the rest.  A negative ``num_masked`` masks the
    *last* |num_masked| DOFs instead."""

    def __init__(self, conditioner: SplineConditioner, num_masked: int):
        nn.Module.__init__(self)
        self.conditioner = conditioner
        self.num_masked = num_masked

    def _split(self, x: Tensor):
        n = self.num_masked
        if n >= 0:
            return x[..., :n], x[..., n:], False
        return x[..., n:], x[..., :n], True

    @staticmethod
    def _join(cond_part: Tensor, moved: Tensor, flipped: bool) -> Tensor:
        if flipped:
            return torch.cat([moved, cond_part], -1)
        return torch.cat([cond_part, moved], -1)

    def _spline(self, cond_part: Tensor) -> RationalQuadraticSpline:
        if cond_part.shape[-1] == 0:
            # A zero-width conditioner sees a constant ones row: evaluate
            # ONE row and let the spline broadcast it.
            return self.conditioner(cond_part.new_zeros((1, 0)))
        return self.conditioner(cond_part)

    def _couple(self, t: Tensor, inverse: bool):
        cond_part, rest, flipped = self._split(t)
        spline = self._spline(cond_part)
        out, ldj = (spline.inverse_and_log_det(rest) if inverse
                    else spline.forward_and_log_det(rest))
        return self._join(cond_part, out, flipped), ldj.sum(-1)

    def forward_and_log_det(self, x, context=None):
        return self._couple(x, inverse=False)

    def inverse_and_log_det(self, y, context=None):
        return self._couple(y, inverse=True)


class MaskedSplineConditioner(nn.Module):
    """MAF conditioner: three MADEs (widths, heights, slopes) sharing an
    input order, with an optional conditional input.  The standard
    single-hidden-layer tanh nets evaluate merged, as one block-diagonal
    net (2 matmuls instead of 6)."""

    def __init__(self, w_net: MADE, h_net: MADE, s_net: MADE,
                 bin_min: float = -10.0, bin_max: float = 10.0,
                 num_bins: int = 32, circular: bool = False):
        super().__init__()
        self.w_net, self.h_net, self.s_net = w_net, h_net, s_net
        self.bin_min, self.bin_max = float(bin_min), float(bin_max)
        self.num_bins = num_bins
        self.circular = circular

    @classmethod
    def create(cls, generator, data_dim: int,
               bin_range: Sequence[float] = (-10.0, 10.0),
               num_bins: int = 32, hidden_dim: int = 200,
               conditional: bool = False,
               conditional_event_shape: Optional[int] = None,
               input_order="left-to-right", circular: bool = False,
               kernel_initializer="truncated_normal", device=None
               ) -> "MaskedSplineConditioner":
        device = default_device(device)
        common = dict(hidden_units=[hidden_dim], input_order=input_order,
                      conditional=conditional,
                      conditional_event_size=conditional_event_shape,
                      activation="tanh",
                      kernel_initializer=kernel_initializer, device=device)
        n_slopes = num_bins if circular else num_bins - 1
        return cls(MADE.create(generator, data_dim, num_bins, **common),
                   MADE.create(generator, data_dim, num_bins, **common),
                   MADE.create(generator, data_dim, n_slopes, **common),
                   bin_range[0], bin_range[1], num_bins, circular)

    @property
    def nets(self) -> Tuple[MADE, MADE, MADE]:
        return (self.w_net, self.h_net, self.s_net)

    @property
    def conditional(self) -> bool:
        return self.w_net.conditional

    @property
    def mergeable(self) -> bool:
        return all(len(n.kernels) == 2 and n.activation == "tanh"
                   for n in self.nets)

    def merged_params(self) -> Tuple[Optional[Tensor], ...]:
        """(k1, b1, k2, b2, c1, c2): first-layer masked kernels side by
        side, second layers block-diagonal, conditional kernels
        concatenated (None without a conditional input)."""
        nets = self.nets
        k1 = torch.cat([n.kernels[0] * n.masks[0] for n in nets], 1)
        b1 = torch.cat([n.biases[0] for n in nets])
        k2 = torch.block_diag(*[n.kernels[1] * n.masks[1] for n in nets])
        b2 = torch.cat([n.biases[1] for n in nets])
        if self.conditional:
            c1 = torch.cat([n.cond_kernels[0] for n in nets], 1)
            c2 = torch.cat([n.cond_kernels[1] for n in nets], 1)
        else:
            c1 = c2 = None
        return k1, b1, k2, b2, c1, c2

    def _check_conditional(self, conditional_input):
        if self.conditional and conditional_input is None:
            raise ValueError("This conditioner is conditional; "
                             "conditional_input is required.")
        if not self.conditional and conditional_input is not None:
            raise ValueError("conditional_input passed to a non-conditional "
                             "conditioner; build with conditional=True.")

    def _merged_raw(self, x: Tensor, conditional_input: Optional[Tensor]):
        if not self.mergeable:
            return tuple(n(x, conditional_input) for n in self.nets)
        self._check_conditional(conditional_input)
        k1, b1, k2, b2, c1, c2 = self.merged_params()
        from vaemolsim_tpu_torch.nn.core import compute_dtype
        cd = compute_dtype()
        if cd is None:
            # One tanh stack, through the dense-stack kernel on CUDA.
            from vaemolsim_tpu_torch.ops.fused_mlp import fused_dense_stack
            out = fused_dense_stack(
                x, [k1, k2], [b1, b2], ["tanh", None],
                cond=conditional_input,
                cond_kernels=None if c1 is None else [c1, c2])
        else:
            # Low-precision operands with float32 accumulation and a
            # float32 tanh, as the JAX merged path does: the operands are
            # rounded to ``cd`` and widened again, so that each product
            # is exact in float32 and the sum is a float32 sum (a product
            # taken in ``cd`` would round the sum itself to ``cd``).
            def mm(a, b):
                return a.to(cd).float() @ b.to(cd).float()

            ctx = conditional_input
            h = torch.tanh(mm(x, k1) + b1 + (mm(ctx, c1) if c1 is not None
                                             else 0.0))
            out = mm(h, k2) + b2 + (mm(ctx, c2) if c2 is not None else 0.0)
        D, K = self.w_net.event_size, self.num_bins
        n_slopes = K if self.circular else K - 1
        lead = out.shape[:-1]
        return (out[..., :D * K].reshape(lead + (D, K)),
                out[..., D * K:2 * D * K].reshape(lead + (D, K)),
                out[..., 2 * D * K:].reshape(lead + (D, n_slopes)))

    def forward(self, x: Tensor, conditional_input: Optional[Tensor] = None
                ) -> RationalQuadraticSpline:
        raw_w, raw_h, raw_s = self._merged_raw(x, conditional_input)
        return RationalQuadraticSpline(
            _bin_positions(raw_w, self.bin_min, self.bin_max, self.num_bins),
            _bin_positions(raw_h, self.bin_min, self.bin_max, self.num_bins),
            _slopes(raw_s), range_min=self.bin_min, circular=self.circular)


class MAFLayer(bj.Bijector, nn.Module):
    """Masked autoregressive flow layer over an RQS conditioner.  Density
    (inverse) is one pass; sampling (forward) is the D-pass fixed point.
    A bijector first: calling it transforms, as with every bijector.
    A CUDA block that the MAF-block kernel supports runs through it (see
    the module docstring)."""

    def __init__(self, conditioner: MaskedSplineConditioner):
        nn.Module.__init__(self)
        self.conditioner = conditioner

    def _fused_args(self, t: Tensor, context: Optional[Tensor]):
        """(params, ctx) for the MAF-block kernel, or None where the
        block takes the unfused route."""
        from vaemolsim_tpu_torch.nn.core import compute_dtype
        from vaemolsim_tpu_torch.ops import maf_fused
        cond = self.conditioner
        if not (t.is_cuda and cond.mergeable and not cond.circular
                and t.dim() == 2
                and (context is None or context.dim() == 2)
                and compute_dtype() in maf_fused.COMPUTE_DTYPES
                and (cond.w_net.event_size > 1 or cond.conditional)
                and cond.w_net.event_size <= maf_fused.MAX_DOFS
                and len({n.kernels[0].shape[1] for n in cond.nets}) == 1):
            return None
        cond._check_conditional(context)
        k1, b1, k2, b2, c1, c2 = cond.merged_params()
        if context is not None:
            return (k1, b1, k2, b2, c1, c2), context
        return (k1, b1, k2, b2), None

    def _fused_call(self, t: Tensor, context: Optional[Tensor],
                    inverse: bool):
        from vaemolsim_tpu_torch.ops import maf_fused
        args = self._fused_args(t, context)
        if args is None:
            return None
        params, ctx = args
        cond = self.conditioner
        fn = (maf_fused.maf_block_inverse_fused if inverse
              else maf_fused.maf_block_forward_fused)
        from vaemolsim_tpu_torch.nn.core import compute_dtype
        return fn(t, params, ctx, cond.w_net.event_size, cond.num_bins,
                  cond.bin_min, cond.bin_max,
                  degrees=cond.w_net.input_order_static,
                  compute_dtype=compute_dtype())

    def _spline(self, t: Tensor, context: Optional[Tensor]):
        cond = self.conditioner
        if cond.w_net.event_size == 1 and not cond.conditional:
            cond._check_conditional(context)
            # Constant spline: a 1-D autoregressive net cannot see its
            # input (every MADE mask is zero), so the parameters depend on
            # the weights alone; evaluate ONE row and broadcast it.
            return cond(torch.zeros((1, 1), dtype=t.dtype, device=t.device))
        return cond(t, context)

    def unfused_and_log_det(self, t: Tensor, context: Optional[Tensor] = None,
                            inverse: bool = False):
        """The block without the MAF-block kernel: the conditioner (the
        dense-stack kernel on CUDA), then the spline (the RQS kernel).
        The route of every block that the kernel does not take."""
        if inverse:
            x, ldj = self._spline(t, context).inverse_and_log_det(t)
            return x, ldj.sum(-1)
        D = self.conditioner.w_net.event_size
        y = t
        # After k passes every DOF of autoregressive depth <= k is final:
        # D - 1 passes here, the D-th with the log-det.
        for _ in range(D - 1):
            y = self._spline(y, context).forward(t)
        y, ldj = self._spline(y, context).forward_and_log_det(t)
        return y, ldj.sum(-1)

    def forward_and_log_det(self, x, context=None):
        fused = self._fused_call(x, context, inverse=False)
        if fused is not None:
            return fused
        return self.unfused_and_log_det(x, context, inverse=False)

    def inverse_and_log_det(self, y, context=None):
        fused = self._fused_call(y, context, inverse=True)
        if fused is not None:
            return fused
        return self.unfused_and_log_det(y, context, inverse=True)


def _ensure_event_transform(t, data_dim: int, device):
    """Wrap a scalar-acting bijector in Block(., 1) so its log-det
    reduces over the event axis; decided by probing the log-det shape."""
    _, ldj = t.forward_and_log_det(torch.zeros((1, data_dim), device=device))
    return bj.Block(t, 1) if torch.as_tensor(ldj).dim() >= 2 else t


def _make_bns(data_dim: int, n: int, device) -> nn.ModuleList:
    return nn.ModuleList(bj.BatchNormBijector.create(data_dim, device)
                         for _ in range(n))


class _FlowMixin:
    """The polymorphic call, the bijector chain and the batch-norm
    statistics shared by the flows."""

    def as_bijector(self, train: bool = False) -> bj.Chain:
        """Forward order before, block0, BN, block1, ..., after, as a
        Chain (which applies its last entry first); each BN in
        batch-moment mode when ``train``."""
        device = next(self.parameters()).device
        seq = []
        if self.before_flow_transform is not None:
            seq.append(_ensure_event_transform(self.before_flow_transform,
                                               self.data_dim, device))
        for i, blk in enumerate(self.blocks):
            if i > 0 and len(self.bn_params):
                seq.append(bj.Block(
                    self.bn_params[i - 1].with_batch_stats(train), 1))
            seq.append(blk)
        if self.after_flow_transform is not None:
            seq.append(_ensure_event_transform(self.after_flow_transform,
                                               self.data_dim, device))
        return bj.Chain(tuple(reversed(seq)))

    @torch.no_grad()
    def update_batch_stats(self, x: Tensor,
                           conditional_input: Optional[Tensor] = None):
        """Run the density (inverse) pass on the batch ``x`` and take one
        EMA step of each batch norm's running moments toward the moments
        of its own input, IN PLACE (the JAX package returns an updated
        flow; here the buffers change).  Returns the flow."""
        y = x
        for bijector in self.as_bijector(train=True).bijectors:
            inner = bijector.inner if isinstance(bijector, bj.Block) else None
            if hasattr(inner, "update_moments"):
                y, _, m, v = inner.inverse_and_log_det_and_moments(y)
                inner.update_moments(m, v)
            else:
                y = bijector.inverse(y, context=conditional_input)
        return self

    def forward(self, inputs, train: bool = False,
                conditional_input: Optional[Tensor] = None):
        if self.conditional and conditional_input is None:
            raise ValueError("This flow is conditional; pass "
                             "conditional_input=.")
        if not self.conditional and conditional_input is not None:
            raise ValueError(
                "conditional_input passed to a non-conditional flow; set "
                "conditional=True in rqs_params (silently ignoring the "
                "context would train an unconditioned model).")
        chain = self.as_bijector(train)
        if isinstance(inputs, dist_lib.Distribution):
            return dist_lib.TransformedDistribution(
                base=inputs, bijector=chain, context=conditional_input)
        return chain.forward(inputs, context=conditional_input)


class RQSSplineRealNVP(_FlowMixin, nn.Module):
    """Chain of RQS coupling blocks with alternating half-masks: even
    blocks condition on the first floor(d/2) DOFs, odd blocks on the last
    ceil(d/2); ``data_dim == 1`` masks nothing and transforms the single
    DOF through the ones-fed conditioner.  Never conditional; optional
    batch norm between blocks and before/after transforms."""

    def __init__(self, blocks: Sequence[CouplingLayer],
                 before_flow_transform: Any = None,
                 after_flow_transform: Any = None, data_dim: int = 1,
                 bn_params: Sequence[bj.BatchNormBijector] = ()):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.bn_params = nn.ModuleList(bn_params)
        self.before_flow_transform = before_flow_transform
        self.after_flow_transform = after_flow_transform
        self.data_dim = data_dim
        self.conditional = False

    @classmethod
    def create(cls, generator, data_dim: int, num_blocks: int = 4,
               rqs_params: Optional[dict] = None, batch_norm: bool = False,
               before_flow_transform=None, after_flow_transform=None,
               device=None) -> "RQSSplineRealNVP":
        device = default_device(device)
        rqs_params = dict(rqs_params or {})
        blocks = []
        for i in range(num_blocks):
            if data_dim == 1:
                n_masked, cond_in, n_out = 0, 0, 1
            elif i % 2 == 0:
                half = data_dim // 2
                n_masked, cond_in, n_out = half, half, data_dim - half
            else:
                half = data_dim // 2
                n_masked = -(data_dim - half)
                cond_in, n_out = data_dim - half, half
            blocks.append(CouplingLayer(SplineConditioner.create(
                generator, cond_in, n_out, device=device, **rqs_params),
                n_masked))
        bns = _make_bns(data_dim, num_blocks - 1, device) if batch_norm else ()
        return cls(blocks, before_flow_transform, after_flow_transform,
                   data_dim, bns)


class RQSSplineMAF(_FlowMixin, nn.Module):
    """Chain of masked-autoregressive RQS blocks: first block
    right-to-left, last left-to-right, middle blocks a permutation drawn
    from ``order_seed`` unless ``rqs_params`` gives ``input_order``;
    optional batch norm between blocks and before/after transforms;
    conditional context threaded to every block."""

    def __init__(self, blocks: Sequence[MAFLayer],
                 before_flow_transform: Any = None,
                 after_flow_transform: Any = None, data_dim: int = 1,
                 conditional: bool = False,
                 order_seed: Optional[int] = None,
                 bn_params: Sequence[bj.BatchNormBijector] = ()):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.bn_params = nn.ModuleList(bn_params)
        self.before_flow_transform = before_flow_transform
        self.after_flow_transform = after_flow_transform
        self.data_dim = data_dim
        self.conditional = conditional
        self.order_seed = order_seed

    @classmethod
    def create(cls, generator, data_dim: int, num_blocks: int = 2,
               order_seed: Optional[int] = None,
               rqs_params: Optional[dict] = None, batch_norm: bool = False,
               before_flow_transform=None, after_flow_transform=None,
               device=None) -> "RQSSplineMAF":
        device = default_device(device)
        rqs_params = dict(rqs_params or {})
        explicit_order = rqs_params.pop("input_order", None)
        conditional = rqs_params.get("conditional", False)
        rng = np.random.default_rng(order_seed)
        blocks = []
        for i in range(num_blocks):
            if explicit_order is not None:
                order = explicit_order
            elif i == 0:
                order = "right-to-left"
            elif i == num_blocks - 1:
                order = "left-to-right"
            else:
                order = np.arange(1, data_dim + 1)
                rng.shuffle(order)
            blocks.append(MAFLayer(MaskedSplineConditioner.create(
                generator, data_dim, input_order=order, device=device,
                **rqs_params)))
        bns = _make_bns(data_dim, num_blocks - 1, device) if batch_norm else ()
        return cls(blocks, before_flow_transform, after_flow_transform,
                   data_dim, conditional, order_seed, bns)

