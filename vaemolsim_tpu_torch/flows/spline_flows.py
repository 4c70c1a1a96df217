"""Masked-autoregressive rational-quadratic-spline flows (port of
``vaemolsim_tpu/flows/spline_flows.py``).

Flows are ``nn.Module``s that act as bijectors and are polymorphic like
the JAX ones: called on a tensor they transform it, called on a
distribution they return a ``TransformedDistribution``.  Spline bin
positions are ``softmax(raw) * (bin_max - bin_min - K*1e-2) + 1e-2`` and
knot slopes ``softplus(raw) + 1e-2``.

Ported so far: SplineConditioner, MaskedSplineConditioner, MAFLayer and
RQSSplineMAF without batch norm.  The MAF-block kernel dispatch comes
with that kernel; RQSSplineRealNVP and CouplingLayer come later.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from vaemolsim_tpu_torch.nn.core import MADE, Dense
from vaemolsim_tpu_torch.ops import bijectors as bj
from vaemolsim_tpu_torch.ops import distributions as dist_lib
from vaemolsim_tpu_torch.ops.rqs import RationalQuadraticSpline

Tensor = torch.Tensor

__all__ = ["SplineConditioner", "MaskedSplineConditioner", "MAFLayer",
           "RQSSplineMAF"]


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
            # Low-precision products with float32 accumulation and a
            # float32 tanh, as the JAX merged path does.
            def mm(a, b):
                return (a.to(cd) @ b.to(cd)).to(torch.float32)

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
    A bijector first: calling it transforms, as with every bijector."""

    def __init__(self, conditioner: MaskedSplineConditioner):
        nn.Module.__init__(self)
        self.conditioner = conditioner

    def _spline(self, t: Tensor, context: Optional[Tensor]):
        cond = self.conditioner
        if cond.w_net.event_size == 1 and not cond.conditional:
            cond._check_conditional(context)
            # Constant spline: a 1-D autoregressive net cannot see its
            # input (every MADE mask is zero), so the parameters depend on
            # the weights alone; evaluate ONE row and broadcast it.
            return cond(torch.zeros((1, 1), dtype=t.dtype, device=t.device))
        return cond(t, context)

    def forward_and_log_det(self, x, context=None):
        D = self.conditioner.w_net.event_size
        y = x
        # After k passes every DOF of autoregressive depth <= k is final:
        # D - 1 passes here, the D-th with the log-det.
        for _ in range(D - 1):
            y = self._spline(y, context).forward(x)
        y, ldj = self._spline(y, context).forward_and_log_det(x)
        return y, ldj.sum(-1)

    def inverse_and_log_det(self, y, context=None):
        x, ldj = self._spline(y, context).inverse_and_log_det(y)
        return x, ldj.sum(-1)


def _ensure_event_transform(t, data_dim: int, device):
    """Wrap a scalar-acting bijector in Block(., 1) so its log-det
    reduces over the event axis; decided by probing the log-det shape."""
    _, ldj = t.forward_and_log_det(torch.zeros((1, data_dim), device=device))
    return bj.Block(t, 1) if torch.as_tensor(ldj).dim() >= 2 else t


class RQSSplineMAF(nn.Module):
    """Chain of masked-autoregressive RQS blocks: first block
    right-to-left, last left-to-right, middle blocks a permutation drawn
    from ``order_seed`` unless ``rqs_params`` gives ``input_order``;
    optional before/after transforms; conditional context threaded to
    every block.  Batch norm between blocks is still to come."""

    def __init__(self, blocks: Sequence[MAFLayer],
                 before_flow_transform: Any = None,
                 after_flow_transform: Any = None, data_dim: int = 1,
                 conditional: bool = False,
                 order_seed: Optional[int] = None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.bn_params = ()
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
        if batch_norm:
            raise NotImplementedError(
                "RQSSplineMAF(batch_norm=True) is not ported yet")
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
        return cls(blocks, before_flow_transform, after_flow_transform,
                   data_dim, conditional, order_seed)

    def as_bijector(self, train: bool = False) -> bj.Chain:
        """Forward order before, block0, ..., after, as a Chain (which
        applies its last entry first)."""
        device = next(self.parameters()).device
        seq = []
        if self.before_flow_transform is not None:
            seq.append(_ensure_event_transform(self.before_flow_transform,
                                               self.data_dim, device))
        seq.extend(self.blocks)
        if self.after_flow_transform is not None:
            seq.append(_ensure_event_transform(self.after_flow_transform,
                                               self.data_dim, device))
        return bj.Chain(tuple(reversed(seq)))

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
