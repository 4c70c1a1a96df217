"""Bijectors on tensors (port of ``vaemolsim_tpu/ops/bijectors.py``).

A bijector offers ``forward(x, context=None)`` / ``inverse(y, context=None)``
and ``forward_and_log_det`` / ``inverse_and_log_det`` returning
``(value, log_det)``.  Log-dets are elementwise for scalar bijectors and
reduced over the event for vector ones; :class:`Block` sums a scalar
bijector's log-det over trailing event axes.  ``context`` is an optional
conditioning tensor threaded explicitly to every call.

Identity, Shift, Scale, Sigmoid, Tanh, Softplus, SoftClip (the von
Mises concentration's bound), Block, Inverse, Chain, BatchNormBijector
and ``make_domain_transform``.

The batch-norm bijector is an ``nn.Module``: its ``log_gamma`` and
``beta`` are parameters, its running ``mean`` and ``var`` buffers (no
gradient, no optimizer step; the JAX package stops their gradient).
Its mode, batch or running moments in the density direction, is the
flag ``use_batch_stats``; ``with_batch_stats(flag)`` gives a view in the
other mode over the same tensors (the JAX package builds a copy with
the flag replaced).
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

Tensor = torch.Tensor

__all__ = ["Bijector", "Identity", "Shift", "Scale", "Sigmoid", "Tanh",
           "Softplus", "SoftClip", "Block", "Inverse", "Chain",
           "BatchNormBijector", "make_domain_transform"]


class Bijector:
    """Protocol with derived conveniences."""

    def forward_and_log_det(self, x: Tensor, context: Optional[Tensor] = None):
        raise NotImplementedError

    def inverse_and_log_det(self, y: Tensor, context: Optional[Tensor] = None):
        raise NotImplementedError

    def forward(self, x: Tensor, context: Optional[Tensor] = None) -> Tensor:
        return self.forward_and_log_det(x, context)[0]

    def inverse(self, y: Tensor, context: Optional[Tensor] = None) -> Tensor:
        return self.inverse_and_log_det(y, context)[0]

    def forward_log_det(self, x: Tensor,
                        context: Optional[Tensor] = None) -> Tensor:
        return self.forward_and_log_det(x, context)[1]

    def inverse_log_det(self, y: Tensor,
                        context: Optional[Tensor] = None) -> Tensor:
        return self.inverse_and_log_det(y, context)[1]

    def __call__(self, x: Tensor, context: Optional[Tensor] = None) -> Tensor:
        return self.forward(x, context)


class Identity(Bijector):
    def forward_and_log_det(self, x, context=None):
        return x, torch.zeros_like(x)

    def inverse_and_log_det(self, y, context=None):
        return y, torch.zeros_like(y)


class Shift(Bijector):
    def __init__(self, shift: Tensor):
        self.shift = shift

    def forward_and_log_det(self, x, context=None):
        return x + self.shift, torch.zeros_like(x)

    def inverse_and_log_det(self, y, context=None):
        return y - self.shift, torch.zeros_like(y)


class Scale(Bijector):
    def __init__(self, scale: Tensor):
        self.scale = torch.as_tensor(scale)

    def _ldj(self, like: Tensor) -> Tensor:
        return torch.log(torch.abs(self.scale)).expand(like.shape)

    def forward_and_log_det(self, x, context=None):
        return x * self.scale, self._ldj(x)

    def inverse_and_log_det(self, y, context=None):
        return y / self.scale, -self._ldj(y)


def _softplus(x: Tensor) -> Tensor:
    """log(1 + e^x) without torch's linear cut-over at 20 (as
    ``jax.nn.softplus``)."""
    return torch.logaddexp(x, torch.zeros_like(x))


class Sigmoid(Bijector):
    def forward_and_log_det(self, x, context=None):
        return torch.sigmoid(x), -_softplus(-x) - _softplus(x)

    def inverse_and_log_det(self, y, context=None):
        return (torch.log(y) - torch.log1p(-y),
                -torch.log(y) - torch.log1p(-y))


class Tanh(Bijector):
    def forward_and_log_det(self, x, context=None):
        # log(1 - tanh^2 x) = 2 (log 2 - x - softplus(-2x))
        return (torch.tanh(x),
                2.0 * (math.log(2.0) - x - _softplus(-2.0 * x)))

    def inverse_and_log_det(self, y, context=None):
        return torch.atanh(y), -torch.log1p(-y * y)


class Softplus(Bijector):
    def forward_and_log_det(self, x, context=None):
        return _softplus(x), -_softplus(-x)

    def inverse_and_log_det(self, y, context=None):
        # x = y + log(1 - e^-y); dx/dy = 1 / (1 - e^-y)
        log1m = torch.log(-torch.expm1(-y))
        return y + log1m, -log1m


class SoftClip(Bijector):
    """Smoothly clip to (low, high): about the identity well inside the
    bounds, softplus-rounded at the edges,

        y = low + s softplus((x - low)/s) - s softplus((x - high)/s),

    with ``s = hinge_softness``.  The inverse is Newton's method from
    ``x0 = y`` clipped into the open interval; y outside it gives NaN."""

    def __init__(self, low: float, high: float, hinge_softness: float = 1.0):
        self.low, self.high = float(low), float(high)
        self.hinge_softness = float(hinge_softness)

    def _slope(self, x: Tensor) -> Tensor:
        s = self.hinge_softness
        return (torch.sigmoid((x - self.low) / s)
                - torch.sigmoid((x - self.high) / s))

    def forward_and_log_det(self, x, context=None):
        s = self.hinge_softness
        y = (self.low + s * _softplus((x - self.low) / s)
             - s * _softplus((x - self.high) / s))
        return y, torch.log(self._slope(x).clamp_min(1e-38))

    def inverse_and_log_det(self, y, context=None):
        x = y.clamp(self.low + 1e-6, self.high - 1e-6)
        for _ in range(25):
            x = x - ((self.forward_and_log_det(x)[0] - y)
                     / self._slope(x).clamp_min(1e-12))
        x = torch.where((y <= self.low) | (y >= self.high),
                        torch.full_like(x, float("nan")), x)
        return x, -self.forward_and_log_det(x)[1]


class Block(Bijector):
    """Promote a scalar bijector to vector events: log-dets summed over
    the trailing ``ndims`` axes."""

    def __init__(self, inner: Any, ndims: int = 1):
        self.inner = inner
        self.ndims = ndims

    def _reduce(self, ldj: Tensor) -> Tensor:
        return ldj.sum(dim=tuple(range(-self.ndims, 0)))

    def forward_and_log_det(self, x, context=None):
        y, ldj = self.inner.forward_and_log_det(x, context)
        return y, self._reduce(ldj)

    def inverse_and_log_det(self, y, context=None):
        x, ldj = self.inner.inverse_and_log_det(y, context)
        return x, self._reduce(ldj)


class Inverse(Bijector):
    def __init__(self, inner: Any):
        self.inner = inner

    def forward_and_log_det(self, x, context=None):
        return self.inner.inverse_and_log_det(x, context)

    def inverse_and_log_det(self, y, context=None):
        return self.inner.forward_and_log_det(y, context)


class Chain(Bijector):
    """Composition; ``bijectors[-1]`` is applied FIRST in the forward
    direction (tfp.bijectors.Chain order)."""

    def __init__(self, bijectors: Sequence[Any]):
        self.bijectors = tuple(bijectors)

    def forward_and_log_det(self, x, context=None):
        ldj = 0.0
        for bij in reversed(self.bijectors):
            x, l = bij.forward_and_log_det(x, context)
            ldj = ldj + l
        return x, ldj

    def inverse_and_log_det(self, y, context=None):
        ldj = 0.0
        for bij in self.bijectors:
            y, l = bij.inverse_and_log_det(y, context)
            ldj = ldj + l
        return y, ldj


class BatchNormBijector(Bijector, nn.Module):
    """Batch normalisation over the last axis as a bijector (the JAX
    package's, after ``tfp.bijectors.BatchNormalization``).  The
    forward direction (sampling) always un-normalises by the running
    moments; the inverse (density) normalises by the batch's moments,
    over all leading axes with the biased variance, when
    ``use_batch_stats``, and by the running ones otherwise.
    ``eps = 1e-5``, momentum 0.99."""

    def __init__(self, mean: Tensor, var: Tensor, log_gamma: Tensor,
                 beta: Tensor, eps: float = 1e-5,
                 use_batch_stats: bool = False, momentum: float = 0.99):
        nn.Module.__init__(self)
        f32 = dict(dtype=torch.float32)
        self.register_buffer("mean", torch.as_tensor(mean, **f32))
        self.register_buffer("var", torch.as_tensor(var, **f32))
        self.log_gamma = nn.Parameter(torch.as_tensor(log_gamma, **f32))
        self.beta = nn.Parameter(torch.as_tensor(beta, **f32))
        self.eps = float(eps)
        self.use_batch_stats = bool(use_batch_stats)
        self.momentum = float(momentum)

    @classmethod
    def create(cls, dim: int, device=None) -> "BatchNormBijector":
        from vaemolsim_tpu_torch.config import default_device
        device = default_device(device)
        zeros = torch.zeros(dim, device=device)
        return cls(zeros, torch.ones(dim, device=device), zeros.clone(),
                   zeros.clone())

    def with_batch_stats(self, use_batch_stats: bool) -> "Bijector":
        """This bijector in the given mode, over the same tensors."""
        if use_batch_stats == self.use_batch_stats:
            return self
        return _BatchNormMode(self, use_batch_stats)

    def _moments(self, y: Tensor, use_batch_stats: bool):
        if use_batch_stats:
            axes = tuple(range(y.dim() - 1))
            m = y.mean(axes)
            return m, ((y - m) ** 2).mean(axes)
        return self.mean, self.var

    def forward_and_log_det(self, x, context=None):
        sigma = torch.sqrt(self.var + self.eps)
        y = (x - self.beta) * torch.exp(-self.log_gamma) * sigma + self.mean
        ldj = (0.5 * torch.log(self.var + self.eps)
               - self.log_gamma).expand(x.shape)
        return y, ldj

    def _inverse(self, y: Tensor, use_batch_stats: bool):
        m, v = self._moments(y, use_batch_stats)
        x = (y - m) / torch.sqrt(v + self.eps) * torch.exp(self.log_gamma) \
            + self.beta
        ldj = (self.log_gamma - 0.5 * torch.log(v + self.eps)).expand(y.shape)
        return x, ldj, m, v

    def inverse_and_log_det(self, y, context=None):
        return self._inverse(y, self.use_batch_stats)[:2]

    def inverse_and_log_det_and_moments(self, y, context=None):
        """``(x, log_det, mean, var)``: the inverse and the moments it
        normalised by."""
        return self._inverse(y, self.use_batch_stats)

    @torch.no_grad()
    def update_moments(self, m: Tensor, v: Tensor) -> None:
        """One EMA step of the running moments toward (m, v), in place."""
        mom = self.momentum
        self.mean.mul_(mom).add_(m, alpha=1.0 - mom)
        self.var.mul_(mom).add_(v, alpha=1.0 - mom)


class _BatchNormMode(Bijector):
    """A :class:`BatchNormBijector` read in the other mode."""

    def __init__(self, bn: BatchNormBijector, use_batch_stats: bool):
        self.bn = bn
        self.use_batch_stats = use_batch_stats

    def forward_and_log_det(self, x, context=None):
        return self.bn.forward_and_log_det(x)

    def inverse_and_log_det(self, y, context=None):
        return self.bn._inverse(y, self.use_batch_stats)[:2]

    def inverse_and_log_det_and_moments(self, y, context=None):
        return self.bn._inverse(y, self.use_batch_stats)

    def update_moments(self, m: Tensor, v: Tensor) -> None:
        self.bn.update_moments(m, v)


def make_domain_transform(domains: Sequence[Tuple[float, float]],
                          target: Tuple[float, float] = (-1.0, 1.0),
                          from_target: bool = False, device=None):
    """The affine map taking each per-DOF interval ``domains[i] =
    (min_i, max_i)`` to the common ``target`` interval (or back, with
    ``from_target``): a scalar-acting ``Chain(Shift, Scale, Shift)``
    (wrap it in :class:`Block` for vector events), on ``device``, by
    default the CUDA card."""
    from vaemolsim_tpu_torch.config import default_device
    device = default_device(device)
    lo = torch.tensor([d[0] for d in domains], dtype=torch.float32,
                      device=device)
    hi = torch.tensor([d[1] for d in domains], dtype=torch.float32,
                      device=device)
    t_lo, t_hi = float(target[0]), float(target[1])
    chain = Chain((Shift(torch.full_like(lo, t_lo)),
                   Scale((t_hi - t_lo) / (hi - lo)), Shift(-lo)))
    return Inverse(chain) if from_target else chain
