"""Bijectors on tensors (port of ``vaemolsim_tpu/ops/bijectors.py``).

A bijector offers ``forward(x, context=None)`` / ``inverse(y, context=None)``
and ``forward_and_log_det`` / ``inverse_and_log_det`` returning
``(value, log_det)``.  Log-dets are elementwise for scalar bijectors and
reduced over the event for vector ones; :class:`Block` sums a scalar
bijector's log-det over trailing event axes.  ``context`` is an optional
conditioning tensor threaded explicitly to every call.

Ported so far: Identity, Shift, Scale, SoftClip (the von Mises
concentration's bound), Block, Inverse and Chain.  Sigmoid, Tanh,
Softplus, BatchNormBijector and ``make_domain_transform`` are still to
come.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

Tensor = torch.Tensor

__all__ = ["Bijector", "Identity", "Shift", "Scale", "SoftClip", "Block",
           "Inverse", "Chain"]


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
