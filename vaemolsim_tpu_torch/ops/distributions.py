"""Probability distributions on tensors (port of
``vaemolsim_tpu/ops/distributions.py``).

Every distribution offers ``log_prob(x)``, ``sample(generator,
sample_shape=())`` and ``sample_and_log_prob(generator, sample_shape=())``
with TFP's shape rules: samples are ``sample_shape + batch_shape +
event_shape``.  Randomness comes only from the ``torch.Generator``
passed in, on the device of the distribution's parameters.

Ported so far: Normal, Uniform, Deterministic, Independent, Blockwise
and TransformedDistribution.  VonMises, Beta, Gamma, Categorical and
MixtureSameFamily are still to come.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor

__all__ = ["Distribution", "Normal", "Uniform", "Deterministic",
           "Independent", "Blockwise", "TransformedDistribution"]

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _reduce_last(x: Tensor, ndims: int) -> Tensor:
    if ndims == 0:
        return x
    return x.sum(dim=tuple(range(-ndims, 0)))


class Distribution:
    """Protocol with shared conveniences."""

    def sample(self, generator: torch.Generator,
               sample_shape: Sequence[int] = ()) -> Tensor:
        raise NotImplementedError

    def log_prob(self, x: Tensor) -> Tensor:
        raise NotImplementedError

    def sample_and_log_prob(self, generator: torch.Generator,
                            sample_shape: Sequence[int] = ()):
        s = self.sample(generator, sample_shape)
        return s, self.log_prob(s)

    def mean(self) -> Tensor:
        raise NotImplementedError(
            f"{type(self).__name__} does not define a closed-form mean")

    @property
    def event_shape(self) -> Tuple[int, ...]:
        return ()

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        raise NotImplementedError


class Normal(Distribution):
    """Scalar normal, batched elementwise."""

    def __init__(self, loc: Tensor, scale: Tensor):
        self.loc = loc
        self.scale = scale

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(self.loc.shape, self.scale.shape))

    def log_prob(self, x: Tensor) -> Tensor:
        z = (x - self.loc) / self.scale
        return -0.5 * z * z - torch.log(self.scale) - _HALF_LOG_2PI

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        eps = torch.randn(shape, generator=generator, dtype=self.loc.dtype,
                          device=self.loc.device)
        return self.loc + self.scale * eps

    def mean(self):
        return self.loc.expand(self.batch_shape)

    def entropy(self):
        return 0.5 + _HALF_LOG_2PI + torch.log(self.scale)


class Uniform(Distribution):
    """Scalar uniform on [low, high)."""

    def __init__(self, low: Tensor, high: Tensor):
        self.low = low
        self.high = high

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(self.low.shape, self.high.shape))

    def log_prob(self, x: Tensor) -> Tensor:
        inside = (x >= self.low) & (x < self.high)
        lp = -torch.log(self.high - self.low)
        return torch.where(inside, lp, torch.full_like(lp, -math.inf))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        u = torch.rand(shape, generator=generator, dtype=self.low.dtype,
                       device=self.low.device)
        return self.low + u * (self.high - self.low)

    def mean(self):
        return (0.5 * (self.low + self.high)).expand(self.batch_shape)


class Deterministic(Distribution):
    """Dirac delta at ``loc``; ``sample`` returns ``loc`` with its
    gradient, ``log_prob`` is 0 within ``atol`` of it and -inf elsewhere."""

    def __init__(self, loc: Tensor, atol: float = 1e-6):
        self.loc = loc
        self.atol = atol

    @property
    def batch_shape(self):
        return tuple(self.loc.shape)

    def log_prob(self, x: Tensor) -> Tensor:
        eq = torch.abs(x - self.loc) <= self.atol
        return torch.where(eq, 0.0, -math.inf).to(self.loc.dtype)

    def sample(self, generator, sample_shape=()):
        return self.loc.expand(tuple(sample_shape) + self.batch_shape)

    def mean(self):
        return self.loc


class Independent(Distribution):
    """Reinterpret the trailing ``reinterpreted_batch_ndims`` batch axes
    of a distribution as event axes."""

    def __init__(self, base: Distribution,
                 reinterpreted_batch_ndims: int = 1):
        self.base = base
        self.reinterpreted_batch_ndims = reinterpreted_batch_ndims

    @property
    def batch_shape(self):
        bs = self.base.batch_shape
        return bs[:len(bs) - self.reinterpreted_batch_ndims]

    @property
    def event_shape(self):
        bs = self.base.batch_shape
        return bs[len(bs) - self.reinterpreted_batch_ndims:]

    def log_prob(self, x: Tensor) -> Tensor:
        return _reduce_last(self.base.log_prob(x),
                            self.reinterpreted_batch_ndims)

    def sample(self, generator, sample_shape=()):
        return self.base.sample(generator, sample_shape)

    def mean(self):
        return self.base.mean()

    def entropy(self):
        return _reduce_last(self.base.entropy(),
                            self.reinterpreted_batch_ndims)


class Blockwise(Distribution):
    """Per-DOF scalar distributions concatenated into one event vector,
    evaluated one family at a time.  ``families[f]`` has batch shape
    ``batch + (n_f,)``; ``dof_indices[f][j]`` is the event position of
    family f's j-th column."""

    def __init__(self, families: Sequence[Distribution],
                 dof_indices: Sequence[Sequence[int]]):
        self.families = tuple(families)
        self.dof_indices = tuple(tuple(int(i) for i in ix)
                                 for ix in dof_indices)
        perm = [i for ix in self.dof_indices for i in ix]
        self._identity = perm == list(range(len(perm)))
        inv = [0] * len(perm)
        for pos, dof in enumerate(perm):
            inv[dof] = pos
        self._inverse_perm = tuple(inv)

    @property
    def num_dofs(self) -> int:
        return sum(len(ix) for ix in self.dof_indices)

    @property
    def event_shape(self):
        return (self.num_dofs,)

    @property
    def batch_shape(self):
        return self.families[0].batch_shape[:-1]

    def _cols(self, x: Tensor, f: int) -> Tensor:
        if self._identity and len(self.families) == 1:
            return x
        idx = torch.tensor(self.dof_indices[f], device=x.device)
        return torch.index_select(x, -1, idx)

    def _to_event_order(self, cat: Tensor) -> Tensor:
        if self._identity:
            return cat
        idx = torch.tensor(self._inverse_perm, device=cat.device)
        return torch.index_select(cat, -1, idx)

    def log_prob(self, x: Tensor) -> Tensor:
        total = 0.0
        for f, fam in enumerate(self.families):
            total = total + fam.log_prob(self._cols(x, f)).sum(-1)
        return total

    def log_prob_per_dof(self, x: Tensor) -> Tensor:
        parts = [fam.log_prob(self._cols(x, f))
                 for f, fam in enumerate(self.families)]
        return self._to_event_order(torch.cat(parts, -1))

    def sample(self, generator, sample_shape=()):
        parts = [fam.sample(generator, sample_shape) for fam in self.families]
        return self._to_event_order(torch.cat(parts, -1))


class TransformedDistribution(Distribution):
    """Pushforward of ``base`` through ``bijector``; ``context`` is passed
    to every bijector call."""

    def __init__(self, base: Distribution, bijector: Any,
                 context: Optional[Tensor] = None):
        self.base = base
        self.bijector = bijector
        self.context = context

    @property
    def batch_shape(self):
        return self.base.batch_shape

    @property
    def event_shape(self):
        return self.base.event_shape

    def log_prob(self, y: Tensor) -> Tensor:
        x, ildj = self.bijector.inverse_and_log_det(y, context=self.context)
        return self.base.log_prob(x) + ildj

    def sample(self, generator, sample_shape=()):
        x = self.base.sample(generator, sample_shape)
        return self.bijector.forward(x, context=self.context)

    def sample_and_log_prob(self, generator, sample_shape=()):
        x, base_lp = self.base.sample_and_log_prob(generator, sample_shape)
        y, fldj = self.bijector.forward_and_log_det(x, context=self.context)
        return y, base_lp - fldj
