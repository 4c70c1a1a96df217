"""ELBO losses and information regularizers (port of
``vaemolsim_tpu/losses.py``).

Losses are plain callables over distribution objects; an estimator that
may have to draw samples takes an explicit ``torch.Generator`` where the
JAX package takes a key.  Reductions are batch means.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

Tensor = torch.Tensor

__all__ = ["LogProbLoss", "PotentialEnergyLogProbLoss", "InfoRegularizer",
           "NonRegularizer", "KLDivergenceEstimate", "LogProbRegularizer",
           "ReverseKLDivergenceEstimate"]


@dataclass
class LogProbLoss:
    """Negative log-likelihood of samples under a predicted distribution:
    ``mean(-dist.log_prob(samples))``."""

    def __call__(self, samples: Tensor, dist) -> Tensor:
        return -dist.log_prob(samples).mean()


@dataclass
class PotentialEnergyLogProbLoss:
    """Reverse-ELBO reconstruction term:
    ``mean(potential(samples) - dist.log_prob(samples))``, with samples
    drawn from ``dist`` when not given.  ``potential_fn`` is beta*U, the
    negative log target density up to a constant."""

    potential_fn: Callable[[Tensor], Tensor]

    def __call__(self, dist, samples: Optional[Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> Tensor:
        if samples is None:
            if generator is None:
                raise ValueError("generator required to draw samples from "
                                 "dist")
            samples = dist.sample(generator)
        return (self.potential_fn(samples) - dist.log_prob(samples)).mean()


@dataclass
class InfoRegularizer:
    """Base of the VAE information regularizers: called on (dist_a,
    dist_b), the encoder posterior and the prior, it returns
    ``weight * call(...)``.  Samples are drawn from ``sample_dist``
    ("dist_a" or "dist_b") when not given."""

    weight: float = 1.0
    sample_dist: str = "dist_a"

    def __post_init__(self):
        if self.sample_dist not in ("dist_a", "dist_b"):
            raise ValueError("sample_dist must be 'dist_a' or 'dist_b'")

    def _get_samples(self, dist_a, dist_b, samples, generator):
        if samples is not None:
            return samples
        if generator is None:
            raise ValueError("generator required when samples not provided")
        src = dist_a if self.sample_dist == "dist_a" else dist_b
        return src.sample(generator)

    def call(self, dist_a, dist_b, samples) -> Tensor:  # pragma: no cover
        raise NotImplementedError

    def __call__(self, dist_a, dist_b, samples: Optional[Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> Tensor:
        samples = self._get_samples(dist_a, dist_b, samples, generator)
        return self.weight * self.call(dist_a, dist_b, samples)


@dataclass
class NonRegularizer(InfoRegularizer):
    """No regularization: a zero, on the samples' device when given."""

    def __call__(self, dist_a, dist_b, samples=None, generator=None):
        return torch.zeros((), device=None if samples is None
                           else samples.device)


@dataclass
class KLDivergenceEstimate(InfoRegularizer):
    """Monte-Carlo KL(dist_a || dist_b) from samples of dist_a:
    ``mean(log p_a(s) - log p_b(s))``."""

    def call(self, dist_a, dist_b, samples) -> Tensor:
        return (dist_a.log_prob(samples) - dist_b.log_prob(samples)).mean()


@dataclass
class LogProbRegularizer(InfoRegularizer):
    """``mean(-log p_b(s))`` on samples of dist_a: prior-only training
    under a deterministic encoder."""

    def call(self, dist_a, dist_b, samples) -> Tensor:
        return -dist_b.log_prob(samples).mean()


@dataclass
class ReverseKLDivergenceEstimate(InfoRegularizer):
    """KL(dist_b || dist_a) from samples of dist_b: the reverse direction
    for reverse-ELBO training."""

    sample_dist: str = "dist_b"

    def call(self, dist_a, dist_b, samples) -> Tensor:
        return (dist_b.log_prob(samples) - dist_a.log_prob(samples)).mean()
