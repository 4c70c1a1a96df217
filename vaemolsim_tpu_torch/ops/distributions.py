"""Probability distributions on tensors (port of
``vaemolsim_tpu/ops/distributions.py``).

Every distribution offers ``log_prob(x)``, ``sample(generator,
sample_shape=())`` and ``sample_and_log_prob(generator, sample_shape=())``
with TFP's shape rules: samples are ``sample_shape + batch_shape +
event_shape``.  Randomness comes only from the ``torch.Generator``
passed in, on the device of the distribution's parameters.

Normal, Uniform, Deterministic, VonMises, Beta, Gamma, Independent,
Categorical, MixtureSameFamily, Blockwise and TransformedDistribution.
Gamma samples through ``standard_gamma``, which is
``torch._standard_gamma`` (reparameterised: its gradient with respect to
the concentration is the implicit one), and Beta from two of them.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

__all__ = ["Distribution", "Normal", "Uniform", "Deterministic", "VonMises",
           "Beta", "Gamma", "standard_gamma", "Independent", "Categorical",
           "MixtureSameFamily", "Blockwise", "TransformedDistribution"]

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
_TWO_PI = 2.0 * math.pi


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


def _wrap(x: Tensor) -> Tensor:
    """x wrapped to [-pi, pi] (round half to even, as jnp.round)."""
    return x - _TWO_PI * torch.round(x / _TWO_PI)


def von_mises_sample_raw(generator: torch.Generator, loc: Tensor,
                         concentration: Tensor, shape: Tuple[int, ...],
                         max_iters: int = 60) -> Tensor:
    """Best-Fisher (1979) rejection sampler with a wrapped-Cauchy
    envelope, without gradients.  Every round draws for all lanes and
    keeps the first acceptance of each; the loop ends when all lanes have
    accepted (one host sync per round) or after ``max_iters`` rounds,
    when lanes still open take the large-concentration wrapped-normal
    approximation.  Concentrations below 1e-5 take a uniform draw on
    [-pi, pi)."""
    with torch.no_grad():
        loc = loc.expand(shape)
        kappa = concentration.expand(shape)
        dtype, device = loc.dtype, loc.device
        safe = kappa.clamp_min(1e-7)
        tau = 1.0 + torch.sqrt(1.0 + 4.0 * safe * safe)
        rho = (tau - torch.sqrt(2.0 * tau)) / (2.0 * safe)
        r = (1.0 + rho * rho) / (2.0 * rho)

        def uniform(lo=0.0, hi=1.0):
            u = torch.rand(shape, generator=generator, dtype=dtype,
                           device=device)
            return lo + u * (hi - lo)

        theta = torch.zeros(shape, dtype=dtype, device=device)
        done = torch.zeros(shape, dtype=torch.bool, device=device)
        for _ in range(max_iters):
            u1, u2, u3 = uniform(), uniform(1e-12), uniform()
            z = torch.cos(math.pi * u1)
            f = (1.0 + r * z) / (r + z)
            c = safe * (r - f)
            accept = (((c * (2.0 - c) - u2) > 0.0)
                      | ((torch.log(c / u2) + 1.0 - c) >= 0.0))
            new = torch.sign(u3 - 0.5) * torch.arccos(f.clamp(-1.0, 1.0))
            theta = torch.where(~done & accept, new, theta)
            done = done | accept
            if bool(done.all()):
                break
        approx = _wrap(torch.randn(shape, generator=generator, dtype=dtype,
                                   device=device) * torch.rsqrt(safe))
        theta = torch.where(done, theta, approx)
        theta = torch.where(kappa < 1e-5, uniform(-math.pi, math.pi), theta)
        return _wrap(theta + loc)


_GL_NODES, _GL_WEIGHTS = (a.astype(np.float32) for a in
                          np.polynomial.legendre.leggauss(64))


def von_mises_dz_dconc(z0: Tensor, kappa: Tensor) -> Tensor:
    """d sample / d concentration at the centred sample z0 in [-pi, pi]:
    -(dF/dkappa)(z0) / p(z0) (Figurnov et al. 2018), by the one-sided
    Gauss-Legendre quadrature

        sign(z0) int_{|z0|}^{pi} exp(kappa (cos t - cos z0)) (cos t - r) dt,

    r = I1/I0, whose density ratio keeps the tails from underflowing;
    above kappa = 1000 the asymptote -z0 / (2 kappa)."""
    nodes = torch.as_tensor(_GL_NODES, device=z0.device)
    weights = torch.as_tensor(_GL_WEIGHTS, device=z0.device)
    r = torch.special.i1e(kappa) / torch.special.i0e(kappa)
    a = z0.abs()
    half = (math.pi - a) / 2.0
    t = a[..., None] + half[..., None] * (nodes + 1.0)
    ratio = torch.exp(kappa[..., None] * (torch.cos(t)
                                          - torch.cos(a)[..., None]))
    g = (weights * ratio * (torch.cos(t) - r[..., None])).sum(-1) * half
    return torch.where(kappa > 1000.0, -z0 / (2.0 * kappa),
                       torch.sign(z0) * g)


class _VonMisesSample(torch.autograd.Function):
    """Implicit reparameterization: the sample's gradient is 1 with
    respect to loc and ``von_mises_dz_dconc`` with respect to the
    concentration (the JAX package's custom_jvp)."""

    @staticmethod
    def forward(ctx, loc, concentration, generator, shape):
        z = von_mises_sample_raw(generator, loc, concentration, shape)
        ctx.save_for_backward(loc, concentration, z)
        return z

    @staticmethod
    def backward(ctx, g):
        loc, conc, z = ctx.saved_tensors
        d_conc = None
        if ctx.needs_input_grad[1]:
            z0 = _wrap(z - loc.expand(z.shape))
            kappa = conc.expand(z.shape).clamp_min(1e-7)
            d_conc = (g * von_mises_dz_dconc(z0, kappa)
                      ).sum_to_size(conc.shape)
        return g.sum_to_size(loc.shape), d_conc, None, None


class VonMises(Distribution):
    """Scalar von Mises distribution on [-pi, pi]:
    log p(x) = k cos(x - loc) - log(2 pi I0(k)), with log I0(k) =
    log(i0e(k)) + k for stability.  Samples are differentiable with
    respect to both parameters (implicit reparameterization)."""

    def __init__(self, loc: Tensor, concentration: Tensor):
        self.loc = loc
        self.concentration = concentration

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(self.loc.shape,
                                            self.concentration.shape))

    def log_prob(self, x: Tensor) -> Tensor:
        k = self.concentration
        log_norm = torch.log(torch.special.i0e(k)) + k + math.log(_TWO_PI)
        return k * torch.cos(x - self.loc) - log_norm

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return _VonMisesSample.apply(self.loc, self.concentration, generator,
                                     shape)

    def mean(self):
        return self.loc.expand(self.batch_shape)


def standard_gamma(generator: torch.Generator, alpha: Tensor,
                   shape: Tuple[int, ...]) -> Tensor:
    """Gamma(alpha, 1) draws of ``shape`` from the generator
    (reparameterised: gradients reach ``alpha``)."""
    return torch._standard_gamma(alpha.expand(shape).contiguous(),
                                 generator=generator)


class Beta(Distribution):
    """Scalar Beta distribution on (0, 1); ``log_prob`` uses xlogy /
    xlog1py, so x = 0 or 1 at a unit concentration gives the finite edge
    density and not 0 * log 0 = NaN."""

    def __init__(self, concentration1: Tensor, concentration0: Tensor):
        self.concentration1 = concentration1
        self.concentration0 = concentration0

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(self.concentration1.shape,
                                            self.concentration0.shape))

    def log_prob(self, x: Tensor) -> Tensor:
        a, b = self.concentration1, self.concentration0
        norm = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
        return (torch.special.xlogy(a - 1.0, x)
                + torch.special.xlog1py(b - 1.0, -x) - norm)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        g1 = standard_gamma(generator, self.concentration1, shape)
        g0 = standard_gamma(generator, self.concentration0, shape)
        return g1 / (g1 + g0)

    def mean(self):
        return (self.concentration1 / (self.concentration1
                                       + self.concentration0)
                ).expand(self.batch_shape)


class Gamma(Distribution):
    """Scalar Gamma distribution (concentration, rate); ``log_prob``
    uses xlogy, so a unit concentration at x = 0 gives log(rate), not
    NaN."""

    def __init__(self, concentration: Tensor, rate: Tensor):
        self.concentration = concentration
        self.rate = rate

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(self.concentration.shape,
                                            self.rate.shape))

    def log_prob(self, x: Tensor) -> Tensor:
        a, r = self.concentration, self.rate
        return (a * torch.log(r) + torch.special.xlogy(a - 1.0, x)
                - r * x - torch.lgamma(a))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return (standard_gamma(generator, self.concentration, shape)
                / self.rate)

    def mean(self):
        return (self.concentration / self.rate).expand(self.batch_shape)


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


class Categorical(Distribution):
    """Categorical over the last axis of ``logits``; samples are int64
    category indices."""

    def __init__(self, logits: Tensor):
        self.logits = logits

    @property
    def batch_shape(self):
        return tuple(self.logits.shape[:-1])

    @property
    def num_categories(self) -> int:
        return self.logits.shape[-1]

    def log_prob(self, x: Tensor) -> Tensor:
        lp = torch.log_softmax(self.logits, -1)
        idx = x.to(torch.int64)[..., None]
        lp = lp.expand(idx.shape[:-1] + lp.shape[-1:])
        return torch.gather(lp, -1, idx)[..., 0]

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        probs = torch.softmax(self.logits, -1).expand(
            shape + (self.num_categories,))
        flat = torch.multinomial(probs.reshape(-1, self.num_categories), 1,
                                 replacement=True, generator=generator)
        return flat.reshape(shape)


class MixtureSameFamily(Distribution):
    """Mixture with a shared component family: ``components``' last batch
    axis indexes the K components, scalar-event (``Normal``) or
    vector-event (``Independent(Normal(locs, scales), 1)`` with ``locs``
    of shape ``(K, d)``); the K axis goes just before the event dims."""

    def __init__(self, mixing_logits: Tensor, components: Distribution):
        self.mixing_logits = mixing_logits
        self.components = components

    @property
    def batch_shape(self):
        return tuple(self.mixing_logits.shape[:-1])

    @property
    def event_shape(self):
        return self.components.event_shape

    def log_prob(self, x: Tensor) -> Tensor:
        e = len(self.components.event_shape)
        lp_comp = self.components.log_prob(x.unsqueeze(-(e + 1)))  # (..., K)
        log_mix = torch.log_softmax(self.mixing_logits, -1)
        return torch.logsumexp(lp_comp + log_mix, -1)

    def sample(self, generator, sample_shape=()):
        idx = Categorical(self.mixing_logits).sample(generator, sample_shape)
        comp = self.components.sample(generator, sample_shape)
        e = len(self.components.event_shape)
        idx_e = idx.reshape(idx.shape + (1,) * (e + 1)).expand(
            idx.shape + (1,) + comp.shape[comp.dim() - e:])
        return torch.gather(comp, -(e + 1), idx_e).squeeze(-(e + 1))


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
