"""Score-based diffusion models: a variance-preserving diffusion (port
of ``vaemolsim_tpu/flows/diffusion.py``; Ho et al. 2020, Song et al.
2021).

The noise-prediction net is the flow-matching :class:`VelocityField` (an
:class:`~vaemolsim_tpu_torch.nn.FCDeepNN` trunk, so on the card it runs
the dense-stack kernel) with a zero-initialized head, trained by
denoising score matching: one net evaluation a sample.  Sampling runs
either the reverse SDE by Euler-Maruyama (ancestral sampling, fresh
noise every step) or the deterministic probability-flow ODE by RK4 on
quadratically stretched knots, which also gives exact densities through
the divergence (``flow_matching._divergence``: the batch stacked
``event_dim`` times and one gradient).

Every draw can be handed in, for a comparison with the JAX package:
``loss(..., u=, strata=, eps=)`` (the stratified times' uniforms and
permutation, the noise), ``sample(..., x1=, noise=)`` (the prior draw
and the SDE's per-step normals, ``(n_steps, *shape)``) and
``sample_and_log_prob(..., x1=)``.  Otherwise they come from the
``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from vaemolsim_tpu_torch.flows.flow_matching import VelocityField, _divergence
from vaemolsim_tpu_torch.ops.distributions import Distribution

Tensor = torch.Tensor

__all__ = ["Diffusion", "DiffusionDist", "DiffusionLayer"]


class Diffusion(nn.Module):
    """Variance-preserving diffusion with the linear schedule ``beta(t) =
    beta_min + t (beta_max - beta_min)`` on ``t in [t_min, 1]``: ``x_t =
    alpha(t) x_0 + sigma(t) eps``, ``alpha = exp(-B(t)/2)``, ``sigma^2 =
    1 - alpha^2``.  :meth:`loss` (denoising score matching with times
    stratified over the batch), :meth:`sample` (``"sde"`` or ``"ode"``),
    :meth:`log_prob` and :meth:`sample_and_log_prob` (the probability-flow
    ODE with its exact divergence).  The final ancestral step applies
    Tweedie's denoising ``(x - sigma eps_hat) / alpha`` at ``t_min``."""

    def __init__(self, eps_net: VelocityField, beta_min: float = 0.1,
                 beta_max: float = 20.0, t_min: float = 1e-3):
        super().__init__()
        self.eps_net = eps_net
        self.beta_min = float(beta_min)
        self.beta_max = float(beta_max)
        self.t_min = float(t_min)

    @classmethod
    def create(cls, generator: torch.Generator, event_dim: int, *,
               hidden_dim: Union[int, Sequence[int]] = (128, 128),
               n_freqs: int = 4, cond_dim: int = 0,
               beta_min: float = 0.1, beta_max: float = 20.0,
               t_min: float = 1e-3, activation: str = "gelu",
               device=None) -> "Diffusion":
        """The fresh model predicts eps = 0 (a zero head), so its reverse
        dynamics start at the Gaussian prior."""
        net = VelocityField.create(generator, event_dim,
                                   hidden_dim=hidden_dim, n_freqs=n_freqs,
                                   cond_dim=cond_dim, activation=activation,
                                   zero_init_head=True, device=device)
        return cls(net, beta_min, beta_max, t_min)

    @property
    def event_dim(self) -> int:
        return self.eps_net.event_dim

    def _device(self) -> torch.device:
        return self.eps_net.net.head.kernel.device

    # ---- schedule -----------------------------------------------------

    def beta(self, t):
        return self.beta_min + t * (self.beta_max - self.beta_min)

    def _log_alpha(self, t):
        return -0.5 * (self.beta_min * t
                       + 0.5 * (self.beta_max - self.beta_min) * t * t)

    def alpha_sigma(self, t) -> Tuple[Tensor, Tensor]:
        """``(alpha(t), sigma(t))``; ``sigma = sqrt(-expm1(2 log alpha))``
        stays accurate (and nonzero) near t = 0."""
        if not isinstance(t, Tensor):
            t = torch.as_tensor(t, dtype=torch.float32, device=self._device())
        log_a = self._log_alpha(t)
        return torch.exp(log_a), torch.sqrt(-torch.expm1(2.0 * log_a))

    # ---- training ------------------------------------------------------

    def loss(self, generator: Optional[torch.Generator], x0: Tensor,
             conditional_input: Optional[Tensor] = None, *,
             u: Optional[Tensor] = None, strata: Optional[Tensor] = None,
             eps: Optional[Tensor] = None) -> Tensor:
        """Mean ``||eps_hat(x_t, t) - eps||^2`` over the batch ``x0``
        (..., event_dim), ``t = t_min + (1 - t_min) (strata + u) / n``:
        each of the n samples takes its own sub-interval (``strata`` a
        permutation of 0..n-1, ``u`` uniform; both (n,), drawn from
        ``generator`` unless given), ``eps`` the noise (x0's shape)."""
        batch_shape = x0.shape[:-1]
        n = int(math.prod(batch_shape))
        kw = dict(dtype=x0.dtype, device=x0.device)
        if u is None:
            u = torch.rand(n, generator=generator, **kw)
        if strata is None:
            strata = torch.randperm(n, generator=generator,
                                    device=x0.device).to(x0.dtype)
        if eps is None:
            eps = torch.randn(x0.shape, generator=generator, **kw)
        t = (self.t_min
             + (1.0 - self.t_min) * (strata + u) / n).reshape(batch_shape)
        alpha, sigma = self.alpha_sigma(t)
        xt = alpha[..., None] * x0 + sigma[..., None] * eps
        pred = self.eps_net(xt, t, conditional_input)
        return ((pred - eps) ** 2).sum(-1).mean()

    # ---- score / ODE right-hand side -----------------------------------

    def score(self, x: Tensor, t,
              conditional_input: Optional[Tensor] = None) -> Tensor:
        """``grad_x log p_t(x) = -eps_hat(x, t) / sigma(t)``."""
        t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
        _, sigma = self.alpha_sigma(t)
        eps = self.eps_net(x, t, conditional_input)
        return -eps / sigma.expand(x.shape[:-1])[..., None]

    def _ode_rhs(self, x: Tensor, t,
                 conditional_input: Optional[Tensor]) -> Tensor:
        """The probability-flow drift ``-beta(t)/2 (x + score(x, t))``."""
        b = self.beta(torch.as_tensor(t, dtype=x.dtype, device=x.device))
        return -0.5 * b * (x + self.score(x, t, conditional_input))

    def _prior_log_prob(self, x: Tensor) -> Tensor:
        return (-0.5 * (x * x).sum(-1)
                - 0.5 * self.event_dim * math.log(2.0 * math.pi))

    def _prior(self, generator, sample_shape, x1) -> Tensor:
        if x1 is not None:
            return x1
        shape = tuple(sample_shape) + (self.event_dim,)
        return torch.randn(shape, generator=generator, device=self._device())

    # ---- probability-flow integration ----------------------------------

    def _time_grid(self, n_steps: int, like: Tensor) -> Tensor:
        """Knots ``t_min + (1 - t_min) u^2`` on a uniform u: finer where
        the score (~ t^-1/2) is stiff."""
        u = torch.linspace(0.0, 1.0, n_steps + 1, dtype=like.dtype,
                           device=like.device)
        return self.t_min + (1.0 - self.t_min) * u * u

    def _integrate_ode(self, x: Tensor, *, n_steps: int, forward: bool,
                       with_div: bool,
                       conditional_input: Optional[Tensor]):
        """Fixed-knot RK4 on the (divergence-augmented) probability-flow
        ODE over ``[t_min, 1]``; ``forward`` runs data -> prior, and the
        backward pass walks the same intervals reversed."""
        knots = self._time_grid(n_steps, x)
        dts = knots[1:] - knots[:-1]
        if forward:
            t0s, hs = knots[:-1], dts
        else:
            t0s, hs = knots[1:].flip(0), -dts.flip(0)

        def rhs(xx, tt):
            def f(xs):
                return self._ode_rhs(xs, tt, conditional_input)

            if with_div:
                return _divergence(f, xx)
            return f(xx), None

        acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for i in range(n_steps):
            t0, h = t0s[i], hs[i]
            k1, d1 = rhs(x, t0)
            k2, d2 = rhs(x + 0.5 * h * k1, t0 + 0.5 * h)
            k3, d3 = rhs(x + 0.5 * h * k2, t0 + 0.5 * h)
            k4, d4 = rhs(x + h * k3, t0 + h)
            x = x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
            if with_div:
                acc = acc + (h / 6.0) * (d1 + 2 * d2 + 2 * d3 + d4)
        return x, acc

    def log_prob(self, x: Tensor, *, n_steps: int = 64,
                 conditional_input: Optional[Tensor] = None) -> Tensor:
        """The model density of ``x`` (up to RK4 error and the ``t_min``
        truncation): data -> prior, accumulating ``+int div f dt``."""
        x1, div_int = self._integrate_ode(
            x, n_steps=n_steps, forward=True, with_div=True,
            conditional_input=conditional_input)
        return self._prior_log_prob(x1) + div_int

    def sample_and_log_prob(self, generator: Optional[torch.Generator],
                            sample_shape=(), *, n_steps: int = 64,
                            conditional_input: Optional[Tensor] = None,
                            x1: Optional[Tensor] = None
                            ) -> Tuple[Tensor, Tensor]:
        """Probability-flow samples with their exact density (the prior
        draw ``x1`` from ``generator`` unless given)."""
        x1 = self._prior(generator, sample_shape, x1)
        lp1 = self._prior_log_prob(x1)
        x0, div_int = self._integrate_ode(
            x1, n_steps=n_steps, forward=False, with_div=True,
            conditional_input=conditional_input)
        # log p at the end of the traversal: the start's minus the
        # integral as traversed (dt < 0 here).
        return x0, lp1 - div_int

    # ---- stochastic (ancestral) sampling --------------------------------

    def _sample_sde(self, x: Tensor, generator, *, n_steps: int,
                    conditional_input: Optional[Tensor],
                    denoise_final: bool, noise: Optional[Tensor]) -> Tensor:
        """Reverse-SDE Euler-Maruyama from the prior draw ``x`` at t = 1 to
        ``t_min``: ``x <- x + (beta/2 x + beta score) dt + sqrt(beta dt)
        z``, ``z`` row i of ``noise`` or drawn from ``generator``."""
        dt = (1.0 - self.t_min) / n_steps
        ts = 1.0 - dt * torch.arange(n_steps, dtype=torch.float32,
                                     device=x.device)
        for i in range(n_steps):
            t = ts[i]
            b = self.beta(t)
            drift = 0.5 * b * x + b * self.score(x, t, conditional_input)
            z = (noise[i] if noise is not None else
                 torch.randn(x.shape, generator=generator, dtype=x.dtype,
                             device=x.device))
            x = x + dt * drift + torch.sqrt(b * dt) * z
        if denoise_final:
            t_end = torch.full((), self.t_min, dtype=x.dtype,
                               device=x.device)
            alpha, sigma = self.alpha_sigma(t_end)
            eps = self.eps_net(x, t_end, conditional_input)
            x = (x - sigma * eps) / alpha
        return x

    def sample(self, generator: Optional[torch.Generator], sample_shape=(),
               *, n_steps: int = 64, method: str = "sde",
               denoise_final: bool = True,
               conditional_input: Optional[Tensor] = None,
               x1: Optional[Tensor] = None,
               noise: Optional[Tensor] = None) -> Tensor:
        """Samples of ``sample_shape``: ``method="sde"`` ancestral
        reverse-SDE sampling (``noise``: its per-step normals, (n_steps,
        *shape)), ``"ode"`` the probability flow (deterministic given the
        prior draw ``x1``)."""
        if method not in ("sde", "ode"):
            raise ValueError(f"unknown sampling method: {method!r}")
        x1 = self._prior(generator, sample_shape, x1)
        if method == "sde":
            return self._sample_sde(x1, generator, n_steps=n_steps,
                                    conditional_input=conditional_input,
                                    denoise_final=denoise_final,
                                    noise=noise)
        x0, _ = self._integrate_ode(x1, n_steps=n_steps, forward=False,
                                    with_div=False,
                                    conditional_input=conditional_input)
        return x0


class DiffusionDist(Distribution):
    """A (conditional) :class:`Diffusion` bound to its context, with the
    distribution protocol: ``sample`` by the ancestral sampler,
    ``sample_and_log_prob`` and ``log_prob`` by the probability-flow ODE,
    ``n_steps`` steps each."""

    def __init__(self, model: Diffusion, cond: Optional[Tensor] = None,
                 n_steps: int = 64):
        self.model = model
        self.cond = cond
        self.n_steps = int(n_steps)

    @property
    def event_shape(self) -> Tuple[int, ...]:
        return (self.model.event_dim,)

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return () if self.cond is None else tuple(self.cond.shape[:-1])

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return self.model.sample(generator, shape, n_steps=self.n_steps,
                                 conditional_input=self.cond)

    def sample_and_log_prob(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        return self.model.sample_and_log_prob(
            generator, shape, n_steps=self.n_steps,
            conditional_input=self.cond)

    def log_prob(self, x: Tensor) -> Tensor:
        return self.model.log_prob(x, n_steps=self.n_steps,
                                   conditional_input=self.cond)


class DiffusionLayer(nn.Module):
    """A distribution-emitting layer over a conditional diffusion: its
    input vector is the conditioning context (``params_size() =
    cond_dim``), for ``MappingToDistribution`` and decoder slots."""

    def __init__(self, model: Diffusion, cond_dim: int, n_steps: int = 64):
        super().__init__()
        self.model = model
        self.cond_dim = int(cond_dim)
        self.n_steps = int(n_steps)

    @classmethod
    def create(cls, generator: torch.Generator, event_dim: int,
               cond_dim: int, *,
               hidden_dim: Union[int, Sequence[int]] = (128, 128),
               n_freqs: int = 4, n_steps: int = 64, beta_min: float = 0.1,
               beta_max: float = 20.0, t_min: float = 1e-3,
               activation: str = "gelu", device=None) -> "DiffusionLayer":
        model = Diffusion.create(generator, event_dim, hidden_dim=hidden_dim,
                                 n_freqs=n_freqs, cond_dim=cond_dim,
                                 beta_min=beta_min, beta_max=beta_max,
                                 t_min=t_min, activation=activation,
                                 device=device)
        return cls(model, cond_dim, n_steps)

    def params_size(self) -> int:
        return self.cond_dim

    def forward(self, raw: Tensor, train: bool = False) -> DiffusionDist:
        return DiffusionDist(self.model, raw, self.n_steps)
