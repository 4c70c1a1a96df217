"""Flow matching: continuous normalizing flows trained without ODE
solves (port of ``vaemolsim_tpu/flows/flow_matching.py``).

The velocity field is an MLP (an :class:`~vaemolsim_tpu_torch.nn.FCDeepNN`
trunk, so on the card it runs the dense-stack kernel) over ``[x,
time features, cond]``.  It is trained by conditional flow matching
(Lipman et al. 2023) on the optimal-transport path ``x_t = (1 - (1 -
sigma_min) t) x_0 + t x_1``, target ``u_t = x_1 - (1 - sigma_min) x_0``:
one net evaluation a sample.  Sampling and densities integrate the
probability-flow ODE by fixed-step RK4, with the exact divergence for
``dlogp/dt = -div v``.

The divergence: the JAX package takes ``event_dim`` JVPs under ``vmap``.
Here the batch is stacked ``event_dim`` times, one forward runs the
stack through the kernel route, and one ``autograd.grad`` of ``sum_i
v_i(copy i)`` gives each copy's diagonal of the Jacobian (the backward
is the plain version's recompute, ``_build.call_with_plain_grad``).
Random draws come from explicit ``torch.Generator``s.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from vaemolsim_tpu_torch.config import default_device
from vaemolsim_tpu_torch.nn.mappings import FCDeepNN
from vaemolsim_tpu_torch.ops.distributions import Distribution

Tensor = torch.Tensor

__all__ = ["VelocityField", "FlowMatching", "FlowMatchingDist",
           "FlowMatchingLayer"]


def _time_features(t: Tensor, n_freqs: int) -> Tensor:
    """``[t, sin(2 pi k t), cos(2 pi k t)]_{k=1..n_freqs}`` on a new last
    axis."""
    t = t[..., None]
    if n_freqs == 0:
        return t
    k = 2.0 * math.pi * torch.arange(1, n_freqs + 1, dtype=t.dtype,
                                     device=t.device)
    ang = t * k
    return torch.cat([t, torch.sin(ang), torch.cos(ang)], -1)


class VelocityField(nn.Module):
    """MLP velocity ``v(x, t [, cond])`` over flat events: ``concat([x,
    time_features(t), cond])`` through an FCDeepNN trunk with a linear
    head of ``event_dim`` units."""

    def __init__(self, net: FCDeepNN, event_dim: int, n_freqs: int,
                 cond_dim: int):
        super().__init__()
        self.net = net
        self.event_dim = int(event_dim)
        self.n_freqs = int(n_freqs)
        self.cond_dim = int(cond_dim)

    @classmethod
    def create(cls, generator: torch.Generator, event_dim: int, *,
               hidden_dim: Union[int, Sequence[int]] = (128, 128),
               n_freqs: int = 4, cond_dim: int = 0,
               activation: str = "gelu", zero_init_head: bool = False,
               device=None) -> "VelocityField":
        """``zero_init_head`` zeroes the head's kernel, so the fresh field
        is identically zero."""
        in_dim = event_dim + 1 + 2 * n_freqs + cond_dim
        net = FCDeepNN.create(generator, in_dim, event_dim,
                              hidden_dim=hidden_dim, activation=activation,
                              device=default_device(device))
        if zero_init_head:
            with torch.no_grad():
                net.head.kernel.zero_()
        return cls(net, event_dim, n_freqs, cond_dim)

    def forward(self, x: Tensor, t, conditional_input: Optional[Tensor]
                = None) -> Tensor:
        t = torch.as_tensor(t, dtype=x.dtype, device=x.device).expand(
            x.shape[:-1])
        feats = [x, _time_features(t, self.n_freqs)]
        if self.cond_dim:
            if conditional_input is None:
                raise ValueError("conditional_input required: this "
                                 "velocity field was built with "
                                 f"cond_dim={self.cond_dim}")
            feats.append(conditional_input.expand(
                x.shape[:-1] + (self.cond_dim,)))
        return self.net(torch.cat(feats, -1))


def _divergence(vel_of_x, x: Tensor) -> Tuple[Tensor, Tensor]:
    """The velocity at ``x`` (..., d) and its exact divergence (...,):
    ``d`` stacked copies of the batch through one forward, and one
    gradient of the sum of each copy's own component.  Keeps the graph
    (for a gradient through the density) when grad mode is on."""
    d = x.shape[-1]
    keep = torch.is_grad_enabled()
    with torch.enable_grad():
        xs = x.expand((d,) + x.shape).clone()
        if not xs.requires_grad:
            xs.requires_grad_(True)
        vs = vel_of_x(xs)                               # (d, ..., d)
        own = torch.einsum("i...i->...", vs)
        (g,) = torch.autograd.grad(own.sum(), xs, create_graph=keep)
    div = torch.einsum("i...i->...", g)
    v = vs[0]
    return (v, div) if keep else (v.detach(), div.detach())


class FlowMatching(nn.Module):
    """A continuous normalizing flow trained by conditional flow matching,
    with a standard-normal base over (event_dim,) events: :meth:`loss`
    (the CFM regression), :meth:`sample` (RK4 from t = 0 to 1),
    :meth:`log_prob` (backward with the divergence) and
    :meth:`sample_and_log_prob`."""

    def __init__(self, velocity: VelocityField, sigma_min: float = 1e-4):
        super().__init__()
        self.velocity = velocity
        self.sigma_min = float(sigma_min)

    @classmethod
    def create(cls, generator: torch.Generator, event_dim: int, *,
               hidden_dim: Union[int, Sequence[int]] = (128, 128),
               n_freqs: int = 4, cond_dim: int = 0,
               sigma_min: float = 1e-4, activation: str = "gelu",
               device=None) -> "FlowMatching":
        vel = VelocityField.create(generator, event_dim,
                                   hidden_dim=hidden_dim, n_freqs=n_freqs,
                                   cond_dim=cond_dim, activation=activation,
                                   device=device)
        return cls(vel, sigma_min)

    @property
    def event_dim(self) -> int:
        return self.velocity.event_dim

    def _device(self) -> torch.device:
        return self.velocity.net.head.kernel.device

    def _base_log_prob(self, x: Tensor) -> Tensor:
        return (-0.5 * (x * x).sum(-1)
                - 0.5 * self.event_dim * math.log(2.0 * math.pi))

    def loss(self, generator: torch.Generator, x1: Tensor,
             conditional_input: Optional[Tensor] = None,
             t: Optional[Tensor] = None,
             x0: Optional[Tensor] = None) -> Tensor:
        """The mean CFM loss over the batch ``x1`` (..., event_dim): ``t ~
        U(0, 1)`` per sample and ``x0 ~ N(0, I)`` from ``generator``,
        unless given."""
        if t is None:
            t = torch.rand(x1.shape[:-1], generator=generator,
                           dtype=x1.dtype, device=x1.device)
        if x0 is None:
            x0 = torch.randn(x1.shape, generator=generator, dtype=x1.dtype,
                             device=x1.device)
        a = 1.0 - (1.0 - self.sigma_min) * t[..., None]
        xt = a * x0 + t[..., None] * x1
        u = x1 - (1.0 - self.sigma_min) * x0
        v = self.velocity(xt, t, conditional_input)
        return ((v - u) ** 2).sum(-1).mean()

    def _integrate(self, x: Tensor, *, n_steps: int, forward: bool,
                   with_div: bool, conditional_input: Optional[Tensor]):
        """Fixed-step RK4 on the (divergence-augmented) flow ODE."""
        dt = (1.0 / n_steps) * (1.0 if forward else -1.0)
        steps = torch.arange(n_steps, dtype=x.dtype, device=x.device)
        ts = steps / n_steps if forward else 1.0 + dt * steps

        def rhs(xx, tt):
            def vel_at(xs):
                return self.velocity(xs, tt, conditional_input)

            if with_div:
                return _divergence(vel_at, xx)
            return vel_at(xx), None

        acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for t0 in ts:
            k1, d1 = rhs(x, t0)
            k2, d2 = rhs(x + 0.5 * dt * k1, t0 + 0.5 * dt)
            k3, d3 = rhs(x + 0.5 * dt * k2, t0 + 0.5 * dt)
            k4, d4 = rhs(x + dt * k3, t0 + dt)
            x = x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
            if with_div:
                acc = acc + (dt / 6.0) * (d1 + 2 * d2 + 2 * d3 + d4)
        return x, acc

    def _base(self, generator, sample_shape, x0):
        if x0 is not None:
            return x0
        shape = tuple(sample_shape) + (self.event_dim,)
        return torch.randn(shape, generator=generator,
                           device=self._device())

    def sample(self, generator: torch.Generator, sample_shape=(), *,
               n_steps: int = 50,
               conditional_input: Optional[Tensor] = None,
               x0: Optional[Tensor] = None) -> Tensor:
        """Samples of ``sample_shape`` (base draws ``x0`` from
        ``generator`` unless given)."""
        x1, _ = self._integrate(self._base(generator, sample_shape, x0),
                                n_steps=n_steps, forward=True,
                                with_div=False,
                                conditional_input=conditional_input)
        return x1

    def sample_and_log_prob(self, generator: torch.Generator,
                            sample_shape=(), *, n_steps: int = 50,
                            conditional_input: Optional[Tensor] = None,
                            x0: Optional[Tensor] = None
                            ) -> Tuple[Tensor, Tensor]:
        x0 = self._base(generator, sample_shape, x0)
        x1, div_int = self._integrate(x0, n_steps=n_steps, forward=True,
                                      with_div=True,
                                      conditional_input=conditional_input)
        return x1, self._base_log_prob(x0) - div_int

    def log_prob(self, x: Tensor, *, n_steps: int = 50,
                 conditional_input: Optional[Tensor] = None) -> Tensor:
        """The CNF density of ``x`` (up to RK4 error): backward to the
        base point, accumulating ``-int_0^1 div v dt``."""
        x0, div_int_back = self._integrate(
            x, n_steps=n_steps, forward=False, with_div=True,
            conditional_input=conditional_input)
        return self._base_log_prob(x0) + div_int_back


class FlowMatchingDist(Distribution):
    """A (conditional) :class:`FlowMatching` bound to its context, with
    the distribution protocol (``sample`` / ``log_prob`` /
    ``sample_and_log_prob``), ``n_steps`` RK4 steps each."""

    def __init__(self, model: FlowMatching, cond: Optional[Tensor] = None,
                 n_steps: int = 48):
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


class FlowMatchingLayer(nn.Module):
    """A distribution-emitting layer over a conditional CNF: its input
    vector is the conditioning context (``params_size() = cond_dim``)."""

    def __init__(self, model: FlowMatching, cond_dim: int,
                 n_steps: int = 48):
        super().__init__()
        self.model = model
        self.cond_dim = int(cond_dim)
        self.n_steps = int(n_steps)

    @classmethod
    def create(cls, generator: torch.Generator, event_dim: int,
               cond_dim: int, *,
               hidden_dim: Union[int, Sequence[int]] = (128, 128),
               n_freqs: int = 4, n_steps: int = 48,
               sigma_min: float = 1e-4, activation: str = "gelu",
               device=None) -> "FlowMatchingLayer":
        model = FlowMatching.create(generator, event_dim,
                                    hidden_dim=hidden_dim, n_freqs=n_freqs,
                                    cond_dim=cond_dim, sigma_min=sigma_min,
                                    activation=activation, device=device)
        return cls(model, cond_dim, n_steps)

    def params_size(self) -> int:
        return self.cond_dim

    def forward(self, raw: Tensor, train: bool = False) -> FlowMatchingDist:
        return FlowMatchingDist(self.model, raw, self.n_steps)
