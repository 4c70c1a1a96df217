"""Neural-net building blocks as ``nn.Module``s (port of
``vaemolsim_tpu/nn/core.py``).

Dense layers keep the JAX ``kernel`` layout, ``(in, out)``, so carrying
weights across is a copy.  Layers are constructed from their tensors, or
initialised by ``create(generator, ...)`` with the Keras-default
initialisers the JAX package uses (the draws differ from JAX's: the
random streams are not the same).

MADE is the masked autoregressive network (Germain et al. 2015) with
static masks, input orders and an optional unmasked conditional input
into every layer.  LayerNorm normalises the last axis with the Keras
epsilon (1e-3); BatchNorm keeps Keras' epsilon and momentum too, with
its running moments as buffers.

Every ``create`` builds on ``device``, by default the CUDA card (it
raises where there is none: pass ``device="cpu"`` for the CPU).  The
initial weights are drawn on the generator's own device and moved.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from vaemolsim_tpu_torch.config import default_device

Tensor = torch.Tensor

__all__ = ["Dense", "MLP", "MADE", "LayerNorm", "BatchNorm",
           "resolve_activation",
           "glorot_uniform", "truncated_normal_init", "set_compute_dtype",
           "compute_dtype"]

_ACTIVATIONS = {
    None: lambda x: x,
    "linear": lambda x: x,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu default
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
    "swish": F.silu,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "shifted_softplus": lambda x: F.softplus(x) - 0.6931471805599453,
}

_COMPUTE_DTYPE = None  # None = the parameters' own dtype (float32)


def set_compute_dtype(dtype) -> None:
    """Matmul compute dtype for Dense/MADE stacks (e.g. ``torch.bfloat16``);
    outputs are cast back to the input dtype.  ``None`` restores full
    precision.  The dense-stack kernel runs float32 only, so any other
    dtype takes its plain path; the MAF-block kernel also has a bf16 mode,
    which keeps a bfloat16 MAF block on the kernel."""
    global _COMPUTE_DTYPE
    _COMPUTE_DTYPE = dtype


def compute_dtype():
    return _COMPUTE_DTYPE


def resolve_activation(name) -> Callable[[Tensor], Tensor]:
    if callable(name):
        return name
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"Unknown activation {name!r}; "
                         f"one of {sorted(k for k in _ACTIVATIONS if k)}")


def glorot_uniform(generator: torch.Generator, shape: Tuple[int, int],
                   device=None, dtype=torch.float32) -> Tensor:
    """Keras-default Glorot/Xavier uniform, drawn on the generator's
    device and placed on ``device``."""
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=dtype)
    return ((2.0 * u - 1.0) * limit).to(device)


def truncated_normal_init(generator: torch.Generator,
                          shape: Tuple[int, int], device=None,
                          dtype=torch.float32, stddev: float = 0.05
                          ) -> Tensor:
    """Keras-default TruncatedNormal: stddev * N(0, 1) cut to [-2, 2],
    drawn by inverting the normal CDF on the kept interval, on the
    generator's device, and placed on ``device``."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=dtype)
    p = lo + u * (1.0 - 2.0 * lo)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)
    return (stddev * z.clamp(-2.0, 2.0)).to(device)


_INITIALIZERS = {
    "glorot_uniform": glorot_uniform,
    "truncated_normal": truncated_normal_init,
}


def resolve_initializer(name):
    if callable(name):
        return name
    return _INITIALIZERS[name]


def _param(t: Tensor) -> nn.Parameter:
    return nn.Parameter(torch.as_tensor(t, dtype=torch.float32))


class Dense(nn.Module):
    """y = activation(x @ kernel + bias), kernel (in, out)."""

    def __init__(self, kernel: Tensor, bias: Tensor,
                 activation: Optional[str] = None):
        super().__init__()
        self.kernel = _param(kernel)
        self.bias = _param(bias)
        self.activation = activation

    @classmethod
    def create(cls, generator: torch.Generator, in_dim: int, out_dim: int,
               activation: Optional[str] = None,
               kernel_initializer="glorot_uniform", device=None) -> "Dense":
        device = default_device(device)
        init = resolve_initializer(kernel_initializer)
        return cls(init(generator, (in_dim, out_dim), device=device),
                   torch.zeros(out_dim, device=device), activation)

    def forward(self, x: Tensor) -> Tensor:
        act = resolve_activation(self.activation)
        cd = compute_dtype()
        if cd is not None:
            y = x.to(cd) @ self.kernel.to(cd) + self.bias.to(cd)
            return act(y).to(x.dtype)
        return act(x @ self.kernel + self.bias)

    @property
    def in_dim(self) -> int:
        return self.kernel.shape[0]

    @property
    def out_dim(self) -> int:
        return self.kernel.shape[1]


class LayerNorm(nn.Module):
    """Layer normalisation over the last axis: the biased variance (as
    ``jnp.var``) and ``eps = 1e-3``, the Keras default the JAX package
    keeps, not ``torch.nn.LayerNorm``'s 1e-5."""

    def __init__(self, scale: Tensor, offset: Tensor, eps: float = 1e-3):
        super().__init__()
        self.scale = _param(scale)
        self.offset = _param(offset)
        self.eps = float(eps)

    @classmethod
    def create(cls, dim: int, device=None) -> "LayerNorm":
        device = default_device(device)
        return cls(torch.ones(dim, device=device),
                   torch.zeros(dim, device=device))

    def forward(self, x: Tensor) -> Tensor:
        m = x.mean(-1, keepdim=True)
        v = ((x - m) ** 2).mean(-1, keepdim=True)
        return (x - m) * torch.rsqrt(v + self.eps) * self.scale + self.offset


class BatchNorm(nn.Module):
    """Batch normalisation over the last axis, as the JAX package's (the
    Keras layer): ``eps = 1e-3``, running moments updated as
    ``new = momentum * old + (1 - momentum) * batch`` with momentum 0.99
    and the biased batch variance (``jnp.var``).  ``forward(x, train)``
    normalises by the batch moments when ``train`` and by the running
    ones otherwise, and never updates them; ``call_and_update`` also
    updates them in place (the JAX package returns an updated layer).
    The running moments are buffers, so no optimizer moves them.
    ``torch.nn.BatchNorm1d`` would differ in its epsilon (1e-5), its
    momentum convention (0.1 of the batch), its unbiased running
    variance and its update on every training forward."""

    def __init__(self, mean: Tensor, var: Tensor, scale: Tensor,
                 offset: Tensor, momentum: float = 0.99, eps: float = 1e-3):
        super().__init__()
        self.register_buffer("mean", torch.as_tensor(mean,
                                                     dtype=torch.float32))
        self.register_buffer("var", torch.as_tensor(var,
                                                    dtype=torch.float32))
        self.scale = _param(scale)
        self.offset = _param(offset)
        self.momentum = float(momentum)
        self.eps = float(eps)

    @classmethod
    def create(cls, dim: int, momentum: float = 0.99,
               device=None) -> "BatchNorm":
        device = default_device(device)
        return cls(torch.zeros(dim, device=device),
                   torch.ones(dim, device=device),
                   torch.ones(dim, device=device),
                   torch.zeros(dim, device=device), momentum)

    def _norm(self, x: Tensor, m: Tensor, v: Tensor) -> Tensor:
        return (x - m) * torch.rsqrt(v + self.eps) * self.scale + self.offset

    @staticmethod
    def _moments(x: Tensor):
        axes = tuple(range(x.dim() - 1))
        m = x.mean(axes)
        return m, ((x - m) ** 2).mean(axes)

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        if train:
            return self._norm(x, *self._moments(x))
        return self._norm(x, self.mean, self.var)

    def call_and_update(self, x: Tensor, train: bool = False):
        """``(out, self)``; with ``train`` the running moments take one
        EMA step toward the batch's, in place."""
        if not train:
            return self(x, False), self
        m, v = self._moments(x)
        with torch.no_grad():
            mom = self.momentum
            self.mean.mul_(mom).add_(m.detach(), alpha=1.0 - mom)
            self.var.mul_(mom).add_(v.detach(), alpha=1.0 - mom)
        return self._norm(x, m, v), self


class MLP(nn.Module):
    """Dense stack with a shared hidden activation and a linear head."""

    def __init__(self, layers: Sequence[Dense]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    @classmethod
    def create(cls, generator: torch.Generator, in_dim: int,
               hidden_dims: Sequence[int], out_dim: int,
               activation: str = "relu", kernel_initializer="glorot_uniform",
               device=None) -> "MLP":
        device = default_device(device)
        dims = [in_dim] + list(hidden_dims) + [out_dim]
        return cls([Dense.create(generator, a, b,
                                 activation if i < len(dims) - 2 else None,
                                 kernel_initializer, device)
                    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))])

    def forward(self, x: Tensor) -> Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


# ---------------------------------------------------------------------------
# MADE
# ---------------------------------------------------------------------------


def _resolve_input_order(input_order, event_size: int) -> np.ndarray:
    """Degrees 1..D for each input position."""
    if isinstance(input_order, str):
        if input_order == "left-to-right":
            return np.arange(1, event_size + 1)
        if input_order == "right-to-left":
            return np.arange(event_size, 0, -1)
        raise ValueError(f"Unknown input_order {input_order!r}")
    order = np.asarray(input_order, dtype=np.int64)
    if sorted(order.tolist()) != list(range(1, event_size + 1)):
        raise ValueError(
            f"input_order must be a permutation of 1..{event_size}, got {order}")
    return order


@functools.lru_cache(maxsize=None)
def _made_masks(degrees_in: Tuple[int, ...], hidden_units: Tuple[int, ...],
                params_per_dim: int) -> Tuple[np.ndarray, ...]:
    """Binary masks of the autoregressive property: hidden degrees cycle
    through 1..D-1; input->hidden and hidden->hidden allow
    deg_out >= deg_in, hidden->output needs deg_out > deg_h.  D == 1
    degenerates to a constant net (the single DOF may not see itself)."""
    deg_in = np.asarray(degrees_in)
    D = len(deg_in)
    degrees = [deg_in]
    for h in hidden_units:
        degrees.append(np.arange(h) % (D - 1) + 1 if D > 1
                       else np.zeros(h, dtype=np.int64))
    masks = [(degrees[i + 1][None, :] >= degrees[i][:, None]
              ).astype(np.float32) for i in range(len(hidden_units))]
    out_deg = np.repeat(deg_in, params_per_dim)
    masks.append((out_deg[None, :] > degrees[-1][:, None]
                  ).astype(np.float32))
    return tuple(masks)


class MADE(nn.Module):
    """Masked autoregressive dense network: ``(..., D)`` (+ optional
    conditional ``(..., C)``) to ``(..., D, params_per_dim)``; output
    ``[..., j, :]`` depends only on inputs of smaller degree than DOF j."""

    def __init__(self, kernels: Sequence[Tensor], biases: Sequence[Tensor],
                 cond_kernels: Optional[Sequence[Tensor]],
                 params_per_dim: int, event_size: int,
                 activation: str = "tanh",
                 input_order_static: Sequence[int] = ()):
        super().__init__()
        self.kernels = nn.ParameterList([_param(k) for k in kernels])
        self.biases = nn.ParameterList([_param(b) for b in biases])
        self.cond_kernels = (None if cond_kernels is None else
                             nn.ParameterList([_param(c)
                                               for c in cond_kernels]))
        self.params_per_dim = params_per_dim
        self.event_size = event_size
        self.activation = activation
        self.input_order_static = tuple(int(d) for d in input_order_static)
        hidden = tuple(k.shape[1] for k in kernels[:-1])
        for i, m in enumerate(_made_masks(self.input_order_static, hidden,
                                          params_per_dim)):
            # A copy: the cached numpy masks are shared by every MADE.
            self.register_buffer(f"mask{i}", torch.tensor(
                m, device=self.kernels[0].device))

    @property
    def masks(self) -> Tuple[Tensor, ...]:
        return tuple(getattr(self, f"mask{i}")
                     for i in range(len(self.kernels)))

    @classmethod
    def create(cls, generator: torch.Generator, event_size: int,
               params_per_dim: int, hidden_units: Sequence[int] = (200,),
               input_order="left-to-right", conditional: bool = False,
               conditional_event_size: Optional[int] = None,
               activation: str = "tanh",
               kernel_initializer="truncated_normal", device=None) -> "MADE":
        device = default_device(device)
        degrees_in = _resolve_input_order(input_order, event_size)
        dims = [event_size] + list(hidden_units) + [event_size
                                                    * params_per_dim]
        init = resolve_initializer(kernel_initializer)
        n = len(dims) - 1
        kernels = [init(generator, (dims[i], dims[i + 1]), device=device)
                   for i in range(n)]
        biases = [torch.zeros(dims[i + 1], device=device) for i in range(n)]
        cond_kernels = None
        if conditional:
            if conditional_event_size is None:
                raise ValueError(
                    "conditional_event_size required when conditional=True")
            # Every layer, the head included, sees the conditional input
            # (TFP AutoregressiveNetwork's all-layers default).
            cond_kernels = [init(generator,
                                 (conditional_event_size, dims[i + 1]),
                                 device=device) for i in range(n)]
        return cls(kernels, biases, cond_kernels, params_per_dim, event_size,
                   activation, tuple(int(d) for d in degrees_in))

    @property
    def conditional(self) -> bool:
        return self.cond_kernels is not None

    def forward(self, x: Tensor,
                conditional_input: Optional[Tensor] = None) -> Tensor:
        if self.conditional and conditional_input is None:
            raise ValueError("This MADE network is conditional; "
                             "conditional_input is required.")
        if not self.conditional and conditional_input is not None:
            raise ValueError(
                "conditional_input passed to a non-conditional MADE; build "
                "it with conditional=True (silently ignoring the context "
                "would train an unconditioned model).")
        from vaemolsim_tpu_torch.ops.fused_mlp import fused_dense_stack
        n = len(self.kernels)
        masked = [k * m for k, m in zip(self.kernels, self.masks)]
        acts = [self.activation] * (n - 1) + [None]
        h = fused_dense_stack(
            x, masked, list(self.biases), acts, cond=conditional_input,
            cond_kernels=(None if self.cond_kernels is None
                          else list(self.cond_kernels)))
        return h.reshape(h.shape[:-1] + (self.event_size,
                                         self.params_per_dim))
