"""Distribution-emitting layers: raw network outputs to distributions
(port of ``vaemolsim_tpu/dists/layers.py``).

A layer maps a raw parameter tensor to a distribution and reports
``params_size()`` so upstream mappings can be sized from it.  DOFs that
share a family are evaluated together (``ops.distributions.Blockwise``).

The family registry (normal, von Mises, deterministic, beta, gamma and
the von Mises mixtures of ``register_von_mises_mixture``),
IndependentBlockwise, AutoregressiveBlockwise, FlowedDistribution,
StaticFlowedDistribution, IndependentVonMises and
IndependentDeterministic.  A von Mises DOF reads three raw values: loc =
atan2(sin, cos), wrapped to [-pi, pi] and pinned to 0 with a zero
gradient where sin = cos = 0, and a concentration soft-clipped to
[float32 eps, sqrt(float32 max) / 2]; a mixture of n reads (sin, cos,
raw concentration) per component, then n mixing logits.

AutoregressiveBlockwise owns a MADE (the dense-stack kernel on CUDA)
that shifts the raw parameters of each DOF by the values of the DOFs
before it.  Its ``sample`` is the fixed-point iteration of
``tfp.distributions.Autoregressive``: D passes that all draw the SAME
noise, so after k passes every DOF of autoregressive depth <= k is
final.  The port restores the generator's state before each pass, so
the generator ends where one pass leaves it.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from vaemolsim_tpu_torch.ops import bijectors as bj
from vaemolsim_tpu_torch.ops import distributions as dl

Tensor = torch.Tensor

__all__ = ["FAMILY_REGISTRY", "register_family", "family_param_count",
           "build_family_dist", "register_von_mises_mixture",
           "IndependentBlockwise", "AutoregressiveBlockwise",
           "AutoregressiveBlockwiseDistribution", "FlowedDistribution",
           "StaticFlowedDistribution", "IndependentVonMises",
           "IndependentDeterministic"]

_F32_EPS = float(np.finfo(np.float32).eps)
_VM_CONC_HIGH = float(np.sqrt(np.finfo(np.float32).max) / 2.0)
_vm_softclip = bj.SoftClip(low=_F32_EPS, high=_VM_CONC_HIGH)


def _positive(x: Tensor) -> Tensor:
    """Default positivity constraint: softplus with a float32-eps floor."""
    return F.softplus(x) + _F32_EPS


def _safe_atan2_loc(sin_raw: Tensor, cos_raw: Tensor) -> Tensor:
    """atan2 that is 0, with a zero gradient, at sin = cos = 0 (where
    plain atan2's gradient is NaN: an all-zero context feeding a
    zero-initialised head gives exactly that point), and plain atan2
    everywhere else."""
    degenerate = (sin_raw == 0.0) & (cos_raw == 0.0)
    return torch.atan2(torch.where(degenerate, 0.0, sin_raw),
                       torch.where(degenerate, 1.0, cos_raw))


def _von_mises_from_raw(raw: Tensor) -> dl.VonMises:
    return dl.VonMises(loc=_safe_atan2_loc(raw[..., 0], raw[..., 1]),
                       concentration=_vm_softclip.forward(raw[..., 2]))


def _von_mises_mixture_from_raw(n_components: int):
    """Per-DOF mixture of n von Mises: raw (..., 4n) is n (sin, cos, raw
    concentration) triples, then n mixing logits."""

    def build(raw: Tensor) -> dl.MixtureSameFamily:
        n = n_components
        comp = raw[..., :3 * n].reshape(raw.shape[:-1] + (n, 3))
        return dl.MixtureSameFamily(
            mixing_logits=raw[..., 3 * n:],
            components=dl.VonMises(
                loc=_safe_atan2_loc(comp[..., 0], comp[..., 1]),
                concentration=_vm_softclip.forward(comp[..., 2])))

    return build


# Family name -> (param_count, raw (..., n, p) -> scalar dist batch (..., n)).
FAMILY_REGISTRY: Dict[str, Tuple[int, Callable[[Tensor], dl.Distribution]]] = {
    "normal": (2, lambda r: dl.Normal(loc=r[..., 0],
                                      scale=_positive(r[..., 1]))),
    "von_mises": (3, _von_mises_from_raw),
    "deterministic": (1, lambda r: dl.Deterministic(loc=r[..., 0])),
    "beta": (2, lambda r: dl.Beta(concentration1=_positive(r[..., 0]),
                                  concentration0=_positive(r[..., 1]))),
    "gamma": (2, lambda r: dl.Gamma(concentration=_positive(r[..., 0]),
                                    rate=_positive(r[..., 1]))),
}

_CLASS_ALIASES = {dl.Normal: "normal", dl.VonMises: "von_mises",
                  dl.Deterministic: "deterministic", dl.Beta: "beta",
                  dl.Gamma: "gamma"}


def register_family(name: str, param_count: int,
                    build: Callable[[Tensor], dl.Distribution]) -> None:
    FAMILY_REGISTRY[name] = (param_count, build)


def register_von_mises_mixture(n_components: int) -> str:
    """Register (idempotently) and return the family name of a von Mises
    mixture of ``n_components`` per DOF: ``von_mises_mixture_<n>``."""
    name = f"von_mises_mixture_{n_components}"
    if name not in FAMILY_REGISTRY:
        register_family(name, 4 * n_components,
                        _von_mises_mixture_from_raw(n_components))
    return name


def _canon_family(f) -> str:
    if isinstance(f, str):
        if f not in FAMILY_REGISTRY:
            raise ValueError(f"Unknown distribution family {f!r}; known: "
                             f"{sorted(FAMILY_REGISTRY)}; use "
                             f"register_family() to add one.")
        return f
    if f in _CLASS_ALIASES:
        return _CLASS_ALIASES[f]
    raise ValueError(f"Cannot resolve distribution family from {f!r}")


def family_param_count(f) -> int:
    return FAMILY_REGISTRY[_canon_family(f)][0]


def build_family_dist(f, raw: Tensor) -> dl.Distribution:
    return FAMILY_REGISTRY[_canon_family(f)][1](raw)


def _group_dofs(families: Sequence[str]):
    """DOF indices grouped by family, in order of first appearance."""
    groups: Dict[str, list] = {}
    for i, f in enumerate(families):
        groups.setdefault(f, []).append(i)
    return tuple(groups.items())


class IndependentBlockwise(nn.Module):
    """Independent heterogeneous 1-D distributions over an event vector:
    raw ``(..., params_size())`` is split per DOF, grouped by family and
    built into one ``Blockwise``."""

    def __init__(self, families: Sequence[str]):
        super().__init__()
        self.families = tuple(_canon_family(f) for f in families)

    @classmethod
    def create(cls, num_dofs: int,
               dist_classes: Union[str, type, Sequence] = "normal"
               ) -> "IndependentBlockwise":
        if isinstance(dist_classes, (str, type)):
            return cls((_canon_family(dist_classes),) * num_dofs)
        if len(dist_classes) != num_dofs:
            raise ValueError(f"Got {len(dist_classes)} families for "
                             f"{num_dofs} DOFs")
        return cls(dist_classes)

    @property
    def num_dofs(self) -> int:
        return len(self.families)

    @property
    def param_nums(self) -> Tuple[int, ...]:
        return tuple(family_param_count(f) for f in self.families)

    def params_size(self) -> int:
        return sum(self.param_nums)

    def forward(self, raw: Tensor, train: bool = False) -> dl.Blockwise:
        if raw.shape[-1] != self.params_size():
            raise ValueError(f"Expected last dim {self.params_size()}, "
                             f"got {tuple(raw.shape)}")
        starts = np.cumsum((0,) + self.param_nums)
        fam_dists, fam_indices = [], []
        for fam, idx in _group_dofs(self.families):
            cols = torch.stack([raw[..., starts[i]:starts[i + 1]]
                                for i in idx], -2)
            fam_dists.append(build_family_dist(fam, cols))
            fam_indices.append(tuple(idx))
        return dl.Blockwise(fam_dists, fam_indices)


class AutoregressiveBlockwiseDistribution(dl.Distribution):
    """The distribution of :class:`AutoregressiveBlockwise`: the
    blockwise families whose raw parameters are the layer input plus
    the MADE's shift of the sample itself.  ``log_prob`` is one pass;
    ``sample`` is the fixed point of D passes on the same noise (see the
    module docstring)."""

    def __init__(self, raw: Tensor, made: Any,
                 blockwise: IndependentBlockwise,
                 conditional_input: Optional[Tensor] = None):
        self.raw = raw  # (..., D, P)
        self.made = made
        self.blockwise = blockwise
        self.conditional_input = conditional_input

    @property
    def batch_shape(self):
        return tuple(self.raw.shape[:-2])

    @property
    def event_shape(self):
        return (self.blockwise.num_dofs,)

    def _dist_at(self, x: Tensor) -> dl.Blockwise:
        params = self.raw + self.made(x, self.conditional_input)
        # DOF i reads the first param_nums[i] of its padded row.
        flat = torch.cat([params[..., i, :p] for i, p in
                          enumerate(self.blockwise.param_nums)], -1)
        return self.blockwise(flat)

    def log_prob(self, x: Tensor) -> Tensor:
        return self._dist_at(x).log_prob(x)

    def sample(self, generator, sample_shape=()):
        """One draw by D passes that each start from the generator's
        state at the call."""
        D = self.blockwise.num_dofs
        shape = tuple(sample_shape) + self.batch_shape + (D,)
        x = torch.ones(shape, dtype=self.raw.dtype, device=self.raw.device)
        state = generator.get_state()
        for i in range(D):
            if i:
                generator.set_state(state)
            x = self._dist_at(x).sample(generator)
        return x


class AutoregressiveBlockwise(nn.Module):
    """A blockwise family set with its own MADE autoregressive shift.
    ``params_size()`` is the 2-D ``(num_dofs, max(param_nums))`` the
    upstream mapping must produce; the MADE's hidden width defaults to
    ``num_dofs * max(param_nums)``."""

    def __init__(self, made: Any, blockwise: IndependentBlockwise):
        super().__init__()
        self.made = made
        self.blockwise = blockwise

    @classmethod
    def create(cls, generator: torch.Generator, num_dofs: int,
               dist_classes: Union[str, type, Sequence] = "normal",
               conditional: bool = False,
               conditional_event_shape: Optional[int] = None,
               auto_net_params: Optional[dict] = None,
               device=None) -> "AutoregressiveBlockwise":
        from vaemolsim_tpu_torch.config import default_device
        from vaemolsim_tpu_torch.nn.core import MADE
        device = default_device(device)
        bw = IndependentBlockwise.create(num_dofs, dist_classes)
        max_p = max(bw.param_nums)
        net_kw = dict(auto_net_params or {})
        net_kw.setdefault("hidden_units", [num_dofs * max_p])
        made = MADE.create(generator, num_dofs, max_p,
                           conditional=conditional,
                           conditional_event_size=conditional_event_shape,
                           device=device, **net_kw)
        return cls(made, bw)

    @property
    def conditional(self) -> bool:
        return self.made.conditional

    def params_size(self) -> Tuple[int, int]:
        return (self.blockwise.num_dofs, max(self.blockwise.param_nums))

    def forward(self, raw: Tensor, conditional_input: Optional[Tensor] = None,
                train: bool = False) -> AutoregressiveBlockwiseDistribution:
        expected = self.params_size()
        if tuple(raw.shape[-2:]) != expected:
            raise ValueError(f"Input must be shaped (..., {expected[0]}, "
                             f"{expected[1]}), got {tuple(raw.shape)}")
        if self.conditional and conditional_input is None:
            raise ValueError("conditional_input required for conditional "
                             "AutoregressiveBlockwise")
        return AutoregressiveBlockwiseDistribution(
            raw, self.made, self.blockwise,
            conditional_input if self.conditional else None)


class FlowedDistribution(nn.Module):
    """A base distribution layer pushed through a flow."""

    def __init__(self, flow: Any, base_layer: Any):
        super().__init__()
        self.flow = flow
        self.base_layer = base_layer

    @property
    def conditional(self) -> bool:
        return getattr(self.flow, "conditional", False)

    def params_size(self):
        return self.base_layer.params_size()

    def forward(self, raw: Tensor, conditional_input: Optional[Tensor] = None,
                train: bool = False) -> dl.TransformedDistribution:
        base = self.base_layer(raw)
        if self.conditional:
            return self.flow(base, train=train,
                             conditional_input=conditional_input)
        return self.flow(base, train=train)


def _base_tensors(obj: Any, prefix: str, out: Dict[str, Tensor]) -> Any:
    """A template of a distribution tree, its tensors replaced by the
    buffer names they are stored under (``prefix`` plus the attribute
    path, with the ``base`` links left out: an Independent(Normal)'s loc
    is ``base_loc``)."""
    if torch.is_tensor(obj):
        out[prefix] = obj
        return _BufferRef(prefix)
    if isinstance(obj, dl.Distribution):
        tmpl = copy.copy(obj)
        for k, v in vars(obj).items():
            name = prefix if k == "base" else f"{prefix}_{k}"
            setattr(tmpl, k, _base_tensors(v, name, out))
        return tmpl
    if isinstance(obj, (tuple, list)):
        return type(obj)(_base_tensors(v, f"{prefix}_{i}", out)
                         for i, v in enumerate(obj))
    return obj


class _BufferRef:
    def __init__(self, name: str):
        self.name = name


def _rebuild(tmpl: Any, module: nn.Module) -> Any:
    if isinstance(tmpl, _BufferRef):
        return getattr(module, tmpl.name)
    if isinstance(tmpl, dl.Distribution):
        obj = copy.copy(tmpl)
        for k, v in vars(tmpl).items():
            setattr(obj, k, _rebuild(v, module))
        return obj
    if isinstance(tmpl, (tuple, list)):
        return type(tmpl)(_rebuild(v, module) for v in tmpl)
    return tmpl


class StaticFlowedDistribution(nn.Module):
    """A flow over a FIXED base distribution, of any family; layer
    inputs are ignored except for their batch shape.  The base's tensors
    are buffers (an Independent(Normal) base keeps ``base_loc`` and
    ``base_scale``), so they move with the module and sit in its state
    dict."""

    def __init__(self, flow: Any, base: dl.Distribution):
        super().__init__()
        self.flow = flow
        tensors: Dict[str, Tensor] = {}
        self._base_template = _base_tensors(base, "base", tensors)
        for name, t in tensors.items():
            self.register_buffer(name, t)

    @property
    def base(self) -> dl.Distribution:
        return _rebuild(self._base_template, self)

    @property
    def conditional(self) -> bool:
        return getattr(self.flow, "conditional", False)

    def forward(self, inputs: Optional[Tensor] = None,
                conditional_input: Optional[Tensor] = None,
                train: bool = False) -> dl.TransformedDistribution:
        if self.conditional:
            return self.flow(self.base, train=train,
                             conditional_input=conditional_input)
        return self.flow(self.base, train=train)


class IndependentVonMises(nn.Module):
    """Independent von Mises over ``event_dim`` DOFs: three raw values
    per DOF, loc = atan2(sin, cos) and a concentration through plain
    softplus (unlike the blockwise family's soft clip)."""

    def __init__(self, event_dim: int):
        super().__init__()
        self.event_dim = int(event_dim)

    @classmethod
    def create(cls, event_dim: int) -> "IndependentVonMises":
        return cls(event_dim)

    def params_size(self) -> int:
        return 3 * self.event_dim

    def forward(self, raw: Tensor, train: bool = False) -> dl.Independent:
        p = raw.reshape(raw.shape[:-1] + (self.event_dim, 3))
        return dl.Independent(dl.VonMises(
            loc=_safe_atan2_loc(p[..., 0], p[..., 1]),
            concentration=bj._softplus(p[..., 2])), 1)


class IndependentDeterministic(nn.Module):
    """Dirac deltas, one raw value per DOF (the reference's deterministic
    CG encoder)."""

    def __init__(self, event_dim: int):
        super().__init__()
        self.event_dim = int(event_dim)

    @classmethod
    def create(cls, event_dim: int) -> "IndependentDeterministic":
        return cls(event_dim)

    def params_size(self) -> int:
        return self.event_dim

    def forward(self, raw: Tensor, train: bool = False) -> dl.Independent:
        if raw.shape[-1] != self.event_dim:
            raise ValueError(f"Expected last dim {self.event_dim}, "
                             f"got {tuple(raw.shape)}")
        return dl.Independent(dl.Deterministic(loc=raw), 1)
