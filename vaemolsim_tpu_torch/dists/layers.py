"""Distribution-emitting layers: raw network outputs to distributions
(port of ``vaemolsim_tpu/dists/layers.py``).

A layer maps a raw parameter tensor to a distribution and reports
``params_size()`` so upstream mappings can be sized from it.  DOFs that
share a family are evaluated together (``ops.distributions.Blockwise``).

Ported so far: the family registry (normal, von Mises and
deterministic), IndependentBlockwise, FlowedDistribution and
StaticFlowedDistribution.  A von Mises DOF reads three raw values: loc =
atan2(sin, cos), wrapped to [-pi, pi] and pinned to 0 with a zero
gradient where sin = cos = 0, and a concentration soft-clipped to
[float32 eps, sqrt(float32 max) / 2].  The Beta and Gamma families and
the autoregressive, von Mises and deterministic layers are still to
come.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from vaemolsim_tpu_torch.ops import bijectors as bj
from vaemolsim_tpu_torch.ops import distributions as dl

Tensor = torch.Tensor

__all__ = ["FAMILY_REGISTRY", "register_family", "family_param_count",
           "build_family_dist", "IndependentBlockwise", "FlowedDistribution",
           "StaticFlowedDistribution"]

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


# Family name -> (param_count, raw (..., n, p) -> scalar dist batch (..., n)).
FAMILY_REGISTRY: Dict[str, Tuple[int, Callable[[Tensor], dl.Distribution]]] = {
    "normal": (2, lambda r: dl.Normal(loc=r[..., 0],
                                      scale=_positive(r[..., 1]))),
    "von_mises": (3, _von_mises_from_raw),
    "deterministic": (1, lambda r: dl.Deterministic(loc=r[..., 0])),
}

_CLASS_ALIASES = {dl.Normal: "normal", dl.VonMises: "von_mises",
                  dl.Deterministic: "deterministic"}


def register_family(name: str, param_count: int,
                    build: Callable[[Tensor], dl.Distribution]) -> None:
    FAMILY_REGISTRY[name] = (param_count, build)


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


class StaticFlowedDistribution(nn.Module):
    """A flow over a FIXED base distribution; layer inputs are ignored
    except for their batch shape.  The base is stored as its ``loc`` and
    ``scale`` buffers: an ``Independent(Normal)`` over the event."""

    def __init__(self, flow: Any, base: dl.Independent):
        super().__init__()
        if not (isinstance(base, dl.Independent)
                and isinstance(base.base, dl.Normal)):
            raise NotImplementedError(
                "StaticFlowedDistribution takes an Independent(Normal) base "
                "so far")
        self.flow = flow
        self.register_buffer("base_loc", base.base.loc)
        self.register_buffer("base_scale", base.base.scale)
        self.reinterpreted_batch_ndims = base.reinterpreted_batch_ndims

    @property
    def base(self) -> dl.Independent:
        return dl.Independent(dl.Normal(self.base_loc, self.base_scale),
                              self.reinterpreted_batch_ndims)

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
