"""Coordinate mappings and encoder/decoder trunks (port of
``vaemolsim_tpu/nn/mappings.py``).

Ported so far: FCDeepNN.  CGCentroid, CGCenterOfMass and
DistanceSelection come with the backmapping slice.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from vaemolsim_tpu_torch.nn.core import Dense

Tensor = torch.Tensor

__all__ = ["FCDeepNN"]


class FCDeepNN(nn.Module):
    """Fully-connected trunk mapping inputs to raw parameters: flatten
    the event axes, expand periodic DOFs to (cos, sin) pairs placed after
    the non-periodic ones, a Dense stack with a hidden activation, then a
    linear head of ``prod(target_shape)`` units reshaped to
    ``target_shape``.  The trunk and head run as one
    ``fused_dense_stack`` (the dense-stack kernel on CUDA).

    ``periodic_mask`` is a per-DOF mask over the flattened input.  The
    batch-norm variant is still to come."""

    def __init__(self, layers: Sequence[Dense], head: Dense, event_ndims: int,
                 target_shape: Tuple[int, ...],
                 periodic_mask: Tuple[bool, ...]):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.head = head
        self.event_ndims = event_ndims
        self.target_shape = tuple(target_shape)
        self.periodic_mask = tuple(bool(b) for b in periodic_mask)
        self.batch_norm = False

    @classmethod
    def create(cls, generator: torch.Generator,
               input_shape: Union[int, Sequence[int]],
               target_shape: Union[int, Sequence[int]],
               hidden_dim: Union[int, Sequence[int]] = 200,
               periodic_dofs: Union[bool, Sequence[bool]] = False,
               batch_norm: bool = False, activation: str = "relu",
               kernel_initializer="glorot_uniform",
               device=None) -> "FCDeepNN":
        if batch_norm:
            raise NotImplementedError(
                "FCDeepNN(batch_norm=True) is not ported yet")
        event_shape = ((input_shape,) if isinstance(input_shape, int)
                       else tuple(input_shape))
        tgt = ((target_shape,) if isinstance(target_shape, int)
               else tuple(target_shape))
        hidden = ([hidden_dim] if isinstance(hidden_dim, int)
                  else list(hidden_dim))
        flat_in = int(np.prod(event_shape))
        if isinstance(periodic_dofs, bool):
            mask = (periodic_dofs,) * flat_in
        else:
            mask = tuple(bool(b) for b in periodic_dofs)
            if len(mask) != flat_in:
                raise ValueError(
                    f"Shape of periodic_dofs ({len(mask)}) should match "
                    f"flattened input ({flat_in}).")
        dims = [flat_in + sum(mask)] + hidden
        layers = [Dense.create(generator, dims[i], dims[i + 1], activation,
                               kernel_initializer, device)
                  for i in range(len(hidden))]
        head = Dense.create(generator, dims[-1], int(np.prod(tgt)), None,
                            kernel_initializer, device)
        return cls(layers, head, len(event_shape), tgt, mask)

    def _expand_periodic(self, flat: Tensor) -> Tensor:
        if not any(self.periodic_mask):
            return flat
        p_idx = [i for i, b in enumerate(self.periodic_mask) if b]
        np_idx = [i for i, b in enumerate(self.periodic_mask) if not b]
        p = flat[..., p_idx]
        parts = [flat[..., np_idx]] if np_idx else []
        return torch.cat(parts + [torch.cos(p), torch.sin(p)], -1)

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        from vaemolsim_tpu_torch.ops.fused_mlp import fused_dense_stack
        batch = x.shape[:x.dim() - self.event_ndims]
        h = self._expand_periodic(x.reshape(batch + (-1,)))
        out = fused_dense_stack(
            h, [l.kernel for l in self.layers] + [self.head.kernel],
            [l.bias for l in self.layers] + [self.head.bias],
            [l.activation for l in self.layers] + [None])
        return out.reshape(batch + self.target_shape)
