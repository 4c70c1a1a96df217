"""Coordinate mappings and encoder/decoder trunks (port of
``vaemolsim_tpu/nn/mappings.py``).

FCDeepNN (with its batch-norm variant), the FG -> CG maps CGCentroid
and CGCenterOfMass, and DistanceSelection.  The CG maps hold a constant
row-normalised aggregation matrix (a buffer: it takes no gradient and
no optimizer step) and apply it with one ``torch.einsum``; the JAX
package computes them outside any Pallas kernel too.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from vaemolsim_tpu_torch.config import default_device
from vaemolsim_tpu_torch.nn.core import BatchNorm, Dense

Tensor = torch.Tensor

__all__ = ["FCDeepNN", "CGCentroid", "CGCenterOfMass", "DistanceSelection"]


class FCDeepNN(nn.Module):
    """Fully-connected trunk mapping inputs to raw parameters: flatten
    the event axes, expand periodic DOFs to (cos, sin) pairs placed after
    the non-periodic ones, a Dense stack with a hidden activation, then a
    linear head of ``prod(target_shape)`` units reshaped to
    ``target_shape``.  Without batch norm the trunk and head run as one
    ``fused_dense_stack`` (the dense-stack kernel on CUDA).  With it,
    a :class:`BatchNorm` follows each hidden layer and the trunk runs
    layer by layer, as the JAX package's does (no dense-stack kernel):
    ``forward(x, train)`` normalises by batch moments when ``train`` and
    never updates them; ``call_and_update`` also takes one EMA step of
    each layer's running moments, in place.

    ``periodic_mask`` is a per-DOF mask over the flattened input."""

    def __init__(self, layers: Sequence[Dense], head: Dense, event_ndims: int,
                 target_shape: Tuple[int, ...],
                 periodic_mask: Tuple[bool, ...],
                 bns: Sequence[BatchNorm] = ()):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.bns = nn.ModuleList(bns)
        self.head = head
        self.event_ndims = event_ndims
        self.target_shape = tuple(target_shape)
        self.periodic_mask = tuple(bool(b) for b in periodic_mask)
        self.batch_norm = bool(bns)
        if self.batch_norm and len(bns) != len(layers):
            raise ValueError(f"{len(bns)} batch norms for {len(layers)} "
                             "hidden layers")

    @classmethod
    def create(cls, generator: torch.Generator,
               input_shape: Union[int, Sequence[int]],
               target_shape: Union[int, Sequence[int]],
               hidden_dim: Union[int, Sequence[int]] = 200,
               periodic_dofs: Union[bool, Sequence[bool]] = False,
               batch_norm: bool = False, activation: str = "relu",
               kernel_initializer="glorot_uniform",
               device=None) -> "FCDeepNN":
        device = default_device(device)
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
        bns = ([BatchNorm.create(h, device=device) for h in hidden]
               if batch_norm else ())
        return cls(layers, head, len(event_shape), tgt, mask, bns)

    def _expand_periodic(self, flat: Tensor) -> Tensor:
        if not any(self.periodic_mask):
            return flat
        p_idx = [i for i, b in enumerate(self.periodic_mask) if b]
        np_idx = [i for i, b in enumerate(self.periodic_mask) if not b]
        p = flat[..., p_idx]
        parts = [flat[..., np_idx]] if np_idx else []
        return torch.cat(parts + [torch.cos(p), torch.sin(p)], -1)

    def _trunk(self, x: Tensor, train: bool, update: bool) -> Tensor:
        from vaemolsim_tpu_torch.ops.fused_mlp import fused_dense_stack
        batch = x.shape[:x.dim() - self.event_ndims]
        h = self._expand_periodic(x.reshape(batch + (-1,)))
        if not self.batch_norm:
            out = fused_dense_stack(
                h, [l.kernel for l in self.layers] + [self.head.kernel],
                [l.bias for l in self.layers] + [self.head.bias],
                [l.activation for l in self.layers] + [None])
            return out.reshape(batch + self.target_shape)
        for layer, bn in zip(self.layers, self.bns):
            h = layer(h)
            h = bn.call_and_update(h, train)[0] if update else bn(h, train)
        return self.head(h).reshape(batch + self.target_shape)

    def forward(self, x: Tensor, train: bool = False) -> Tensor:
        return self._trunk(x, train, update=False)

    def call_and_update(self, x: Tensor, train: bool = False):
        """``(out, self)``, the batch norms' running moments updated in
        place when ``train``."""
        return self._trunk(x, train, update=True), self


def _aggregation_matrix(res_atom_nums: Sequence[int],
                        weights: Optional[np.ndarray] = None) -> np.ndarray:
    """(n_res, n_atoms) row-normalised aggregation matrix."""
    n_atoms = int(np.sum(res_atom_nums))
    A = np.zeros((len(res_atom_nums), n_atoms), dtype=np.float32)
    start = 0
    for r, n in enumerate(res_atom_nums):
        w = (np.ones(n, dtype=np.float32) if weights is None
             else np.asarray(weights[start:start + n], dtype=np.float32))
        A[r, start:start + n] = w / w.sum()
        start += n
    return A


class _CGMap(nn.Module):
    """coords (..., n_atoms, 3) -> (..., n_res, 3) through a constant
    aggregation matrix ``agg`` (n_res, n_atoms), a buffer."""

    def __init__(self, agg: Tensor):
        super().__init__()
        self.register_buffer("agg", torch.as_tensor(agg,
                                                    dtype=torch.float32))

    def forward(self, coords: Tensor) -> Tensor:
        return torch.einsum("ra,...ad->...rd", self.agg, coords)


class CGCentroid(_CGMap):
    """FG -> CG centroid map: the mean of each residue's atoms."""

    @classmethod
    def create(cls, res_atom_nums: Sequence[int],
               device=None) -> "CGCentroid":
        return cls(torch.as_tensor(_aggregation_matrix(res_atom_nums),
                                   device=default_device(device)))


class CGCenterOfMass(_CGMap):
    """FG -> CG centre-of-mass map with per-atom masses: from a flat
    ``masses`` array with ``res_atom_nums``, or (``from_residue_dict``) a
    {residue name: per-atom masses} dict and a sequence of residue
    names."""

    @classmethod
    def create(cls, res_atom_nums: Sequence[int], masses: Sequence[float],
               device=None) -> "CGCenterOfMass":
        return cls(torch.as_tensor(
            _aggregation_matrix(res_atom_nums,
                                np.asarray(masses, dtype=np.float32)),
            device=default_device(device)))

    @classmethod
    def from_residue_dict(cls, res_masses: Dict[str, Sequence[float]],
                          res_names: Sequence[str],
                          device=None) -> "CGCenterOfMass":
        nums = [len(res_masses[name]) for name in res_names]
        flat = np.concatenate([np.asarray(res_masses[name],
                                          dtype=np.float32)
                               for name in res_names])
        return cls.create(nums, flat, device)


class DistanceSelection(nn.Module):
    """The ``max_included`` particles nearest a reference point, within
    ``cutoff``: coordinates relative to the reference (minimum image
    under a stored or per-call box, which takes no gradient), a validity
    mask and the co-selected per-particle info, all zero-filled where
    invalid and zero-padded back to ``max_included`` when a frame has
    fewer particles.  Masked-out particles sit at distance
    ``finfo.max``.

    ``torch.topk`` may order exact ties otherwise than ``jax.lax.top_k``.
    The ties that arise are padding rows at ``finfo.max``, which are
    invalid and zeroed whichever order they take; and the embeddings
    that read a selection do not depend on its order."""

    def __init__(self, cutoff: float, max_included: int = 50,
                 box_lengths: Optional[Tensor] = None):
        super().__init__()
        self.cutoff = float(cutoff)
        self.max_included = int(max_included)
        self.register_buffer("box_lengths", box_lengths)

    @classmethod
    def create(cls, cutoff: float, max_included: int = 50, box_lengths=None,
               device=None) -> "DistanceSelection":
        device = default_device(device)
        box = (None if box_lengths is None else
               torch.as_tensor(box_lengths, dtype=torch.float32,
                               device=device))
        return cls(cutoff, max_included, box)

    def forward(self, coords: Tensor, ref: Tensor,
                mask: Optional[Tensor] = None,
                particle_info: Optional[Tensor] = None,
                box_lengths: Optional[Tensor] = None):
        """coords (B, P, 3); ref (B, 3) or (B, 1, 3); mask (B, P) bool;
        particle_info (B, P, I) or None; box_lengths (3,) or (B, 3), in
        place of the stored box.  Returns (sel (B, max_included, 3),
        valid (B, max_included) bool, sel_info or None)."""
        if ref.dim() == coords.dim():
            ref = ref[..., 0, :]
        diff = coords - ref[..., None, :]
        box = box_lengths if box_lengths is not None else self.box_lengths
        if box is not None:
            box = torch.as_tensor(box, dtype=diff.dtype,
                                  device=diff.device).detach()
            if box.dim() < diff.dim():
                box = box[..., None, :]
            diff = diff - box * torch.round(diff / box)
        d2 = (diff * diff).sum(-1)
        big = torch.finfo(d2.dtype).max
        if mask is not None:
            d2 = torch.where(mask, d2, torch.full_like(d2, big))
        k = min(self.max_included, d2.shape[-1])
        neg_top, idx = torch.topk(-d2, k, dim=-1)
        sel_d2 = -neg_top
        sel = torch.gather(diff, -2, idx[..., None].expand(
            idx.shape + (diff.shape[-1],)))
        valid = sel_d2 <= self.cutoff * self.cutoff
        if mask is not None:
            valid = valid & (sel_d2 < big)
        sel = torch.where(valid[..., None], sel, 0.0)
        sel_info = None
        if particle_info is not None:
            sel_info = torch.gather(particle_info, -2, idx[..., None].expand(
                idx.shape + (particle_info.shape[-1],)))
            sel_info = torch.where(valid[..., None], sel_info, 0.0)
        pad = self.max_included - k
        if pad:
            sel = torch.nn.functional.pad(sel, (0, 0, 0, pad))
            valid = torch.nn.functional.pad(valid, (0, pad))
            if sel_info is not None:
                sel_info = torch.nn.functional.pad(sel_info, (0, 0, 0, pad))
        return sel, valid, sel_info
