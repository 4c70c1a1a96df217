"""CG -> atomistic backmapping over local environments (port of
``vaemolsim_tpu/models/backmapping.py``).

For each CG site: select and embed the nearby particles (rotation
invariant), then decode the site's internal coordinates (for example
torsions) from a distribution conditioned on the embedding.  Ragged
inputs are dense tensors with boolean masks.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from vaemolsim_tpu_torch.nn.attention import LocalParticleDescriptors

Tensor = torch.Tensor

__all__ = ["BackmappingOnly"]


class BackmappingOnly(nn.Module):
    """``mask_and_embed`` (DistanceSelection + ParticleEmbedding) feeding
    a decoding ``MappingToDistribution``.  Inputs: the CG site to decode
    around ``cg_ref`` (B, 3), the surrounding coordinates (B, P, 3) with
    an optional mask (B, P), and per-particle info (B, P, I)."""

    def __init__(self, mask_and_embed: LocalParticleDescriptors,
                 decoder: Any):
        super().__init__()
        self.mask_and_embed = mask_and_embed
        self.decoder = decoder

    def embed(self, cg_ref: Tensor, coords: Tensor, particle_info: Tensor,
              mask: Optional[Tensor] = None,
              box_lengths: Optional[Tensor] = None) -> Tensor:
        return self.mask_and_embed(coords, cg_ref, particle_info, mask=mask,
                                   box_lengths=box_lengths)

    def forward(self, cg_ref: Tensor, coords: Tensor, particle_info: Tensor,
                mask: Optional[Tensor] = None,
                box_lengths: Optional[Tensor] = None, train: bool = False):
        """The decoder's distribution of the site's internal
        coordinates."""
        return self.decoder(self.embed(cg_ref, coords, particle_info, mask,
                                       box_lengths), train=train)

    def log_prob(self, cg_ref: Tensor, coords: Tensor, particle_info: Tensor,
                 targets: Tensor, mask: Optional[Tensor] = None,
                 box_lengths: Optional[Tensor] = None,
                 train: bool = False) -> Tensor:
        """Log-density of decoded ``targets`` (B, D): the training
        objective's per-site term."""
        return self(cg_ref, coords, particle_info, mask, box_lengths,
                    train).log_prob(targets)

    def predict(self, cg_ref: Tensor, coords: Tensor, particle_info: Tensor,
                generator: torch.Generator, mask: Optional[Tensor] = None,
                box_lengths: Optional[Tensor] = None,
                train: bool = False) -> Tensor:
        """One sample of the decoded internal coordinates per site."""
        return self(cg_ref, coords, particle_info, mask, box_lengths,
                    train).sample(generator)
