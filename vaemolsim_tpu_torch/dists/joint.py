"""System-level autoregressive backmapping (port of
``vaemolsim_tpu/dists/joint.py``).

Each residue r of a system owns a block of D internal coordinates
(B, R, D), decoded in index order.  Its context is the concatenation of
(a) a rotation-invariant embedding of the CG environment around its
site (``LocalParticleDescriptors`` over the CG point cloud; with
``embedding="attention"`` the pair-attention kernel and, in the
``FCDeepNN`` mapping, the dense-stack kernel run on the card) and (b) a
causal summary of the residues before it: their encodings averaged by
a strictly lower-triangular matrix.  So ``log_prob`` is one parallel
pass over (B, R), while ``sample`` decodes residue by residue, building
only residue r's context at step r.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from vaemolsim_tpu_torch.config import default_device
from vaemolsim_tpu_torch.nn.attention import LocalParticleDescriptors
from vaemolsim_tpu_torch.nn.core import Dense
from vaemolsim_tpu_torch.ops import distributions as dl

Tensor = torch.Tensor

__all__ = ["JointBackmapping", "JointBackmappingDistribution"]


def _causal_mean_matrix(R: int, device=None) -> Tensor:
    """Strictly lower-triangular averaging: row r averages rows < r."""
    tri = torch.tril(torch.ones((R, R), device=device), diagonal=-1)
    return tri / tri.sum(-1, keepdim=True).clamp_min(1.0)


class JointBackmappingDistribution(dl.Distribution):
    """The joint distribution of every residue's internal coordinates,
    autoregressive over residues; emitted by :class:`JointBackmapping`."""

    def __init__(self, layer: "JointBackmapping", cg_coords: Tensor,
                 cg_info: Tensor):
        self.layer = layer
        self.cg_coords = cg_coords  # (B, R, 3)
        self.cg_info = cg_info  # (B, R, I)

    @property
    def batch_shape(self):
        return tuple(self.cg_coords.shape[:-2])

    @property
    def event_shape(self):
        return (self.cg_coords.shape[-2], self.layer.dofs_per_residue)

    def _env_contexts(self) -> Tensor:
        """The x-independent environment embedding of each residue, over
        B * R clouds (each residue sees the whole CG cloud around its own
        site): (B, R, E)."""
        B, R, _ = self.cg_coords.shape
        coords = self.cg_coords[:, None].expand(B, R, R, 3).reshape(
            B * R, R, 3)
        info = self.cg_info[:, None].expand(
            (B, R) + tuple(self.cg_info.shape[-2:])).reshape(
            B * R, R, self.cg_info.shape[-1])
        refs = self.cg_coords.reshape(B * R, 3)
        return self.layer.cg_embed(coords, refs, info).reshape(B, R, -1)

    def _prefix(self, x: Tensor) -> Tensor:
        """Causal summary of the residues decoded before each: (B, R, F)."""
        causal = _causal_mean_matrix(x.shape[-2], x.device)
        return torch.einsum("rs,bsf->brf", causal,
                            self.layer.residue_encoder(x))

    def _contexts(self, x: Tensor, env: Tensor = None) -> Tensor:
        """Each residue's context, causal in x: (B, R, C)."""
        if env is None:
            env = self._env_contexts()
        return torch.cat([env, self._prefix(x)], -1)

    def _residue_dist(self, context: Tensor):
        lay = self.layer
        params = lay.mapping(context)
        if getattr(lay.decoder_dist, "conditional", False):
            return lay.decoder_dist(params, conditional_input=context)
        return lay.decoder_dist(params)

    def log_prob(self, x: Tensor) -> Tensor:
        return self._residue_dist(self._contexts(x)).log_prob(x).sum(-1)

    def sample(self, generator: torch.Generator,
               sample_shape: Sequence[int] = ()) -> Tensor:
        if tuple(sample_shape):
            n = 1
            for s in sample_shape:
                n *= int(s)
            out = torch.stack([self.sample(generator) for _ in range(n)])
            return out.reshape(tuple(sample_shape) + out.shape[1:])
        B, R, _ = self.cg_coords.shape
        D = self.layer.dofs_per_residue
        x = torch.zeros((B, R, D), dtype=self.cg_coords.dtype,
                        device=self.cg_coords.device)
        env = self._env_contexts()
        causal = _causal_mean_matrix(R, x.device)
        for r in range(R):
            # Only residue r's context: row r of the causal matrix
            # against the encodings (O(R) a step, not the whole grid).
            enc = self.layer.residue_encoder(x)
            prefix_r = torch.einsum("s,bsf->bf", causal[r], enc)
            ctx_r = torch.cat([env[:, r], prefix_r], -1)
            x_r = self._residue_dist(ctx_r).sample(generator)
            x = torch.cat([x[:, :r], x_r[:, None], x[:, r + 1:]], 1)
        return x


class JointBackmapping(nn.Module):
    """Emits a :class:`JointBackmappingDistribution` from a CG
    configuration ``(cg_coords (B, R, 3), cg_info (B, R, I))``."""

    def __init__(self, cg_embed: LocalParticleDescriptors,
                 residue_encoder: Dense, mapping: Any, decoder_dist: Any,
                 dofs_per_residue: int):
        super().__init__()
        self.cg_embed = cg_embed
        self.residue_encoder = residue_encoder
        self.mapping = mapping
        self.decoder_dist = decoder_dist
        self.dofs_per_residue = int(dofs_per_residue)

    @classmethod
    def create(cls, generator: torch.Generator, dofs_per_residue: int,
               cg_info_dim: int, decoder_dist: Any, embed_dim: int = 16,
               prefix_dim: int = 8, cutoff: float = 5.0,
               max_included: int = 8, mapping_hidden: int = 32,
               embedding: str = "attention",
               device=None) -> "JointBackmapping":
        """``embedding``: "attention" (GA attention, one block) or
        "schnet" (continuous-filter convolutions) for the CG
        environment."""
        from vaemolsim_tpu_torch.nn.attention import ParticleEmbedding
        from vaemolsim_tpu_torch.nn.mappings import (DistanceSelection,
                                                     FCDeepNN)
        from vaemolsim_tpu_torch.nn.schnet import SchNetEmbedding

        device = default_device(device)
        if embedding == "schnet":
            env_embed = SchNetEmbedding.create(
                generator, cg_info_dim, embed_dim, cutoff=cutoff,
                device=device)
        elif embedding == "attention":
            env_embed = ParticleEmbedding.create(
                generator, cg_info_dim, embed_dim, num_blocks=1,
                device=device)
        else:
            raise ValueError("embedding must be 'attention' or 'schnet', "
                             f"got {embedding!r}")
        cg_embed = LocalParticleDescriptors(
            DistanceSelection.create(cutoff, max_included, device=device),
            env_embed)
        residue_encoder = Dense.create(generator, dofs_per_residue,
                                       prefix_dim, "tanh", device=device)
        p = decoder_dist.params_size()
        target = p if isinstance(p, int) else tuple(p)
        mapping = FCDeepNN.create(generator, embed_dim + prefix_dim, target,
                                  hidden_dim=mapping_hidden, device=device)
        return cls(cg_embed, residue_encoder, mapping, decoder_dist,
                   dofs_per_residue)

    def forward(self, cg_coords: Tensor, cg_info: Tensor,
                train: bool = False) -> JointBackmappingDistribution:
        del train
        return JointBackmappingDistribution(self, cg_coords, cg_info)
