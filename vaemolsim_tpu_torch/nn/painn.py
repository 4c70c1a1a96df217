"""PaiNN: an E(3)-equivariant message-passing interatomic potential (port
of ``vaemolsim_tpu/nn/painn.py``; Schütt, Unke & Gastegger, ICML 2021).

Each atom carries scalar features ``s (..., N, F)`` and vector features
``v (..., N, 3, F)`` that rotate with the frame; messages mix the unit
pair directions into the vectors, and the updates couple vectors back
into scalars only through invariant contractions (``<Uv, Vv>``,
``|Vv|``), so the energy is exactly invariant and its autograd forces
equivariant.  The ``(N, N)`` pair grid is dense and masked, as in
:mod:`~vaemolsim_tpu_torch.nn.schnet`; the vector mixes ``U`` and ``V``
are bias-free parameters (a bias on an equivariant channel would break
covariance).  Plain PyTorch in float32: the JAX package computes these
products outside any Pallas kernel.

Pair distances are ``sqrt(r^2 + 1e-12)`` (so a pair's own direction is
exactly 0) and the vector norm ``sqrt(sum w^2 + 1e-12)``: gradients stay
finite at ``v = 0``, where every fresh model starts.  The contract is
``SchNetPotential``'s: ``forward(x, species, box, mask)``,
``atom_energies``, ``as_potential`` and ``as_potential_for_box``, and
:func:`~vaemolsim_tpu_torch.nn.schnet.energy_force_loss` trains it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from vaemolsim_tpu_torch.config import default_device
from vaemolsim_tpu_torch.nn.core import Dense, glorot_uniform
from vaemolsim_tpu_torch.nn.schnet import (_pair_mask, cosine_cutoff,
                                           gaussian_rbf)

Tensor = torch.Tensor

__all__ = ["PaiNNBlock", "PaiNNPotential"]


class PaiNNBlock(nn.Module):
    """One PaiNN message and update block, both residual.

    Message: the filter ``W = filter_net(rbf) * envelope * pair_mask``
    and ``phi = phi2(phi1(s_j))`` (3F channels each, split in three):
    ``ds_i = sum_j phi1_j W1_ij``, ``dv_i = sum_j phi2_j W2_ij v_j +
    sum_j phi3_j W3_ij r_ij / |r_ij|``.  Update: ``u = v U``, ``w = v
    V``, ``a = upd2(upd1([s, |w|]))`` split in three: ``ds = a1 + a2
    <u, w>``, ``dv = a3 u``."""

    def __init__(self, phi1: Dense, phi2: Dense, filter_net: Dense,
                 U: Tensor, V: Tensor, upd1: Dense, upd2: Dense):
        super().__init__()
        self.phi1, self.phi2, self.filter_net = phi1, phi2, filter_net
        self.U = nn.Parameter(torch.as_tensor(U, dtype=torch.float32))
        self.V = nn.Parameter(torch.as_tensor(V, dtype=torch.float32))
        self.upd1, self.upd2 = upd1, upd2

    @classmethod
    def create(cls, generator: torch.Generator, features: int, n_rbf: int,
               device=None) -> "PaiNNBlock":
        device = default_device(device)
        F = features
        return cls(
            Dense.create(generator, F, F, "swish", device=device),
            Dense.create(generator, F, 3 * F, device=device),
            Dense.create(generator, n_rbf, 3 * F, device=device),
            glorot_uniform(generator, (F, F), device=device),
            glorot_uniform(generator, (F, F), device=device),
            Dense.create(generator, 2 * F, F, "swish", device=device),
            Dense.create(generator, F, 3 * F, device=device))

    def forward(self, s: Tensor, v: Tensor, rbf: Tensor, direction: Tensor,
                envelope: Tensor, pair_mask: Tensor
                ) -> Tuple[Tensor, Tensor]:
        """``s (..., N, F)``, ``v (..., N, 3, F)``, ``rbf (..., N, N,
        n_rbf)``, ``direction (..., N, N, 3)`` (unit ``r_j - r_i``),
        ``envelope`` and ``pair_mask (..., N, N)`` -> the updated (s, v)."""
        F = s.shape[-1]
        # --- message: each weight meets its scalar gate first, so no
        # (..., N, N, 3, F) tensor is built.
        W = self.filter_net(rbf) * (envelope * pair_mask)[..., None]
        phi = self.phi2(self.phi1(s))
        w1, w2, w3 = torch.split(W, F, -1)                  # (..., N, N, F)
        p1, p2, p3 = torch.split(phi, F, -1)                # (..., N, F)
        ds = torch.einsum("...ijf,...jf->...if", w1, p1)
        dv = (torch.einsum("...ijf,...jdf->...idf", w2, p2[..., None, :] * v)
              + torch.einsum("...ijf,...ijd->...idf",
                             w3 * p3[..., None, :, :], direction))
        s = s + ds
        v = v + dv
        # --- update (atom-wise)
        u = v @ self.U                                      # (..., N, 3, F)
        w = v @ self.V
        w_norm = torch.sqrt((w * w).sum(-2) + 1e-12)        # (..., N, F)
        a = self.upd2(self.upd1(torch.cat([s, w_norm], -1)))
        a1, a2, a3 = torch.split(a, F, -1)
        s = s + a1 + a2 * (u * w).sum(-2)
        v = v + a3[..., None, :] * u
        return s, v


class PaiNNPotential(nn.Module):
    """An E(3)-equivariant machine-learned potential: per-atom energies
    ``e_scale * out2(out1(s)) + species @ e_ref`` after ``num_blocks``
    PaiNN blocks on ``species_net(species)``, summed over atoms.
    ``species``: per-atom feature vectors ``(N, S)`` or ``(..., N, S)``;
    ``box``: periodic lengths (minimum image, differentiable in the box)
    or None; ``mask (..., N)``: True for real atoms, padding contributes
    exactly zero."""

    def __init__(self, species_net: Dense, blocks: Sequence[PaiNNBlock],
                 out1: Dense, out2: Dense, e_scale: Tensor, e_ref: Tensor,
                 n_rbf: int = 20, cutoff: float = 3.0):
        super().__init__()
        self.species_net = species_net
        self.blocks = nn.ModuleList(blocks)
        self.out1, self.out2 = out1, out2
        self.e_scale = nn.Parameter(torch.as_tensor(e_scale,
                                                    dtype=torch.float32))
        self.e_ref = nn.Parameter(torch.as_tensor(e_ref,
                                                  dtype=torch.float32))
        self.n_rbf, self.cutoff = int(n_rbf), float(cutoff)

    @classmethod
    def create(cls, generator: torch.Generator, species_dim: int,
               features: int = 32, num_blocks: int = 2, n_rbf: int = 20,
               cutoff: float = 3.0, device=None) -> "PaiNNPotential":
        device = default_device(device)
        half = max(features // 2, 1)
        return cls(
            Dense.create(generator, species_dim, features, device=device),
            [PaiNNBlock.create(generator, features, n_rbf, device)
             for _ in range(num_blocks)],
            Dense.create(generator, features, half, "swish", device=device),
            Dense.create(generator, half, 1, device=device),
            torch.ones((), device=device),
            torch.zeros(species_dim, device=device), n_rbf, cutoff)

    def atom_energies(self, x: Tensor, species: Tensor,
                      box: Optional[Tensor] = None,
                      mask: Optional[Tensor] = None) -> Tensor:
        """Per-atom energies ``(..., N)`` of ``x (..., N, 3)``."""
        N = x.shape[-2]
        diff = x[..., None, :, :] - x[..., :, None, :]      # r_j - r_i rows
        if box is not None:
            b = torch.as_tensor(box, dtype=x.dtype,
                                device=x.device)[..., None, None, :]
            diff = diff - b * torch.round(diff / b)
        d_pair = torch.sqrt((diff * diff).sum(-1) + 1e-12)
        direction = diff / d_pair[..., None]
        rbf = gaussian_rbf(d_pair, self.n_rbf, self.cutoff)
        env = cosine_cutoff(d_pair, self.cutoff)
        pair_mask = _pair_mask(N, mask, x.device).to(rbf.dtype)
        F = self.species_net.out_dim
        s = self.species_net(species).expand(x.shape[:-1] + (F,))
        v = torch.zeros(x.shape[:-1] + (3, F), dtype=x.dtype,
                        device=x.device)
        for block in self.blocks:
            s, v = block(s, v, rbf, direction, env, pair_mask)
        e_atom = (self.e_scale * self.out2(self.out1(s))[..., 0]
                  + species @ self.e_ref)
        if mask is not None:
            e_atom = e_atom * mask.to(e_atom.dtype)
        return e_atom

    def forward(self, x: Tensor, species: Tensor,
                box: Optional[Tensor] = None,
                mask: Optional[Tensor] = None) -> Tensor:
        """Total potential energy, of the batch shape of ``x``."""
        return self.atom_energies(x, species, box, mask).sum(-1)

    def as_potential(self, species: Tensor, box: Optional[Tensor] = None,
                     mask: Optional[Tensor] = None):
        """``energy(x)`` with the chemistry closed over (``md.baoab``, the
        HMC moves, ``potentials.composite``)."""
        return lambda x: self(x, species, box, mask)

    def as_potential_for_box(self, species: Tensor,
                             mask: Optional[Tensor] = None):
        """``box -> energy(x)``, for volume moves and virial dilations."""
        return lambda box: (lambda x: self(x, species, box, mask))
