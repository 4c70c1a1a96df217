"""SchNet continuous-filter convolution embeddings and potentials (port
of ``vaemolsim_tpu/nn/schnet.py``; Schütt et al. 2018, J. Chem. Phys.
148, 241722).

Edge features are Gaussian radial-basis expansions of pair distances;
the filter-generating net is two Dense layers on the ``(N, N, n_rbf)``
grid, scaled by a smooth cosine cutoff, and each convolution is one
contraction over neighbours: dense masked tensors, no gather or
scatter.  Plain PyTorch in float32 (the JAX package runs these on XLA,
with no Pallas kernel).

* :class:`SchNetEmbedding`: a site-centred point cloud and per-particle
  info to a rotation-invariant embedding, call-compatible with
  ``ParticleEmbedding`` (so it drops into ``LocalParticleDescriptors``,
  ``BackmappingOnly`` and ``JointBackmapping``).  Each atom's input adds
  an RBF embedding of its distance to the site.
* :class:`SchNetPotential`: a machine-learned interatomic potential,
  per-atom energies summed, periodic by the minimum image; forces are
  ``-grad`` by autograd, so ``md.baoab`` and the HMC moves take
  ``as_potential(...)`` as they are.  :func:`energy_force_loss` matches
  energies and forces (second-order autograd when trained).

Pair distances are ``sqrt(r^2 + 1e-12)``, so coincident points keep a
finite gradient, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from vaemolsim_tpu_torch.config import default_device
from vaemolsim_tpu_torch.nn.core import Dense

Tensor = torch.Tensor

__all__ = ["SchNetEmbedding", "SchNetInteraction", "SchNetPotential",
           "gaussian_rbf", "cosine_cutoff", "shifted_softplus",
           "energy_and_forces", "energy_force_loss"]

_SSP = "shifted_softplus"


def shifted_softplus(x: Tensor) -> Tensor:
    """ssp(x) = softplus(x) - log 2 (SchNet's activation; ssp(0) = 0)."""
    return F.softplus(x) - math.log(2.0)


def gaussian_rbf(d: Tensor, n_rbf: int, cutoff: float) -> Tensor:
    """Gaussian radial basis of distances, ``(...,) -> (..., n_rbf)``:
    centres ``linspace(0, cutoff, n_rbf)``, ``gamma = 1 / spacing^2``."""
    centers = torch.linspace(0.0, float(cutoff), n_rbf, dtype=d.dtype,
                             device=d.device)
    spacing = float(cutoff) / max(n_rbf - 1, 1)
    gamma = 1.0 / (spacing * spacing)
    return torch.exp(-gamma * (d[..., None] - centers) ** 2)


def cosine_cutoff(d: Tensor, cutoff: float) -> Tensor:
    """Behler's smooth envelope: 0.5 (cos(pi d / r_c) + 1), 0 beyond."""
    env = 0.5 * (torch.cos(math.pi * torch.clamp(d, max=cutoff) / cutoff)
                 + 1.0)
    return torch.where(d < cutoff, env, torch.zeros_like(env))


def _pair_mask(n: int, mask: Optional[Tensor], device) -> Tensor:
    """(..., N, N) float: 1 for distinct real atoms, else 0."""
    pm = ~torch.eye(n, dtype=torch.bool, device=device)
    if mask is not None:
        pm = pm & mask[..., :, None] & mask[..., None, :]
    return pm.float()


class SchNetInteraction(nn.Module):
    """One continuous-filter convolution block with a residual update:
    ``x_i <- x_i + g(sum_j W(d_ij) * (A x_j))``, W the filter net (two
    ssp Dense layers on the RBFs, times the envelope and the pair mask),
    A a linear atom-wise map and g an atom-wise ssp MLP."""

    def __init__(self, atom_in: Dense, filter1: Dense, filter2: Dense,
                 out1: Dense, out2: Dense):
        super().__init__()
        self.atom_in, self.filter1, self.filter2 = atom_in, filter1, filter2
        self.out1, self.out2 = out1, out2

    @classmethod
    def create(cls, generator: torch.Generator, features: int, n_rbf: int,
               device=None) -> "SchNetInteraction":
        device = default_device(device)
        return cls(
            Dense.create(generator, features, features, device=device),
            Dense.create(generator, n_rbf, features, _SSP, device=device),
            Dense.create(generator, features, features, _SSP, device=device),
            Dense.create(generator, features, features, _SSP, device=device),
            Dense.create(generator, features, features, device=device))

    def forward(self, x: Tensor, rbf: Tensor, envelope: Tensor,
                pair_mask: Tensor) -> Tensor:
        """x (..., N, F); rbf (..., N, N, n_rbf); envelope and pair_mask
        (..., N, N) -> the updated x."""
        filt = self.filter2(self.filter1(rbf))
        filt = filt * (envelope * pair_mask)[..., None]
        msg = torch.einsum("...ijf,...jf->...if", filt, self.atom_in(x))
        return x + self.out2(self.out1(msg))


class SchNetEmbedding(nn.Module):
    """Site-centred point cloud + per-particle info -> an invariant
    embedding ``(..., embedding_dim)``: ``info_net`` on the info plus
    ``center_net`` on the RBFs of each atom's distance to the site,
    ``num_blocks`` interactions, an atom-wise ssp MLP and a masked pool
    (``"mean"``, bounded whatever the neighbourhood's size, or
    ``"sum"``).  ``mask_zero`` treats all-zero coordinate rows as
    padding (an explicit mask overrides it); a fully masked cloud embeds
    to zeros."""

    def __init__(self, info_net: Dense, center_net: Dense,
                 blocks: Sequence[SchNetInteraction], out1: Dense,
                 out2: Dense, n_rbf: int = 16, cutoff: float = 3.0,
                 mask_zero: bool = True, pool: str = "mean"):
        super().__init__()
        if pool not in ("mean", "sum"):
            raise ValueError(f"pool must be 'mean' or 'sum', got {pool!r}")
        self.info_net, self.center_net = info_net, center_net
        self.blocks = nn.ModuleList(blocks)
        self.out1, self.out2 = out1, out2
        self.n_rbf, self.cutoff = int(n_rbf), float(cutoff)
        self.mask_zero, self.pool = mask_zero, pool

    @classmethod
    def create(cls, generator: torch.Generator, info_dim: int,
               embedding_dim: int, features: int = 32, num_blocks: int = 2,
               n_rbf: int = 16, cutoff: float = 3.0, mask_zero: bool = True,
               pool: str = "mean", device=None) -> "SchNetEmbedding":
        if pool not in ("mean", "sum"):
            raise ValueError(f"pool must be 'mean' or 'sum', got {pool!r}")
        device = default_device(device)
        return cls(
            Dense.create(generator, info_dim, features, device=device),
            Dense.create(generator, n_rbf, features, device=device),
            [SchNetInteraction.create(generator, features, n_rbf, device)
             for _ in range(num_blocks)],
            Dense.create(generator, features, features, _SSP, device=device),
            Dense.create(generator, features, embedding_dim, device=device),
            n_rbf, cutoff, mask_zero, pool)

    def forward(self, coords: Tensor, particle_info: Tensor,
                mask: Optional[Tensor] = None) -> Tensor:
        if mask is None and self.mask_zero:
            mask = (coords != 0.0).any(-1)
        N = coords.shape[-2]
        diff = coords[..., :, None, :] - coords[..., None, :, :]
        d_pair = torch.sqrt((diff * diff).sum(-1) + 1e-12)
        d_site = torch.sqrt((coords * coords).sum(-1) + 1e-12)
        rbf = gaussian_rbf(d_pair, self.n_rbf, self.cutoff)
        env = cosine_cutoff(d_pair, self.cutoff)
        pair_mask = _pair_mask(N, mask, coords.device)
        x = (self.info_net(particle_info)
             + self.center_net(gaussian_rbf(d_site, self.n_rbf,
                                            self.cutoff)))
        for block in self.blocks:
            x = block(x, rbf, env, pair_mask)
        atomwise = self.out2(self.out1(x))
        if mask is not None:
            atomwise = atomwise * mask[..., None].to(atomwise.dtype)
        total = atomwise.sum(-2)
        if self.pool == "sum":
            return total
        if mask is None:
            return total / N
        count = mask.sum(-1, keepdim=True).clamp_min(1)
        return total / count.to(total.dtype)


class SchNetPotential(nn.Module):
    """A SchNet interatomic potential: per-atom energies from
    ``num_blocks`` interactions on ``species_net(species)``, scaled by a
    learnable ``e_scale`` plus a per-species reference energy ``e_ref``
    (linear in composition), summed over atoms.  ``box``: periodic
    lengths (minimum image on the pair differences, differentiable in
    the box) or None; ``mask`` (..., N): True for real atoms, padding
    contributes exactly zero."""

    def __init__(self, species_net: Dense,
                 blocks: Sequence[SchNetInteraction], out1: Dense,
                 out2: Dense, e_scale: Tensor, e_ref: Tensor,
                 n_rbf: int = 32, cutoff: float = 3.0):
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
               features: int = 32, num_blocks: int = 3, n_rbf: int = 32,
               cutoff: float = 3.0, device=None) -> "SchNetPotential":
        device = default_device(device)
        half = max(features // 2, 1)
        return cls(
            Dense.create(generator, species_dim, features, device=device),
            [SchNetInteraction.create(generator, features, n_rbf, device)
             for _ in range(num_blocks)],
            Dense.create(generator, features, half, _SSP, device=device),
            Dense.create(generator, half, 1, device=device),
            torch.ones((), device=device),
            torch.zeros(species_dim, device=device), n_rbf, cutoff)

    def atom_energies(self, x: Tensor, species: Tensor,
                      box: Optional[Tensor] = None,
                      mask: Optional[Tensor] = None) -> Tensor:
        """Per-atom energies ``(..., N)`` of ``x (..., N, 3)``; ``species
        (N, S)`` or ``(..., N, S)``."""
        N = x.shape[-2]
        diff = x[..., :, None, :] - x[..., None, :, :]
        if box is not None:
            b = torch.as_tensor(box, dtype=x.dtype,
                                device=x.device)[..., None, None, :]
            diff = diff - b * torch.round(diff / b)
        d_pair = torch.sqrt((diff * diff).sum(-1) + 1e-12)
        rbf = gaussian_rbf(d_pair, self.n_rbf, self.cutoff)
        env = cosine_cutoff(d_pair, self.cutoff)
        pair_mask = _pair_mask(N, mask, x.device)
        h = self.species_net(species).expand(
            x.shape[:-1] + (self.species_net.out_dim,))
        for block in self.blocks:
            h = block(h, rbf, env, pair_mask)
        e_atom = (self.e_scale * self.out2(self.out1(h))[..., 0]
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
        """``energy(x)`` with the chemistry closed over: the potential
        contract of ``potentials`` (``md.baoab``, the HMC moves,
        ``potentials.composite``, ``as_log_prob``)."""
        return lambda x: self(x, species, box, mask)

    def as_potential_for_box(self, species: Tensor,
                             mask: Optional[Tensor] = None):
        """``box -> energy(x)``, for volume moves and virial dilations."""
        return lambda box: (lambda x: self(x, species, box, mask))


def energy_and_forces(model: nn.Module, x: Tensor, species: Tensor,
                      box: Optional[Tensor] = None,
                      mask: Optional[Tensor] = None):
    """``(E, F)``: the potential's energies and forces ``F = -grad_x
    sum(E)``, the force by ``torch.func.grad``, so that it runs inside
    ``torch.func`` transforms (a committee's ``vmap``, a trainer's
    ``grad``) and, outside them, stays differentiable in the weights and
    in ``x`` wherever grad mode records them."""
    def total(xx):
        e = model(xx, species, box, mask)
        return e.sum(), e

    g, e = torch.func.grad(total, has_aux=True)(x)
    return e, -g


def energy_force_loss(model: nn.Module, x: Tensor, species: Tensor,
                      energy: Tensor, forces: Tensor, *,
                      box: Optional[Tensor] = None,
                      mask: Optional[Tensor] = None,
                      w_energy: float = 1.0,
                      w_force: float = 1.0) -> Tensor:
    """``(w_e / N) mean_b (E_pred - E)^2 + (w_f / 3N) mean_b |F_pred -
    F|^2`` with ``F_pred = -grad_x E_pred`` (:func:`energy_and_forces`,
    so the loss differentiates in the weights through the forces, under
    autograd and under ``torch.func.grad`` alike).  ``model`` is any ML
    potential with the contract ``model(x, species, box, mask) ->
    energy``: a :class:`SchNetPotential` or a
    :class:`~vaemolsim_tpu_torch.nn.painn.PaiNNPotential`."""
    if mask is None:
        n_eff = float(x.shape[-2])
    else:
        n_eff = mask.sum(-1).clamp_min(1).to(x.dtype)
    e_pred, f_pred = energy_and_forces(model, x, species, box, mask)
    e_term = ((e_pred - energy) ** 2 / n_eff).mean()
    df = (f_pred - forces) ** 2
    if mask is not None:
        df = df * mask[..., None].to(df.dtype)
    f_term = (df.sum((-2, -1)) / (3.0 * n_eff)).mean()
    return w_energy * e_term + w_force * f_term
