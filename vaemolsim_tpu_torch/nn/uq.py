"""Committee (deep-ensemble) uncertainty for ML potentials (port of
``vaemolsim_tpu/nn/uq.py``; Lakshminarayanan et al. 2017, Schran et al.
2020).

K independently initialized potentials (``SchNetPotential``,
``PaiNNPotential``, or any member with the contract ``member(x,
species, box, mask) -> energy``), stacked by ``train.stack_models`` (a
``ModelStack``; a sequence of members is stacked for the call only,
the members untouched), are evaluated as one ``torch.func.vmap`` over
the member axis, as the JAX package ``vmap``s its stack; the
committee's force disagreement is the error signal of active learning.
Forces are ``-grad`` of the summed energy
(``nn.schnet.energy_and_forces``); when grad mode is on the graph is
kept to ``x`` and to the members' weights (a ``ModelStack``'s stacked
parameters, or each member's own), for a gradient of the uncertainty.  Standard deviations
and variances are the population ones (``correction=0``), as the JAX
package's ``jnp.std`` / ``jnp.var``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from vaemolsim_tpu_torch.members import (ModelStack, stacked_state,
                                         vmap_members)
from vaemolsim_tpu_torch.nn.schnet import energy_and_forces

Tensor = torch.Tensor

__all__ = ["EnsemblePrediction", "ensemble_energy_forces",
           "max_force_uncertainty"]


class EnsemblePrediction(NamedTuple):
    """Committee statistics over frames ``(..., N, 3)``: the mean
    ``energy`` and ``forces`` (the deployment prediction), the per-frame
    std of the total energy, and ``force_std``, ``sqrt(mean_{atoms, xyz}
    Var_K[F])``."""

    energy: Tensor        # (...,)
    forces: Tensor        # (..., N, 3)
    energy_std: Tensor    # (...,)
    force_std: Tensor     # (...,)


def _energies_forces(model_stack: Sequence[torch.nn.Module], x: Tensor,
                     species: Tensor, box: Optional[Tensor],
                     mask: Optional[Tensor]):
    """Every member's energies (K, ...) and forces (K, ..., N, 3): one
    vmapped call over the stack's member axis (a sequence's members
    stacked for the call only, left as they are)."""
    def member(m, xx):
        return energy_and_forces(m, xx, species, box, mask)

    if isinstance(model_stack, ModelStack):
        e, f = model_stack.vmap(member, x)
    else:
        members = list(model_stack)
        e, f = vmap_members(members[0], stacked_state(members), member, x)
    if not torch.is_grad_enabled():
        e, f = e.detach(), f.detach()
    return e, f


def ensemble_energy_forces(model_stack: Sequence[torch.nn.Module],
                           x: Tensor, species: Tensor,
                           box: Optional[Tensor] = None,
                           mask: Optional[Tensor] = None
                           ) -> EnsemblePrediction:
    """The committee's mean and spread on frames ``x (..., N, 3)``.
    Padding atoms (``mask`` False) add nothing to the force
    disagreement's average."""
    e_k, f_k = _energies_forces(model_stack, x, species, box, mask)
    e_std = e_k.std(0, correction=0)
    f_var = f_k.var(0, correction=0)                        # (..., N, 3)
    if mask is not None:
        f_var = f_var * mask[..., None].to(f_var.dtype)
        n_eff = 3.0 * mask.sum(-1).clamp_min(1)
        f_std = torch.sqrt(f_var.sum((-2, -1)) / n_eff)
    else:
        f_std = torch.sqrt(f_var.mean((-2, -1)))
    return EnsemblePrediction(energy=e_k.mean(0), forces=f_k.mean(0),
                              energy_std=e_std, force_std=f_std)


def max_force_uncertainty(model_stack: Sequence[torch.nn.Module],
                          x: Tensor, species: Tensor,
                          box: Optional[Tensor] = None,
                          mask: Optional[Tensor] = None) -> Tensor:
    """Per frame, the largest atom's committee force std, ``max_i
    sqrt(mean_xyz Var_K[F_i])``: one poorly described atom flags the
    frame."""
    _, f_k = _energies_forces(model_stack, x, species, box, mask)
    per_atom = torch.sqrt(f_k.var(0, correction=0).mean(-1))
    if mask is not None:
        per_atom = per_atom * mask.to(per_atom.dtype)
    return per_atom.amax(-1)
