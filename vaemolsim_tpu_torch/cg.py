"""Coarse-grained force matching (multiscale coarse-graining, MS-CG) and
relative-entropy coarse-graining (port of ``vaemolsim_tpu/cg.py``).

The force-matching variational principle (Izvekov & Voth, J. Phys. Chem.
B 109, 2469 (2005); Noid et al., J. Chem. Phys. 128, 244114 (2008)),

    min_F  E_{x~p_FG} | F(M(x)) - F_mapped(x) |^2,

is minimized by the mean force of the many-body PMF, so regressing mapped
instantaneous forces yields the thermodynamically consistent CG
potential.  For a centre-of-mass mapping (per-site weights summing to 1)
the consistent mapped force on site I is the plain sum of its atoms'
forces: one (S, N) matrix product (:func:`force_aggregation_matrix`,
:func:`map_forces`).  Pair the mapped data with a differentiable CG
potential (``nn.SchNetPotential``; :func:`force_matching_loss`
differentiates through it), then run CG MD with the port's samplers.
:func:`rel_entropy_fit` fits a CG potential to the mapped distribution
itself (Shell 2008).  End-to-end workflow:
``examples/18_cg_force_matching.py``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from vaemolsim_tpu_torch.config import default_device
from vaemolsim_tpu_torch.difftre import _detached, _f32_value, _trainable

Tensor = torch.Tensor

__all__ = ["force_aggregation_matrix", "map_forces",
           "force_matching_loss", "rel_entropy_loss",
           "rel_entropy_fit", "RelEntropyResult"]


def force_aggregation_matrix(res_atom_nums: Sequence[int],
                             device=None) -> Tensor:
    """(n_sites, n_atoms) 0/1 block matrix summing the atoms of a site, on
    ``device`` (the CUDA card unless given).

    This is the force map ``d_{I,i}`` consistent with any coordinate map
    whose per-site weights sum to one (centroid, centre of mass): the
    MS-CG constraint ``sum_i c_{I,i} = 1  =>  d_{I,i} = 1`` for the atoms
    of site I (Noid et al. 2008, eq. 10-12)."""
    nums = [int(n) for n in res_atom_nums]
    agg = np.zeros((len(nums), sum(nums)), np.float32)
    start = 0
    for i, n in enumerate(nums):
        agg[i, start:start + n] = 1.0
        start += n
    return torch.as_tensor(agg, device=default_device(device))


def map_forces(agg: Tensor, forces: Tensor) -> Tensor:
    """Aggregate atomistic forces to CG sites, ``(..., N, 3) -> (..., S,
    3)``, by the (S, N) matrix of :func:`force_aggregation_matrix`."""
    return torch.einsum("ra,...ad->...rd", agg, forces)


def force_matching_loss(model: Any, R: Tensor, species: Tensor,
                        f_cg: Tensor, *,
                        box: Optional[Tensor] = None,
                        mask: Optional[Tensor] = None,
                        model_fn: Optional[Callable] = None) -> Tensor:
    """MS-CG objective: the per-site mean squared difference between the
    model's CG forces and the mapped atomistic forces,
    ``mean_b |(-grad_R E_model(R)) - f_cg|^2 / (3 S)``, over the real
    sites of ``mask`` where given.  The residual at the optimum is the
    PMF's fluctuation floor, so train to convergence of a validation loss,
    not to zero.

    ``model``: an ``nn.SchNetPotential`` (or any module with its
    ``model(x, species, box, mask)`` contract; ``model_fn(model, x)``
    overrides how the energy is computed).  The force is taken with
    ``create_graph`` under grad mode, so the loss is differentiable in the
    model's parameters."""
    if model_fn is None:
        def model_fn(m, x):
            return m(x, species, box, mask)

    create = torch.is_grad_enabled()
    x = R.detach().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(model_fn(model, x).sum(), x,
                                   create_graph=create)
    df = (-g - f_cg) ** 2
    if mask is not None:
        df = df * mask[..., None].to(df.dtype)
        n_eff = mask.sum(-1).clamp_min(1).to(df.dtype)
    else:
        n_eff = R.shape[-2]
    return (df.sum((-2, -1)) / (3.0 * n_eff)).mean()


# --- relative-entropy coarse-graining (Shell 2008) ---------------------

def rel_entropy_loss(potential: Callable, params: Any,
                     mapped_frames: Tensor, cg_frames: Tensor,
                     u_ref: Tensor, *, beta: float = 1.0):
    """Reweighted relative-entropy objective for CG potential fitting
    (Shell, J. Chem. Phys. 129, 144108 (2008)): up to a
    parameter-independent constant

        S_rel(theta) = beta < U_theta >_{AA-mapped} + ln Z_theta,

    with ``ln Z_theta - ln Z_ref = ln < exp(-beta (U_theta - U_ref))
    >_ref`` estimated on CG configurations generated at the reference
    parameters (``u_ref``: their energies there).  Its gradient is the
    exact ``beta (<dU/dtheta>_mapped - <dU/dtheta>_{theta, reweighted})``
    wherever the reweighting overlaps.  Returns ``(loss, ess)``;
    regenerate CG frames when ``ess`` collapses (:func:`rel_entropy_fit`).
    ``potential(params, frames) -> (n,)`` batched reduced energies, as in
    ``difftre``."""
    u_mapped = potential(params, mapped_frames)
    u_cg = potential(params, cg_frames)
    logw = -beta * (u_cg - u_ref)
    lse = torch.logsumexp(logw, 0)
    log_mean = lse - math.log(u_cg.shape[0])
    w = torch.exp(logw - lse)
    ess = 1.0 / (w * w).sum()
    loss = beta * u_mapped.mean() + log_mean
    return loss, ess


class RelEntropyResult(NamedTuple):
    """Output of :func:`rel_entropy_fit`.

    params: the optimized CG-potential parameters
    loss_history: (n_outer,) relative-entropy estimate after each round,
        comparable across rounds up to one additive constant (``ln Z`` of
        the starting parameters): each round's ``ln Z`` increment is
        chained by exponential reweighting on that round's frames, so a
        falling history means Srel is falling
    ess_history: (n_outer,) effective sample size at each round's end
    """
    params: Any
    loss_history: Tensor
    ess_history: Tensor


def rel_entropy_fit(potential: Callable, params: Any, *,
                    mapped_frames: Tensor, sample_fn: Callable,
                    beta: float, generator: torch.Generator,
                    n_outer: int = 10, inner_steps: int = 30,
                    ess_frac: float = 0.5,
                    optimizer: Optional[Callable] = None,
                    learning_rate: float = 1e-2,
                    sample_state: Any = None) -> RelEntropyResult:
    """Srel minimization: outer rounds regenerate CG configurations at the
    current parameters by ``sample_fn(params, generator, sample_state) ->
    (cg_frames, sample_state)`` (detached parameters); each inner phase
    takes optimizer steps on :func:`rel_entropy_loss` until
    ``inner_steps`` or until the reweighting ESS falls below ``ess_frac *
    n``.  The ESS guard is strict: a step whose ESS is below the floor is
    not applied (neither the parameters nor the optimizer's state move),
    and the phase ends there.  ``optimizer``: a factory ``params ->
    torch.optim.Optimizer``, built once per fit; by default Adam at
    ``learning_rate``."""
    leaves, opt, live = _trainable(params, optimizer, learning_rate)
    losses, esses = [], []
    cum_lnz = 0.0
    for _ in range(n_outer):
        fixed = _detached(params, leaves)
        cg_frames, sample_state = sample_fn(fixed, generator, sample_state)
        n = cg_frames.shape[0]
        floor = _f32_value(ess_frac * n)
        with torch.no_grad():
            u_ref = potential(fixed, cg_frames)
        steps, ess = 0, float(n)
        while steps < inner_steps and ess >= floor:
            opt.zero_grad(set_to_none=True)
            loss, ess_t = rel_entropy_loss(potential, live, mapped_frames,
                                           cg_frames, u_ref, beta=beta)
            loss.backward()
            ess = float(ess_t.detach())
            if ess >= floor:
                opt.step()
            steps += 1
        with torch.no_grad():
            # The gauge at the round's end: this round's frames reweighted
            # from their generating parameters to the updated ones.
            fixed = _detached(params, leaves)
            u_new = potential(fixed, cg_frames)
            dlnz = (torch.logsumexp(-beta * (u_new - u_ref), 0)
                    - math.log(n))
            mean_u = beta * potential(fixed, mapped_frames).mean()
        cum_lnz += float(dlnz)
        losses.append(float(mean_u) + cum_lnz)
        esses.append(ess)
    dev = leaves[0].device
    return RelEntropyResult(
        _detached(params, leaves),
        torch.tensor(losses, dtype=torch.float32, device=dev),
        torch.tensor(esses, dtype=torch.float32, device=dev))
