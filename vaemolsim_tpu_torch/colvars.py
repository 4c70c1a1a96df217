"""Differentiable collective variables (port of
``vaemolsim_tpu/colvars.py``).

Every biasing engine (:mod:`~vaemolsim_tpu_torch.metadynamics`,
:mod:`~vaemolsim_tpu_torch.opes`, :mod:`~vaemolsim_tpu_torch.abf`) takes
a scalar ``cv_fn: (..., n_atoms, dim) -> (...)`` whose gradient drives the
bias force.  Each factory here returns such a closure over STATIC index
and weight arrays.  The closure places them on the coordinates' device
once and reuses them, so a step that calls it can be captured as a CUDA
graph (no copy from the host inside the step).  ``rmsd_to`` runs a batched
SVD, which checks its convergence on the host: it is not capturable.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from vaemolsim_tpu_torch import coords as _coords
from vaemolsim_tpu_torch.observables import kabsch_align

Tensor = torch.Tensor
CVFn = Callable[[Tensor], Tensor]

__all__ = [
    "distance", "angle", "torsion", "projection", "gyration_radius",
    "coordination_number", "rmsd_to", "linear_combination", "cv_gradient",
]


class _Static:
    """A static array, placed on each (device, dtype) it is asked for once
    and kept there."""

    def __init__(self, a, dtype=None):
        self.a = torch.as_tensor(np.asarray(a), dtype=dtype)
        self._on = {}

    def on(self, like: Tensor, dtype=None) -> Tensor:
        dtype = dtype or (self.a.dtype if not self.a.is_floating_point()
                          else like.dtype)
        key = (like.device, dtype)
        t = self._on.get(key)
        if t is None:
            t = self._on[key] = self.a.to(device=like.device, dtype=dtype)
        return t


def _indices(i) -> _Static:
    return _Static([int(i)] if np.ndim(i) == 0 else list(i), torch.long)


def _min_image(d: Tensor, box: Optional[_Static]) -> Tensor:
    if box is None:
        return d
    b = box.on(d)
    return d - b * torch.round(d / b)


def _group_mean(x: Tensor, idx: _Static, weights: Optional[_Static]
                ) -> Tensor:
    """(Weighted) centroid of the atoms in ``idx``: (..., len(idx), d)
    -> (..., d)."""
    g = x[..., idx.on(x), :]
    if weights is None:
        return g.mean(-2)
    w = weights.on(g)
    w = w / w.sum()
    return (w[:, None] * g).sum(-2)


def _maybe(a) -> Optional[_Static]:
    return None if a is None else _Static(a, torch.float32)


def distance(i, j, *, box=None, weights_i=None, weights_j=None) -> CVFn:
    """|r_i - r_j| between two atoms or (weighted) group centroids.

    ``i``/``j``: an atom index or an index sequence (group -> centroid,
    optionally mass-weighted by ``weights_*``).  ``box``: minimum image
    for the separation vector; group centroids are computed on the
    unwrapped coordinates, so a group must not straddle the boundary."""
    i_idx, j_idx = _indices(i), _indices(j)
    w_i, w_j, b = _maybe(weights_i), _maybe(weights_j), _maybe(box)

    def cv(x: Tensor) -> Tensor:
        d = _min_image(_group_mean(x, i_idx, w_i)
                       - _group_mean(x, j_idx, w_j), b)
        return torch.sqrt((d * d).sum(-1) + 1e-12)

    return cv


def angle(i: int, j: int, k: int) -> CVFn:
    """Bond angle at vertex ``j`` (radians, in (0, pi)), by
    :func:`coords.bond_angles`' atan2 form."""
    triple = _Static([[i, j, k]], torch.long)

    def cv(x: Tensor) -> Tensor:
        return _coords.bond_angles(x, triple.on(x))[..., 0]

    return cv


def torsion(i: int, j: int, k: int, l: int) -> CVFn:  # noqa: E741
    """Signed dihedral about the j-k axis, in [-pi, pi]: a PERIODIC CV
    (give the bias engines periodic grids).  The sign convention of
    :func:`coords.dihedrals`."""
    quad = _Static([[i, j, k, l]], torch.long)

    def cv(x: Tensor) -> Tensor:
        return _coords.dihedrals(x, quad.on(x))[..., 0]

    return cv


def projection(i, axis=(0.0, 0.0, 1.0), *, weights=None) -> CVFn:
    """Position of atom/group-centroid ``i`` along a (normalized)
    ``axis``."""
    i_idx, w = _indices(i), _maybe(weights)
    ax = torch.as_tensor(np.asarray(axis, np.float32))
    ax = _Static(ax / torch.sqrt((ax * ax).sum()))

    def cv(x: Tensor) -> Tensor:
        return (_group_mean(x, i_idx, w) * ax.on(x)).sum(-1)

    return cv


def gyration_radius(idx=None, *, weights=None) -> CVFn:
    """(Mass-weighted) radius of gyration of ``idx`` (default: all
    atoms): sqrt(sum_a w_a |r_a - r_com|^2)."""
    sel = None if idx is None else _indices(idx)
    wts = _maybe(weights)

    def cv(x: Tensor) -> Tensor:
        g = x if sel is None else x[..., sel.on(x), :]
        n = g.shape[-2]
        if wts is None:
            w = torch.full((n,), 1.0 / n, dtype=g.dtype, device=g.device)
        else:
            w = wts.on(g)
            w = w / w.sum()
        com = (w[:, None] * g).sum(-2, keepdim=True)
        return torch.sqrt((w * ((g - com) ** 2).sum(-1)).sum(-1) + 1e-12)

    return cv


def coordination_number(group_a, group_b, *, r0: float,
                        n: int = 6, m: Optional[int] = None,
                        box=None, d0: float = 0.0) -> CVFn:
    """Smooth pair count between two atom groups (PLUMED COORDINATION):
    the sum over pairs of ``s(r) = (1 - u^n) / (1 - u^m)``, ``u = (r -
    d0) / r0``, ``m = 2n`` by default.  Near the removable singularity
    ``u == 1`` the first-order expansion about it (value n/m, slope
    n(n-m)/(2m)) is used, and the far branch sees a safe ``u`` there, so
    neither its value nor its gradient turns NaN.  Self pairs (an atom in
    both groups) are excluded."""
    a_idx = _Static(list(group_a), torch.long)
    b_idx = _Static(list(group_b), torch.long)
    mm = 2 * n if m is None else m
    self_pair = _Static(np.asarray(list(group_a))[:, None]
                        == np.asarray(list(group_b))[None, :])
    b = _maybe(box)

    def cv(x: Tensor) -> Tensor:
        ga = x[..., a_idx.on(x), :]
        gb = x[..., b_idx.on(x), :]
        d = _min_image(ga[..., :, None, :] - gb[..., None, :, :], b)
        r = torch.sqrt((d * d).sum(-1) + 1e-12)
        u = torch.clamp((r - d0) / r0, min=0.0)
        near = torch.abs(u - 1.0) < 1e-4
        u_safe = torch.where(near, 0.5, u)
        s_far = (1.0 - u_safe ** n) / (1.0 - u_safe ** mm)
        s_near = (n / mm) * (1.0 + 0.5 * (n - mm) * (u - 1.0))
        s = torch.where(near, s_near, s_far)
        s = torch.where(self_pair.on(x, torch.bool), 0.0, s)
        return s.sum((-2, -1))

    return cv


def rmsd_to(reference, *, weights=None) -> CVFn:
    """Kabsch-superposed (mass-weighted) RMSD to a reference structure,
    differentiable through the batched SVD (avoid exactly degenerate
    references)."""
    ref = _Static(torch.as_tensor(np.asarray(reference)))
    w = _maybe(weights)

    def cv(x: Tensor) -> Tensor:
        return kabsch_align(x, ref.on(x), None if w is None else w.on(x))[2]

    return cv


def linear_combination(cvs: Sequence[CVFn], coeffs: Sequence[float]) -> CVFn:
    """``sum_k c_k cv_k(x)``, e.g. a distance difference d1 - d2."""
    cs = [float(c) for c in coeffs]
    if len(cs) != len(cvs):
        raise ValueError(f"{len(cvs)} CVs but {len(cs)} coefficients")

    def cv(x: Tensor) -> Tensor:
        total = cs[0] * cvs[0](x)
        for c, f in zip(cs[1:], cvs[1:]):
            total = total + c * f(x)
        return total

    return cv


def cv_gradient(cv_fn: CVFn) -> Callable[[Tensor], tuple]:
    """``x -> (s, grad_x s)``, the gradient of each replica's CV with
    respect to its own coordinates (JAX's vjp with ones)."""

    def both(x: Tensor):
        xg = x.detach().requires_grad_(True)
        with torch.enable_grad():
            s = cv_fn(xg)
            (gs,) = torch.autograd.grad(s.sum(), xg)
        return s.detach(), gs

    return both
