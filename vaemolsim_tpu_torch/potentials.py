"""Molecular potential-energy terms (port of ``vaemolsim_tpu/potentials.py``,
the molecular MD slice).

Every term is a function ``energy(x) -> (...,)`` of coordinates ``(...,
n_atoms, 3)``, differentiable by autograd; the cell-list pair term takes
its neighbour list first, ``energy(nl, x)``.  Energies are in reduced
units.  The constructors build their tables (neighbour-cell table,
exclusion table, per-atom sigma / sqrt(epsilon), charges, bond lists,
the PME influence function) on ``config.default_device(device)``: the
CUDA card unless a device is given, and an error without one.

Ported: the bonded terms (``harmonic_bonds``, ``harmonic_angles``,
``periodic_torsions``, ``morse_bonds``, ``harmonic_impropers``),
``exclusions_from_bonds``, the dense pair terms (``lennard_jones``, the
independent O(N^2) reference, ``lennard_jones_softcore``, ``buckingham``,
``coulomb``), ``lennard_jones_tail``, the classic ``ewald_coulomb``,
``composite``, ``com_restraint``, ``as_log_prob``, ``minimize_energy``
(with its L-BFGS polish), ``CellNeighborList`` /
``lennard_jones_cell_neighbor`` with ``lennard_jones_cell``, and
``pme_coulomb`` on an orthorhombic box or a static triclinic cell.  The
dense periodic factories take a tensor ``box`` (kept in the autograd
graph: NPT moves, virial dilations).  The
cell-list energy runs the cell-pair kernel (``ops/cell_lj.py``) on the
card: the neighbour list is always built in the kernel's cell layout,
and there is no other route (the JAX ``backend=`` and ``interpret=``
options are not ported).  ROADMAP.md lists what is still to come.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from vaemolsim_tpu_torch.config import default_device
from vaemolsim_tpu_torch.coords import dihedrals
from vaemolsim_tpu_torch.ops.cell_lj import SLOPE_F, cell_pair_energy_force

Tensor = torch.Tensor

__all__ = ["harmonic_bonds", "harmonic_angles", "periodic_torsions",
           "lennard_jones", "lennard_jones_softcore",
           "lennard_jones_cell", "lennard_jones_cell_neighbor",
           "lennard_jones_tail", "CellNeighborList", "coulomb",
           "ewald_coulomb", "pme_coulomb", "com_restraint", "composite",
           "as_log_prob", "exclusions_from_bonds", "minimize_energy",
           "morse_bonds", "harmonic_impropers", "buckingham"]

_EPS = 1e-12  # guards sqrt gradients at coincident points
_TWO_OPI = 2.0 / math.sqrt(math.pi)
_MESH = "ROADMAP.md, Queue 1 item 4, slice 14"


def _f32(a, device) -> Tensor:
    """A host-side constant (a number, list or numpy array) as float32 on
    ``device``; parameters go through :func:`_param_arg`."""
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _param_arg(a, device) -> Tensor:
    """A force-field parameter: a tensor becomes float32 on ``device``
    with its autograd graph kept (parameters fitted through the energy,
    as DiffTRe does), anything else goes through :func:`_f32`."""
    if isinstance(a, Tensor):
        return a.to(device=device, dtype=torch.float32)
    return _f32(a, device)


def _norm(d: Tensor) -> Tensor:
    return torch.sqrt((d * d).sum(-1).clamp_min(_EPS))


def harmonic_bonds(bonds, k, r0, device=None) -> Callable[[Tensor], Tensor]:
    """Harmonic bond-stretch term ``sum_b k_b/2 (|r_i - r_j| - r0_b)^2``.
    ``bonds``: (B, 2) atom-index pairs; ``k`` / ``r0``: scalars or (B,)."""
    bonds = np.asarray(bonds, np.int64)
    if bonds.ndim != 2 or bonds.shape[1] != 2:
        raise ValueError(f"bonds must be (B, 2); got {bonds.shape}")
    dev = default_device(device)
    i = torch.as_tensor(bonds[:, 0], device=dev)
    j = torch.as_tensor(bonds[:, 1], device=dev)
    k = _param_arg(k, dev)
    r0 = _param_arg(r0, dev)

    def energy(x: Tensor) -> Tensor:
        r = _norm(x[..., i, :] - x[..., j, :])
        return (0.5 * k * (r - r0) ** 2).sum(-1)

    return energy


def _index_pairs(idx, width: int, what: str, dev) -> Tuple[Tensor, ...]:
    """Columns of an (M, width) static index list, as long tensors on
    ``dev``."""
    idx = np.asarray(idx, np.int64)
    if idx.ndim != 2 or idx.shape[1] != width:
        raise ValueError(f"{what} must be (M, {width}); got {idx.shape}")
    return tuple(torch.as_tensor(idx[:, c], device=dev)
                 for c in range(width))


def harmonic_angles(angles, k, theta0, device=None
                    ) -> Callable[[Tensor], Tensor]:
    """Harmonic angle bend ``sum_a k_a/2 (theta - theta0_a)^2``, theta the
    i-j-k angle at the centre atom j, from ``atan2(|u x v|, u . v)``
    (finite gradients at 0 and pi, where the arccos form's are not).
    ``angles``: (A, 3); ``k`` / ``theta0`` (radians): scalars or (A,).
    Coordinates in 2-D or 3-D."""
    dev = default_device(device)
    i, j, c = _index_pairs(angles, 3, "angles", dev)
    k = _param_arg(k, dev)
    theta0 = _param_arg(theta0, dev)

    def energy(x: Tensor) -> Tensor:
        u = x[..., i, :] - x[..., j, :]
        v = x[..., c, :] - x[..., j, :]
        if x.shape[-1] == 3:
            sin_t = _norm(torch.linalg.cross(u, v, dim=-1))
        else:
            sin_t = torch.abs(u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0])
        theta = torch.atan2(sin_t, (u * v).sum(-1))
        return (0.5 * k * (theta - theta0) ** 2).sum(-1)

    return energy


def periodic_torsions(torsions, k, n, phase, device=None
                      ) -> Callable[[Tensor], Tensor]:
    """Periodic dihedral term ``sum_t k_t (1 + cos(n_t phi - phase_t))``
    over i-j-k-l quadruples (3-D), ``phi`` the dihedral of
    ``coords.dihedrals``.  ``k`` / ``phase`` (radians) / ``n``: scalars or
    (T,)."""
    dev = default_device(device)
    quads = torch.stack(_index_pairs(torsions, 4, "torsions", dev), -1)
    k = _param_arg(k, dev)
    n = _param_arg(n, dev)
    phase = _param_arg(phase, dev)

    def energy(x: Tensor) -> Tensor:
        phi = dihedrals(x, quads)
        return (k * (1.0 + torch.cos(n * phi - phase))).sum(-1)

    return energy


def morse_bonds(bonds, D, a, r0, device=None) -> Callable[[Tensor], Tensor]:
    """Morse bond stretch ``sum_b D_b (1 - e^{-a_b (r - r0_b)})^2`` (zero
    at r0, D at infinite separation, curvature 2 D a^2 at the minimum).
    ``bonds``: (B, 2); ``D`` / ``a`` / ``r0``: scalars or (B,)."""
    dev = default_device(device)
    i, j = _index_pairs(bonds, 2, "bonds", dev)
    D = _param_arg(D, dev)
    a = _param_arg(a, dev)
    r0 = _param_arg(r0, dev)

    def energy(x: Tensor) -> Tensor:
        e = 1.0 - torch.exp(-a * (_norm(x[..., i, :] - x[..., j, :]) - r0))
        return (D * e * e).sum(-1)

    return energy


def harmonic_impropers(impropers, k, phi0=0.0, device=None
                       ) -> Callable[[Tensor], Tensor]:
    """Harmonic improper dihedral ``sum_t k_t/2 wrap(phi - phi0_t)^2``,
    the deviation wrapped to (-pi, pi] (no seam at phi0 = pi)."""
    dev = default_device(device)
    quads = torch.stack(_index_pairs(impropers, 4, "impropers", dev), -1)
    k = _param_arg(k, dev)
    phi0 = _param_arg(phi0, dev)

    def energy(x: Tensor) -> Tensor:
        d = dihedrals(x, quads) - phi0
        d = d - 2.0 * math.pi * torch.round(d / (2.0 * math.pi))
        return (0.5 * k * d * d).sum(-1)

    return energy


def exclusions_from_bonds(n_atoms: int, bonds,
                          through_angles: bool = True) -> np.ndarray:
    """(n_atoms, n_atoms) bool mask of nonbonded exclusions: bonded (1-2)
    pairs and, with ``through_angles``, 1-3 pairs; the diagonal set."""
    adj = np.zeros((n_atoms, n_atoms), bool)
    for a, b in np.asarray(bonds, np.int64):
        adj[a, b] = adj[b, a] = True
    excl = adj.copy()
    if through_angles:
        excl |= (adj.astype(np.int32) @ adj.astype(np.int32)) > 0
    np.fill_diagonal(excl, True)
    return excl


def _exclude_matrix(exclude, n: int) -> np.ndarray:
    """An ``exclude`` argument, an (n, n) bool matrix or an (E, 2) integer
    pair list, as a validated symmetric (n, n) bool matrix."""
    ex = np.asarray(exclude)
    if ex.dtype == bool:
        if ex.ndim != 2 or ex.shape[0] != ex.shape[1]:
            raise ValueError(f"bool exclude must be a square (n, n) "
                             f"matrix; got {ex.shape}")
        if ex.shape[0] != n:
            raise ValueError(f"exclude matrix is {ex.shape[0]}x"
                             f"{ex.shape[0]} but the system has {n} atoms")
        if not (ex == ex.T).all():
            raise ValueError("exclude matrix must be symmetric")
        return ex
    pr = ex.astype(np.int64).reshape(-1, 2)
    if (pr[:, 0] == pr[:, 1]).any():
        raise ValueError("exclude pair list contains self pairs")
    if pr.size and (pr.min() < 0 or pr.max() >= n):
        raise ValueError(f"exclude references atom {pr.max()} but the "
                         f"system has {n} atoms")
    m = np.zeros((n, n), bool)
    m[pr[:, 0], pr[:, 1]] = True
    m[pr[:, 1], pr[:, 0]] = True
    return m


def lennard_jones(sigma=1.0, epsilon=1.0, *,
                  exclude: Optional[np.ndarray] = None,
                  box: Optional[Sequence[float]] = None,
                  cutoff: Optional[float] = None, shift: bool = True,
                  device=None) -> Callable[[Tensor], Tensor]:
    """Dense all-pairs Lennard-Jones 12-6,
    ``sum_{i<j} 4 eps_ij ((sig_ij/r)^12 - (sig_ij/r)^6)``, with a linear
    core below 0.3 sigma_ij.  ``sigma`` / ``epsilon``: scalars, per-atom
    (n,) (Lorentz-Berthelot) or (n, n); ``box``: minimum image;
    ``cutoff``: truncation, shifted to 0 there with ``shift``;
    ``exclude``: pairs masked out (see :func:`_exclude_matrix`)."""
    dev = default_device(device)
    sigma = _param_arg(sigma, dev)
    epsilon = _param_arg(epsilon, dev)
    if sigma.ndim == 1:
        sigma = 0.5 * (sigma[:, None] + sigma[None, :])
    if epsilon.ndim == 1:
        epsilon = torch.sqrt(epsilon[:, None] * epsilon[None, :])
    box_t = _box_arg(box, dev)
    masks = {}

    def pair_mask(n):
        if n not in masks:
            m = np.triu(np.ones((n, n), bool), k=1)
            if exclude is not None:
                m &= ~_exclude_matrix(exclude, n)
            masks[n] = torch.as_tensor(m, device=dev)
        return masks[n]

    def energy(x: Tensor) -> Tensor:
        mask = pair_mask(x.shape[-2])
        d = x[..., :, None, :] - x[..., None, :, :]
        if box_t is not None:
            d = d - box_t * torch.round(d / box_t)
        r2 = (d * d).sum(-1)
        if cutoff is not None:
            mask = mask & (r2 < cutoff * cutoff)
        # Masked pairs get r2 = 1 (finite powers; NaN would poison the
        # gradient); the floor keeps exact coincidence finite.
        r = torch.sqrt(torch.where(mask, r2, 1.0).clamp_min(_EPS))
        rc = 0.3 * sigma
        sr6 = (sigma / torch.maximum(r, rc)) ** 6
        u = 4.0 * epsilon * (sr6 * sr6 - sr6)
        src6 = (sigma / rc) ** 6
        slope = 24.0 * epsilon / rc * (src6 - 2.0 * src6 * src6)
        u = u + torch.where(r < rc, slope * (r - rc), 0.0)
        if cutoff is not None and shift:
            sc6 = (sigma / cutoff) ** 6
            u = u - 4.0 * epsilon * (sc6 * sc6 - sc6)
        return torch.where(mask, u, 0.0).sum((-2, -1))

    return energy


def _squeeze_box(box: Tensor) -> Tensor:
    """A box of the NPT convention (..., 1, 1, 3) as (..., 3): its
    singleton axes before the last dropped."""
    for i in reversed(range(box.dim() - 1)):
        if box.shape[i] == 1:
            box = box.squeeze(i)
    return box


def _box_arg(box, dev) -> Optional[Tensor]:
    """A ``box`` argument: a tensor is kept as it is (it may be in an
    autograd graph: NPT moves, virial dilations), anything else becomes a
    float32 tensor on ``dev``."""
    if box is None or isinstance(box, Tensor):
        return box
    return _f32(box, dev)


def _pair_mask(cache: dict, exclude, n: int, dev) -> Tensor:
    """The (n, n) upper-triangle pair mask without ``exclude``, built once
    per n on ``dev``."""
    if n not in cache:
        m = np.triu(np.ones((n, n), bool), k=1)
        if exclude is not None:
            m &= ~_exclude_matrix(exclude, n)
        cache[n] = torch.as_tensor(m, device=dev)
    return cache[n]


def _min_image(x: Tensor, box: Optional[Tensor]) -> Tensor:
    d = x[..., :, None, :] - x[..., None, :, :]
    if box is not None:
        d = d - box * torch.round(d / box)
    return d


def buckingham(A=1.0, rho=0.1, C=1.0, *, box=None, cutoff=None,
               exclusions=None, r_core=0.4, device=None
               ) -> Callable[[Tensor], Tensor]:
    """Buckingham (exp-6) pair potential ``sum_{i<j} A e^{-r/rho} - C /
    r^6``, dense, with ``lennard_jones``'s conventions (minimum image
    ``box``, shifted ``cutoff``, static bool ``exclusions``); below
    ``r_core`` the energy continues linearly (value and slope matched),
    so overlaps stay finite."""
    dev = default_device(device)
    box_t = _box_arg(box, dev)
    excl = (None if exclusions is None
            else torch.as_tensor(np.asarray(exclusions, bool), device=dev))

    def pair_u(rr):
        return A * torch.exp(-rr / rho) - C / rr ** 6

    u_core = A * math.exp(-r_core / rho) - C / r_core ** 6
    g_core = -A / rho * math.exp(-r_core / rho) + 6.0 * C / r_core ** 7
    u_cut = (None if cutoff is None
             else A * math.exp(-cutoff / rho) - C / cutoff ** 6)

    def energy(x: Tensor) -> Tensor:
        n = x.shape[-2]
        d = _min_image(x, box_t)
        r = torch.sqrt((d * d).sum(-1)
                       + torch.eye(n, dtype=x.dtype, device=x.device))
        r_safe = torch.clamp_min(r, r_core)
        u = torch.where(r < r_core, u_core + g_core * (r - r_core),
                        pair_u(r_safe))
        if cutoff is not None:
            u = torch.where(r_safe < cutoff, u - u_cut, 0.0)
        mask = torch.ones((n, n), dtype=torch.bool, device=x.device).triu(1)
        if excl is not None:
            mask = mask & ~excl
        return torch.where(mask, u, 0.0).sum((-2, -1))

    return energy


def lennard_jones_tail(sigma: float = 1.0, epsilon: float = 1.0, *, box,
                       cutoff: float) -> Callable[[Tensor], Tensor]:
    """Homogeneous-fluid tail correction of a truncated LJ,
    ``(8 pi N^2 eps sig^3) / (3 V) [(1/3)(sig/rc)^9 - (sig/rc)^3]``
    (Frenkel & Smit eq. 3.2.5).  ``box`` may be a tensor (the NPT (..., 1,
    1, 3) convention too), so volume moves and virial dilations see the
    tail's volume dependence; it goes to x's device at call time."""
    sr3 = (float(sigma) / float(cutoff)) ** 3
    coeff = ((8.0 / 3.0) * math.pi * float(epsilon) * float(sigma) ** 3
             * (sr3 ** 3 / 3.0 - sr3))

    def energy(x: Tensor) -> Tensor:
        b = _squeeze_box(torch.as_tensor(box, dtype=x.dtype,
                                         device=x.device))
        vol = torch.prod(b, -1)
        n = x.shape[-2]
        return (coeff * n * n / vol).expand(x.shape[:-2])

    return energy


def lennard_jones_softcore(sigma=1.0, epsilon=1.0, *, alchemical,
                           alpha: float = 0.5,
                           exclude: Optional[np.ndarray] = None,
                           box=None, device=None):
    """Alchemical LJ (Beutler et al. 1994): a pair with exactly one
    ``alchemical`` atom takes the soft core
    ``4 eps lam [(alpha (1 - lam) + (r/sig)^6)^-2 - (alpha (1 - lam) +
    (r/sig)^6)^-1]``, exact LJ at lam = 1, zero at lam = 0 and finite at
    r = 0 for every lam < 1; other pairs take the full LJ with its linear
    core.  Returns ``energy(x, lam)``; ``lam`` broadcasts against the
    energy's batch shape (a tensor lam gives dU/dlam by autograd)."""
    dev = default_device(device)
    sigma = _param_arg(sigma, dev)
    epsilon = _param_arg(epsilon, dev)
    if sigma.ndim == 1:
        sigma = 0.5 * (sigma[:, None] + sigma[None, :])
    if epsilon.ndim == 1:
        epsilon = torch.sqrt(epsilon[:, None] * epsilon[None, :])
    alch = np.asarray(alchemical, bool)
    box_t = _box_arg(box, dev)
    scaled_np = alch[:, None] ^ alch[None, :]
    masks = {}

    def energy(x: Tensor, lam) -> Tensor:
        n = x.shape[-2]
        if alch.shape != (n,):
            raise ValueError(f"alchemical must be ({n},); got {alch.shape}")
        if n not in masks:
            pm = np.triu(np.ones((n, n), bool), k=1)
            if exclude is not None:
                pm &= ~_exclude_matrix(exclude, n)
            masks[n] = (torch.as_tensor(pm & ~scaled_np, device=dev),
                        torch.as_tensor(pm & scaled_np, device=dev))
        full, soft = masks[n]
        lam = torch.as_tensor(lam, dtype=x.dtype, device=x.device)
        d = _min_image(x, box_t)
        r2 = (d * d).sum(-1)
        r = torch.sqrt(torch.where(full, r2, 1.0).clamp_min(_EPS))
        rc = 0.3 * sigma
        sr6 = (sigma / torch.maximum(r, rc)) ** 6
        u_full = 4.0 * epsilon * (sr6 * sr6 - sr6)
        src6 = (sigma / rc) ** 6
        slope = 24.0 * epsilon / rc * (src6 - 2.0 * src6 * src6)
        u_full = u_full + torch.where(r < rc, slope * (r - rc), 0.0)
        lam_p = lam[..., None, None]
        r6s = (torch.where(soft, r2, 1.0) / sigma ** 2) ** 3
        den = torch.clamp_min(alpha * (1.0 - lam_p) + r6s, 1e-12)
        u_soft = 4.0 * epsilon * lam_p * (1.0 / den ** 2 - 1.0 / den)
        return (torch.where(full, u_full, 0.0).sum((-2, -1))
                + torch.where(soft, u_soft, 0.0).sum((-2, -1)))

    return energy


def coulomb(charges, *, exclude: Optional[np.ndarray] = None, box=None,
            cutoff: Optional[float] = None, shift: bool = True,
            device=None) -> Callable[[Tensor], Tensor]:
    """Dense pairwise Coulomb ``sum_{i<j} q_i q_j / r_ij`` in reduced
    units (Coulomb constant 1), with minimum image under ``box``,
    ``exclude`` and a ``cutoff``, shifted to 0 there with ``shift``: the
    gas-phase and short-range form (:func:`ewald_coulomb` is the periodic
    sum)."""
    dev = default_device(device)
    q = _param_arg(charges, dev)
    if q.ndim != 1:
        raise ValueError(f"charges must be (n,); got {tuple(q.shape)}")
    qq = q[:, None] * q[None, :]
    box_t = _box_arg(box, dev)
    masks = {}

    def energy(x: Tensor) -> Tensor:
        n = x.shape[-2]
        if n != q.shape[0]:
            raise ValueError(f"coords have {n} atoms but charges has "
                             f"{q.shape[0]}")
        mask = _pair_mask(masks, exclude, n, dev)
        d = _min_image(x, box_t)
        r2 = (d * d).sum(-1)
        if cutoff is not None:
            mask = mask & (r2 < cutoff * cutoff)
        r = torch.sqrt(torch.where(mask, r2, 1.0).clamp_min(_EPS))
        u = qq / r
        if cutoff is not None and shift:
            u = u - qq / cutoff
        return torch.where(mask, u, 0.0).sum((-2, -1))

    return energy


def _ewald_modes(ref: np.ndarray, k_cut: float) -> np.ndarray:
    """The half-space integer modes n with |2 pi n / L_ref| <= k_cut."""
    n_max = np.maximum(np.ceil(k_cut * ref / (2 * np.pi)), 1).astype(int)
    axes = [np.arange(-m, m + 1) for m in n_max]
    nn = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    half = ((nn[:, 0] > 0)
            | ((nn[:, 0] == 0) & (nn[:, 1] > 0))
            | ((nn[:, 0] == 0) & (nn[:, 1] == 0) & (nn[:, 2] > 0)))
    nn = nn[half]
    k_ref = 2 * np.pi * nn / ref
    return nn[(k_ref ** 2).sum(-1) <= k_cut * k_cut]


def ewald_coulomb(charges, *, box, r_cutoff: float,
                  exclude: Optional[np.ndarray] = None,
                  alpha: Optional[float] = None, tolerance: float = 1e-5,
                  k_cutoff: Optional[float] = None, reference_box=None,
                  include_real_space: bool = True, device=None
                  ) -> Callable[[Tensor], Tensor]:
    """Classic Ewald summation on an orthorhombic box (reduced units,
    Coulomb constant 1): the dense minimum-image erfc pair sum, the
    reciprocal sum over the half-space modes |k| <= k_cut, the self term,
    the neutralising background ``-pi (sum q)^2 / (2 V alpha^2)`` of a
    net charge, and ``-q_i q_j erf(alpha r)/r`` for each excluded pair
    (whose interaction then vanishes in total).

    ``include_real_space=False`` drops the erfc pair sum: compute it with
    ``lennard_jones_cell_neighbor(charges=..., coulomb_alpha=
    energy.ewald_alpha)`` at the same ``r_cutoff`` (the cell-pair kernel
    on the card) and the two add up to this sum.  ``alpha`` / ``k_cutoff``
    default from ``tolerance``: ``sqrt(-ln tol) / r_cutoff`` and ``2 alpha
    sqrt(-ln tol)``.  The mode set is frozen on the host from
    ``reference_box`` (default ``box``), so ``box`` may be a tensor in an
    autograd graph (NPT moves, virial dilations).

    The phases ``x . k`` are three multiply-adds, not a matrix product,
    and the sums over atoms are reductions: with TF32 allowed a product
    would round them to 10 mantissa bits, and phases of O(100) rad turn
    that into O(1e-3) relative energy errors."""
    dev = default_device(device)
    q = _f32(charges, dev)
    if q.ndim != 1:
        raise ValueError(f"charges must be (n,); got {tuple(q.shape)}")
    if reference_box is None:
        reference_box = box
    if isinstance(reference_box, Tensor):
        reference_box = reference_box.detach().cpu().numpy()
    ref = np.asarray(reference_box, np.float64).reshape(-1)
    if ref.shape != (3,):
        raise ValueError(f"box must be 3 lengths; got {ref.shape}")
    if not r_cutoff * 2.0 <= ref.min():
        raise ValueError(
            f"r_cutoff {r_cutoff} must be <= half the smallest box edge "
            f"({ref.min() / 2}) for minimum-image validity")
    ln_tol = float(np.sqrt(-np.log(tolerance)))
    alpha_v = float(alpha) if alpha is not None else ln_tol / float(r_cutoff)
    k_cut = (float(k_cutoff) if k_cutoff is not None
             else 2.0 * alpha_v * ln_tol)
    nn = _ewald_modes(ref, k_cut)
    if nn.shape[0] == 0:
        raise ValueError("empty k-vector set; increase k_cutoff/tolerance")
    modes = torch.as_tensor(nn.astype(np.float32), device=dev)   # (n_k, 3)
    box_t = _box_arg(box, dev)
    n_q = q.shape[0]
    qq = q[:, None] * q[None, :]
    excl = None if exclude is None else _exclude_matrix(exclude, n_q)
    real_mask = None
    if include_real_space:
        real_mask = np.triu(np.ones((n_q, n_q), bool), k=1)
        if excl is not None:
            real_mask &= ~excl
        real_mask = torch.as_tensor(real_mask, device=dev)
    excl_mask = (None if excl is None
                 else torch.as_tensor(np.triu(excl, k=1), device=dev))
    u_self = -alpha_v / math.sqrt(math.pi) * float((q.double() ** 2).sum())
    q_net = float(q.double().sum())

    def energy(x: Tensor) -> Tensor:
        n = x.shape[-2]
        if n != n_q:
            raise ValueError(f"coords have {n} atoms but charges has {n_q}")
        b = _squeeze_box(box_t.to(x.dtype))              # (..., 3)
        row = b[..., None, :]
        pair = b[..., None, None, :]
        vol = torch.prod(b, -1)
        xw = x - row * torch.floor(x / row)              # bounds the phases
        k = 2 * math.pi * modes / row                    # (..., n_k, 3)
        k2 = (k * k).sum(-1)
        w = (4 * math.pi / k2) * torch.exp(-k2 / (4 * alpha_v * alpha_v))
        phase = (xw[..., :, None, 0] * k[..., None, :, 0]
                 + xw[..., :, None, 1] * k[..., None, :, 1]
                 + xw[..., :, None, 2] * k[..., None, :, 2])
        s_cos = (q[:, None] * torch.cos(phase)).sum(-2)
        s_sin = (q[:, None] * torch.sin(phase)).sum(-2)
        total = (w * (s_cos ** 2 + s_sin ** 2)).sum(-1) / vol
        total = total + u_self - math.pi / (
            2 * vol * alpha_v * alpha_v) * q_net ** 2
        if include_real_space or excl_mask is not None:
            d = xw[..., :, None, :] - xw[..., None, :, :]
            d = d - pair * torch.round(d / pair)
            r2 = (d * d).sum(-1)
        if include_real_space:
            m = real_mask & (r2 < r_cutoff * r_cutoff)
            r = torch.sqrt(torch.where(m, r2, 1.0).clamp_min(_EPS))
            total = total + torch.where(
                m, qq * torch.special.erfc(alpha_v * r) / r, 0.0).sum((-2, -1))
        if excl_mask is not None:
            r = torch.sqrt(torch.where(excl_mask, r2, 1.0).clamp_min(_EPS))
            total = total - torch.where(
                excl_mask, qq * torch.special.erf(alpha_v * r) / r,
                0.0).sum((-2, -1))
        return total

    energy.ewald_alpha = alpha_v
    energy.n_modes = int(nn.shape[0])
    return energy


class CellNeighborList(NamedTuple):
    """A cell list frozen at build time (the JAX package's fields, so a
    JAX-built list converts with ``convert.from_jax``).  Valid while no
    atom has moved more than skin/2 from ``x_ref``; the energy is NaN
    otherwise, or when a cell overflowed ``capacity``."""

    x_ref: Tensor       # (n, 3) wrapped build-time positions
    cell_atoms: Tensor  # (n_cells, capacity) int32 atom ids (n = empty)
    nb_cid: Tensor      # (n, 27) per-atom cell ids (empty: cell layout)
    mask: Tensor        # (n, 27 capacity) candidate mask; empty likewise
    overflow: Tensor    # () bool: some cell exceeded capacity
    atom_slot: Tensor   # (n,) int32 flat cell * capacity + slot per atom


class _CellEnergy(torch.autograd.Function):
    """The cell-pair energy, whose kernel returns the gradient with it: the
    backward scales that gradient by the incoming cotangent.

    Under ``create_graph=True`` (grad mode in the backward) the gradient
    is rebuilt instead by ``grad_fn(nl, x)``, a differentiable function
    of x on the per-atom candidate layout, so that a second derivative
    (a Hessian-vector product, force matching) sees this term."""

    @staticmethod
    def forward(ctx, x, impl, nl, grad_fn):
        e, grad = impl(nl, x)
        ctx.save_for_backward(grad, x)
        ctx.nl, ctx.grad_fn = nl, grad_fn
        return e

    @staticmethod
    def backward(ctx, ct):
        grad, x = ctx.saved_tensors
        if torch.is_grad_enabled():
            grad = ctx.grad_fn(ctx.nl, x)
        return ct * grad, None, None, None


def lennard_jones_cell_neighbor(
        sigma=1.0, epsilon=1.0, *, box: Sequence[float], cutoff: float,
        skin: float = 0.4, capacity: int = 24, shift: bool = True,
        mesh=None, charges=None, coulomb_alpha: Optional[float] = None,
        exclude: Optional[np.ndarray] = None, device=None
        ) -> Tuple[Callable[[Tensor], CellNeighborList],
                   Callable[[CellNeighborList, Tensor], Tensor]]:
    """Cell-list Lennard-Jones with a reusable neighbour list: returns
    ``(build, energy)``.  ``build(x)`` sorts atoms into a grid of cells of
    edge >= cutoff + skin (at least 3 per axis), ``capacity`` slots each;
    ``energy(nl, x)`` is the truncated, shifted LJ of :func:`lennard_jones`
    over every pair within ``cutoff``, valid until an atom has moved
    skin/2, NaN (energy and gradient) after that or after an overflowed
    build.  Single-system shapes (n, 3).

    ``sigma`` / ``epsilon``: scalars or per-atom (n,) (Lorentz-Berthelot).
    ``charges`` with ``coulomb_alpha`` add the Ewald real-space term
    ``q_i q_j erfc(alpha r) / r`` (pair it with :func:`pme_coulomb`'s
    ``include_real_space=False`` and its ``ewald_alpha``).  ``exclude``:
    an (n, n) bool matrix or (E, 2) pair list, masked out of the pair sum
    itself (never subtracted after: a bonded pair sits in the LJ core).

    The energy and its gradient come from one call of the cell-pair
    kernel on the card (its plain version on the CPU); autograd scales
    that gradient.  ``energy.stress(nl, x)`` (the configurational
    pressure tensor) and ``energy.heat_flux(nl, x, v, masses)`` (refused
    with exclusions) run plain PyTorch on the per-atom candidate layout;
    ``energy.cell_pair_inputs(nl, x)`` returns the kernel's
    ``(args, kwargs)``.  ``mesh=`` is not ported yet."""
    if mesh is not None:
        raise NotImplementedError(
            f"a mesh-sharded cell grid is not ported yet ({_MESH}: "
            "mesh-sharded cell grid over torch.distributed)")
    if skin < 0:
        raise ValueError(f"skin must be >= 0; got {skin}")
    dev = default_device(device)
    rc_build = float(cutoff) + float(skin)
    box_np = np.asarray(box, np.float64)
    n_grid = np.maximum(np.floor(box_np / rc_build).astype(np.int64), 1)
    if (n_grid < 3).any():
        raise ValueError(
            f"box {box_np.tolist()} fits {n_grid.tolist()} cells of edge "
            f">= cutoff+skin {rc_build}; need >= 3 per dimension (use the "
            "dense lennard_jones for small boxes)")
    cell_size = box_np / n_grid
    n_cells = int(n_grid.prod())
    strides_np = np.array([n_grid[1] * n_grid[2], n_grid[2], 1], np.int64)
    offs = np.stack(np.meshgrid(*[[-1, 0, 1]] * 3, indexing="ij"),
                    -1).reshape(-1, 3)
    g3 = np.stack(np.unravel_index(np.arange(n_cells), n_grid), -1)
    raw = g3[:, None, :] + offs[None, :, :]              # (n_cells, 27, 3)
    cell_nb = torch.as_tensor((raw % n_grid) @ strides_np, device=dev)
    box_t = _f32(box_np, dev)
    cell_t = _f32(cell_size, dev)
    grid_max = torch.as_tensor(n_grid - 1, dtype=torch.int32, device=dev)
    strides = torch.as_tensor(strides_np, dtype=torch.int32, device=dev)
    offs_t = torch.as_tensor(offs, dtype=torch.int32, device=dev)
    n_grid_t = torch.as_tensor(n_grid, dtype=torch.int32, device=dev)
    rc2 = float(cutoff) * float(cutoff)
    drift2_max = (float(skin) / 2.0) ** 2

    sigma_np = np.asarray(sigma, np.float64)
    epsilon_np = np.asarray(epsilon, np.float64)
    if sigma_np.ndim > 1 or epsilon_np.ndim > 1:
        raise ValueError(
            "cell-list LJ supports scalar or per-atom (n,) sigma/epsilon"
            " (Lorentz-Berthelot); use the dense lennard_jones for"
            " (n, n) pair matrices")
    per_atom = sigma_np.ndim == 1 or epsilon_np.ndim == 1
    if per_atom:
        n_spec = max(sigma_np.size if sigma_np.ndim else 1,
                     epsilon_np.size if epsilon_np.ndim else 1)
        sig_at = _f32(np.broadcast_to(sigma_np, (n_spec,)), dev)
        seps_at = _f32(np.sqrt(np.broadcast_to(epsilon_np, (n_spec,))), dev)
        sigma = epsilon = None
    else:
        n_spec = None
        sigma, epsilon = float(sigma_np), float(epsilon_np)

    if charges is not None:
        q_np = np.asarray(charges, np.float64)
        if q_np.ndim != 1:
            raise ValueError(f"charges must be (n,); got {q_np.shape}")
        if coulomb_alpha is None:
            raise ValueError(
                "charges need coulomb_alpha: use the SAME alpha as the "
                "reciprocal part (pme_coulomb(...).ewald_alpha)")
        if per_atom and q_np.size != n_spec:
            raise ValueError(f"charges has {q_np.size} atoms but "
                             f"sigma/epsilon has {n_spec}")
        q_at = _f32(q_np, dev)
        c_alpha = float(coulomb_alpha)
    else:
        q_at, c_alpha = None, 0.0

    # Bonded exclusions: a per-atom partner table, masked in the sum.
    if exclude is not None:
        ex_np = np.asarray(exclude)
        if ex_np.dtype == bool:
            if ex_np.ndim != 2 or ex_np.shape[0] != ex_np.shape[1]:
                raise ValueError(f"bool exclude must be a square "
                                 f"(n, n) matrix; got {ex_np.shape}")
            if not (ex_np == ex_np.T).all():
                raise ValueError("exclude matrix must be symmetric")
            ex_i, ex_j = np.nonzero(np.triu(ex_np, k=1))
        else:
            pr = ex_np.astype(np.int64).reshape(-1, 2)
            lo = np.minimum(pr[:, 0], pr[:, 1])
            hi = np.maximum(pr[:, 0], pr[:, 1])
            if (lo == hi).any():
                raise ValueError("exclude pair list contains self pairs")
            if lo.size and lo.min() < 0:
                raise ValueError("exclude pair indices must be >= 0")
            pairs = np.unique(np.stack([lo, hi], 1), axis=0)
            ex_i, ex_j = pairs[:, 0], pairs[:, 1]
        ex_max = int(max(ex_i.max(), ex_j.max())) if ex_i.size else -1
        if n_spec is not None and ex_max >= n_spec:
            raise ValueError(f"exclude references atom {ex_max} but "
                             f"per-atom sigma/epsilon has {n_spec}")
        if q_at is not None and ex_max >= q_at.shape[0]:
            raise ValueError(f"exclude references atom {ex_max} but "
                             f"charges has {q_at.shape[0]}")
        if ex_i.size == 0:
            exclude = None
    if exclude is not None:
        deg = np.zeros(ex_max + 1, np.int64)
        np.add.at(deg, ex_i, 1)
        np.add.at(deg, ex_j, 1)
        ex_deg = int(deg.max())
        excl_tab0 = np.full((ex_max + 1, ex_deg), -1, np.int32)
        fill = np.zeros(ex_max + 1, np.int64)
        for a, b in zip(ex_i.tolist(), ex_j.tolist()):
            excl_tab0[a, fill[a]] = b
            fill[a] += 1
            excl_tab0[b, fill[b]] = a
            fill[b] += 1
    else:
        ex_max, ex_deg, excl_tab0 = -1, 0, None
    excl_tabs = {}

    def _excl_tab(n):
        """(n, D) int32 excluded-partner ids (-1 padding) for n > ex_max
        atoms (``_check_n``)."""
        if n not in excl_tabs:
            pad = np.full((n - excl_tab0.shape[0], ex_deg), -1, np.int32)
            excl_tabs[n] = torch.as_tensor(
                np.concatenate([excl_tab0, pad]), device=dev)
        return excl_tabs[n]

    def _check_n(n):
        if per_atom and n != n_spec:
            raise ValueError(f"coords have {n} atoms but per-atom "
                             f"sigma/epsilon has {n_spec}")
        if q_at is not None and n != q_at.shape[0]:
            raise ValueError(f"coords have {n} atoms but charges has "
                             f"{q_at.shape[0]}")
        if ex_max >= n:
            raise ValueError(f"exclude references atom {ex_max} but "
                             f"coords have {n} atoms")

    def _wrap(x):
        return x - box_t * torch.floor(x / box_t)

    def _cells3(xw):
        return torch.minimum((xw / cell_t).to(torch.int32).clamp_min(0),
                             grid_max)

    def build(x: Tensor) -> CellNeighborList:
        """Sort atoms into cells (stably, by cell id) and pad each cell to
        ``capacity`` slots."""
        n = x.shape[0]
        xw = _wrap(x)
        cid = (_cells3(xw) * strides).sum(-1, dtype=torch.int32)
        order = torch.argsort(cid, stable=True)
        cid_sorted = cid[order]
        grid = torch.arange(n_cells, dtype=torch.int32, device=x.device)
        start = torch.searchsorted(cid_sorted, grid)
        count = torch.searchsorted(cid_sorted, grid, right=True) - start
        overflow = count.max() > capacity
        slots = torch.arange(capacity, device=x.device)
        slot = (start[:, None] + slots[None, :]).clamp(0, n - 1)
        cell_atoms = torch.where(slots[None, :] < count[:, None],
                                 order[slot], n).to(torch.int32)
        slot_sorted = (torch.arange(n, device=x.device)
                       - start[cid_sorted.long()])
        atom_slot = torch.empty(n, dtype=torch.int32, device=x.device)
        atom_slot[order] = (cid_sorted * capacity + slot_sorted).to(
            torch.int32)
        return CellNeighborList(
            x_ref=xw, cell_atoms=cell_atoms,
            nb_cid=torch.zeros((0,), dtype=torch.int32, device=x.device),
            mask=torch.zeros((0,), dtype=torch.bool, device=x.device),
            overflow=overflow, atom_slot=atom_slot)

    def _invalid(nl, xw):
        """Overflow at build, or an atom drifted past skin/2 (strict >,
        so any motion invalidates a zero-skin list)."""
        d = xw - nl.x_ref
        d = d - box_t * torch.round(d / box_t)
        return nl.overflow | ((d * d).sum(-1).max() > drift2_max)

    def cell_pair_inputs(nl: CellNeighborList, x: Tensor):
        """The cell-pair kernel's ``(args, kwargs)`` at coordinates x:
        positions, ids and the optional species, charge and exclusion
        blocks gathered into cell layout."""
        return _inputs(nl, _wrap(x))

    def _inputs(nl, xw):
        n = xw.shape[0]
        _check_n(n)
        cells = nl.cell_atoms.long().clamp(0, n - 1)
        cell_x = xw[cells]                               # (n_cells, C, 3)
        cxt = cell_x.transpose(1, 2).contiguous()
        nxt = cell_x[cell_nb].reshape(n_cells, 27 * capacity, 3).transpose(
            1, 2).contiguous()
        cid = nl.cell_atoms.reshape(n_cells, 1, capacity)
        nid = nl.cell_atoms[cell_nb].reshape(n_cells, 1, 27 * capacity)

        def blocks(per_atom_t):
            c = per_atom_t[cells]
            return (c.reshape(n_cells, 1, capacity),
                    c[cell_nb].reshape(n_cells, 1, 27 * capacity))

        species = charge = exclusion = None
        if per_atom:
            (csig, nsig), (cse, nse) = blocks(sig_at), blocks(seps_at)
            species = (csig, nsig, cse, nse)
        if q_at is not None:
            charge = blocks(q_at)
        if exclude is not None:
            # Padding slots (id n, clipped to n - 1) gather a real atom's
            # partners; the kernel's i < n mask drops them first.
            exclusion = _excl_tab(n)[cells].transpose(1, 2).contiguous()
        kwargs = dict(n_atoms=n, sigma=1.0 if sigma is None else sigma,
                      epsilon=1.0 if epsilon is None else epsilon,
                      cutoff=float(cutoff), box=tuple(box_np.tolist()),
                      shift=shift, coulomb_alpha=c_alpha)
        return (cxt, nxt, cid, nid, species, charge, exclusion), kwargs

    def _impl(nl, x):
        xw = _wrap(x)
        args, kwargs = _inputs(nl, xw)
        e_cells, grad_t = cell_pair_energy_force(*args, **kwargs)
        bad = _invalid(nl, xw)
        # An overflowed build's atom_slot runs past the last slot: clamp
        # (the result is NaN anyway) rather than index out of bounds.
        grad = grad_t.transpose(1, 2).reshape(n_cells * capacity, 3)[
            nl.atom_slot.long().clamp(max=n_cells * capacity - 1)]
        nan = torch.where(bad, torch.nan, 1.0)
        return e_cells.sum() * nan, grad * nan

    def energy(nl: CellNeighborList, x: Tensor) -> Tensor:
        return _CellEnergy.apply(x, _impl, nl, _grad)

    # ---- the per-atom candidate layout: stress and heat flux ----
    def _nb_cid_mask(nl, n):
        """Per-atom neighbour-cell ids and candidate masks: stored on a
        JAX XLA-path build, recomputed from the frozen x_ref binning
        otherwise."""
        if nl.nb_cid.numel():
            return nl.nb_cid.long(), nl.mask
        nb3 = (_cells3(nl.x_ref)[:, None, :] + offs_t[None]) % n_grid_t
        nb_cid = (nb3 * strides).sum(-1).long()
        cand = nl.cell_atoms[nb_cid].reshape(n, 27 * capacity)
        mask = (cand < n) & (cand != torch.arange(n, device=cand.device)[
            :, None])
        if exclude is not None:
            tab = _excl_tab(n)
            for k in range(ex_deg):
                mask = mask & (cand != tab[:, k:k + 1])
        return nb_cid, mask

    def _cand(nl, per_atom_t, nb_cid, n):
        cells = nl.cell_atoms.long().clamp(0, n - 1)
        return per_atom_t[cells][nb_cid].reshape(n, -1, *per_atom_t.shape[1:])

    def _pairs(nl, xw):
        """Min-image displacements and distances from the current
        positions to every frozen candidate, the cutoff folded into the
        mask (masked pairs get r = 1)."""
        n = xw.shape[0]
        nb_cid, nb_mask = _nb_cid_mask(nl, n)
        d = xw[:, None, :] - _cand(nl, xw, nb_cid, n)
        d = d - box_t * torch.round(d / box_t)
        r2 = (d * d).sum(-1)
        mask = nb_mask & (r2 < rc2)
        r = torch.sqrt(torch.where(mask, r2, 1.0).clamp_min(_EPS))
        return d, r, mask, nb_cid

    def _pair_params(nl, nb_cid, n):
        if not per_atom:
            return sigma, epsilon
        return (0.5 * (sig_at[:, None] + _cand(nl, sig_at, nb_cid, n)),
                seps_at[:, None] * _cand(nl, seps_at, nb_cid, n))

    def _pair_u_of(nl, r, nb_cid, n):
        """Per-candidate pair energy u(r), unmasked."""
        sig_p, eps_p = _pair_params(nl, nb_cid, n)
        rcore = 0.3 * sig_p
        slope = SLOPE_F * eps_p / sig_p
        sr6 = (sig_p / r.clamp(min=rcore)) ** 6
        u = 4.0 * eps_p * (sr6 * sr6 - sr6)
        u = u + torch.where(r < rcore, slope * (r - rcore), 0.0)
        if shift:
            sc6 = (sig_p / cutoff) ** 6
            u = u - 4.0 * eps_p * (sc6 * sc6 - sc6)
        if q_at is not None:
            qq = q_at[:, None] * _cand(nl, q_at, nb_cid, n)
            u = u + qq * torch.special.erfc(c_alpha * r) / r
        return u

    def _pair_dudr(nl, xw):
        """Per-candidate (d, r, mask, du/dr): the analytic core of the
        stress tensor and the heat flux."""
        n = xw.shape[0]
        d, r, mask, nb_cid = _pairs(nl, xw)
        sig_p, eps_p = _pair_params(nl, nb_cid, n)
        rcore = 0.3 * sig_p
        sr6 = (sig_p / r) ** 6
        dudr = 24.0 * eps_p / r * (sr6 - 2.0 * sr6 * sr6)
        dudr = torch.where(r < rcore, SLOPE_F * eps_p / sig_p, dudr)
        if q_at is not None:
            qq = q_at[:, None] * _cand(nl, q_at, nb_cid, n)
            dudr = dudr - qq * (torch.special.erfc(c_alpha * r) / (r * r)
                                + _TWO_OPI * c_alpha
                                * torch.exp(-(c_alpha * r) ** 2) / r)
        return d, r, mask, torch.where(mask, dudr, 0.0), nb_cid

    def _grad(nl, x):
        """dE/dx as a differentiable function of x: sum over each atom's
        candidates of (du/dr) d / r (the candidate lists are symmetric,
        so this is the gradient of the half-counted pair sum); NaN under
        the drift and overflow contract."""
        xw = _wrap(x)
        d, r, _, dudr, _ = _pair_dudr(nl, xw)
        g = ((dudr / r)[..., None] * d).sum(1)
        return g * torch.where(_invalid(nl, xw), torch.nan, 1.0)

    vol = float(box_np.prod())

    def stress(nl: CellNeighborList, x: Tensor) -> Tensor:
        """Configurational pressure tensor
        ``P_ab = -(1/2V) sum_{i != j} (du/dr) d_a d_b / r``, (3, 3); NaN
        under the drift and overflow contract."""
        _check_n(x.shape[0])
        xw = _wrap(x)
        d, r, _, dudr, _ = _pair_dudr(nl, xw)
        sig = -0.5 * torch.einsum("nk,nka,nkb->ab", dudr / r, d, d) / vol
        return sig * torch.where(_invalid(nl, xw), torch.nan, 1.0)

    def heat_flux(nl: CellNeighborList, x: Tensor, v: Tensor,
                  masses=1.0) -> Tensor:
        """Energy flux ``J = (sum_i e_i v_i + (1/2) sum_{i<j} (f_ij .
        (v_i + v_j)) d_ij) / V`` (Irving-Kirkwood pair form), (3,); NaN
        under the drift and overflow contract."""
        n = x.shape[0]
        _check_n(n)
        xw = _wrap(x)
        d, r, mask, dudr, nb_cid = _pair_dudr(nl, xw)
        u = torch.where(mask, _pair_u_of(nl, r, nb_cid, n), 0.0)
        vc = _cand(nl, v, nb_cid, n)
        m = torch.as_tensor(masses, dtype=v.dtype, device=v.device)
        m_col = m[:, None] if m.ndim == 1 else m
        e_i = 0.5 * (m_col * v * v).sum(-1) + 0.5 * u.sum(-1)
        conv = (e_i[:, None] * v).sum(0)
        fdotv = -(dudr / r) * torch.einsum("nka,nka->nk", d,
                                           v[:, None, :] + vc)
        vir = 0.25 * torch.einsum("nk,nka->a", fdotv, d)
        return ((conv + vir) / vol) * torch.where(_invalid(nl, xw),
                                                  torch.nan, 1.0)

    def heat_flux_refused(*a, **k):
        raise NotImplementedError(
            "heat_flux with bonded exclusions is not supported: the "
            "Irving-Kirkwood pair form needs ALL interatomic forces "
            "(including the bonded terms that motivate exclusions), "
            "which this nonbonded potential does not see")

    energy.stress = stress
    energy.heat_flux = heat_flux if exclude is None else heat_flux_refused
    energy.cell_pair_inputs = cell_pair_inputs
    return build, energy


def lennard_jones_cell(sigma=1.0, epsilon=1.0, *, box: Sequence[float],
                       cutoff: float, capacity: int = 24, shift: bool = True,
                       device=None) -> Callable[[Tensor], Tensor]:
    """Cell-list Lennard-Jones built anew at every call
    (:func:`lennard_jones_cell_neighbor` at skin 0), over coordinates
    (..., n, 3); NaN where a cell overflows ``capacity``."""
    build, energy_nl = lennard_jones_cell_neighbor(
        sigma, epsilon, box=box, cutoff=cutoff, skin=0.0,
        capacity=capacity, shift=shift, device=device)

    def energy(x: Tensor) -> Tensor:
        if x.ndim == 2:
            return energy_nl(build(x), x)
        flat = x.reshape((-1,) + x.shape[-2:])
        return torch.stack([energy_nl(build(xi), xi)
                            for xi in flat]).reshape(x.shape[:-2])

    return energy


def _bspline_weights(order: int, t: Tensor) -> Tensor:
    """Cardinal B-spline weights ``M_order(t + j)``, j = 0..order-1, as a
    trailing axis (the PME coefficient recurrence, Essmann et al. 1995
    eq. 4.1); ``t`` in [0, 1)."""
    if order < 2:
        raise ValueError("spline order must be >= 2")
    w = [1.0 - t, t] + [torch.zeros_like(t) for _ in range(order - 2)]
    for k in range(3, order + 1):
        div = 1.0 / (k - 1)
        w[k - 1] = div * t * w[k - 2]
        for j in range(1, k - 1):
            w[k - 1 - j] = div * ((t + j) * w[k - 2 - j]
                                  + (k - j - t) * w[k - 1 - j])
        w[0] = div * (1.0 - t) * w[0]
    return torch.stack(w[::-1], dim=-1)


def _bspline_integer_values(order: int) -> np.ndarray:
    """``M_order`` at the integers 1..order-1 (numpy) for the Euler
    exponential-spline factors."""
    xs = np.arange(1, order, dtype=np.float64)

    def mn(n, x):
        if n == 2:
            return np.where((x >= 0) & (x <= 2), 1.0 - np.abs(x - 1.0), 0.0)
        return (x * mn(n - 1, x) + (n - x) * mn(n - 1, x - 1.0)) / (n - 1)

    return mn(order, xs)


def _next_smooth(n: int) -> int:
    """The least 5-smooth even size >= max(n, 4): a fast FFT length."""
    cand = max(int(n), 4)
    while True:
        m = cand
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        if m == 1 and cand % 2 == 0:
            return cand
        cand += 1


def pme_coulomb(charges, *, box: Optional[Sequence[float]] = None,
                cell=None, r_cutoff: float,
                grid_shape: Optional[Sequence[int]] = None, order: int = 6,
                exclude: Optional[np.ndarray] = None,
                alpha: Optional[float] = None, tolerance: float = 1e-5,
                include_real_space: bool = True, mesh=None, device=None
                ) -> Callable[[Tensor], Tensor]:
    """Smooth particle-mesh Ewald (Essmann et al. 1995) on an orthorhombic
    ``box`` or a static restricted-triclinic ``cell`` (a (3, 3) lower-
    triangular matrix, ``triclinic.validate_cell``): B-spline charge
    spreading (one ``index_add``) in fractional space, a real 3-D FFT
    (``torch.fft.rfftn``), and the influence function
    ``4 pi / k^2 e^{-k^2 / 4 alpha^2} / |b|^2`` built at construction,
    with ``k(m) = 2 pi H^-1 m`` (the dual basis) in a sheared cell; plus
    the self, background and exclusion corrections and, with
    ``include_real_space``, the dense erfc pair sum, both with the
    (sequential, in a sheared cell) minimum image.  Forces by autograd
    through the scatter and the FFT.

    ``alpha`` defaults to ``sqrt(-ln tolerance) / r_cutoff``;
    ``grid_shape`` to the least 5-smooth even size with spacing <= pi /
    (1.5 k_cut) per axis, along each cell vector's length (the JAX
    package's rule).  ``exclude`` (an (n, n) bool matrix or (E, 2) pair
    list) removes each excluded pair's Coulomb interaction, real and
    reciprocal.  ``energy.ewald_alpha`` and ``energy.grid_shape`` give
    the chosen values.  ``mesh=`` (the slab-decomposed PME) is not
    ported yet."""
    if mesh is not None:
        raise NotImplementedError(
            f"mesh-sharded PME is not ported yet ({_MESH}: PME over "
            "torch.distributed)")
    q_np = np.asarray(charges, np.float64)
    if q_np.ndim != 1:
        raise ValueError(f"charges must be (n,); got {q_np.shape}")
    if (box is None) == (cell is None):
        raise ValueError("pass exactly one of box= (orthorhombic "
                         "lengths) or cell= (restricted-triclinic "
                         "(3, 3) matrix)")
    h_np = None
    if cell is not None:
        from vaemolsim_tpu_torch.triclinic import (_perp_widths_np,
                                                   validate_cell)
        h_np = validate_cell(cell)
        w_np = _perp_widths_np(h_np)
        if not r_cutoff * 2.0 <= w_np.min() + 1e-9:
            raise ValueError(
                f"r_cutoff {r_cutoff} must be <= half the minimum "
                f"perpendicular width ({w_np.min() / 2}) of the cell "
                "for minimum-image validity")
        box_np = np.sqrt((h_np ** 2).sum(axis=1))
    else:
        box_np = np.asarray(box, np.float64)
        if box_np.shape != (3,):
            raise ValueError(f"box must be 3 lengths; got {box_np.shape}")
        if not r_cutoff * 2.0 <= box_np.min():
            raise ValueError(
                f"r_cutoff {r_cutoff} must be <= half the smallest box "
                f"edge ({box_np.min() / 2}) for minimum-image validity")
    if order < 3:
        raise ValueError("PME needs spline order >= 3 for usable "
                         "accuracy (4 is standard)")
    dev = default_device(device)
    ln_tol = float(np.sqrt(-np.log(tolerance)))
    alpha_v = float(alpha) if alpha is not None else ln_tol / float(r_cutoff)
    k_cut = 2.0 * alpha_v * ln_tol
    if grid_shape is None:
        need = np.ceil(1.5 * k_cut * box_np / np.pi).astype(int)
        grid_shape = tuple(_next_smooth(g) for g in need)
    gx, gy, gz = (int(g) for g in grid_shape)
    for g in (gx, gy, gz):
        if g < 2 * order:
            raise ValueError(f"grid_shape {grid_shape} too coarse for "
                             f"order {order} (need >= {2 * order})")

    # Influence function on the rfft half-spectrum, built with numpy.
    def axis_modes(g):
        m = np.arange(g)
        return np.where(m <= g // 2, m, m - g)

    mx, my, mz = axis_modes(gx), axis_modes(gy), np.arange(gz // 2 + 1)
    if h_np is None:
        kx = 2 * np.pi * mx / box_np[0]
        ky = 2 * np.pi * my / box_np[1]
        kz = 2 * np.pi * mz / box_np[2]
        k2 = (kx[:, None, None] ** 2 + ky[None, :, None] ** 2
              + kz[None, None, :] ** 2)
    else:
        m3 = np.stack(np.meshgrid(mx, my, mz, indexing="ij"), axis=0)
        kvec = 2 * np.pi * np.einsum("ab,bxyz->axyz", np.linalg.inv(h_np),
                                     m3)
        k2 = (kvec ** 2).sum(axis=0)

    def euler_b2(g, m_signed):
        """|b(m)|^2 per axis mode (Essmann eq. 4.4); an even-order spline
        cannot represent the Nyquist mode of an even grid: dropped."""
        mvals = _bspline_integer_values(order)
        kk = np.arange(order - 1)
        ph = np.exp(2j * np.pi * m_signed[:, None] * kk[None, :] / g)
        b2 = 1.0 / np.maximum(np.abs((mvals[None, :] * ph).sum(1)) ** 2,
                              1e-300)
        if order % 2 == 0 and g % 2 == 0:
            b2 = np.where(np.abs(m_signed) == g // 2, 0.0, b2)
        return b2

    with np.errstate(divide="ignore", invalid="ignore"):
        infl = (4 * np.pi / k2) * np.exp(-k2 / (4 * alpha_v * alpha_v))
    infl[0, 0, 0] = 0.0
    infl = infl * (euler_b2(gx, mx)[:, None, None]
                   * euler_b2(gy, my)[None, :, None]
                   * euler_b2(gz, mz)[None, None, :])
    # Half-spectrum: double every mode whose conjugate is not stored.
    dbl = np.full(mz.size, 2.0)
    dbl[0] = 1.0
    if gz % 2 == 0:
        dbl[-1] = 1.0
    vol = (float(np.prod(box_np)) if h_np is None
           else float(abs(np.linalg.det(h_np))))
    infl_t = _f32(0.5 / vol * infl * dbl[None, None, :], dev)

    q = _f32(q_np, dev)
    n_q = q_np.size
    box_t = _f32(box_np, dev)
    grid_t = _f32([gx, gy, gz], dev)
    sizes = torch.as_tensor([gx, gy, gz], device=dev)
    j_order = torch.arange(order, device=dev)
    excl_pairs = real_mask = None
    if exclude is not None:
        m_host = _exclude_matrix(exclude, n_q)
        pairs = np.argwhere(np.triu(m_host, 1))
        if pairs.size:
            excl_pairs = (torch.as_tensor(pairs[:, 0], device=dev),
                          torch.as_tensor(pairs[:, 1], device=dev))
    if include_real_space:
        m = np.triu(np.ones((n_q, n_q), bool), k=1)
        if exclude is not None:
            m &= ~_exclude_matrix(exclude, n_q)
        real_mask = torch.as_tensor(m, device=dev)
    rc2 = float(r_cutoff) * float(r_cutoff)

    if h_np is None:
        def _frac(x):
            return x / box_t

        def _wrapx(x):
            return x - box_t * torch.floor(x / box_t)

        def _minimg(d):
            return d - box_t * torch.round(d / box_t)
    else:
        from vaemolsim_tpu_torch import triclinic as tc
        cell_t = _f32(h_np, dev)

        def _frac(x):
            return tc.to_fractional(x, cell_t)

        def _wrapx(x):
            return tc.wrap(x, cell_t)

        def _minimg(d):
            return tc.min_image(d, cell_t)

    def _spread(x: Tensor) -> Tensor:
        """Charges on the (gx, gy, gz) grid: order^3 B-spline points per
        atom, summed by one index_add."""
        s = _frac(x)
        u = (s - torch.floor(s)) * grid_t
        base = torch.floor(u)
        w = _bspline_weights(order, u - base)            # (n, 3, order)
        pts = (base.long()[..., None] - j_order) % sizes[:, None]
        wq = (q[:, None, None, None] * w[:, 0, :, None, None]
              * w[:, 1, None, :, None] * w[:, 2, None, None, :])
        flat = ((pts[:, 0, :, None, None] * gy + pts[:, 1, None, :, None])
                * gz + pts[:, 2, None, None, :])
        grid = torch.zeros(gx * gy * gz, dtype=x.dtype, device=x.device)
        grid = grid.index_add(0, flat.reshape(-1), wq.reshape(-1))
        return grid.reshape(gx, gy, gz)

    def energy(x: Tensor) -> Tensor:
        n = x.shape[-2]
        if n != n_q:
            raise ValueError(f"coords have {n} atoms but charges has {n_q}")
        if x.ndim > 2:
            flat = x.reshape((-1,) + x.shape[-2:])
            return torch.stack([energy(xi) for xi in flat]).reshape(
                x.shape[:-2])
        f = torch.fft.rfftn(_spread(x))
        u_recip = (infl_t * (f.real ** 2 + f.imag ** 2)).sum()
        xw = _wrapx(x)
        total = u_recip
        if include_real_space:
            d = _minimg(xw[:, None, :] - xw[None, :, :])
            r2 = (d * d).sum(-1)
            mask = real_mask & (r2 < rc2)
            r = torch.sqrt(torch.where(mask, r2, 1.0).clamp_min(_EPS))
            qq = q[:, None] * q[None, :]
            total = total + torch.where(
                mask, qq * torch.special.erfc(alpha_v * r) / r, 0.0).sum()
        total = total - alpha_v / math.sqrt(math.pi) * (q * q).sum()
        total = total - math.pi / (2 * vol * alpha_v * alpha_v) * q.sum() ** 2
        if excl_pairs is not None:
            pi, pj = excl_pairs
            de = _minimg(xw[pi] - xw[pj])
            re = torch.sqrt((de * de).sum(-1).clamp_min(_EPS))
            total = total - (q[pi] * q[pj] * torch.special.erf(alpha_v * re)
                             / re).sum()
        return total

    energy.ewald_alpha = alpha_v
    energy.grid_shape = (gx, gy, gz)
    return energy


def composite(*terms: Callable[[Tensor], Tensor]
              ) -> Callable[[Tensor], Tensor]:
    """The sum of potential terms (a force field)."""
    if not terms:
        raise ValueError("composite needs at least one term")

    def energy(x: Tensor) -> Tensor:
        total = terms[0](x)
        for t in terms[1:]:
            total = total + t(x)
        return total

    return energy


def com_restraint(k: float = 1.0, center=0.0) -> Callable[[Tensor], Tensor]:
    """Harmonic restraint on the centre of mass,
    ``k/2 |mean_atoms(x) - center|^2``: removes the translational zero
    mode of a gas-phase cluster.  ``center`` goes to x's device."""
    center = np.asarray(center, np.float32)

    def energy(x: Tensor) -> Tensor:
        c = torch.as_tensor(center, dtype=x.dtype, device=x.device)
        com = x.mean(-2)
        return 0.5 * k * ((com - c) ** 2).sum(-1)

    return energy


def as_log_prob(potential: Callable[[Tensor], Tensor],
                beta: float = 1.0) -> Callable[[Tensor], Tensor]:
    """The MC engine's convention, ``log p~(x) = -beta U(x)`` (the
    engine's ``energy_func`` is a log target density)."""

    def log_prob(x: Tensor) -> Tensor:
        return -beta * potential(x)

    return log_prob


def _value_and_grad(potential, x: Tensor) -> Tuple[Tensor, Tensor]:
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        e = potential(xg)
        (g,) = torch.autograd.grad(e.sum(), xg)
    return e.detach(), g


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through (a, fa), (b, fb), (c, fc)
    with slope fpa at a (NaN where there is none)."""
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    y1, y2 = fb - fa - fpa * db, fc - fa - fpa * dc
    A = (dc ** 2 * y1 + -(db ** 2) * y2) / denom
    B = (-(dc ** 3) * y1 + db ** 3 * y2) / denom
    return a + (-B + torch.sqrt(B * B - 3.0 * A * fpa)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through (a, fa), (b, fb) with
    slope fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


_LS_STEPS, _LS_SLOPE, _LS_CURV, _LS_APPROX, _LS_PRECISION = (
    20, 1e-4, 0.9, 1e-6, 1e-5)


def _zoom_linesearch(fg, p: Tensor, u: Tensor, value: Tensor,
                     grad: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """optax's zoom line search (``scale_by_zoom_linesearch`` with
    ``max_linesearch_steps=20``, ``initial_guess_strategy='one'``,
    ``slope_rtol=1e-4``, ``curv_rtol=0.9``, ``approx_dec_rtol=1e-6``,
    ``stepsize_precision=1e-5``, ``increase_factor=2``, no maximal step)
    along ``u`` from ``p`` (B, P), one search per row: the bracketing
    phase, then the zoom by cubic, quadratic or bisection steps with
    optax's safeguards, and the fall-back to the best step of sufficient
    decrease when the search fails.  Every iteration evaluates ``fg``
    once on all rows; rows whose search has ended are masked.  Returns
    the chosen step sizes, values and gradients."""
    f32 = dict(dtype=p.dtype, device=p.device)
    B = p.shape[0]
    v0 = value
    s0 = (u * grad).sum(-1)
    zero = torch.zeros(B, **f32)
    st = dict(count=torch.zeros(B, dtype=torch.int64, device=p.device),
              stepsize=zero, value=v0, grad=grad, slope=s0,
              dec=torch.full((B,), math.inf, **f32),
              curv=torch.full((B,), math.inf, **f32),
              found=torch.zeros(B, dtype=torch.bool, device=p.device),
              done=torch.zeros(B, dtype=torch.bool, device=p.device),
              failed=torch.zeros(B, dtype=torch.bool, device=p.device),
              low=zero, v_low=v0, s_low=s0, high=zero, v_high=v0,
              s_high=s0, cref=zero, v_cref=v0, safe=zero, v_safe=v0,
              g_safe=grad)

    def dec_err(step, v, sl):
        d = v - v0 - _LS_SLOPE * step * s0
        approx = sl - (2 * _LS_SLOPE - 1.0) * s0
        dv = v - v0 - _LS_APPROX * v0.abs()
        d = torch.minimum(torch.maximum(approx, dv), d).clamp_min(0.0)
        return torch.where(torch.isnan(d), math.inf, d)

    def curv_err(sl):
        c = (sl.abs() - _LS_CURV * s0.abs()).clamp_min(0.0)
        return torch.where(torch.isnan(c), math.inf, c)

    def sel(m, a, b):
        return torch.where(m[:, None] if a.dim() == 2 else m, a, b)

    while True:
        active = ~(st["done"] | st["failed"])
        if not bool(active.any()):
            break
        it, found = st["count"], st["found"]
        # The bracketing phase's trial, and the zoom's.
        new_step = torch.where(it == 0, 1.0, 2.0 * st["stepsize"])
        low, high = st["low"], st["high"]
        delta = (high - low).abs()
        left, right = torch.minimum(high, low), torch.maximum(high, low)
        mc = _cubicmin(low, st["v_low"], st["s_low"], high, st["v_high"],
                       st["cref"], st["v_cref"])
        use_c = (mc > left + 0.2 * delta) & (mc < right - 0.2 * delta)
        mq = _quadmin(low, st["v_low"], st["s_low"], high, st["v_high"])
        use_q = ~use_c & (mq > left + 0.1 * delta) & (mq < right
                                                       - 0.1 * delta)
        middle = torch.where(use_c, mc, st["cref"])
        middle = torch.where(use_q, mq, middle)
        middle = torch.where(~use_c & ~use_q, (low + high) / 2.0, middle)
        step = torch.where(found, middle, new_step)
        v, g = fg(p + step[:, None] * u)
        sl = (g * u).sum(-1)
        dec, curv = dec_err(step, v, sl), curv_err(sl)
        err = torch.maximum(dec, curv)
        ok = err <= 0.0
        # Bracketing phase (Nocedal & Wright algorithm 3.5).
        safe_b = dec <= 0.0
        hi_new = (dec > 0.0) | ((v >= st["value"]) & (it > 0))
        lo_new = (sl >= 0.0) & ~hi_new
        b_low = torch.where(lo_new, step, st["stepsize"])
        b_vlow = torch.where(lo_new, v, st["value"])
        b_slow = torch.where(lo_new, sl, st["slope"])
        b_high = torch.where(lo_new, st["stepsize"], step)
        b_vhigh = torch.where(lo_new, st["value"], v)
        b_shigh = torch.where(lo_new, st["slope"], sl)
        b_found = hi_new | lo_new | ok
        b_failed = (it + 1 >= _LS_STEPS) & ~ok
        # Zoom phase (algorithm 3.6).
        safe_z = (dec <= 0.0) & (v < st["v_safe"])
        hi_mid = (dec > 0.0) | (v >= st["v_low"])
        hi_low = (sl * (high - low) >= 0.0) & ~hi_mid
        z_high = torch.where(hi_low, low, torch.where(hi_mid, step, high))
        z_vhigh = torch.where(hi_low, st["v_low"],
                              torch.where(hi_mid, v, st["v_high"]))
        z_shigh = torch.where(hi_low, st["s_low"],
                              torch.where(hi_mid, sl, st["s_high"]))
        z_low = torch.where(~hi_mid, step, low)
        z_vlow = torch.where(~hi_mid, v, st["v_low"])
        z_slow = torch.where(~hi_mid, sl, st["s_low"])
        moved = hi_mid | hi_low
        z_cref = torch.where(moved, high, low)
        z_vcref = torch.where(moved, st["v_high"], st["v_low"])
        take_safe = torch.where(found, safe_z, safe_b)
        safe = torch.where(take_safe, step, st["safe"])
        v_safe = torch.where(take_safe, v, st["v_safe"])
        g_safe = sel(take_safe, g, st["g_safe"])
        z_failed = (((it + 1) >= _LS_STEPS)
                    | ((delta <= _LS_PRECISION) & (safe > 0.0))) & ~ok
        new = dict(
            count=it + 1, stepsize=step, value=v, grad=g, slope=sl,
            dec=dec, curv=curv, found=torch.where(found, found, b_found),
            done=ok, failed=torch.where(found, z_failed, b_failed),
            low=torch.where(found, z_low, b_low),
            v_low=torch.where(found, z_vlow, b_vlow),
            s_low=torch.where(found, z_slow, b_slow),
            high=torch.where(found, z_high, b_high),
            v_high=torch.where(found, z_vhigh, b_vhigh),
            s_high=torch.where(found, z_shigh, b_shigh),
            cref=torch.where(found, z_cref, b_low),
            v_cref=torch.where(found, z_vcref, b_vlow),
            safe=safe, v_safe=v_safe, g_safe=g_safe)
        # A failed search takes its best step of sufficient decrease.
        fall = new["failed"] & ((safe > 0.0) | torch.isinf(dec))
        new["stepsize"] = torch.where(fall, safe, step)
        new["value"] = torch.where(fall, v_safe, v)
        new["grad"] = sel(fall, g_safe, g)
        st = {k: sel(active, new[k], st[k]) for k in st}
    return st["stepsize"], st["value"], st["grad"]


def _lbfgs_polish(potential, x0: Tensor, n_steps: int,
                  memory: int = 10) -> Tensor:
    """``n_steps`` of optax's ``lbfgs()`` on every leading-axis
    configuration at once (each with its own history, step size and
    line search): the two-loop recursion over the last ``memory``
    position and gradient differences, the initial scale ``<dw, du> /
    <du, du>`` (``min(1, 1 / |g|)`` at the first step), and
    :func:`_zoom_linesearch` along the negated direction."""
    shape = x0.shape
    n_ev = shape[-2] * shape[-1]
    p = x0.reshape(-1, n_ev)
    B = p.shape[0]

    def fg(flat):
        e, g = _value_and_grad(potential, flat.reshape((B,) + shape[-2:]))
        return e.reshape(B), g.reshape(B, n_ev)

    value, grad = fg(p)
    dws = torch.zeros((memory, B, n_ev), dtype=p.dtype, device=p.device)
    dus = torch.zeros_like(dws)
    rhos = torch.zeros((memory, B), dtype=p.dtype, device=p.device)
    p_prev, g_prev = torch.zeros_like(p), torch.zeros_like(p)
    for k in range(n_steps):
        idx, prev = k % memory, (k - 1) % memory
        if k > 0:
            dw, du = p - p_prev, grad - g_prev
            vdot = (du * dw).sum(-1)
            dws[prev], dus[prev] = dw, du
            rhos[prev] = torch.where(vdot == 0.0, 0.0, 1.0 / vdot)
            den = (du * du).sum(-1)
            gamma = torch.where(den > 0.0, vdot / den, 1.0)
        else:
            rhos[prev] = 0.0
            gamma = torch.clamp(
                1.0 / torch.sqrt((grad * grad).sum(-1)), max=1.0)
        order = [(idx + j) % memory for j in range(memory)]
        vec, alphas = grad, {}
        for i in reversed(order):
            alphas[i] = rhos[i] * (dws[i] * vec).sum(-1)
            vec = vec - alphas[i][:, None] * dus[i]
        vec = gamma[:, None] * vec
        for i in order:
            beta = rhos[i] * (dus[i] * vec).sum(-1)
            vec = vec + (alphas[i] - beta)[:, None] * dws[i]
        p_prev, g_prev = p, grad
        u = -vec
        step, value, grad = _zoom_linesearch(fg, p, u, value, grad)
        p = p + step[:, None] * u
    return p.reshape(shape)


def minimize_energy(potential: Callable[[Tensor], Tensor], x0: Tensor, *,
                    steps: int = 500, lr: float = 0.01, clip: float = 1.0,
                    polish_lbfgs: int = 0) -> Tensor:
    """Relax configurations to a local energy minimum, every leading-axis
    configuration independently: ``steps // 2`` Adam steps at ``lr``,
    then the rest at ``lr / 10`` with fresh moments, each step's
    displacement clipped to ``clip`` per atom.  Adam is optax's (and
    ``torch.optim.Adam``'s): b1 0.9, b2 0.999, eps 1e-8, bias-corrected
    moments; the clip acts on its step, so the update is written out
    here.  Returns the relaxed coordinates (no graph).

    ``polish_lbfgs > 0`` then takes that many L-BFGS steps with a zoom
    line search (optax's ``lbfgs()``, written out in
    :func:`_lbfgs_polish`), batched over the configurations: the
    superlinear refinement to the basin floor once Adam has escaped the
    blow-up region.  Never start L-BFGS from overlapping configurations:
    the line search along an r^-12 wall direction is what the clipped
    Adam phases exist to avoid."""
    b1, b2, eps = 0.9, 0.999, 1e-8

    def phase(x, rate, n):
        m = torch.zeros_like(x)
        v = torch.zeros_like(x)
        for t in range(1, n + 1):
            with torch.enable_grad():
                xg = x.detach().requires_grad_(True)
                (g,) = torch.autograd.grad(potential(xg).sum(), xg)
            m = b1 * m + (1.0 - b1) * g
            v = b2 * v + (1.0 - b2) * g * g
            d = -rate * (m / (1.0 - b1 ** t)) / (
                torch.sqrt(v / (1.0 - b2 ** t)) + eps)
            norm = torch.sqrt((d * d).sum(-1, keepdim=True).clamp_min(_EPS))
            x = x + d * torch.clamp(clip / norm, max=1.0)
        return x

    with torch.no_grad():
        x = phase(x0.detach(), lr, steps // 2)
        x = phase(x, lr / 10.0, steps - steps // 2)
        if polish_lbfgs > 0:
            x = _lbfgs_polish(potential, x, int(polish_lbfgs))
        return x
