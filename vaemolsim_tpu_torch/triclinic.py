"""General triclinic (sheared) periodic cells (port of
``vaemolsim_tpu/triclinic.py``).

Conventions, as in the JAX package: the restricted-triclinic form, a
LOWER-TRIANGULAR cell matrix ``H`` whose ROWS are the cell vectors
``a = (ax, 0, 0)``, ``b = (bx, by, 0)``, ``c = (cx, cy, cz)``, positive
diagonal, and tilts ``|bx| <= ax/2``, ``|cx| <= ax/2``, ``|cy| <= by/2``.
Cartesian and fractional coordinates relate by ``x = s @ H``, written
out element by element (no 3-wide matrix product).  The minimum image
is SEQUENTIAL (remove multiples of c, then b, then a), exact for
separations below half the least perpendicular width.

- cell geometry: :func:`validate_cell` (NumPy, build time),
  :func:`cell_volume`, :func:`perpendicular_widths`,
  :func:`to_fractional`, :func:`from_fractional`, :func:`wrap`,
  :func:`min_image`, :func:`lattice_in_cell`;
- cell-parametric potentials ``energy(x, cell)``:
  :func:`lennard_jones_triclinic` and :func:`ewald_coulomb_triclinic`;
- :func:`kinetic_tensor` and :func:`pressure_tensor`, the full virial
  by the strain derivative ``-dU/d(eps)`` at ``eps = 0`` through
  ``torch.autograd``;
- :func:`lennard_jones_cell_triclinic`, an O(N) cell list binned in
  fractional space for a static cell (plain PyTorch: the cell-pair
  kernel stays orthorhombic, as the JAX package's Pallas kernel does);
- anisotropic NPT Monte Carlo: :class:`NPTTriclinicState`,
  :func:`npt_triclinic_init`, :func:`make_npt_triclinic_step` (with
  ``step.draw`` / ``step.move``) and :func:`run_npt_triclinic`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vaemolsim_tpu_torch.config import default_device
from vaemolsim_tpu_torch.mcmc.engine import log_uniform

Tensor = torch.Tensor

__all__ = [
    "validate_cell", "cell_volume", "perpendicular_widths", "wrap",
    "to_fractional", "from_fractional", "min_image", "lattice_in_cell",
    "lennard_jones_triclinic", "ewald_coulomb_triclinic",
    "pressure_tensor", "kinetic_tensor",
    "lennard_jones_cell_triclinic", "NPTTriclinicState",
    "npt_triclinic_init", "make_npt_triclinic_step", "run_npt_triclinic",
]

_EPS = 1e-12


# ---------------------------------------------------------------------
# Cell geometry
# ---------------------------------------------------------------------

def validate_cell(cell) -> np.ndarray:
    """The (3, 3) float64 NumPy cell of a restricted-triclinic cell
    matrix (rows a, b, c) or of 3 edge lengths.  Raises on an upper
    triangle, a non-positive diagonal, or tilts outside the half-edge
    bounds (where the sequential minimum image is not valid)."""
    if isinstance(cell, torch.Tensor):
        cell = cell.detach().cpu().numpy()
    h = np.asarray(cell, np.float64)
    if h.shape == (3,):
        h = np.diag(h)
    if h.shape != (3, 3):
        raise ValueError(f"cell must be (3,3) or 3 lengths; got {h.shape}")
    if np.abs(h[np.triu_indices(3, k=1)]).max() > 1e-12:
        raise ValueError("cell must be LOWER triangular (rows a, b, c "
                         "with a along x) — rotate the cell first")
    if (np.diag(h) <= 0).any():
        raise ValueError(f"cell diagonal must be positive; got {np.diag(h)}")
    ax, by = h[0, 0], h[1, 1]
    bad = []
    if abs(h[1, 0]) > ax / 2 + 1e-12:
        bad.append(f"|bx|={abs(h[1, 0])} > ax/2={ax / 2}")
    if abs(h[2, 0]) > ax / 2 + 1e-12:
        bad.append(f"|cx|={abs(h[2, 0])} > ax/2={ax / 2}")
    if abs(h[2, 1]) > by / 2 + 1e-12:
        bad.append(f"|cy|={abs(h[2, 1])} > by/2={by / 2}")
    if bad:
        raise ValueError("tilt factors outside the restricted-triclinic "
                         "bounds: " + "; ".join(bad))
    return h


def _perp_widths_np(h: np.ndarray) -> np.ndarray:
    a, b, c = h
    v = abs(h[0, 0] * h[1, 1] * h[2, 2])

    def area(u, w):
        cr = np.cross(u, w)
        return np.sqrt((cr * cr).sum() + _EPS)

    return np.array([v / area(b, c), v / area(a, c), v / area(a, b)])


def cell_volume(cell: Tensor) -> Tensor:
    """V = det H, the product of the diagonal."""
    return cell[..., 0, 0] * cell[..., 1, 1] * cell[..., 2, 2]


def perpendicular_widths(cell: Tensor) -> Tensor:
    """(..., 3) distances between opposite faces, ``V / |face area|``."""
    a, b, c = cell[..., 0, :], cell[..., 1, :], cell[..., 2, :]
    v = cell_volume(cell).abs()

    def area(u, w):
        cr = torch.linalg.cross(u, w, dim=-1)
        return torch.sqrt((cr * cr).sum(-1) + _EPS)

    return torch.stack([v / area(b, c), v / area(a, c), v / area(a, b)], -1)


def _c(h: Tensor, i: int, j: int) -> Tensor:
    return h[..., i, j][..., None]


def to_fractional(x: Tensor, cell: Tensor) -> Tensor:
    """Cartesian -> fractional (``x = s @ H``) by back-substitution on the
    lower-triangular H, element by element."""
    h = cell.to(x.dtype)
    s2 = x[..., 2] / _c(h, 2, 2)
    s1 = (x[..., 1] - s2 * _c(h, 2, 1)) / _c(h, 1, 1)
    s0 = (x[..., 0] - s1 * _c(h, 1, 0) - s2 * _c(h, 2, 0)) / _c(h, 0, 0)
    return torch.stack([s0, s1, s2], -1)


def from_fractional(s: Tensor, cell: Tensor) -> Tensor:
    """Fractional -> Cartesian, element by element."""
    h = cell.to(s.dtype)
    s0, s1, s2 = s[..., 0], s[..., 1], s[..., 2]
    x0 = s0 * _c(h, 0, 0) + s1 * _c(h, 1, 0) + s2 * _c(h, 2, 0)
    x1 = s1 * _c(h, 1, 1) + s2 * _c(h, 2, 1)
    x2 = s2 * _c(h, 2, 2)
    return torch.stack([x0, x1, x2], -1)


def wrap(x: Tensor, cell: Tensor) -> Tensor:
    """Coordinates wrapped into the primary cell (fractional [0, 1))."""
    s = to_fractional(x, cell)
    return from_fractional(s - torch.floor(s), cell)


def min_image(d: Tensor, cell: Tensor) -> Tensor:
    """Sequential minimum-image displacement: multiples of c fix z, then
    b fixes y, then a fixes x."""
    h = cell.to(d.dtype)
    d = d - h[..., 2, :] * torch.round(d[..., 2:3] / h[..., 2, 2][..., None])
    d = d - h[..., 1, :] * torch.round(d[..., 1:2] / h[..., 1, 1][..., None])
    d = d - h[..., 0, :] * torch.round(d[..., 0:1] / h[..., 0, 0][..., None])
    return d


def lattice_in_cell(n_atoms: int, cell, device=None) -> Tensor:
    """An m^3 fractional grid (first ``n_atoms`` points) mapped through
    H: an overlap-free start, on ``device`` (by default the card)."""
    h = validate_cell(cell)
    m = int(np.ceil(n_atoms ** (1.0 / 3.0)))
    g = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n_atoms] / m
    return torch.as_tensor((g @ h).astype(np.float32),
                           device=default_device(device))


def _pair_cell(cell: Tensor) -> Tensor:
    """A batch of cells broadcast against the (..., n, n, 3) pair axes."""
    return cell[..., None, None, :, :] if cell.dim() > 2 else cell


# ---------------------------------------------------------------------
# Potentials
# ---------------------------------------------------------------------

def lennard_jones_triclinic(sigma: float = 1.0, epsilon: float = 1.0, *,
                            cutoff: float, shift: bool = True
                            ) -> Callable[[Tensor, Tensor], Tensor]:
    """Dense periodic LJ in a triclinic cell, ``energy(x, cell)``: the cell
    is an argument (and stays in the autograd graph), batched over the
    leading axes of ``x`` with a matching or broadcastable batch of
    cells.  ``shift`` removes the cutoff discontinuity."""
    sig2 = float(sigma) ** 2
    eps4 = 4.0 * float(epsilon)
    rc2 = float(cutoff) ** 2
    s6c = (sig2 / rc2) ** 3
    u_cut = eps4 * (s6c * s6c - s6c) if shift else 0.0
    cache = {}

    def energy(x: Tensor, cell: Tensor) -> Tensor:
        n = x.shape[-2]
        key = (n, x.device)
        if key not in cache:
            cache[key] = torch.ones((n, n), dtype=torch.bool,
                                    device=x.device).triu(1)
        d = x[..., :, None, :] - x[..., None, :, :]
        d = min_image(d, _pair_cell(cell.to(x.dtype)))
        r2 = (d * d).sum(-1)
        mask = cache[key] & (r2 < rc2)
        r2s = torch.where(mask, r2, 1.0)
        s6 = (sig2 / r2s) ** 3
        u = eps4 * (s6 * s6 - s6) - u_cut
        return torch.where(mask, u, 0.0).sum((-2, -1))

    return energy


def ewald_coulomb_triclinic(charges, *, reference_cell, r_cutoff: float,
                            exclude: Optional[np.ndarray] = None,
                            alpha: Optional[float] = None,
                            tolerance: float = 1e-5,
                            k_cutoff: Optional[float] = None,
                            include_real_space: bool = True, device=None
                            ) -> Callable[[Tensor, Tensor], Tensor]:
    """Exact periodic electrostatics in a sheared cell, cell-parametric
    ``energy(x, cell)``: the reciprocal sum over the half-space integer
    modes fixed at ``reference_cell`` (``|k| <= k_cutoff`` there) with
    k-values ``2 pi H^-1 n`` re-evaluated from the call-time cell
    element by element (so the strain derivative sees the reciprocal
    virial), the erfc real-space sum with the sequential minimum image,
    and the self, background and excluded-pair terms, as the
    orthorhombic ``potentials.ewald_coulomb``.  The phase contraction is
    a float32 product: run it with TF32 off on the card.  Tables live on
    ``device`` (by default the card)."""
    from vaemolsim_tpu_torch.potentials import _exclude_matrix
    dev = default_device(device)
    q_np = np.asarray(charges, np.float64)
    if q_np.ndim != 1:
        raise ValueError(f"charges must be (n,); got {q_np.shape}")
    h_ref = validate_cell(reference_cell)
    w_ref = _perp_widths_np(h_ref)
    if not (r_cutoff * 2.0 <= w_ref.min() + 1e-9):
        raise ValueError(
            f"r_cutoff {r_cutoff} must be <= half the minimum "
            f"perpendicular width ({w_ref.min() / 2}) of the reference "
            "cell for minimum-image validity")
    ln_tol = float(np.sqrt(-np.log(tolerance)))
    alpha_v = float(alpha) if alpha is not None else ln_tol / float(r_cutoff)
    k_cut = (float(k_cutoff) if k_cutoff is not None
             else 2.0 * alpha_v * ln_tol)
    row_len = np.sqrt((h_ref ** 2).sum(axis=1))
    n_max = np.maximum(np.ceil(k_cut * row_len / (2 * np.pi)),
                       1).astype(int)
    nn = np.stack(np.meshgrid(*[np.arange(-m, m + 1) for m in n_max],
                              indexing="ij"), -1).reshape(-1, 3)
    half = ((nn[:, 0] > 0)
            | ((nn[:, 0] == 0) & (nn[:, 1] > 0))
            | ((nn[:, 0] == 0) & (nn[:, 1] == 0) & (nn[:, 2] > 0)))
    nn = nn[half]
    k_ref = 2 * np.pi * nn @ np.linalg.inv(h_ref).T
    nn = nn[(k_ref ** 2).sum(-1) <= k_cut * k_cut]
    if nn.shape[0] == 0:
        raise ValueError("empty k-vector set; increase k_cutoff/"
                         "tolerance")
    modes = torch.as_tensor(nn.astype(np.float32), device=dev)
    q = torch.as_tensor(q_np.astype(np.float32), device=dev)
    n_q = q_np.size
    qq = q[:, None] * q[None, :]
    excl_np = None if exclude is None else _exclude_matrix(exclude, n_q)
    real_mask = excl_mask = None
    if include_real_space:
        m = np.triu(np.ones((n_q, n_q), bool), k=1)
        if excl_np is not None:
            m &= ~excl_np
        real_mask = torch.as_tensor(m, device=dev)
    if excl_np is not None:
        excl_mask = torch.as_tensor(np.triu(excl_np, k=1), device=dev)
    sum_q2 = float((q * q).sum())
    sum_q = float(q.sum())

    def _k_vectors(h: Tensor) -> Tensor:
        n0, n1, n2 = modes[:, 0], modes[:, 1], modes[:, 2]
        k0 = n0 / _c(h, 0, 0)
        k1 = (n1 - k0 * _c(h, 1, 0)) / _c(h, 1, 1)
        k2 = (n2 - k0 * _c(h, 2, 0) - k1 * _c(h, 2, 1)) / _c(h, 2, 2)
        return 2 * math.pi * torch.stack([k0, k1, k2], -1)

    def energy(x: Tensor, cell: Tensor) -> Tensor:
        n = x.shape[-2]
        if n != n_q:
            raise ValueError(f"coords have {n} atoms but charges has {n_q}")
        h = cell.to(x.dtype)
        vol = cell_volume(h)
        xw = wrap(x, h)
        k = _k_vectors(h)                              # (..., n_k, 3)
        k2 = (k * k).sum(-1)
        w = (4 * math.pi / k2) * torch.exp(-k2 / (4 * alpha_v * alpha_v))
        phase = torch.einsum("...nd,...kd->...nk", xw, k)
        s_cos = (q[:, None] * torch.cos(phase)).sum(-2)
        s_sin = (q[:, None] * torch.sin(phase)).sum(-2)
        total = (w * (s_cos ** 2 + s_sin ** 2)).sum(-1) / vol
        h_pair = _pair_cell(h)
        if include_real_space or excl_mask is not None:
            d = min_image(xw[..., :, None, :] - xw[..., None, :, :], h_pair)
            r2 = (d * d).sum(-1)
        if include_real_space:
            mask = real_mask & (r2 < r_cutoff * r_cutoff)
            r = torch.sqrt(torch.where(mask, r2, 1.0).clamp_min(_EPS))
            total = total + torch.where(
                mask, qq * torch.special.erfc(alpha_v * r) / r,
                0.0).sum((-2, -1))
        total = total - alpha_v / math.sqrt(math.pi) * sum_q2
        total = total - math.pi / (2 * vol * alpha_v * alpha_v) * sum_q ** 2
        if excl_mask is not None:
            re = torch.sqrt(torch.where(excl_mask, r2, 1.0).clamp_min(_EPS))
            total = total - torch.where(
                excl_mask, qq * torch.special.erf(alpha_v * re) / re,
                0.0).sum((-2, -1))
        return total

    energy.ewald_alpha = alpha_v
    return energy


def kinetic_tensor(v: Tensor, mass=1.0) -> Tensor:
    """``sum_i m v_i (x) v_i``, (..., 3, 3)."""
    m = torch.as_tensor(mass, dtype=v.dtype, device=v.device)
    if m.dim() == 1:
        m = m[:, None]
    return torch.einsum("...ia,...ib->...ab", m * v, v)


def pressure_tensor(energy: Callable[[Tensor, Tensor], Tensor], x: Tensor,
                    cell: Tensor, *, v: Optional[Tensor] = None,
                    mass=1.0, kT: Optional[float] = None) -> Tensor:
    """The (..., 3, 3) instantaneous pressure tensor by the strain
    derivative: ``P V = K - dU/d(eps)`` at ``eps = 0`` under ``x -> x (1
    + eps)``, ``H -> H (1 + eps)``, one autograd gradient through the
    cell-parametric ``energy(x, cell)``, symmetrised.  Batched: each
    leading-axis configuration gets its own strain (the gradient of the
    summed energies).  The kinetic part is ``v``'s, else ``N kT I``."""
    h = torch.as_tensor(cell, dtype=x.dtype, device=x.device)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    batch = torch.broadcast_shapes(x.shape[:-2], h.shape[:-2])
    with torch.enable_grad():
        eps = torch.zeros(batch + (3, 3), dtype=x.dtype, device=x.device,
                          requires_grad=True)
        f = eye + eps
        u = energy(x.detach() @ f, h.detach() @ f)
        (g,) = torch.autograd.grad(u.sum(), eps)
    virial = -g
    virial = 0.5 * (virial + virial.transpose(-1, -2))
    if v is not None:
        kin = kinetic_tensor(v, mass)
    else:
        if kT is None:
            raise ValueError("pass velocities v= or kT= for the "
                             "kinetic part")
        kin = x.shape[-2] * float(kT) * eye
    return (kin + virial) / cell_volume(h)[..., None, None]


# ---------------------------------------------------------------------
# Cell list (fractional-space binning, static cell)
# ---------------------------------------------------------------------

class TriclinicNeighborList(NamedTuple):
    """Wrapped coordinates in (n_cells, capacity) slots, the slots' atom
    ids (n where empty), each atom's flat slot, and the positions at
    build time."""
    blocks: Tensor
    block_ids: Tensor
    slot_of: Tensor
    x_build: Tensor


def lennard_jones_cell_triclinic(cell, *, cutoff: float, skin: float = 0.3,
                                 capacity: int = 32, sigma: float = 1.0,
                                 epsilon: float = 1.0, shift: bool = True,
                                 device=None):
    """O(N) cell-list LJ for a static triclinic cell: ``(build, energy)``
    with the orthorhombic ``lennard_jones_cell_neighbor`` contract (build
    once, reuse while no atom moves more than skin/2; NaN on a cell
    overflowing ``capacity`` or an atom drifting past skin/2).  Axis k is
    split into ``floor(w_perp_k / (cutoff + skin))`` fractional slabs, so
    every pair within the build cutoff lies in the 27 neighbouring cells;
    distances are Cartesian with the sequential minimum image."""
    dev = default_device(device)
    h_np = validate_cell(cell)
    h = torch.as_tensor(h_np.astype(np.float32), device=dev)
    rc_build = float(cutoff) + float(skin)
    w = _perp_widths_np(h_np)
    n_grid = np.maximum(np.floor(w / rc_build).astype(np.int64), 1)
    if (n_grid < 3).any():
        raise ValueError(
            f"cell with perpendicular widths {w.tolist()} fits "
            f"{n_grid.tolist()} bins of width >= cutoff+skin {rc_build};"
            " need >= 3 per axis (use lennard_jones_triclinic dense)")
    n_cells = int(n_grid.prod())
    strides = np.array([n_grid[1] * n_grid[2], n_grid[2], 1], np.int64)
    offs = np.stack(np.meshgrid(*[[-1, 0, 1]] * 3, indexing="ij"),
                    -1).reshape(-1, 3)
    g3 = np.stack(np.unravel_index(np.arange(n_cells), n_grid), -1)
    cell_nb = torch.as_tensor(
        ((g3[:, None, :] + offs[None, :, :]) % n_grid) @ strides,
        device=dev)
    grid_t = torch.as_tensor(n_grid.astype(np.float32), device=dev)
    grid_max = torch.as_tensor(n_grid - 1, device=dev)
    strides_t = torch.as_tensor(strides, device=dev)
    sig2 = float(sigma) ** 2
    eps4 = 4.0 * float(epsilon)
    rc2 = float(cutoff) ** 2
    s6c = (sig2 / float(cutoff) ** 2) ** 3
    u_cut = eps4 * (s6c * s6c - s6c) if shift else 0.0
    drift2_max = (skin / 2.0) ** 2
    n_slots = n_cells * capacity
    fill = 2.0 * rc_build

    def build(x: Tensor) -> TriclinicNeighborList:
        n = x.shape[0]
        s = to_fractional(x, h)
        s = s - torch.floor(s)
        xw = from_fractional(s, h)
        cid = torch.minimum((s * grid_t).long().clamp_min(0), grid_max)
        cid = (cid * strides_t).sum(-1)
        cid_sorted, order = torch.sort(cid, stable=True)
        rank = torch.searchsorted(cid_sorted, cid_sorted, side="left")
        slot_in_cell = torch.arange(n, device=x.device) - rank
        slot = torch.where(slot_in_cell < capacity,
                           cid_sorted * capacity + slot_in_cell, n_slots)
        blocks = torch.full((n_slots + 1, 3), fill, dtype=x.dtype,
                            device=x.device)
        blocks[slot] = xw[order]
        ids = torch.full((n_slots + 1,), n, dtype=torch.long,
                         device=x.device)
        ids[slot] = order
        slot_of = torch.zeros((n,), dtype=torch.long, device=x.device)
        slot_of[order] = slot
        overflow = (slot_in_cell >= capacity).any()
        blocks = torch.where(overflow, math.nan, 1.0) * blocks[:-1]
        return TriclinicNeighborList(
            blocks.reshape(n_cells, capacity, 3),
            ids[:-1].reshape(n_cells, capacity), slot_of, x)

    def energy(nl: TriclinicNeighborList, x: Tensor) -> Tensor:
        n = x.shape[0]
        s = to_fractional(x, h)
        xw = from_fractional(s - torch.floor(s), h)
        drift = min_image(x - nl.x_build, h)
        bad = ((drift * drift).sum(-1) > drift2_max).any()
        cur = torch.full((n_slots + 1, 3), fill, dtype=x.dtype,
                         device=x.device).index_put((nl.slot_of,), xw)
        cur = cur[:-1].reshape(n_cells, capacity, 3)
        nb = cur[cell_nb]                     # (n_cells, 27, cap, 3)
        nb_ids = nl.block_ids[cell_nb]        # (n_cells, 27, cap)
        d = cur[:, None, :, None, :] - nb[:, :, None, :, :]
        d = min_image(d, h)
        r2 = (d * d).sum(-1)
        ids_i = nl.block_ids[:, None, :, None]
        ids_j = nb_ids[:, :, None, :]
        mask = (ids_i < n) & (ids_j < n) & (ids_i != ids_j) & (r2 < rc2)
        r2s = torch.where(mask, r2, 1.0)
        s6 = (sig2 / r2s) ** 3
        u = eps4 * (s6 * s6 - s6) - u_cut
        tot = 0.5 * torch.where(mask, u, 0.0).sum()
        return torch.where(bad | torch.isnan(nl.blocks).any(), math.nan,
                           tot)

    return build, energy


# ---------------------------------------------------------------------
# Anisotropic NPT Monte Carlo
# ---------------------------------------------------------------------

def _count(device) -> Tensor:
    return torch.zeros((), dtype=torch.int64, device=device)


@dataclass
class NPTTriclinicState:
    """Per-chain coordinates (..., n, 3), cell matrices (..., 3, 3),
    potential energies (...,), the chains' generator and exact int64
    displacement and cell trial / acceptance counts."""

    x: Tensor
    cell: Tensor
    energy: Tensor
    generator: torch.Generator
    disp_trials: Tensor
    disp_acc: Tensor
    cell_trials: Tensor
    cell_acc: Tensor

    @property
    def volume(self) -> Tensor:
        return cell_volume(self.cell)

    @property
    def disp_acceptance_rate(self) -> Tensor:
        return self.disp_acc.double() / self.disp_trials.double()

    @property
    def cell_acceptance_rate(self) -> Tensor:
        return self.cell_acc.double() / self.cell_trials.double()


def npt_triclinic_init(energy: Callable[[Tensor, Tensor], Tensor],
                       x: Tensor, cell,
                       generator: torch.Generator) -> NPTTriclinicState:
    """The initial state: ``cell`` validated and given to every chain."""
    h = torch.as_tensor(validate_cell(cell).astype(np.float32),
                        device=x.device)
    if x.dim() > 2:
        h = h.expand(x.shape[:-2] + (3, 3)).clone()
    with torch.no_grad():
        e = energy(x, h)
    return NPTTriclinicState(x, h, e, generator, _count(x.device),
                             _count(x.device), _count(x.device),
                             _count(x.device))


_TRI = ((0, 0), (1, 1), (2, 2), (1, 0), (2, 0), (2, 1))


def make_npt_triclinic_step(energy: Callable[[Tensor, Tensor], Tensor], *,
                            beta: float, pressure: float,
                            dx_scale: float = 0.1, dh_scale: float = 0.02,
                            min_perp: float = 0.0,
                            max_tilt_frac: float = 0.5,
                            diagonal_only: bool = False
                            ) -> Callable[[NPTTriclinicState],
                                          NPTTriclinicState]:
    """One anisotropic-NPT sweep: an all-atom Gaussian displacement trial,
    then a cell trial that moves one random lower-triangle component of
    H by ``dh_scale`` N(0, 1) at fixed fractional coordinates, accepted
    with ``exp(-beta dU - beta P dV + N ln(V'/V))``.  A cell with a
    non-positive diagonal, a tilt beyond ``max_tilt_frac`` of its edge or
    a perpendicular width at or below ``min_perp`` is rejected.
    ``diagonal_only`` moves the edge lengths only.  ``step.draw(state)``
    gives the sweep's draws (normals, accept draws, the component) from
    the state's generator and ``step.move(state, noise)`` runs the sweep
    on given draws."""
    b = float(beta)
    p = float(pressure)
    n_comp = 3 if diagonal_only else 6

    def draw(st: NPTTriclinicState) -> dict:
        g, x, e = st.generator, st.x, st.energy
        kw = dict(generator=g, dtype=x.dtype, device=x.device)
        return dict(
            disp=torch.randn(x.shape, **kw),
            disp_logu=log_uniform(g, e.shape, e.dtype, e.device),
            comp=torch.randint(0, n_comp, e.shape, generator=g,
                               device=x.device),
            delta=torch.randn(e.shape, **kw),
            cell_logu=log_uniform(g, e.shape, e.dtype, e.device))

    def move(st: NPTTriclinicState, noise: dict) -> NPTTriclinicState:
        n = st.x.shape[-2]
        x_new = st.x + dx_scale * noise["disp"]
        e_new = energy(x_new, st.cell)
        acc = noise["disp_logu"] <= -b * (e_new - st.energy)
        x = torch.where(acc[..., None, None], x_new, st.x)
        e = torch.where(acc, e_new, st.energy)
        tri = torch.as_tensor(_TRI, device=st.x.device)
        ij = tri[noise["comp"]]                        # (..., 2)
        flat = ij[..., 0] * 3 + ij[..., 1]
        bump = torch.nn.functional.one_hot(flat, 9).to(st.x.dtype)
        bump = (bump * (dh_scale * noise["delta"])[..., None]).reshape(
            st.cell.shape)
        h_new = st.cell + bump
        x_cand = from_fractional(to_fractional(x, st.cell), h_new)
        e_cand = energy(x_cand, h_new)
        v_old, v_new = cell_volume(st.cell), cell_volume(h_new)
        diag = torch.stack([h_new[..., 0, 0], h_new[..., 1, 1],
                            h_new[..., 2, 2]], -1)
        legal = ((diag > 0.0).all(-1)
                 & (h_new[..., 1, 0].abs()
                    <= max_tilt_frac * h_new[..., 0, 0])
                 & (h_new[..., 2, 0].abs()
                    <= max_tilt_frac * h_new[..., 0, 0])
                 & (h_new[..., 2, 1].abs()
                    <= max_tilt_frac * h_new[..., 1, 1])
                 & (perpendicular_widths(h_new) > min_perp).all(-1))
        log_acc = (-b * (e_cand - e) - b * p * (v_new - v_old)
                   + n * torch.log(v_new.clamp_min(_EPS) / v_old))
        acc_c = legal & (noise["cell_logu"] <= log_acc)
        return NPTTriclinicState(
            x=torch.where(acc_c[..., None, None], x_cand, x),
            cell=torch.where(acc_c[..., None, None], h_new, st.cell),
            energy=torch.where(acc_c, e_cand, e), generator=st.generator,
            disp_trials=st.disp_trials + acc.numel(),
            disp_acc=st.disp_acc + acc.sum(),
            cell_trials=st.cell_trials + acc_c.numel(),
            cell_acc=st.cell_acc + acc_c.sum())

    @torch.no_grad()
    def step(st: NPTTriclinicState) -> NPTTriclinicState:
        return move(st, draw(st))

    step.draw, step.move = draw, move
    return step


def run_npt_triclinic(step_fn, state: NPTTriclinicState, n_steps: int,
                      collect_every: int = 0
                      ) -> Tuple[NPTTriclinicState, Optional[dict]]:
    """``n_steps`` sweeps; with ``collect_every = k > 0`` also
    ``{"volume": (n_steps // k, ...), "cell": (n_steps // k, ..., 3,
    3)}`` after every k-th sweep (a remainder still runs)."""
    vols, cells = [], []
    for k in range(1, n_steps + 1):
        state = step_fn(state)
        if collect_every and k % collect_every == 0:
            vols.append(state.volume)
            cells.append(state.cell)
    if not collect_every:
        return state, None
    return state, {"volume": torch.stack(vols), "cell": torch.stack(cells)}
