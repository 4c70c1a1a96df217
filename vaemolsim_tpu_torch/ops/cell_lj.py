"""The cell-pair Lennard-Jones / Ewald real-space kernel (port of the TPU
kernel ``_make_kernel`` of ``vaemolsim_tpu/ops/cell_lj_pallas.py``).

Per cell of a cell list, over the (C, K) block of its C centre slots
against the K = 27 C pre-gathered slots of its 27 neighbour cells, with
pair displacements ``d = x_i - x_j`` wrapped once per axis to the minimum
image of a static orthorhombic box (``rint``, half to even):

    mask  = i < n, j < n, i != j, r^2 < rc^2, j not excluded against i
    r2s   = max(r^2, 1e-12)                 (coincident atoms stay finite)
    u     = 4 eps ((s/r)^12 - (s/r)^6) [- the same at the cutoff]
            continued linearly (value and slope matched) below 0.3 sigma
    u    += q_i q_j erfc(alpha r) / r       (with charges)

with sigma_ij = (s_i + s_j) / 2 and eps_ij = sqrt(eps_i) sqrt(eps_j) per
slot when species are given.  The outputs are every cell's half-energy
(each pair is seen from both of its cells) and the full row sum
``sum_j (du/dr / r) d_ij`` per centre slot: the gradient dU/dx_i in cell
layout.  Padding slots carry the id ``n_atoms``.

:func:`cell_pair_energy_force_plain` is the plain version, with the
Pallas function's signature, shapes and outputs.
:func:`cell_pair_energy_force_cuda` launches ``csrc/cell_lj.cu`` on
CUDA tensors.  :func:`cell_pair_energy_force` runs the plain version on
a CPU tensor; on a CUDA tensor it launches the kernel or raises.  A
neighbour block larger than one launch takes (16384 slots, or less
where a block's shared memory runs out first) is spread over several
launches, each on a run of the neighbour slots (:func:`neighbour_runs`),
whose half-energies and gradients add: every term is a sum over
neighbour slots.  The
kernel and the plain version both take erfc from the math library
(``erfcf``, ``torch.special.erfc``); the Pallas kernel used an
Abramowitz-Stegun form, within 1.5e-7 of it.  The pair displacement and
r^2 are rounded after every operation in both, so their cutoff and
exclusion masks agree exactly.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from vaemolsim_tpu_torch import _build

Tensor = torch.Tensor

__all__ = ["cell_pair_energy_force", "cell_pair_energy_force_plain",
           "cell_pair_energy_force_cuda", "cluster_split",
           "neighbour_runs", "max_slots", "SLOPE_F", "KERNEL"]

KERNEL = _build.Kernel(
    "cell_lj", "csrc/cell_lj.cu", "cell_lj_launch",
    [ctypes.c_void_p] * 13 + [ctypes.c_longlong] + [ctypes.c_int] * 5
    + [ctypes.c_float] * 13 + [ctypes.c_int],
    replaces="vaemolsim_tpu/ops/cell_lj_pallas.py:62")

# The kernel's blocks: 8 warps, split over a cluster of up to 8 blocks per
# cell (the split is decided here and only validated by the launch),
# aiming at 2 centres per warp.
WARPS, MAX_SPLIT, CENTRES_PER_WARP = 8, 8, 2
_max_slots: dict = {}


def max_slots(C: int, D: int = 0, species: bool = False,
              coulomb: bool = False) -> int:
    """The most neighbour slots one launch of ``csrc/cell_lj.cu`` takes
    (its ``cell_lj_max_slots``, from its own shared-memory layout; needs
    the built library).  Raises where no launch takes C centre slots."""
    key = (C, D, bool(species), bool(coulomb))
    if key not in _max_slots:
        _max_slots[key] = KERNEL.query("cell_lj_max_slots", C, D,
                                       int(species), int(coulomb))
    if _max_slots[key] < 1:
        raise ValueError(f"cell_lj: a block of C = {C} centre slots does "
                         f"not fit shared memory")
    return _max_slots[key]


def neighbour_runs(K: int, most: int) -> list:
    """The runs ``(first, end)`` of K neighbour slots, one launch each:
    all K in one where ``most`` (the slots a launch takes,
    :func:`max_slots`) allows, else equal runs of at most ``most``."""
    n = -(-K // most)
    size = -(-K // n)
    return [(lo, min(lo + size, K)) for lo in range(0, K, size)]


def cluster_split(n_atoms: int, n_cells: int) -> int:
    """Blocks per cell that ``csrc/cell_lj.cu`` is launched with:
    enough warps for CENTRES_PER_WARP centres each at the mean occupancy
    ``n_atoms / n_cells``, between 1 and MAX_SPLIT."""
    per = WARPS * CENTRES_PER_WARP
    want = -(-n_atoms // (n_cells * per)) if n_cells else 1
    return min(max(want, 1), MAX_SPLIT)


_SRC6 = (1.0 / 0.3) ** 6
# Linear-core slope factor: with rcore = 0.3 sigma_ij the slope of u at
# the core is SLOPE_F eps_ij / sigma_ij.
SLOPE_F = 24.0 / 0.3 * (_SRC6 - 2.0 * _SRC6 * _SRC6)
_TWO_OPI = 2.0 / math.sqrt(math.pi)


def cell_pair_energy_force_plain(
        cxt: Tensor, nxt: Tensor, cid: Tensor, nid: Tensor,
        species: Optional[Sequence[Tensor]] = None,
        charge: Optional[Sequence[Tensor]] = None,
        exclusion: Optional[Tensor] = None, *, n_atoms: int, sigma: float,
        epsilon: float, cutoff: float, box: Sequence[float],
        shift: bool = True, coulomb_alpha: float = 0.0
        ) -> Tuple[Tensor, Tensor]:
    """Per-cell half-energy ``(n_cells, 1, 1)`` and gradient ``(n_cells,
    3, C)`` in plain PyTorch.  cxt (n_cells, 3, C) and nxt (n_cells, 3, K)
    float32 positions; cid (n_cells, 1, C) and nid (n_cells, 1, K) int32
    ids (``n_atoms`` = padding); species (csig, nsig, cse, nse): per-slot
    sigma and sqrt(epsilon) blocks of width C / K, overriding the scalar
    sigma and epsilon; charge (cq, nq): per-slot charges, adding the
    Ewald real-space term; exclusion (n_cells, D, C) int32: each centre
    slot's excluded partner ids, -1 padding."""
    rc2 = float(cutoff) * float(cutoff)
    inv_cut6 = 1.0 / float(cutoff) ** 6
    ci = cid.transpose(1, 2)                               # (nc, C, 1)
    d = []
    for a, b in enumerate(box):
        da = cxt[:, a, :, None] - nxt[:, a, None, :]       # (nc, C, K)
        d.append(da - float(b) * torch.round(da * (1.0 / float(b))))
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    if species is not None:
        csig, nsig, cse, nse = species
        sg = 0.5 * (csig.transpose(1, 2) + nsig)
        ep = cse.transpose(1, 2) * nse
    else:
        sg, ep = float(sigma), float(epsilon)
    sig2 = sg * sg
    mask = (ci < n_atoms) & (nid < n_atoms) & (ci != nid) & (r2 < rc2)
    if exclusion is not None:
        for k in range(exclusion.shape[1]):
            mask = mask & (exclusion[:, k, :, None] != nid)
    r2s = torch.where(mask, r2, 1.0).clamp_min(1e-12)
    rcore2 = 0.09 * sig2
    irr = 1.0 / r2s.clamp(min=rcore2)
    ir2 = sig2 * irr
    ir6 = ir2 * ir2 * ir2
    u = 4.0 * ep * (ir6 * ir6 - ir6)
    if shift:
        s6 = sig2 * sig2 * sig2 * inv_cut6
        u = u - 4.0 * ep * (s6 * s6 - s6)
    w = 24.0 * ep * (ir6 - 2.0 * ir6 * ir6) * irr
    in_core = r2s < rcore2
    rs = torch.rsqrt(r2s)
    if species is not None:
        slope = SLOPE_F * ep * torch.rsqrt(sig2)
    else:
        slope = SLOPE_F * float(epsilon) / float(sigma)
    u = u + torch.where(in_core, slope * (r2s * rs - 0.3 * sg), 0.0)
    w = torch.where(in_core, slope * rs, w)
    if charge is not None:
        cq, nq = charge
        alpha = float(coulomb_alpha)
        qq = cq.transpose(1, 2) * nq
        ar = alpha * r2s * rs
        erfc_t = torch.special.erfc(ar)
        exp_t = torch.exp(-ar * ar)
        u = u + qq * erfc_t * rs
        w = w - qq * (erfc_t * rs + _TWO_OPI * alpha * exp_t) * rs * rs
    w = torch.where(mask, w, 0.0)
    e = 0.5 * torch.where(mask, u, 0.0).sum((1, 2))
    grad = torch.stack([(w * da).sum(2) for da in d], 1)
    return e.reshape(-1, 1, 1), grad


def cell_pair_energy_force_cuda(
        cxt: Tensor, nxt: Tensor, cid: Tensor, nid: Tensor,
        species: Optional[Sequence[Tensor]] = None,
        charge: Optional[Sequence[Tensor]] = None,
        exclusion: Optional[Tensor] = None, *, n_atoms: int, sigma: float,
        epsilon: float, cutoff: float, box: Sequence[float],
        shift: bool = True, coulomb_alpha: float = 0.0
        ) -> Tuple[Tensor, Tensor]:
    """Launch ``csrc/cell_lj.cu`` (same arguments and outputs as the plain
    version), split over :func:`cluster_split` blocks per cell.  A
    neighbour block of more than 16384 slots, or one that does not fit
    shared memory, is refused by the kernel's launch, which raises."""
    if cxt.dim() != 3 or cxt.shape[1] != 3:
        raise ValueError(f"cxt: expected (n_cells, 3, C), got "
                         f"{tuple(cxt.shape)}")
    if len(box) != 3:
        raise ValueError(f"box: expected 3 lengths, got {len(box)}")
    nc, _, C = cxt.shape
    K = nxt.shape[-1]
    req = _build.require
    args = [req(cxt, "cxt", (nc, 3, C)), req(nxt, "nxt", (nc, 3, K)),
            req(cid, "cid", (nc, 1, C), torch.int32),
            req(nid, "nid", (nc, 1, K), torch.int32)]
    if species is not None:
        args += [req(t, w, (nc, 1, s)) for t, w, s in zip(
            species, ("csig", "nsig", "cse", "nse"), (C, K, C, K))]
    else:
        args += [None] * 4
    if charge is not None:
        args += [req(t, w, (nc, 1, s)) for t, w, s in zip(
            charge, ("cq", "nq"), (C, K))]
    else:
        args += [None] * 2
    D = 0
    if exclusion is not None:
        D = exclusion.shape[1]
        args.append(req(exclusion, "exclusion", (nc, D, C), torch.int32))
    else:
        args.append(None)
    e = torch.empty((nc, 1, 1), dtype=torch.float32, device=cxt.device)
    grad = torch.empty((nc, 3, C), dtype=torch.float32, device=cxt.device)
    box = [float(b) for b in box]
    KERNEL.launch(cxt.device, *[_build.ptr(t) for t in args], e.data_ptr(),
                  grad.data_ptr(), nc, C, K, int(n_atoms), D, int(bool(shift)),
                  float(sigma), float(epsilon), float(cutoff) ** 2,
                  1.0 / float(cutoff) ** 6,
                  SLOPE_F * float(epsilon) / float(sigma), SLOPE_F,
                  float(coulomb_alpha), *box, *[1.0 / b for b in box],
                  cluster_split(int(n_atoms), nc))
    return e, grad


def cell_pair_energy_force(cxt: Tensor, *args, **kwargs
                           ) -> Tuple[Tensor, Tensor]:
    """The cell-pair block: the plain version on a CPU tensor, the kernel
    on a CUDA tensor, in the neighbour runs of :func:`neighbour_runs`.
    Not differentiable itself: it returns the gradient
    (``potentials.lennard_jones_cell_neighbor`` wraps it)."""
    if not cxt.is_cuda:
        return cell_pair_energy_force_plain(cxt, *args, **kwargs)
    return _split_call(cell_pair_energy_force_cuda, cxt, *args, **kwargs)


def _split_call(fn, cxt: Tensor, *args, **kwargs) -> Tuple[Tensor, Tensor]:
    """``fn`` (the kernel's wrapper, or any function of its signature) on
    each run of :func:`neighbour_runs`, the half-energies and gradients
    added."""
    nxt, cid, nid, species, charge, exclusion = (
        list(args) + [None] * (6 - len(args)))
    species = kwargs.pop("species", species)
    charge = kwargs.pop("charge", charge)
    exclusion = kwargs.pop("exclusion", exclusion)
    runs = neighbour_runs(nxt.shape[-1], max_slots(
        cxt.shape[-1], 0 if exclusion is None else exclusion.shape[1],
        species is not None, charge is not None))
    e = grad = None
    for lo, hi in runs:
        def part(t):
            return t[..., lo:hi].contiguous() if len(runs) > 1 else t
        sp = None if species is None else [
            t if i % 2 == 0 else part(t) for i, t in enumerate(species)]
        ch = None if charge is None else [charge[0], part(charge[1])]
        e_r, g_r = fn(cxt, part(nxt), cid, part(nid), sp, ch, exclusion,
                      **kwargs)
        e, grad = (e_r, g_r) if e is None else (e + e_r, grad + g_r)
    return e, grad
