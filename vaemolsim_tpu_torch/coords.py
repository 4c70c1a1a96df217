"""Internal-coordinate (bond / angle / torsion) transforms (port of
``vaemolsim_tpu/coords.py``).

- :func:`bond_lengths`, :func:`bond_angles`, :func:`dihedrals` measure
  internal coordinates of Cartesian frames, over any index lists and
  leading batch axes.
- :func:`bat_from_cartesian` / :func:`cartesian_from_bat`: the
  Z-matrix decomposition and its NeRF reconstruction (Parsons et al.
  2005, "natural extension reference frame").  Placement is sequential:
  the reconstruction is a Python loop over atoms, each step batched over
  the leading axes; measurement is one batched pass.

Conventions: for Z-matrix row ``(j, k, l)`` of atom i, the internals are
``r = |x_i - x_j|``, ``theta = angle(i, j, k)`` in (0, pi), and
``phi = dihedral(l, k, j, i)`` in [-pi, pi] (praxeolitic/IUPAC sign).
Atom 0 sits at the origin, atom 1 on +x, atom 2 in the xy half-plane
with positive y: reconstruction returns this canonical frame, so a round
trip recovers the geometry up to the rigid-body frame and every
internal coordinate exactly.  Tensors stay on the caller's device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

Tensor = torch.Tensor

__all__ = ["bond_lengths", "bond_angles", "dihedrals", "chain_zmatrix",
           "bat_from_cartesian", "cartesian_from_bat"]

_EPS = 1e-12


def _unit(v: Tensor) -> Tensor:
    return v / torch.sqrt((v * v).sum(-1, keepdim=True) + _EPS)


def _index(coords: Tensor, idx) -> Tensor:
    if not isinstance(idx, Tensor):
        idx = torch.as_tensor(np.asarray(idx), dtype=torch.long,
                              device=coords.device)
    return coords[..., idx, :]


def bond_lengths(coords: Tensor, pairs) -> Tensor:
    """|x_a - x_b| for each (a, b) in pairs: (..., A, 3) -> (..., M)."""
    pairs = np.asarray(pairs)
    d = _index(coords, pairs[:, 0]) - _index(coords, pairs[:, 1])
    return torch.sqrt((d * d).sum(-1))


def bond_angles(coords: Tensor, triples) -> Tensor:
    """angle(a, b, c) at vertex b, in (0, pi): (..., A, 3) -> (..., M).
    ``triples``: (M, 3) indices, a long tensor on the coordinates' device
    or anything numpy reads."""
    t = triples if isinstance(triples, Tensor) else np.asarray(triples)
    b = _index(coords, t[:, 1])
    u = _unit(_index(coords, t[:, 0]) - b)
    v = _unit(_index(coords, t[:, 2]) - b)
    # The atan2 form is stable near 0 and pi.
    cross = torch.linalg.cross(u, v, dim=-1)
    return torch.atan2(torch.sqrt((cross * cross).sum(-1) + _EPS),
                       (u * v).sum(-1))


def dihedrals(coords: Tensor, quads) -> Tensor:
    """Signed dihedral of (p0, p1, p2, p3) about the p1-p2 axis, in
    [-pi, pi] (praxeolitic formulation).  ``quads``: (M, 4) indices, a
    long tensor on the coordinates' device or anything numpy reads."""
    q = quads if isinstance(quads, Tensor) else np.asarray(quads)
    p0, p1, p2, p3 = (_index(coords, q[:, i]) for i in range(4))
    b0 = p0 - p1
    b1 = _unit(p2 - p1)
    b2 = p3 - p2
    v = b0 - (b0 * b1).sum(-1, keepdim=True) * b1
    w = b2 - (b2 * b1).sum(-1, keepdim=True) * b1
    x = (v * w).sum(-1)
    y = (torch.linalg.cross(b1, v, dim=-1) * w).sum(-1)
    return torch.atan2(y, x)


def chain_zmatrix(n_atoms: int) -> np.ndarray:
    """Simple chain topology: atom i references (i-1, i-2, i-3).

    Rows for atoms 3..n-1, shape (n_atoms - 3, 3) of (j, k, l).
    """
    i = np.arange(3, n_atoms)
    return np.stack([i - 1, i - 2, i - 3], axis=1)


def bat_from_cartesian(coords: Tensor, zmatrix
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """Cartesian -> (bonds, angles, torsions).

    coords (..., A, 3); zmatrix (A-3, 3) rows (j, k, l) for atoms 3..A-1.
    Returns bonds (..., A-1), angles (..., A-2), torsions (..., A-3):
    bonds[0] = |x1 - x0|, bonds[1] = |x2 - x1|, then per Z-matrix row;
    angles[0] = angle(2, 1, 0), then per row; torsions per row.
    """
    z = np.asarray(zmatrix).reshape(-1, 3)
    A = coords.shape[-2]
    i = np.arange(3, A)
    bond_pairs = np.concatenate(
        [[[1, 0], [2, 1]], np.stack([i, z[:, 0]], axis=1)])
    angle_triples = np.concatenate(
        [[[2, 1, 0]], np.stack([i, z[:, 0], z[:, 1]], axis=1)])
    quads = np.stack([z[:, 2], z[:, 1], z[:, 0], i], axis=1)
    return (bond_lengths(coords, bond_pairs),
            bond_angles(coords, angle_triples),
            dihedrals(coords, quads))


def cartesian_from_bat(bonds: Tensor, angles: Tensor, torsions: Tensor,
                       zmatrix) -> Tensor:
    """(bonds, angles, torsions) -> Cartesian coordinates in the canonical
    frame (atom 0 at the origin, atom 1 on +x, atom 2 in xy with y > 0),
    batched over the leading axes: (..., A, 3) with A = bonds' last
    size + 1.  NeRF places atom 3, 4, ... in turn, each from its three
    already placed references."""
    z = np.asarray(zmatrix).reshape(-1, 3)
    A = bonds.shape[-1] + 1
    zero = torch.zeros_like(bonds[..., 0])
    pos = [torch.stack([zero, zero, zero], -1),
           torch.stack([bonds[..., 0], zero, zero], -1)]
    # Atom 2: bonded to atom 1, angle(2, 1, 0) = angles[0], in xy, y > 0.
    pos.append(torch.stack(
        [bonds[..., 0] - bonds[..., 1] * torch.cos(angles[..., 0]),
         bonds[..., 1] * torch.sin(angles[..., 0]), zero], -1))
    for n in range(A - 3):
        j, k, l = (int(v) for v in z[n])
        cj, ck, cl = pos[j], pos[k], pos[l]
        r = bonds[..., n + 2, None]
        theta = angles[..., n + 1, None]
        phi = torsions[..., n, None]
        u1 = _unit(cj - ck)  # k -> j
        u2 = _unit(ck - cl)  # l -> k
        nvec = _unit(torch.linalg.cross(u2, u1, dim=-1))
        mvec = torch.linalg.cross(nvec, u1, dim=-1)
        d = (-torch.cos(theta) * u1
             + torch.sin(theta) * torch.cos(phi) * mvec
             + torch.sin(theta) * torch.sin(phi) * nvec)
        pos.append(cj + r * d)
    return torch.stack(pos, -2)
