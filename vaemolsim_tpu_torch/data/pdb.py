"""PDB structure/trajectory IO (port of ``vaemolsim_tpu/data/pdb.py``,
host-side NumPy, copied so that the port imports nothing of the JAX
package).

Fixed-column ATOM/HETATM parsing, multi-MODEL trajectories, CRYST1
boxes, and the per-residue topology (names, ids, elements) that the CG
mapping layers consume.  Parsing is vectorized over all atom rows at
once: lines are padded to fixed width and column-sliced as one byte
matrix, with no per-field Python loop.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["PDBTopology", "read_pdb", "write_pdb"]

_ELEMENT_MASSES = {
    "H": 1.008, "C": 12.011, "N": 14.007, "O": 15.999, "F": 18.998,
    "NA": 22.990, "MG": 24.305, "P": 30.974, "S": 32.06, "CL": 35.45,
    "K": 39.098, "CA": 40.078, "FE": 55.845, "ZN": 65.38, "BR": 79.904,
    "I": 126.904,
}


@dataclass
class PDBTopology:
    """Per-atom topology parsed from ATOM/HETATM records."""

    atom_names: List[str]
    res_names: List[str]
    res_ids: np.ndarray          # (n_atoms,) int32 — file resSeq values
    chain_ids: List[str]
    elements: List[str]
    serial: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))

    @property
    def n_atoms(self) -> int:
        return len(self.atom_names)

    def residues(self) -> List[Tuple[str, int]]:
        """Ordered unique ``(res_name, res_id)`` pairs — the residue
        sequence a CG map is built over."""
        out, seen = [], set()
        for name, rid, chain in zip(self.res_names, self.res_ids,
                                    self.chain_ids):
            key = (chain, int(rid))
            if key not in seen:
                seen.add(key)
                out.append((name, int(rid)))
        return out

    def res_atom_nums(self) -> np.ndarray:
        """Atoms per residue in file order — the constructor input of
        centroid-style CG maps."""
        keys = list(zip(self.chain_ids, (int(r) for r in self.res_ids)))
        counts, prev = [], None
        for k in keys:
            if k != prev:
                counts.append(0)
                prev = k
            counts[-1] += 1
        return np.asarray(counts, np.int32)

    def masses(self, default: float = 12.011) -> np.ndarray:
        """Per-atom masses from the element column (unknown -> carbon
        unless ``default`` overrides)."""
        return np.asarray(
            [_ELEMENT_MASSES.get(e.upper(), default)
             for e in self.elements], np.float32)


def _guess_element(atom_name: str) -> str:
    s = atom_name.strip()
    if not s:
        return ""
    if s[0].isdigit():  # e.g. "1HB2"
        s = s.lstrip("0123456789")
    if len(s) >= 2 and s[:2].upper() in _ELEMENT_MASSES \
            and not s[:2].upper() in ("CA", "CL"):  # CA/CL ambiguous in names
        return s[:2].capitalize()
    return s[0].upper()


def read_pdb(path: str) -> Tuple[np.ndarray, PDBTopology,
                                 Optional[np.ndarray]]:
    """Read a PDB file.

    Returns ``(coords, topology, box)``: coordinates of shape
    ``(n_models, n_atoms, 3)`` float32 (files without MODEL records are
    one model), the :class:`PDBTopology`, and the orthorhombic box
    lengths from CRYST1 as ``(3,)`` float32 or None.  All models must
    contain the same atoms (the PDB trajectory convention)."""
    with open(path) as fh:
        lines = fh.read().split("\n")

    box = None
    atom_rows: List[str] = []
    model_breaks: List[int] = []
    for ln in lines:
        rec = ln[:6]
        if rec.startswith("CRYST1") and box is None:
            parts = ln.split()
            box = np.asarray(parts[1:4], np.float32)
        elif rec.startswith("MODEL"):
            model_breaks.append(len(atom_rows))
        elif rec.startswith(("ATOM", "HETATM")):
            atom_rows.append(ln)
    if not atom_rows:
        raise ValueError(f"{path}: no ATOM/HETATM records")

    if model_breaks:
        n_atoms = (model_breaks[1] - model_breaks[0]) \
            if len(model_breaks) > 1 else len(atom_rows)
        n_models = len(atom_rows) // max(n_atoms, 1)
        # Both checks are needed: divisibility alone misses unequal
        # models whose total happens to divide by the first model's
        # size (e.g. 1-atom + 3-atom models = 4 rows "= 4 models of 1").
        sizes_ok = (model_breaks
                    == [m * n_atoms for m in range(len(model_breaks))])
        if (n_models * n_atoms != len(atom_rows)
                or n_models != len(model_breaks) or not sizes_ok):
            raise ValueError(
                f"{path}: models have unequal atom counts "
                f"({len(atom_rows)} rows over {len(model_breaks)} models)")
    else:
        n_atoms, n_models = len(atom_rows), 1

    # Vectorized fixed-column parse: pad to 80 chars, slice as a byte
    # matrix.
    padded = np.asarray([r.ljust(80)[:80] for r in atom_rows], "S80")
    mat = padded.view("S1").reshape(len(atom_rows), 80)

    def col(a, b):
        return mat[:, a:b].view(f"S{b - a}").ravel().astype(str)

    xyz = np.stack([col(30, 38), col(38, 46), col(46, 54)],
                   axis=-1).astype(np.float32)
    coords = xyz.reshape(n_models, n_atoms, 3)

    first = slice(0, n_atoms)
    names = [s.strip() for s in col(12, 16)[first]]
    resn = [s.strip() for s in col(17, 21)[first]]
    chains = [s.strip() or "A" for s in col(21, 22)[first]]
    resseq = np.asarray([int(s) for s in col(22, 26)[first]], np.int32)
    serial_raw = [s.strip() for s in col(6, 11)[first]]
    serial = np.asarray([int(s) if s.isdigit() else i + 1
                         for i, s in enumerate(serial_raw)], np.int32)
    elem_col = [s.strip() for s in col(76, 78)[first]]
    elements = [e.capitalize() if e else _guess_element(nm)
                for e, nm in zip(elem_col, names)]
    topo = PDBTopology(atom_names=names, res_names=resn, res_ids=resseq,
                       chain_ids=chains, elements=elements, serial=serial)
    return coords, topo, box


def write_pdb(path: str, coords: np.ndarray,
              topology: Optional[PDBTopology] = None,
              box: Optional[np.ndarray] = None) -> None:
    """Write ``coords`` of shape ``(n_models, n_atoms, 3)`` (or a single
    ``(n_atoms, 3)`` frame).  Without a topology every atom is written
    as a carbon in residue MOL 1.  Multi-model files carry
    MODEL/ENDMDL records (the PDB trajectory convention)."""
    coords = np.asarray(coords, np.float32)
    if coords.ndim == 2:
        coords = coords[None]
    n_models, n_atoms = coords.shape[:2]
    if topology is not None and topology.n_atoms != n_atoms:
        raise ValueError(f"topology has {topology.n_atoms} atoms, "
                         f"coords have {n_atoms}")

    def row(i, p):
        if topology is not None:
            nm = topology.atom_names[i][:4]
            rn = topology.res_names[i][:4]
            ch = (topology.chain_ids[i] or "A")[0]
            ri = int(topology.res_ids[i])
            el = topology.elements[i][:2].rjust(2)
        else:
            nm, rn, ch, ri, el = "C", "MOL", "A", 1, " C"
        nm_fmt = f" {nm:<3s}" if len(nm) < 4 else nm
        return (f"ATOM  {i + 1:>5d} {nm_fmt}{'':1s}{rn:<4s}{ch}"
                f"{ri:>4d}    {p[0]:8.3f}{p[1]:8.3f}{p[2]:8.3f}"
                f"{1.00:6.2f}{0.00:6.2f}          {el}")

    out = []
    if box is not None:
        b = np.asarray(box, np.float32).reshape(3)
        out.append(f"CRYST1{b[0]:9.3f}{b[1]:9.3f}{b[2]:9.3f}"
                   f"{90.0:7.2f}{90.0:7.2f}{90.0:7.2f} P 1           1")
    multi = n_models > 1
    for m in range(n_models):
        if multi:
            out.append(f"MODEL     {m + 1:>4d}")
        out.extend(row(i, coords[m, i]) for i in range(n_atoms))
        if multi:
            out.append("ENDMDL")
    out.append("END")
    with open(path, "w") as fh:
        fh.write("\n".join(out) + "\n")
