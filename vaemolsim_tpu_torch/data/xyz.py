"""XYZ text-format trajectory IO (port of ``vaemolsim_tpu/data/xyz.py``,
host-side NumPy, copied so that the port imports nothing of the JAX
package; it complements the binary DCD reader).

The simple multi-frame XYZ layout: per frame, an atom-count line, a
comment line, then ``<element> x y z`` rows.  Parsing is vectorized with
NumPy over the whole file (no per-line Python loop over atoms).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

__all__ = ["read_xyz", "write_xyz"]


def read_xyz(path: str) -> Tuple[np.ndarray, List[str]]:
    """Read a (multi-frame) XYZ file.

    Returns ``(coords (n_frames, n_atoms, 3) float32, elements)``.
    All frames must share the first frame's atom count and element order.
    """
    with open(path) as f:
        lines = f.read().split("\n")
    if not lines or not lines[0].strip():
        raise ValueError(f"{path}: empty XYZ file")
    n_atoms = int(lines[0])
    frame_len = n_atoms + 2
    n_frames = 0
    while (n_frames + 1) * frame_len <= len(lines) and \
            lines[n_frames * frame_len].strip():
        n_frames += 1
    if n_frames == 0:
        raise ValueError(f"{path}: no complete frames")

    elements = [lines[2 + i].split()[0] for i in range(n_atoms)]
    # Vectorized parse: gather all atom rows, split columns.
    rows = []
    for fidx in range(n_frames):
        base = fidx * frame_len
        if int(lines[base]) != n_atoms:
            raise ValueError(f"{path}: frame {fidx} has a different atom "
                             f"count ({lines[base]} vs {n_atoms})")
        rows.extend(lines[base + 2: base + 2 + n_atoms])
    table = np.char.split(np.asarray(rows, dtype=np.str_))
    coords = np.asarray([r[1:4] for r in table], dtype=np.float32)
    return coords.reshape(n_frames, n_atoms, 3), elements


def write_xyz(path: str, coords: np.ndarray,
              elements: Optional[List[str]] = None,
              comment: str = "generated by vaemolsim_tpu") -> None:
    """Write (n_frames, n_atoms, 3) coordinates as multi-frame XYZ."""
    coords = np.asarray(coords, np.float32)
    n_frames, n_atoms, _ = coords.shape
    elements = elements or ["C"] * n_atoms
    if len(elements) != n_atoms:
        raise ValueError(f"{len(elements)} elements for {n_atoms} atoms")
    with open(path, "w") as f:
        for fidx in range(n_frames):
            f.write(f"{n_atoms}\n{comment}\n")
            for a in range(n_atoms):
                x, y, z = coords[fidx, a]
                f.write(f"{elements[a]} {x:.6f} {y:.6f} {z:.6f}\n")
