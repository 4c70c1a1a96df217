"""Trajectory and structure I/O on the host (port of
``vaemolsim_tpu/data``): DCD (native reader with a NumPy fallback), PDB
and XYZ.  The JAX package's ``pipeline`` (background readers, device
prefetch) is not ported yet."""

from vaemolsim_tpu_torch.data.dcd import DCDReader, write_dcd  # noqa: F401
from vaemolsim_tpu_torch.data.pdb import (  # noqa: F401
    PDBTopology,
    read_pdb,
    write_pdb,
)
from vaemolsim_tpu_torch.data.xyz import read_xyz, write_xyz  # noqa: F401
