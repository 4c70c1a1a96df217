"""Trajectory and structure I/O and the input pipeline (port of
``vaemolsim_tpu/data``): DCD (native reader with a NumPy fallback), PDB
and XYZ on the host, and ``pipeline`` (background readers, prefetch to
the card on a side stream, shuffled epoch streams)."""

from vaemolsim_tpu_torch.data.dcd import DCDReader, write_dcd  # noqa: F401
from vaemolsim_tpu_torch.data.pdb import (  # noqa: F401
    PDBTopology,
    read_pdb,
    write_pdb,
)
from vaemolsim_tpu_torch.data.pipeline import (  # noqa: F401
    BackgroundReader,
    epoch_stream,
    prefetch_to_device,
)
from vaemolsim_tpu_torch.data.xyz import read_xyz, write_xyz  # noqa: F401
