"""Replica exchange on one device (port of ``vaemolsim_tpu/parallel``:
the replica-exchange module; the mesh, sharding and multi-process
modules are not ported)."""

from vaemolsim_tpu_torch.parallel.replica import (  # noqa: F401
    REMCState,
    make_remc_step,
    run_remc,
    temperature_ladder,
)
