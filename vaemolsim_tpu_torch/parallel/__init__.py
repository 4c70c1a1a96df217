"""Replica exchange on one device (port of ``vaemolsim_tpu/parallel``):
tempered VAE-proposal MC (``replica``), replica-exchange MD (``remd``)
and Hamiltonian replica exchange (``hrex``).  The mesh, sharding and
multi-process modules are not ported yet."""

from vaemolsim_tpu_torch.parallel.hrex import (  # noqa: F401
    HREXState,
    make_hrex_step,
    run_hrex,
)
from vaemolsim_tpu_torch.parallel.remd import (  # noqa: F401
    REMDState,
    make_remd_step,
    run_remd,
)
from vaemolsim_tpu_torch.parallel.replica import (  # noqa: F401
    REMCState,
    make_remc_step,
    run_remc,
    temperature_ladder,
)
