"""Parallelism over ``torch.distributed`` (port of
``vaemolsim_tpu/parallel``): device meshes and the chain-sharded state
(``sharding``), the multi-process runtime (``distributed``), tempered
VAE-proposal MC with replica exchange (``replica``, on one device or
sharded over a ``("replica", "chain")`` mesh), replica-exchange MD
(``remd``) and Hamiltonian replica exchange (``hrex``)."""

from vaemolsim_tpu_torch.parallel.distributed import (  # noqa: F401
    broadcast_from_coordinator,
    global_to_local,
    initialize_distributed,
    is_coordinator,
    local_to_global,
    mesh_dim,
    process_allmean,
    process_count,
    process_index,
    shutdown_distributed,
    sync_processes,
)
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
from vaemolsim_tpu_torch.parallel.sharding import (  # noqa: F401
    ChainShard,
    chain_sharding,
    make_hybrid_mesh,
    make_mesh,
    replicate,
    shard_chain_state,
)
