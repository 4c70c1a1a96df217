"""VAE-proposal Monte Carlo."""

from vaemolsim_tpu_torch.mcmc.engine import (  # noqa: F401
    MCMC,
    MCMCState,
    apply_mh,
    log_uniform,
    make_mcmc_step,
    mh_propose,
    run_mcmc,
    vae_proposal_fns,
)
from vaemolsim_tpu_torch.mcmc.fused import (  # noqa: F401
    UnsupportedModelError,
    fused_vae_proposal,
    make_fused_vae_step,
)
