"""Monte Carlo: the VAE-proposal engine and its fused step, local moves
and their tuner, chain diagnostics, simulated tempering and free-energy
estimators, NPT, grand-canonical and Gibbs-ensemble MC, transition path
sampling and forward flux sampling."""

from vaemolsim_tpu_torch.mcmc.diagnostics import (  # noqa: F401
    autocorrelation,
    block_averaging_error,
    effective_sample_size,
    potential_scale_reduction,
    statistical_inefficiency,
)
from vaemolsim_tpu_torch.mcmc.engine import (  # noqa: F401
    MCMC,
    MCMCState,
    apply_mh,
    log_uniform,
    make_mcmc_step,
    mh_propose,
    run_mcmc,
    run_mcmc_checkpointed,
    vae_proposal_fns,
)
from vaemolsim_tpu_torch.mcmc.ffs import (  # noqa: F401
    FFSResult,
    FluxResult,
    StageResult,
    basin_flux,
    ffs_stage,
    run_ffs,
)
from vaemolsim_tpu_torch.mcmc.free_energy import (  # noqa: F401
    AISResult,
    MBARResult,
    ais,
    bar_free_energy,
    exp_free_energy,
    gauss_legendre_lambdas,
    mbar_expectation,
    mbar_free_energy,
    mbar_from_samples,
    mbar_perturbed_free_energy,
    targeted_bar,
    targeted_work_values,
    tfep_loss,
    ti_free_energy,
    work_values,
)
from vaemolsim_tpu_torch.mcmc.fused import (  # noqa: F401
    UnsupportedModelError,
    fused_vae_proposal,
    make_fused_vae_step,
)
from vaemolsim_tpu_torch.mcmc.gcmc import (  # noqa: F401
    GCMCState,
    gcmc_init,
    lj_pair_u,
    make_gcmc_step,
    run_gcmc,
    total_energy,
)
from vaemolsim_tpu_torch.mcmc.gibbs import (  # noqa: F401
    GibbsState,
    gibbs_init,
    make_gibbs_step,
    run_gibbs,
)
from vaemolsim_tpu_torch.mcmc.moves import (  # noqa: F401
    cycle_moves,
    make_hmc_step,
    make_mala_step,
    make_random_walk_step,
    mix_moves,
    tune_scale,
)
from vaemolsim_tpu_torch.mcmc.npt import (  # noqa: F401
    NPTState,
    make_npt_step,
    npt_init,
    run_npt,
)
from vaemolsim_tpu_torch.mcmc.tps import (  # noqa: F401
    TPSState,
    first_hitting_committor,
    make_tps_step,
    reactive_windows,
    run_tps,
    tps_init,
)
from vaemolsim_tpu_torch.mcmc.tempering import (  # noqa: F401
    STState,
    make_st_step,
    run_st,
)
