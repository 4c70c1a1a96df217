"""Neural-net building blocks and mappings."""

from vaemolsim_tpu_torch.nn.core import (  # noqa: F401
    MADE,
    BatchNorm,
    MLP,
    Dense,
    LayerNorm,
    compute_dtype,
    set_compute_dtype,
)
from vaemolsim_tpu_torch.nn.mappings import (  # noqa: F401
    CGCenterOfMass,
    CGCentroid,
    DistanceSelection,
    FCDeepNN,
)
from vaemolsim_tpu_torch.nn.attention import (  # noqa: F401
    AttentionBlock,
    LocalParticleDescriptors,
    ParticleEmbedding,
    VectorAttention,
    VectorAttentionTwoStage,
    pair_invariants,
)
from vaemolsim_tpu_torch.nn.schnet import (  # noqa: F401
    SchNetEmbedding,
    SchNetInteraction,
    SchNetPotential,
    cosine_cutoff,
    energy_force_loss,
    gaussian_rbf,
    shifted_softplus,
)
from vaemolsim_tpu_torch.nn.painn import (  # noqa: F401
    PaiNNBlock,
    PaiNNPotential,
)
from vaemolsim_tpu_torch.nn.uq import (  # noqa: F401
    EnsemblePrediction,
    ensemble_energy_forces,
    max_force_uncertainty,
)
