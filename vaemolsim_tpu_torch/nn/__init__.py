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
    pair_invariants,
)
