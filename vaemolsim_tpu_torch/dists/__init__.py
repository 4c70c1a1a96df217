"""Distribution-emitting layers."""

from vaemolsim_tpu_torch.dists.layers import (  # noqa: F401
    FAMILY_REGISTRY,
    AutoregressiveBlockwise,
    AutoregressiveBlockwiseDistribution,
    FlowedDistribution,
    IndependentBlockwise,
    IndependentDeterministic,
    IndependentVonMises,
    StaticFlowedDistribution,
    build_family_dist,
    family_param_count,
    register_family,
    register_von_mises_mixture,
)
from vaemolsim_tpu_torch.dists.joint import (  # noqa: F401
    JointBackmapping,
    JointBackmappingDistribution,
)
