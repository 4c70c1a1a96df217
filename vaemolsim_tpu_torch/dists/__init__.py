"""Distribution-emitting layers."""

from vaemolsim_tpu_torch.dists.layers import (  # noqa: F401
    FAMILY_REGISTRY,
    FlowedDistribution,
    IndependentBlockwise,
    StaticFlowedDistribution,
    build_family_dist,
    family_param_count,
    register_family,
)
