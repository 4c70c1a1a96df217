"""Rational-quadratic-spline flows, flow matching and score diffusion."""

from vaemolsim_tpu_torch.flows.diffusion import (  # noqa: F401
    Diffusion,
    DiffusionDist,
    DiffusionLayer,
)
from vaemolsim_tpu_torch.flows.flow_matching import (  # noqa: F401
    FlowMatching,
    FlowMatchingDist,
    FlowMatchingLayer,
    VelocityField,
)
from vaemolsim_tpu_torch.flows.spline_flows import (  # noqa: F401
    CouplingLayer,
    MAFLayer,
    MaskedSplineConditioner,
    RQSSplineMAF,
    RQSSplineRealNVP,
    SplineConditioner,
)
