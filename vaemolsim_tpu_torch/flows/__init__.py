"""Rational-quadratic-spline flows and flow matching."""

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
