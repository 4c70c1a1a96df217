"""Rational-quadratic-spline flows."""

from vaemolsim_tpu_torch.flows.spline_flows import (  # noqa: F401
    MAFLayer,
    MaskedSplineConditioner,
    RQSSplineMAF,
    SplineConditioner,
)
