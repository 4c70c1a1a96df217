"""Shared scaffolding (port of ``vaemolsim_tpu/utils``): the run loop
:func:`scan_collect`, profiling and step timing (``profiling``) and the
runtime numerical sanitizers (``debug``)."""

from vaemolsim_tpu_torch.utils.debug import (  # noqa: F401
    CheckError,
    assert_finite,
    assert_shape,
    checked,
)
from vaemolsim_tpu_torch.utils.profiling import (  # noqa: F401
    StepTimer,
    benchmark_fn,
    count_params,
    trace,
)
from vaemolsim_tpu_torch.utils.scan import scan_collect  # noqa: F401
