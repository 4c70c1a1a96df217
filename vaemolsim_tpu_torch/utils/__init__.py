"""Shared scaffolding (port of ``vaemolsim_tpu/utils``): the run loop
:func:`scan_collect`.  ``debug`` and ``profiling`` are not ported yet."""

from vaemolsim_tpu_torch.utils.scan import scan_collect  # noqa: F401
