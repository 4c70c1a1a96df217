"""Neural-net building blocks and mappings."""

from vaemolsim_tpu_torch.nn.core import (  # noqa: F401
    MADE,
    MLP,
    Dense,
    compute_dtype,
    set_compute_dtype,
)
from vaemolsim_tpu_torch.nn.mappings import FCDeepNN  # noqa: F401
