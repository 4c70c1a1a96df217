"""Bijectors, distributions, the RQS spline, dense stacks, the MAF block,
the attention pair grid and the cell-pair LJ block, each kernel beside
its plain PyTorch version."""

from vaemolsim_tpu_torch.ops import attention, cell_lj  # noqa: F401
from vaemolsim_tpu_torch.ops import bijectors, distributions  # noqa: F401
from vaemolsim_tpu_torch.ops import maf_fused  # noqa: F401
from vaemolsim_tpu_torch.ops.fused_mlp import (  # noqa: F401
    dense_stack_plain,
    fused_dense_stack,
)
from vaemolsim_tpu_torch.ops.rqs import (  # noqa: F401
    RationalQuadraticSpline,
    rqs_forward,
    rqs_inverse,
)
