"""Model compositions."""

from vaemolsim_tpu_torch.models.backmapping import BackmappingOnly  # noqa: F401
from vaemolsim_tpu_torch.models.core import (  # noqa: F401
    VAE,
    DualVAEOutput,
    FlowModel,
    MappingToDistribution,
    VAEDualELBO,
    VAEOutput,
)
