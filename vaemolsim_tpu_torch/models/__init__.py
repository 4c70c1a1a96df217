"""Model compositions."""

from vaemolsim_tpu_torch.models.core import (  # noqa: F401
    VAE,
    FlowModel,
    MappingToDistribution,
    VAEOutput,
)
