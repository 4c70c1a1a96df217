"""Training loops, ensembles and checkpoints."""

from vaemolsim_tpu_torch.train.checkpoint import (  # noqa: F401
    CheckpointManager,
    restore_checkpoint,
    save_checkpoint,
)
from vaemolsim_tpu_torch.train.loop import (  # noqa: F401
    EnsembleAdam,
    ModelStack,
    fit,
    fit_ensemble,
    make_train_step,
    stack_models,
    unstack_model,
)
