"""Training loops (checkpointing is still to come; see ROADMAP.md)."""

from vaemolsim_tpu_torch.train.loop import (  # noqa: F401
    fit,
    fit_ensemble,
    make_train_step,
)
