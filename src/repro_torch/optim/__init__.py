from repro_torch.optim.optimizers import (
    AdamState,
    Optimizer,
    adamw,
    apply_updates,
    global_norm,
    sgd,
)

__all__ = ["AdamState", "Optimizer", "adamw", "apply_updates",
           "global_norm", "sgd"]
