from repro_torch.optim.optimizers import (
    Optimizer,
    apply_updates,
    global_norm,
    sgd,
)

__all__ = ["Optimizer", "apply_updates", "global_norm", "sgd"]
