from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.reshard import load_resharded, save_sharded

__all__ = ["CheckpointManager", "load_resharded", "save_sharded"]
