"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention.

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA.
[arXiv:2401.16818; hf]
"""
from repro_torch.config import ArchSpec, ModelConfig, smoke_of

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab=32_000,
    sliding_window=4096,
    subquadratic=True,          # SWA: O(seq * window) -> long_500k runs
    notes="sliding-window attention; long_500k uses ring-buffer window cache",
)

SPEC = ArchSpec(
    arch_id="h2o-danube-1.8b",
    model=CONFIG,
    smoke=smoke_of(CONFIG, sliding_window=8),
    source="arXiv:2401.16818; hf",
)
