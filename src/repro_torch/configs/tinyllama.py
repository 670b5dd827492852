"""tinyllama-1.1b — llama2-architecture small dense model.

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.
[arXiv:2401.02385; hf]
"""
from repro_torch.config import ArchSpec, ModelConfig, smoke_of

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab=32_000,
    subquadratic=False,
)

SPEC = ArchSpec(
    arch_id="tinyllama-1.1b",
    model=CONFIG,
    smoke=smoke_of(CONFIG),
    source="arXiv:2401.02385; hf",
)
