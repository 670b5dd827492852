"""qwen3-32b — dense GQA transformer with qk_norm.

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936. Qwen3 uses an
explicit head_dim=128 (projection dim 64*128=8192 > d_model).
[hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.config import ArchSpec, ModelConfig, smoke_of

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25_600,
    vocab=151_936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    subquadratic=False,
)

SPEC = ArchSpec(
    arch_id="qwen3-32b",
    model=CONFIG,
    smoke=smoke_of(CONFIG, qk_norm=True),
    source="hf:Qwen/Qwen3-8B; hf",
)
