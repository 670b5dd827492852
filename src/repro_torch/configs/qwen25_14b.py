"""qwen2.5-14b — dense GQA transformer with QKV bias.

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
[hf:Qwen/Qwen2.5-0.5B; hf]
"""
from repro_torch.config import ArchSpec, ModelConfig, smoke_of

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13_824,
    vocab=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    subquadratic=False,
)

SPEC = ArchSpec(
    arch_id="qwen2.5-14b",
    model=CONFIG,
    smoke=smoke_of(CONFIG, qkv_bias=True),
    source="hf:Qwen/Qwen2.5-0.5B; hf",
)
