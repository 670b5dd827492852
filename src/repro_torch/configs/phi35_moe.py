"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE transformer.

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16e top-2.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""
from repro_torch.config import ArchSpec, ModelConfig, MoEConfig, smoke_of

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab=32_064,
    moe=MoEConfig(n_experts=16, top_k=2),
    subquadratic=False,
)

SPEC = ArchSpec(
    arch_id="phi3.5-moe-42b-a6.6b",
    model=CONFIG,
    smoke=smoke_of(CONFIG),
    source="hf:microsoft/Phi-3.5-MoE-instruct; hf",
)
