"""dbrx-132b — fine-grained 16-expert top-4 MoE transformer.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4.
[hf:databricks/dbrx-base; unverified]
"""
from repro_torch.config import ArchSpec, ModelConfig, MoEConfig, smoke_of

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10_752,
    vocab=100_352,
    moe=MoEConfig(n_experts=16, top_k=4),
    subquadratic=False,
)

SPEC = ArchSpec(
    arch_id="dbrx-132b",
    model=CONFIG,
    smoke=smoke_of(CONFIG),
    source="hf:databricks/dbrx-base; unverified",
)
