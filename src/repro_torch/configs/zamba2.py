"""zamba2-2.7b — Mamba-2 backbone with shared attention blocks.

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64.
A single shared transformer block (full MHA, kv=32) is applied every
``attn_every`` Mamba-2 layers with shared weights (Zamba2 design).
[arXiv:2411.15242; hf]
"""
from repro_torch.config import ArchSpec, ModelConfig, SSMConfig, smoke_of

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10_240,
    vocab=32_000,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, version=2, head_dim=64),
    attn_every=6,               # shared attn block at layers 6, 12, ...
    subquadratic=True,          # mamba-2 body; shared attn uses full cache
    notes="hybrid mamba2 + shared-weight attention block every 6 layers",
)

SPEC = ArchSpec(
    arch_id="zamba2-2.7b",
    model=CONFIG,
    smoke=smoke_of(CONFIG, n_layers=4, attn_every=2),
    source="arXiv:2411.15242; hf",
)
