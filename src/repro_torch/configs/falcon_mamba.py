"""falcon-mamba-7b — attention-free Mamba-1 SSM.

64L d_model=4096 (attn-free) vocab=65024, ssm_state=16, expand=2
(d_inner=8192), d_conv=4.
[arXiv:2410.05355; unverified]
"""
from repro_torch.config import ArchSpec, ModelConfig, SSMConfig, smoke_of

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=65_024,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, version=1),
    subquadratic=True,          # SSM: O(1)-state decode -> long_500k runs
    notes="mamba-1 selective scan; decode is constant-size state update",
)

SPEC = ArchSpec(
    arch_id="falcon-mamba-7b",
    model=CONFIG,
    smoke=smoke_of(CONFIG, d_model=32),
    source="arXiv:2410.05355; unverified",
)
