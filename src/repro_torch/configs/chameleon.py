"""chameleon-34b — early-fusion VLM transformer backbone.

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536. Early fusion uses
discrete VQ image tokens in the shared vocab; the VQ tokenizer frontend is a
STUB (inputs are precomputed token ids).
[arXiv:2405.09818; unverified]
"""
from repro_torch.config import ArchSpec, ModelConfig, smoke_of

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22_016,
    vocab=65_536,
    qk_norm=True,               # chameleon uses qk-norm for stability
    subquadratic=False,
    notes="early-fusion VQ image tokens share text vocab; frontend stubbed",
)

SPEC = ArchSpec(
    arch_id="chameleon-34b",
    model=CONFIG,
    smoke=smoke_of(CONFIG, qk_norm=True),
    source="arXiv:2405.09818; unverified",
)
