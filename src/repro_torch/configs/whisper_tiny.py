"""whisper-tiny — enc-dec audio transformer backbone.

4L d_model=384 6H (GQA kv=6) d_ff=1536 vocab=51865; conv audio frontend is a
STUB: ``input_specs`` provides precomputed frame embeddings.
[arXiv:2212.04356; unverified]
"""
from repro_torch.config import ArchSpec, ModelConfig, smoke_of

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,                 # decoder layers
    encoder_layers=4,
    encoder_seq=1500,           # 30 s of audio at 50 Hz post-conv
    frontend_dim=384,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51_865,
    gated_mlp=False,            # whisper uses plain GELU MLP
    subquadratic=False,         # full attention: long_500k skipped
    notes="enc-dec; conv frontend stubbed as precomputed frame embeddings",
)

SPEC = ArchSpec(
    arch_id="whisper-tiny",
    model=CONFIG,
    smoke=smoke_of(CONFIG),
    source="arXiv:2212.04356; unverified",
)
