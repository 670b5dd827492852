"""The paper's own evaluation workloads (Section V).

The aggregation substrate only needs each workload's flat *gradient
size*: a client's gradient is one contiguous f32 vector of ``params``
elements, whatever the model. GPT-2 Large also maps onto the dense
transformer (``GPT2_LARGE_MODEL``).
"""
from dataclasses import dataclass

from repro_torch.config import ArchSpec, ModelConfig, smoke_of


@dataclass(frozen=True)
class PaperWorkload:
    name: str
    params: int                  # parameter count
    grad_mb: float               # float32 gradient footprint used in the paper
    kind: str                    # "cnn" | "lm" | "synthetic"


# Gradient sizes as reported in Tables III-VII.
RESNET18 = PaperWorkload("resnet18", params=11_200_000, grad_mb=42.7, kind="cnn")
VGG16 = PaperWorkload("vgg16", params=134_000_000, grad_mb=512.3, kind="cnn")
GPT2_MEDIUM = PaperWorkload("gpt2-medium", params=355_000_000, grad_mb=1_354.0, kind="lm")
GPT2_LARGE = PaperWorkload("gpt2-large", params=774_000_000, grad_mb=2_953.0, kind="lm")
SYNTHETIC_5GB = PaperWorkload("synthetic-5gb", params=1_342_177_280, grad_mb=5_120.0,
                              kind="synthetic")

PAPER_WORKLOADS = {w.name: w for w in
                   (RESNET18, VGG16, GPT2_MEDIUM, GPT2_LARGE, SYNTHETIC_5GB)}


# GPT-2 Large as a real transformer config (the paper's largest real model):
# 36L d_model=1280 20H d_ff=5120 vocab=50257, learned pos-emb approximated
# with RoPE (positional scheme does not affect aggregation, which operates on
# the flat gradient).
GPT2_LARGE_MODEL = ModelConfig(
    name="gpt2-large",
    family="dense",
    n_layers=36,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=50_257,
    gated_mlp=False,            # GPT-2 uses plain GELU MLP
    subquadratic=False,
    notes="paper workload; MHA (no GQA), RoPE stand-in for learned pos-emb",
)

GPT2_LARGE_SPEC = ArchSpec(
    arch_id="gpt2-large",
    model=GPT2_LARGE_MODEL,
    smoke=smoke_of(GPT2_LARGE_MODEL),
    source="paper Table III; radford2019 gpt-2",
)
