"""The paper's own evaluation workloads (Section V).

The aggregation substrate only needs each workload's flat *gradient
size*: a client's gradient is one contiguous f32 vector of ``params``
elements, whatever the model.
"""
from dataclasses import dataclass


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
