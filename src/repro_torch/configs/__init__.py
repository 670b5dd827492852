"""The paper's evaluation workloads (gradient sizes only) and the
architecture registry: ``--arch <id>`` resolution.

The dense decoder family of the reference's registry, in its ``ASSIGNED``
order, plus the paper's own GPT-2 Large workload in ``REGISTRY`` only.
The reference's other architectures (MoE, SSM, hybrid, VLM and
encoder-decoder families) wait for ROADMAP queue 1, item 3.
"""
from __future__ import annotations

from repro_torch.config import ArchSpec
from repro_torch.configs.h2o_danube import SPEC as _danube
from repro_torch.configs.paper_workloads import (
    GPT2_LARGE_SPEC as _gpt2_large,
    PAPER_WORKLOADS,
    PaperWorkload,
)
from repro_torch.configs.qwen25_14b import SPEC as _qwen25
from repro_torch.configs.qwen3_32b import SPEC as _qwen3
from repro_torch.configs.tinyllama import SPEC as _tinyllama

ASSIGNED: tuple[ArchSpec, ...] = (_qwen25, _danube, _tinyllama, _qwen3)

REGISTRY: dict[str, ArchSpec] = {s.arch_id: s for s in ASSIGNED}
REGISTRY[_gpt2_large.arch_id] = _gpt2_large


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(REGISTRY)} (the "
            f"reference's other architectures are not ported yet: ROADMAP "
            f"queue 1, item 3)")
    return REGISTRY[arch_id]


def arch_ids(assigned_only: bool = True) -> list[str]:
    return [s.arch_id for s in ASSIGNED] if assigned_only else sorted(REGISTRY)


__all__ = ["ASSIGNED", "REGISTRY", "PAPER_WORKLOADS", "PaperWorkload",
           "get_arch", "arch_ids"]
