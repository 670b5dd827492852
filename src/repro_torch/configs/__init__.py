"""The paper's evaluation workloads (gradient sizes only) and the
architecture registry: ``--arch <id>`` resolution.

All ten assigned architectures in the reference's ``ASSIGNED`` order, plus
the paper's own GPT-2 Large workload in ``REGISTRY`` only.
"""
from __future__ import annotations

from repro_torch.config import ArchSpec
from repro_torch.configs.chameleon import SPEC as _chameleon
from repro_torch.configs.dbrx import SPEC as _dbrx
from repro_torch.configs.falcon_mamba import SPEC as _falcon_mamba
from repro_torch.configs.h2o_danube import SPEC as _danube
from repro_torch.configs.paper_workloads import (
    GPT2_LARGE_SPEC as _gpt2_large,
    PAPER_WORKLOADS,
    PaperWorkload,
)
from repro_torch.configs.phi35_moe import SPEC as _phi35
from repro_torch.configs.qwen25_14b import SPEC as _qwen25
from repro_torch.configs.qwen3_32b import SPEC as _qwen3
from repro_torch.configs.tinyllama import SPEC as _tinyllama
from repro_torch.configs.whisper_tiny import SPEC as _whisper
from repro_torch.configs.zamba2 import SPEC as _zamba2

ASSIGNED: tuple[ArchSpec, ...] = (
    _whisper, _phi35, _dbrx, _qwen25, _danube,
    _tinyllama, _qwen3, _falcon_mamba, _chameleon, _zamba2,
)

REGISTRY: dict[str, ArchSpec] = {s.arch_id: s for s in ASSIGNED}
REGISTRY[_gpt2_large.arch_id] = _gpt2_large


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def arch_ids(assigned_only: bool = True) -> list[str]:
    return [s.arch_id for s in ASSIGNED] if assigned_only else sorted(REGISTRY)


__all__ = ["ASSIGNED", "REGISTRY", "PAPER_WORKLOADS", "PaperWorkload",
           "get_arch", "arch_ids"]
