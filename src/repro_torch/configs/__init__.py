"""The paper's evaluation workloads (gradient sizes only) and the
architecture registry: ``--arch <id>`` resolution.

Only the dense ``tinyllama-1.1b`` is registered so far; the reference's
other architectures (MoE, SSM, hybrid, encoder-decoder families) wait for
ROADMAP queue 1, item 12.
"""
from __future__ import annotations

from repro_torch.config import ArchSpec
from repro_torch.configs.paper_workloads import PAPER_WORKLOADS, PaperWorkload
from repro_torch.configs.tinyllama import SPEC as _tinyllama

ASSIGNED: tuple[ArchSpec, ...] = (_tinyllama,)
REGISTRY: dict[str, ArchSpec] = {s.arch_id: s for s in ASSIGNED}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(REGISTRY)} (the "
            f"reference's other architectures are not ported yet: ROADMAP "
            f"queue 1, item 12)")
    return REGISTRY[arch_id]


def arch_ids(assigned_only: bool = True) -> list[str]:
    return [s.arch_id for s in ASSIGNED] if assigned_only else sorted(REGISTRY)


__all__ = ["ASSIGNED", "REGISTRY", "PAPER_WORKLOADS", "PaperWorkload",
           "get_arch", "arch_ids"]
