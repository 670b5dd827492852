"""The paper's evaluation workloads (gradient sizes only)."""
from repro_torch.configs.paper_workloads import PAPER_WORKLOADS, PaperWorkload

__all__ = ["PAPER_WORKLOADS", "PaperWorkload"]
