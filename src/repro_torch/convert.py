"""Carry the reference package's state across to the port.

The aggregation system holds no weights: a round's state is the clients'
flat f32 gradients and the partition plan. Gradients arrive as numpy
arrays (the reference's form) or tensors, and become contiguous f32
tensors on the session's device; a plan is any object with ``total``,
``segments`` and ``strategy``.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.sharding import PartitionPlan, as_grad_tensor


def grads_from_numpy(grads: Sequence, device: str | torch.device = "cpu"
                     ) -> list[torch.Tensor]:
    """The reference's list of numpy f32 gradients as contiguous f32
    tensors on ``device``."""
    return [as_grad_tensor(g, device) for g in grads]


def plan_from_reference(plan) -> PartitionPlan:
    """The port's :class:`PartitionPlan` equal to a reference plan (any
    object with ``.total``, ``.segments`` and ``.strategy``)."""
    return PartitionPlan(
        total=int(plan.total),
        segments=tuple(tuple((int(a), int(b)) for a, b in segs)
                       for segs in plan.segments),
        strategy=str(plan.strategy))
