"""FedAvg protocol primitives, on torch tensors and parameter dicts.

``streaming_mean`` is the paper's aggregator inner loop: one contribution
at a time, a running sum, one divide at the end. The client side is
``local_sgd_update`` (one SGD-with-momentum step, through the fused-SGD
kernel on the card), ``model_delta`` (what a client uploads) and
``apply_delta`` (what every client applies after the round).

Parameter trees are dicts of tensors under dotted names
(:mod:`repro_torch.models.transformer`). The reference's trees are
immutable; here ``local_sgd_update`` updates the parameters and the
velocity in place, so a caller that must keep the global parameters
passes each client a copy (``{k: v.clone() ...}``).
"""
from __future__ import annotations

from typing import Callable, Iterable, Mapping, Sequence

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.quantize import f32_scalar


def streaming_mean(chunks: Iterable[torch.Tensor],
                   weights: Sequence[float] | None = None) -> torch.Tensor:
    """Element-wise (weighted) mean, accumulated one contribution at a time
    in iteration order; sum first, divide once at the end."""
    acc = None
    total_w = 0.0
    n = 0
    for i, c in enumerate(chunks):
        w = 1.0 if weights is None else float(weights[i])
        contrib = c * w if weights is not None else c
        acc = contrib if acc is None else acc + contrib
        total_w += w
        n += 1
    if acc is None:
        raise ValueError("streaming_mean of empty iterator")
    denom = total_w if weights is not None else float(n)
    # a 0-d device tensor, never a Python number: CUDA's divide by a CPU
    # scalar multiplies by the reciprocal, 1 ulp off the IEEE quotient
    return acc / f32_scalar(denom, acc.device)


def fedavg_pytrees(updates: Sequence[Mapping[str, torch.Tensor]],
                   weights: Sequence[float] | None = None) -> dict:
    """Average a list of parameter dicts leaf-wise (the reference's
    full-gradient path)."""
    return {k: streaming_mean([u[k] for u in updates], weights)
            for k in updates[0]}


def weighted_merge(partials: Sequence[torch.Tensor],
                   counts: Sequence[float]) -> torch.Tensor:
    """Combine partial means with their contribution counts (tree
    topologies: a root averaging leaf outputs weights by group size)."""
    total = float(sum(counts))
    acc = None
    for p, c in zip(partials, counts):
        contrib = p * (c / total)
        acc = contrib if acc is None else acc + contrib
    return acc


def local_sgd_update(loss_fn: Callable, params: Mapping[str, torch.Tensor],
                     batch, lr: float, momentum: float = 0.0,
                     velocity: dict | None = None):
    """One client-side SGD(+momentum) step; returns ``(params, velocity,
    loss)``.

    The gradient is taken by autograd on ``params`` (leaf tensors, marked
    as requiring grad here if they are not). With ``momentum`` every leaf
    goes through ``ops.sgd_momentum_update`` (``v ← μv + g; p ← p − ηv``,
    the fused-SGD kernel on the card), in place on ``params`` and
    ``velocity``; a missing velocity starts at zeros. Without momentum the
    step is ``p ← p − η·g`` in plain ops and there is no velocity, as in
    the reference.
    """
    leaves = list(params.values())
    for p in leaves:
        if not p.requires_grad:
            p.requires_grad_(True)
    loss, _ = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        if momentum:
            if velocity is None:
                # detlint: allow[ORD001] a per-key map of zero buffers;
                # no arithmetic runs over the keys
                velocity = {k: torch.zeros_like(p, dtype=torch.float32)
                            for k, p in params.items()}
            # detlint: allow[ORD001] grads follow leaves = params.values(),
            # so zip pairs each key with its own gradient; each leaf's
            # update is independent of the others
            for (k, p), g in zip(params.items(), grads):
                ops.sgd_momentum_update(p, g.contiguous(), velocity[k], lr,
                                        momentum)
        else:
            for p, g in zip(leaves, grads):
                p.sub_(g * lr)
    return params, velocity, loss.detach()


def model_delta(old_params: Mapping[str, torch.Tensor],
                new_params: Mapping[str, torch.Tensor]) -> dict:
    """Update transmitted by a client: old - new (so that ``p - 1·delta``
    reproduces new)."""
    with torch.no_grad():
        return {k: old_params[k] - new_params[k] for k in old_params}


def apply_delta(params: Mapping[str, torch.Tensor],
                delta: Mapping[str, torch.Tensor], scale: float = 1.0
                ) -> dict:
    with torch.no_grad():
        # detlint: allow[ORD001] a per-key map: each leaf's update is
        # independent, so the order never reaches the arithmetic
        return {k: p - delta[k] * scale for k, p in params.items()}
