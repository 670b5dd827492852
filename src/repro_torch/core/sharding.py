"""Gradient tensor partitioning — the paper's core mechanism (Step 1/4).

A client's gradient is one contiguous flat vector ``g_i ∈ R^{|θ|}`` (a 1-D
torch tensor) split into M shards ``g_i = [g_i^(1), …, g_i^(M)]``.
Because FedAvg is element-wise, per-shard averaging + concatenation is
algebraically identical to full-vector averaging (bit-identical when the
per-element accumulation order matches — tested).

Strategies:
  * ``uniform``          — the paper's: contiguous, equal element ranges,
                            ignoring tensor boundaries.
  * ``layer_contiguous`` — contiguous but aligned to tensor boundaries
                            (shards are whole tensors; can be imbalanced for
                            heterogeneous layers — the paper's noted MoE
                            weakness).
  * ``balanced``         — the paper's future work: greedy bin-packing of
                            whole tensors into M bins, minimizing the max
                            shard (non-contiguous index sets).

The plans are pure Python; shards, views and the reconstruction are torch
tensors on the gradient's device. :func:`flatten` turns a parameter dict
(a state dict under dotted names) into the client's flat vector, in the
reference's leaf order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Flatten / unflatten
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FlatSpec:
    names: tuple[str, ...]
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[torch.dtype, ...]
    sizes: tuple[int, ...]

    @property
    def total(self) -> int:
        return int(sum(self.sizes))


def leaf_order(names) -> list[str]:
    """Dotted names in ``jax.tree.flatten``'s order: dict keys sorted at
    every level of the tree, i.e. names sorted by their dotted parts."""
    return sorted(names, key=lambda name: name.split("."))


def flatten(tree: Mapping[str, torch.Tensor], dtype=torch.float32
            ) -> tuple[torch.Tensor, FlatSpec]:
    """A dict of tensors under dotted names -> (one flat ``dtype`` vector
    of every leaf raveled in the reference's leaf order, its spec)."""
    names = leaf_order(tree)
    leaves = [tree[name] for name in names]
    spec = FlatSpec(names=tuple(names),
                    shapes=tuple(tuple(t.shape) for t in leaves),
                    dtypes=tuple(t.dtype for t in leaves),
                    sizes=tuple(t.numel() for t in leaves))
    flat = torch.cat([t.reshape(-1).to(dtype) for t in leaves]) if leaves \
        else torch.zeros((0,), dtype=dtype)
    return flat, spec


def unflatten(flat: torch.Tensor, spec: FlatSpec) -> dict:
    """The inverse of :func:`flatten`: leaves are views of ``flat`` where
    the types agree."""
    out, off = {}, 0
    for name, shape, dt, size in zip(spec.names, spec.shapes, spec.dtypes,
                                     spec.sizes):
        out[name] = flat[off:off + size].reshape(shape).to(dt)
        off += size
    return out


# ---------------------------------------------------------------------------
# Partition plans
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PartitionPlan:
    """Assignment of flat-index ranges to M shards.

    ``segments[j]`` is a tuple of (start, stop) ranges owned by shard j —
    a single range for contiguous strategies, possibly several for
    ``balanced``. Ranges are disjoint and cover [0, total).
    """

    total: int
    segments: tuple[tuple[tuple[int, int], ...], ...]
    strategy: str

    @property
    def n_shards(self) -> int:
        return len(self.segments)

    def shard_sizes(self) -> list[int]:
        # detlint: allow[ORD001] integer span lengths over the ordered
        # segment tuple — no float accumulation involved
        return [sum(b - a for a, b in segs) for segs in self.segments]

    def max_shard(self) -> int:
        return max(self.shard_sizes())

    def imbalance(self) -> float:
        sizes = self.shard_sizes()
        mean = sum(sizes) / len(sizes)
        return max(sizes) / mean if mean else 1.0


def plan_uniform(total: int, m: int) -> PartitionPlan:
    """The paper's contiguous equal split (last shard takes the remainder)."""
    if m < 1:
        raise ValueError("M must be >= 1")
    base = total // m
    rem = total % m
    segs = []
    off = 0
    for j in range(m):
        size = base + (1 if j < rem else 0)
        segs.append(((off, off + size),))
        off += size
    return PartitionPlan(total, tuple(segs), "uniform")


def plan_layer_contiguous(sizes: Sequence[int], m: int) -> PartitionPlan:
    """Contiguous, tensor-aligned: cut at tensor boundaries nearest to the
    uniform cut points. Imbalanced when single tensors dominate."""
    total = int(sum(sizes))
    bounds = np.cumsum([0] + list(sizes))
    targets = [total * j // m for j in range(1, m)]
    cuts = [0]
    for t in targets:
        i = int(np.argmin(np.abs(bounds - t)))
        cuts.append(int(bounds[i]))
    cuts.append(total)
    cuts = sorted(set(cuts))
    while len(cuts) < m + 1:          # degenerate (few tensors): pad empty
        cuts.append(total)
    segs = tuple((((cuts[j], cuts[j + 1]),)) for j in range(m))
    return PartitionPlan(total, segs, "layer_contiguous")


def plan_balanced(sizes: Sequence[int], m: int) -> PartitionPlan:
    """Greedy LPT bin-packing of whole tensors into M shards (future work in
    the paper; evens out MoE/embedding heterogeneity)."""
    total = int(sum(sizes))
    offsets = np.cumsum([0] + list(sizes))
    order = np.argsort(-np.asarray(sizes, dtype=np.int64), kind="stable")
    loads = [0] * m
    bins: list[list[int]] = [[] for _ in range(m)]
    for t in order:
        j = int(np.argmin(loads))
        bins[j].append(int(t))
        loads[j] += int(sizes[t])
    segs = tuple(
        tuple(sorted((int(offsets[t]), int(offsets[t + 1])) for t in bin_))
        for bin_ in bins)
    return PartitionPlan(total, segs, "balanced")


def make_plan(strategy: str, total: int, m: int,
              sizes: Sequence[int] | None = None) -> PartitionPlan:
    if strategy == "uniform":
        return plan_uniform(total, m)
    if sizes is None:
        raise ValueError(f"{strategy} partitioning needs per-tensor sizes")
    if strategy == "layer_contiguous":
        return plan_layer_contiguous(sizes, m)
    if strategy == "balanced":
        return plan_balanced(sizes, m)
    raise ValueError(f"unknown partition strategy {strategy!r}")


# ---------------------------------------------------------------------------
# Shard / reconstruct (Step 1 and Step 4)
# ---------------------------------------------------------------------------

def as_grad_tensor(grad, device: str | torch.device | None = None
                   ) -> torch.Tensor:
    """One flat gradient as a contiguous f32 tensor on ``device`` (its own
    device when ``None``; numpy arrays then land on the CPU). No copy when
    it already is one."""
    if not isinstance(grad, torch.Tensor):
        grad = torch.from_numpy(np.ascontiguousarray(grad, dtype=np.float32))
    return grad.to(device=device, dtype=torch.float32).contiguous()


def resolve_device(device: str | torch.device) -> torch.device:
    """A value plane's device; a CUDA device must exist — a session or a
    population round never quietly runs on the CPU instead."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but no CUDA device is available; pass "
            f"device='cpu' to run the plain folds on the host")
    return dev


class ShardView:
    """Zero-copy view of one shard: the plan's segments over a flat tensor,
    presented as a single logical 1-D tensor without materializing the
    concatenation. Used by the batched aggregation engine to skip the N·M
    per-shard copies of eager sharding; contiguous-strategy shards stay
    views of the client's tensor even after :meth:`materialize`."""

    __slots__ = ("flat", "segments", "_sizes", "_cum", "_mat")

    def __init__(self, flat: torch.Tensor, segments):
        self.flat = flat
        self.segments = tuple(segments)
        self._sizes = [b - a for a, b in self.segments]
        self._cum = np.cumsum([0] + self._sizes)
        self._mat = None

    @property
    def size(self) -> int:
        return int(self._cum[-1])

    @property
    def shape(self) -> tuple:
        return (self.size,)

    @property
    def dtype(self):
        return self.flat.dtype

    @property
    def device(self) -> torch.device:
        return self.flat.device

    @property
    def nbytes(self) -> int:
        return self.size * self.flat.element_size()

    def read(self, start: int, stop: int) -> torch.Tensor:
        """Chunk [start, stop) in concatenated-index space; a view whenever
        the chunk falls inside one segment."""
        lo = int(np.searchsorted(self._cum, start, side="right")) - 1
        hi = int(np.searchsorted(self._cum, stop, side="left"))
        parts = []
        for k in range(max(lo, 0), hi):
            a, b = self.segments[k]
            s = a + max(0, start - int(self._cum[k]))
            e = a + min(b - a, stop - int(self._cum[k]))
            if s < e:
                parts.append(self.flat[s:e])
        if not parts:
            return self.flat[0:0]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def materialize(self) -> torch.Tensor:
        """The shard as one tensor — a view for single-segment plans, a
        cached concatenation otherwise."""
        if self._mat is None:
            if not self.segments:
                self._mat = self.flat[0:0]
            elif len(self.segments) == 1:
                a, b = self.segments[0]
                self._mat = self.flat[a:b]
            else:
                self._mat = torch.cat(
                    [self.flat[a:b] for a, b in self.segments])
        return self._mat


def shard_views(flat: torch.Tensor, plan: PartitionPlan) -> list[ShardView]:
    """Zero-copy counterpart of :func:`shard`: per-shard segment views."""
    flat = torch.as_tensor(flat)
    return [ShardView(flat, segs) for segs in plan.segments]


def shard(flat: torch.Tensor, plan: PartitionPlan) -> list:
    """Split a flat gradient into per-shard tensors (concatenated segments).

    Single-segment shards are returned as views (zero-copy); multi-segment
    (``balanced``) shards require a concatenation copy — use
    :func:`shard_views` for the fully lazy, zero-copy representation.

    Shards with no segments (balanced packing when M > #tensors) come back
    as empty tensors — an aggregator for an empty shard is a no-op."""
    flat = torch.as_tensor(flat)
    out = []
    for segs in plan.segments:
        parts = [flat[a:b] for a, b in segs]
        if not parts:
            out.append(flat.new_zeros((0,)))
        else:
            out.append(parts[0] if len(parts) == 1 else torch.cat(parts))
    return out


def reconstruct(shards: Sequence[torch.Tensor],
                plan: PartitionPlan) -> torch.Tensor:
    """Concatenate averaged shards back to the full flat gradient."""
    out = torch.zeros((plan.total,), dtype=shards[0].dtype,
                      device=shards[0].device)
    for segs, sh in zip(plan.segments, shards):
        off = 0
        for a, b in segs:
            out[a:b] = sh[off:off + (b - a)]
            off += b - a
    return out
