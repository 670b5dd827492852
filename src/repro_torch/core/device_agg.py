"""Device-parallel aggregation: the paper's topologies as device collectives.

The serverless architectures map onto mesh collectives:

  * full-gradient (λ-FL/LIFL leaf semantics)  -> ``all_reduce_mean``:
    every replica ends with the full averaged gradient, O(|θ|) memory each.
  * GradsSharding                             -> ``reduce_scatter_mean_flat``:
    replica j ends with averaged shard j only, O(|θ|/M) memory each —
    the semantics of sharding + per-shard averaging.
  * shard reconstruct (Step 4)                -> ``all_gather_shards``.
  * λ-FL's two-level tree                     -> ``hierarchical_mean``:
    the mean inside the pod (≈ leaf aggregators), then across pods
    (≈ root) — the same math, divided twice. Here it sends the same
    bytes as the flat mean, which also runs one all-reduce an axis.

Every function runs in each rank of a ``DeviceMesh``
(:mod:`repro_torch.launch.mesh`) on that rank's own tensors, and takes the
mesh, since a collective runs on the process group of one mesh axis.
M = the product of the replica axes' sizes (every axis but ``model``).
Rank d owns shard d, d counted over the replica axes in their mesh order
(the first axis slowest). The sum's order across ranks is the backend's (NCCL
or gloo), so results agree with a single-device mean to rounding, not bit
for bit.

The tensor-parallel (TP) operators run over the ``model`` axis, where each
rank holds one block of a weight (:mod:`repro_torch.launch.partitioning`)
and the activations between blocks are the same on every rank: Megatron's
f/g pair (:class:`SumGrad`: identity forward, all-reduce backward, at the
input of a column-parallel product; :class:`SumOut`: all-reduce forward,
identity backward, at the output of a row-parallel one),
:func:`all_gather_model` (vocabulary or width blocks joined; backward keeps
this rank's block), :class:`GatherRows` (the batch blocks of the replica
axes joined) and :func:`combine_partial_softmax` (one attention over a
cache whose length is split: a max all-reduce, then sum all-reduces of the
rescaled denominator and numerator).

The host fold (:func:`make_fold_mesh`, :func:`mesh_fold_sum`) is the
``host_mesh`` aggregation engine's substrate: no collective, so its sums
are bit-identical to the streaming fold.
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Mapping

import torch
import torch.distributed as dist

from repro_torch.kernels import fedavg_stream
from repro_torch.launch.mesh import axis_sizes

Tree = Any      # a tensor or a dict of tensors


def _map(fn, tree: Tree) -> Tree:
    if isinstance(tree, Mapping):
        # detlint: allow[ORD001] a per-key map: each leaf is reduced on
        # its own, so the order never reaches the arithmetic
        return {k: fn(v) for k, v in tree.items()}
    return fn(tree)


def _divide_(x: torch.Tensor, m: int) -> torch.Tensor:
    """x /= m in place, by a 0-d tensor on x's device (a CUDA divide by a
    Python number multiplies by the reciprocal instead)."""
    return x.div_(torch.full((), float(m), dtype=x.dtype, device=x.device))


# the flat-tensor collectives under whichever names the installed torch
# gives them (newer releases rename the *_tensor forms *_single)
def _reduce_scatter(out: torch.Tensor, flat: torch.Tensor, group) -> None:
    """Sum ``flat`` over ``group``; this rank's tiled chunk into ``out``."""
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    fn(out, flat, group=group)


def _all_gather(out: torch.Tensor, shard: torch.Tensor, group) -> None:
    """Every rank's ``shard`` of ``group``, tiled in rank order, into
    ``out``."""
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, shard, group=group)


def _dense_copy(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` to reduce in place: NCCL takes contiguous
    tensors only, and a gradient or a product can come in any layout (a
    convolution's output on the card, a transposed view's gradient)."""
    return x.clone(memory_format=torch.contiguous_format)


# ---------------------------------------------------------------------------
# Per-axis collective primitives
# ---------------------------------------------------------------------------

def _axes(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def psum(mesh, tree: Tree, axes) -> Tree:
    """Sum of every leaf over the mesh axes ``axes`` (a name or a tuple),
    one axis after the other."""
    def one(g: torch.Tensor) -> torch.Tensor:
        out = _dense_copy(g)
        for ax in _axes(axes):
            dist.all_reduce(out, group=mesh.get_group(ax))
        return out

    return _map(one, tree)


def pmean(mesh, tree: Tree, axes) -> Tree:
    """Mean of every leaf over the mesh axes ``axes``: their sum, then one
    divide by the product of their sizes."""
    sizes = axis_sizes(mesh)
    m = 1
    for ax in _axes(axes):
        m *= sizes[ax]
    return _map(lambda g: _divide_(g, m), psum(mesh, tree, axes))


def _psum_scatter(mesh, flat: torch.Tensor, axis: str) -> torch.Tensor:
    size = axis_sizes(mesh)[axis]
    out = torch.empty(flat.shape[0] // size, dtype=flat.dtype,
                      device=flat.device)
    _reduce_scatter(out, flat.contiguous(), mesh.get_group(axis))
    return out


def psum_scatter_mean(mesh, flat: torch.Tensor, axis: str) -> torch.Tensor:
    """This rank's flat gradient -> its averaged shard over ``axis``.

    flat must be divisible by the axis size; callers pad via
    ``pad_to_multiple``.
    """
    return _divide_(_psum_scatter(mesh, flat, axis), axis_sizes(mesh)[axis])


def all_gather_flat(mesh, shard: torch.Tensor, axis: str) -> torch.Tensor:
    size = axis_sizes(mesh)[axis]
    out = torch.empty(shard.shape[0] * size, dtype=shard.dtype,
                      device=shard.device)
    _all_gather(out, shard.contiguous(), mesh.get_group(axis))
    return out


def hierarchical_mean(mesh, tree: Tree, inner_axis: str,
                      outer_axis: str) -> Tree:
    """Two-stage mean: inner (pod-local ≈ λ-FL leaves) then outer
    (cross-pod ≈ root). Algebraically the joint mean for equal group
    sizes."""
    return pmean(mesh, pmean(mesh, tree, inner_axis), outer_axis)


# ---------------------------------------------------------------------------
# Padding helpers
# ---------------------------------------------------------------------------

def pad_to_multiple(flat: torch.Tensor, m: int) -> tuple[torch.Tensor, int]:
    """``flat`` with zeros appended to a multiple of ``m``, and the pad."""
    pad = (-flat.shape[0]) % m
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, pad


# ---------------------------------------------------------------------------
# Mesh-level wrappers (gradient trees and flat vectors)
# ---------------------------------------------------------------------------

def replica_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in axis_sizes(mesh) if a != "model")


def replica_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    m = 1
    for ax in replica_axes(mesh):
        m *= sizes[ax]
    return m


def replica_index(mesh) -> int:
    """This rank's shard index d over the replica axes (first axis
    slowest)."""
    sizes = axis_sizes(mesh)
    idx = 0
    for ax in replica_axes(mesh):
        idx = idx * sizes[ax] + mesh.get_local_rank(ax)
    return idx


def all_reduce_mean(mesh, grads: Tree, hierarchical: bool = False) -> Tree:
    """Full-gradient aggregation over the replica axes (λ-FL analogue)."""
    axes = replica_axes(mesh)
    if hierarchical and len(axes) > 1:
        return hierarchical_mean(mesh, grads, axes[-1], axes[0])
    return pmean(mesh, grads, axes)


def reduce_scatter_mean_flat(mesh, flat: torch.Tensor) -> torch.Tensor:
    """GradsSharding: this rank's flat (padded) gradient -> its averaged
    shard; rank d owns shard d. Sums over each replica axis in turn, then
    divides once by M."""
    out = flat
    for ax in replica_axes(mesh):
        out = _psum_scatter(mesh, out, ax)
    return _divide_(out, replica_size(mesh))


def all_gather_shards(mesh, shard: torch.Tensor) -> torch.Tensor:
    """Step 4: reconstruct the full flat vector from per-rank shards."""
    out = shard
    for ax in reversed(replica_axes(mesh)):
        out = all_gather_flat(mesh, out, ax)
    return out


# ---------------------------------------------------------------------------
# Tensor-parallel operators over the ``model`` axis
# ---------------------------------------------------------------------------

class SumGrad(torch.autograd.Function):
    """Identity forward; backward sums the gradient over ``groups`` (each
    rank holds one part of the true gradient of a replicated input)."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = _dense_copy(g)
        for group in ctx.groups:
            dist.all_reduce(g, group=group)
        return g, None


class SumOut(torch.autograd.Function):
    """All-reduce (sum) forward over ``group``; identity backward (the
    gradient of the replicated sum is the same on every rank)."""

    @staticmethod
    def forward(ctx, x, group):
        out = _dense_copy(x)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class GatherRows(torch.autograd.Function):
    """All-gather of each rank's rows over the replica axes (rank d's rows
    at block d); backward keeps this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, index):
        ctx.rows, ctx.index = x.shape[0], index
        full = all_gather_shards(mesh, x.reshape(-1))
        return full.reshape((-1,) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.rows
        return g[lo:lo + ctx.rows], None, None


class _GatherDim(torch.autograd.Function):
    """All-gather of each rank's block of dim ``dim`` over ``group`` (rank
    r's block at position r); backward keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, dim, group, size, index):
        ctx.dim, ctx.width, ctx.index = dim, x.shape[dim], index
        out = torch.empty(size * x.numel(), dtype=x.dtype, device=x.device)
        _all_gather(out, x.contiguous().reshape(-1), group)
        return torch.cat(out.view((size,) + tuple(x.shape)).unbind(0),
                         dim=dim)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.width
        return g.narrow(ctx.dim, lo, ctx.width), None, None, None, None


def all_gather_model(mesh, x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ``model`` ranks' blocks of dim ``dim`` joined in rank order (the
    decode logits' vocabulary blocks, a width-split embedding's columns);
    backward keeps this rank's block of the gradient."""
    return _GatherDim.apply(x, dim % x.ndim, mesh.get_group("model"),
                            axis_sizes(mesh)["model"],
                            mesh.get_local_rank("model"))


def combine_partial_softmax(mesh, axes, m: torch.Tensor, l: torch.Tensor,
                            acc: torch.Tensor) -> torch.Tensor:
    """One softmax-weighted sum from the ranks' partial ones over ``axes``:
    each rank's running max ``m``, denominator ``l`` (both (B, H, S)) and
    numerator ``acc`` ((B, S, H, D)), f32, over its block of keys. A max
    all-reduce, then a sum all-reduce of the denominator and of the
    numerator, each rescaled by ``exp(m - max)``; ``l`` clamped at 1e-30
    before the divide, as the chunked attention does."""
    top = _dense_copy(m)
    for ax in _axes(axes):
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=mesh.get_group(ax))
    alpha = torch.exp(m - top)
    l, acc = psum(mesh, {"l": l * alpha,
                         "acc": acc * alpha.transpose(1, 2)[..., None]},
                  axes).values()
    return acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]


# ---------------------------------------------------------------------------
# The host_mesh engine's fold devices
# ---------------------------------------------------------------------------

def make_fold_mesh(n_devices: int | None = None,
                   device_type: str = "cuda") -> list[torch.device]:
    """The devices of a ``host_mesh`` fold: the first ``n_devices`` visible
    cards on ``"cuda"`` (``None``: every one), or ``n_devices`` column
    slices of the host on ``"cpu"`` (``None``: one a host core). Asking for
    more cards than are visible is an error that names the fix."""
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"host_mesh must be >= 1, got {n_devices}")
    if device_type == "cpu":
        n = n_devices or len(os.sched_getaffinity(0))
        return [torch.device("cpu")] * n
    if device_type != "cuda":
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible == 0 or (n_devices is not None and n_devices > visible):
        raise ValueError(
            f"host_mesh={n_devices} exceeds the {visible} visible CUDA "
            f"device(s); make more cards visible to the process "
            f"(CUDA_VISIBLE_DEVICES) or ask for at most {visible}")
    return [torch.device("cuda", i) for i in range(n_devices or visible)]


def mesh_fold_sum(devices: list[torch.device], stack) -> torch.Tensor:
    """Element-sharded sequential left-fold sum of ``stack`` -> (L,) f32.

    ``stack`` is an (N, L) tensor or N tensors of shape (L,). Device j
    takes the j-th contiguous column slice (width ⌈L/len(devices)⌉, the
    last one short) and adds the N rows of its slice **in row order**
    without dividing (the fold kernel's ``finalize=False`` form on a card,
    its plain version on the CPU): the streaming reference's exact f32 add
    chain, so the joined sum is bit-identical to it at every device count.
    The caller divides, keeping the one-divide op sequence. The sum comes
    back on the stack's device.
    """
    rows = list(stack)
    home = rows[0].device
    length = int(rows[0].shape[0])
    width = -(-length // len(devices))
    parts = []
    for j, dev in enumerate(devices):
        lo, hi = j * width, min(length, (j + 1) * width)
        if lo >= hi:
            break
        cols = [r[lo:hi].to(dev) for r in rows]
        # a kernel launches on the current card's stream: make it dev's
        with torch.cuda.device(dev) if dev.type == "cuda" else \
                contextlib.nullcontext():
            parts.append(fedavg_stream.fold_nodes([(cols, None)],
                                                  finalize=False)[0])
    if not parts:
        return torch.zeros(0, dtype=torch.float32, device=home)
    return torch.cat([p.to(home) for p in parts])
