"""Streaming (weighted) FedAvg fold: a hand-written Hopper kernel and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``fedavg_stream`` of the reference package
(``repro/kernels/fedavg_stream.py``: ``_fedavg_kernel`` accumulating over
a sequential client grid axis, then ``_finalize_kernel`` dividing), and
its wrappers ``fedavg_shards`` / ``fedavg_multi`` (``repro/kernels/ops.py``).

The fold is bound by device-memory bytes: a node of N inputs of L f32
elements reads N·L·4 bytes and writes L·4, so ``(N+1)·L·4`` bytes for at
most two flops per input element. The CUDA kernel
(``csrc/fedavg_stream.cu``) therefore makes one pass: each thread owns a
few elements, walks the clients 0..N-1 in order with the running sum in
registers, and divides at the end of the same loop, so the accumulator
never touches device memory. One launch folds every node of a dependency
wave: the wrapper hands the kernel a device table of per-node lengths,
output pointers and divisors and per-(node, client) input pointers and
weights, instead of concatenating the stacks as the TPU wrapper does.

Arithmetic, per element, with the reference engine's exact bits:

* unweighted — an f32 left fold, then one f32 divide by N;
* weighted, ``acc="f64"`` (the engines' weighted folds) — an f64 fold of
  ``x_i·w_i``, one f64 divide by the host's ``float(sum(w))``, a cast to
  f32;
* weighted, ``acc="f32"`` (the TPU kernel's ``fedavg_shards`` form) — an
  f32 fold of ``x_i·w_i``, divided by the f32 sum of the weights.

Inputs are f32, or bf16 widened exactly. :func:`fold_nodes` runs the
kernel for CUDA tensors and :func:`fedavg_stream_plain` for CPU tensors;
there is no other switch. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import build

#: kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0

_MODES = {None: 0, "f64": 1, "f32": 2}
_META = 5                     # columns of the per-node table rows
_MAX_NODES = 65535            # grid.y limit of one launch
_INPUT_DTYPES = (torch.float32, torch.bfloat16)


def _scalar(value: float, dtype: torch.dtype, device) -> torch.Tensor:
    """A 0-d tensor on ``device``. Value-plane divides take a device tensor,
    never a Python number: CUDA's true divide by a CPU scalar multiplies by
    the reciprocal, which can be 1 ulp off the IEEE quotient."""
    return torch.full((), value, dtype=dtype, device=device)


def _f32_weights(weights: Sequence[float]) -> list[float]:
    return [float(np.float32(w)) for w in weights]


def _divisor(n: int, weights: Sequence[float] | None, acc: str) -> float:
    if weights is None:
        return float(n)
    if acc == "f32":
        return float(np.asarray(_f32_weights(weights), np.float32)
                     .sum(dtype=np.float32))
    return float(sum(weights))


def fedavg_stream_plain(inputs: Sequence[torch.Tensor],
                        weights: Sequence[float] | None = None,
                        acc: str = "f64") -> torch.Tensor:
    """The kernel's arithmetic as a torch loop: the same op sequence, one
    whole-tensor op per step. ``inputs`` is a sequence of equal-length 1-D
    f32/bf16 tensors (or an (N, L) stack); returns the (L,) f32 mean."""
    xs = list(inputs)
    dev = xs[0].device
    div = _divisor(len(xs), weights, acc)
    if weights is None:
        out = xs[0].to(torch.float32, copy=True)
        for x in xs[1:]:
            out.add_(x)
        return out.div_(_scalar(div, torch.float32, dev))
    if acc == "f32":
        w = _f32_weights(weights)
        out = xs[0].to(torch.float32) * _scalar(w[0], torch.float32, dev)
        for x, wi in zip(xs[1:], w[1:]):
            out.add_(x.to(torch.float32) * _scalar(wi, torch.float32, dev))
        return out.div_(_scalar(div, torch.float32, dev))
    if acc != "f64":
        raise ValueError(f"acc must be 'f64' or 'f32', got {acc!r}")
    out = xs[0].to(torch.float64) * _scalar(weights[0], torch.float64, dev)
    for x, wi in zip(xs[1:], weights[1:]):
        out.add_(x.to(torch.float64) * _scalar(wi, torch.float64, dev))
    return out.div_(_scalar(div, torch.float64, dev)).to(torch.float32)


def _check_inputs(nodes, device: torch.device) -> torch.dtype:
    dtype = None
    for inputs, weights in nodes:
        if not len(inputs):
            raise ValueError("a fold node needs at least one input")
        if weights is not None and len(weights) != len(inputs):
            raise ValueError(f"{len(weights)} weights for {len(inputs)} "
                             f"inputs")
        length = int(inputs[0].shape[0])
        for x in inputs:
            if x.device != device:
                raise ValueError(f"fold inputs span devices: {x.device} "
                                 f"and {device}")
            if x.dim() != 1 or int(x.shape[0]) != length:
                raise ValueError(f"fold inputs must be 1-D of one length, "
                                 f"got {tuple(x.shape)} vs ({length},)")
            if x.dtype not in _INPUT_DTYPES:
                raise TypeError(f"fold inputs must be f32 or bf16, got "
                                f"{x.dtype}")
            if dtype is not None and x.dtype != dtype:
                raise TypeError("one launch folds inputs of one dtype")
            if length > 1 and x.stride(0) != 1:
                raise ValueError("fold inputs must be contiguous")
            dtype = x.dtype
    return dtype


@functools.cache
def _launcher():
    return build.launcher("fedavg_stream", "fedavg_fold_launch",
                          [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                           ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])


def _table(nodes, acc: str, device: torch.device):
    """The kernel's node table (layout in ``csrc/fedavg_stream.cu``) as a
    host int64 array, the allocated outputs, and the longest node."""
    n = len(nodes)
    n_slots = sum(len(inputs) for inputs, _ in nodes)
    table = np.zeros(n * (_META + 1) + 2 * n_slots, np.int64)
    meta = table[:n * _META].reshape(n, _META)
    div = table[n * _META:n * (_META + 1)].view(np.float64)
    ptr = table[n * (_META + 1):n * (_META + 1) + n_slots]
    wts = table[n * (_META + 1) + n_slots:].view(np.float64)
    outs, slot, max_len = [], 0, 0
    for j, (inputs, weights) in enumerate(nodes):
        length = int(inputs[0].shape[0])
        out = torch.empty(length, dtype=torch.float32, device=device)
        outs.append(out)
        max_len = max(max_len, length)
        meta[j] = (length, out.data_ptr(), slot, len(inputs), _MODES[
            None if weights is None else acc])
        div[j] = _divisor(len(inputs), weights, acc)
        w = [1.0] * len(inputs) if weights is None else (
            _f32_weights(weights) if acc == "f32" else
            [float(x) for x in weights])
        for x, wi in zip(inputs, w):
            ptr[slot] = x.data_ptr()
            wts[slot] = wi
            slot += 1
    return table, outs, max_len


def _launch(nodes, acc: str, device: torch.device) -> list[torch.Tensor]:
    """One kernel launch over ``nodes`` (at most ``_MAX_NODES``)."""
    global LAUNCHES
    dtype = _check_inputs(nodes, device)
    launch = _launcher()
    table, outs, max_len = _table(nodes, acc, device)
    n, n_slots = len(nodes), sum(len(inputs) for inputs, _ in nodes)
    if max_len == 0:
        return outs
    # freed on return: the caching allocator hands the block out again only
    # to work queued on this stream after the launch
    dev_table = torch.from_numpy(table).to(device)
    rc = launch(dev_table.data_ptr(), n, n_slots, max_len,
                int(dtype == torch.bfloat16), build.raw_stream(device.index))
    if rc != 0:
        raise RuntimeError(f"fedavg_stream kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    return outs


def fold_nodes(nodes: Sequence[tuple], acc: str = "f64"
               ) -> list[torch.Tensor]:
    """Fold many averaging nodes: ``nodes`` is a sequence of
    ``(inputs, weights)`` pairs, ``weights`` ``None`` for the unweighted
    mean. CUDA tensors go through the kernel, every node of the call in one
    launch; CPU tensors through :func:`fedavg_stream_plain`. Returns one
    (L_j,) f32 mean per node."""
    nodes = [(list(inputs), weights) for inputs, weights in nodes]
    if not nodes:
        return []
    if acc not in ("f64", "f32"):
        raise ValueError(f"acc must be 'f64' or 'f32', got {acc!r}")
    device = nodes[0][0][0].device
    if device.type == "cpu":
        if any(x.device.type != "cpu" for inputs, _ in nodes for x in inputs):
            raise ValueError("fold inputs span devices")
        return [fedavg_stream_plain(inputs, weights, acc)
                for inputs, weights in nodes]
    if device.type != "cuda":
        raise ValueError(f"no fold kernel for device {device}")
    outs: list[torch.Tensor] = []
    for lo in range(0, len(nodes), _MAX_NODES):
        outs.extend(_launch(nodes[lo:lo + _MAX_NODES], acc, device))
    return outs


def fedavg_shards(client_shards: torch.Tensor,
                  weights: Sequence[float] | None = None) -> torch.Tensor:
    """client_shards: (N, L) f32/bf16 -> (L,) f32 weighted mean, with the
    TPU kernel's f32 weighted form (``repro/kernels/ops.py:fedavg_shards``)."""
    return fold_nodes([(list(client_shards), weights)], acc="f32")[0]


def fedavg_multi(shard_stacks: Sequence[torch.Tensor],
                 weights: Sequence[float] | None = None
                 ) -> list[torch.Tensor]:
    """Average M (N, L_j) shard stacks in one launch; every stack holds the
    same N clients in the same order. Returns a list of (L_j,) f32 means,
    each exactly :func:`fedavg_shards` of its stack."""
    stacks = list(shard_stacks)
    if stacks and any(s.shape[0] != stacks[0].shape[0] for s in stacks):
        raise ValueError("all shard stacks must hold the same N clients")
    return fold_nodes([(list(s), weights) for s in stacks], acc="f32")
