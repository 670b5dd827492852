"""Streaming (weighted) FedAvg fold: a hand-written Hopper kernel and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``fedavg_stream`` of the reference package
(``repro/kernels/fedavg_stream.py``: ``_fedavg_kernel`` accumulating over
a sequential client grid axis, then ``_finalize_kernel`` dividing), and
its wrappers ``fedavg_shards`` / ``fedavg_multi`` (``repro/kernels/ops.py``).

The fold is bound by device-memory bytes: a node of N inputs of L f32
elements reads N·L·4 bytes and writes L·4, so ``(N+1)·L·4`` bytes for at
most two flops per input element. The CUDA source
(``csrc/fedavg_stream.cu``) therefore makes one pass: each thread owns
elements of one node, walks the clients 0..N-1 in order with the running
sum in registers, and divides at the end of the same loop, so the
accumulator never touches device memory. It has two routes:

* the table kernel, for several nodes or 1-D inputs (a round's dependency
  waves): one launch folds every node of a wave, from a device table of
  per-node lengths, output pointers and divisors and per-(node, client)
  input pointers and weights, instead of concatenating the stacks as the
  TPU wrapper does;
* the carry route, for one node whose inputs are the rows of one 2-D
  tensor (the population's chunks): every argument by value, a row's
  address ``base + i·stride``, a ring of row tiles in shared memory filled
  by TMA (16-byte aligned base and row stride) or ``cp.async``. It builds
  no table and copies nothing to the device, except the weights of a call
  whose weights are not all exactly 1.0.

Arithmetic, per element, with the reference engine's exact bits:

* unweighted — an f32 left fold, then one f32 divide by N;
* weighted, ``acc="f64"`` (the engines' weighted folds) — an f64 fold of
  ``x_i·w_i``, one f64 divide by the host's ``float(sum(w))``, a cast to
  f32;
* weighted, ``acc="f32"`` (the TPU kernel's ``fedavg_shards`` form) — an
  f32 fold of ``x_i·w_i``, divided by the f32 sum of the weights.

A node may also start from a carried accumulator instead of its first
input and skip the divide, returning the raw accumulator: a long fold then
runs chunk by chunk, ``acc ← acc + x_0 + … + x_{n-1}`` per chunk and the
divide after the last, with the bits of one fold over every input (and of
numpy's ``add.accumulate`` down the client axis). The accumulator is f32
for the unweighted and ``acc="f32"`` forms and f64 for ``acc="f64"``; the
last chunk's divisor is passed in, since it counts every chunk's inputs.

Inputs are f32, or bf16 widened exactly; a node's inputs are a sequence of
1-D tensors or the rows of one 2-D tensor. :func:`fold_nodes` runs the
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
_SUM_F64 = 3                  # the carry route's mode 1 with all weights 1.0
_META = 7                     # columns of the per-node table rows
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


def acc_dtype(weighted: bool, acc: str = "f64") -> torch.dtype:
    """The accumulator dtype of a node: f64 for a weighted ``acc="f64"``
    fold, f32 otherwise (the dtype of a carry and of a raw accumulator)."""
    return torch.float64 if weighted and acc == "f64" else torch.float32


def fedavg_stream_plain(inputs, weights: Sequence[float] | None = None,
                        acc: str = "f64", *,
                        carry: torch.Tensor | None = None,
                        finalize: bool = True,
                        divisor: float | None = None) -> torch.Tensor:
    """The kernel's arithmetic as a torch loop: the same op sequence, one
    whole-tensor op per step. ``inputs`` is a sequence of equal-length 1-D
    f32/bf16 tensors (or an (N, L) stack); returns the (L,) f32 mean, or
    with ``finalize=False`` the raw accumulator (:func:`acc_dtype`).
    ``carry`` starts the sum in place of the first input (it is not
    modified); ``divisor`` replaces the count or weight sum of the
    inputs."""
    xs = list(inputs)
    dev = xs[0].device
    if acc not in ("f64", "f32"):
        raise ValueError(f"acc must be 'f64' or 'f32', got {acc!r}")
    div = _divisor(len(xs), weights, acc) if divisor is None \
        else float(divisor)
    if weights is None:
        if carry is None:
            out = xs[0].to(torch.float32, copy=True)
            xs = xs[1:]
        else:
            out = carry.clone()
        for x in xs:
            out.add_(x)
        return out.div_(_scalar(div, torch.float32, dev)) if finalize else out
    if acc == "f32":
        w = _f32_weights(weights)
        if carry is None:
            out = xs[0].to(torch.float32) * _scalar(w[0], torch.float32, dev)
            xs, w = xs[1:], w[1:]
        else:
            out = carry.clone()
        for x, wi in zip(xs, w):
            out.add_(x.to(torch.float32) * _scalar(wi, torch.float32, dev))
        return out.div_(_scalar(div, torch.float32, dev)) if finalize else out
    # a weight of exactly 1.0 adds the widened input unmultiplied, as the
    # engines do (the multiply would be exact)
    w = [float(x) for x in weights]
    if carry is None:
        out = xs[0].to(torch.float64, copy=True)
        if w[0] != 1.0:
            out.mul_(_scalar(w[0], torch.float64, dev))
        xs, w = xs[1:], w[1:]
    else:
        out = carry.clone()
    for x, wi in zip(xs, w):
        if wi == 1.0:
            out.add_(x.to(torch.float64))
        else:
            out.add_(x.to(torch.float64) * _scalar(wi, torch.float64, dev))
    if not finalize:
        return out
    return out.div_(_scalar(div, torch.float64, dev)).to(torch.float32)


def _rows(inputs) -> int:
    return int(inputs.shape[0]) if isinstance(inputs, torch.Tensor) \
        else len(inputs)


def _check_inputs(nodes, carries, acc: str, device: torch.device
                  ) -> torch.dtype:
    dtype = None
    for (inputs, weights), carry in zip(nodes, carries):
        if not _rows(inputs):
            raise ValueError("a fold node needs at least one input")
        if weights is not None and len(weights) != _rows(inputs):
            raise ValueError(f"{len(weights)} weights for {_rows(inputs)} "
                             f"inputs")
        stack = isinstance(inputs, torch.Tensor)
        if stack and inputs.dim() != 2:
            raise ValueError(f"a node's stacked inputs must be 2-D, got "
                             f"{tuple(inputs.shape)}")
        length = int(inputs.shape[1] if stack else inputs[0].shape[0])
        for x in ([inputs] if stack else inputs):
            if x.device != device:
                raise ValueError(f"fold inputs span devices: {x.device} "
                                 f"and {device}")
            if not stack and (x.dim() != 1 or int(x.shape[0]) != length):
                raise ValueError(f"fold inputs must be 1-D of one length, "
                                 f"got {tuple(x.shape)} vs ({length},)")
            if x.dtype not in _INPUT_DTYPES:
                raise TypeError(f"fold inputs must be f32 or bf16, got "
                                f"{x.dtype}")
            if dtype is not None and x.dtype != dtype:
                raise TypeError("one launch folds inputs of one dtype")
            if length > 1 and x.stride(-1) != 1:
                raise ValueError("fold inputs must be contiguous")
            dtype = x.dtype
        _check_carry(carry, weights, acc, length, device)
    return dtype


def _check_carry(carry, weights, acc: str, length: int,
                 device: torch.device) -> None:
    if carry is None:
        return
    want = acc_dtype(weights is not None, acc)
    if carry.device != device or carry.dtype != want \
            or carry.shape != (length,) \
            or (length > 1 and carry.stride(0) != 1):
        raise ValueError(
            f"a carry must be a contiguous ({length},) {want} tensor on "
            f"{device}, got {tuple(carry.shape)} {carry.dtype} on "
            f"{carry.device}")


@functools.cache
def _launcher():
    return build.launcher("fedavg_stream", "fedavg_fold_launch",
                          [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                           ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])


@functools.cache
def _carry_launcher():
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    return build.launcher("fedavg_stream", "fedavg_carry_launch",
                          [ptr, i64, i64, i64, i32, i32, ptr, ptr, i32,
                           ctypes.c_double, i32, ptr, ptr])


def _carry_route(nodes) -> bool:
    """Whether a call goes to the carry route: one node whose inputs are
    the rows of one 2-D tensor."""
    return len(nodes) == 1 and isinstance(nodes[0][0], torch.Tensor)


def _carry_args(stack: torch.Tensor, weights, carry, divisor, acc: str,
                finalize: bool, device: torch.device):
    """The carry route's by-value launch arguments (the C signature of
    ``fedavg_carry_launch`` in ``csrc/fedavg_stream.cu`` up to the weights
    pointer), the allocated output, and the f64 weights the kernel reads
    (None for the unweighted and all-ones calls, which read none)."""
    n, length = (int(d) for d in stack.shape)
    stride = stack.stride(0) * stack.element_size()
    if weights is None:
        mode, w = _MODES[None], None
    elif acc == "f32":
        mode, w = _MODES["f32"], np.asarray(_f32_weights(weights), np.float64)
    elif list(weights).count(1.0) == n:
        mode, w = _SUM_F64, None
    else:
        mode, w = _MODES["f64"], np.asarray(weights, np.float64)
    out = torch.empty(length, device=device, dtype=torch.float32
                      if finalize else acc_dtype(weights is not None, acc))
    base = stack.data_ptr()
    tma = base % 16 == 0 and stride % 16 == 0 \
        and stride >= length * stack.element_size()
    div = _divisor(n, weights, acc) if divisor is None else float(divisor)
    args = (base, stride, n, length, int(stack.dtype == torch.bfloat16),
            int(tma), 0 if carry is None else carry.data_ptr(),
            out.data_ptr(), mode, div, int(finalize))
    return args, out, w


def _launch_carry(node, carry, divisor, acc: str, finalize: bool,
                  device: torch.device) -> torch.Tensor:
    """One carry-route launch over the rows of ``node``'s 2-D tensor."""
    global LAUNCHES
    _check_inputs([node], [carry], acc, device)
    stack, weights = node
    args, out, w = _carry_args(stack, weights, carry, divisor, acc,
                               finalize, device)
    if not out.numel():
        return out
    # freed on return, like the table kernel's table
    w_dev = None if w is None else torch.from_numpy(w).to(device)
    rc = _carry_launcher()(*args, 0 if w_dev is None else w_dev.data_ptr(),
                           build.raw_stream(device.index))
    if rc != 0:
        raise RuntimeError(f"fedavg_stream carry kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    return out


def _table(nodes, carries, divisors, acc: str, finalize: bool,
           device: torch.device):
    """The kernel's node table (layout in ``csrc/fedavg_stream.cu``) as a
    host int64 array, the allocated outputs, and the longest node."""
    n = len(nodes)
    n_slots = sum(_rows(inputs) for inputs, _ in nodes)
    table = np.zeros(n * (_META + 1) + 2 * n_slots, np.int64)
    meta = table[:n * _META].reshape(n, _META)
    div = table[n * _META:n * (_META + 1)].view(np.float64)
    ptr = table[n * (_META + 1):n * (_META + 1) + n_slots]
    wts = table[n * (_META + 1) + n_slots:].view(np.float64)
    outs, slot, max_len = [], 0, 0
    for j, ((inputs, weights), carry) in enumerate(zip(nodes, carries)):
        stack = isinstance(inputs, torch.Tensor)
        rows = _rows(inputs)
        length = int(inputs.shape[1] if stack else inputs[0].shape[0])
        out = torch.empty(length, device=device, dtype=torch.float32
                          if finalize else acc_dtype(weights is not None, acc))
        outs.append(out)
        max_len = max(max_len, length)
        meta[j] = (length, out.data_ptr(), slot, rows, _MODES[
            None if weights is None else acc],
            0 if carry is None else carry.data_ptr(), int(finalize))
        div[j] = _divisor(rows, weights, acc) if divisors is None \
            else float(divisors[j])
        wts[slot:slot + rows] = 1.0 if weights is None else (
            _f32_weights(weights) if acc == "f32" else
            [float(x) for x in weights])
        if stack:
            ptr[slot:slot + rows] = inputs.data_ptr() + np.arange(
                rows, dtype=np.int64) * (inputs.stride(0)
                                         * inputs.element_size())
        else:
            ptr[slot:slot + rows] = [x.data_ptr() for x in inputs]
        slot += rows
    return table, outs, max_len


def _launch(nodes, carries, divisors, acc: str, finalize: bool,
            device: torch.device) -> list[torch.Tensor]:
    """One kernel launch over ``nodes`` (at most ``_MAX_NODES``)."""
    global LAUNCHES
    dtype = _check_inputs(nodes, carries, acc, device)
    launch = _launcher()
    table, outs, max_len = _table(nodes, carries, divisors, acc, finalize,
                                  device)
    n, n_slots = len(nodes), sum(_rows(inputs) for inputs, _ in nodes)
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


def fold_nodes(nodes: Sequence[tuple], acc: str = "f64", *,
               carry: Sequence[torch.Tensor | None] | None = None,
               finalize: bool = True,
               divisors: Sequence[float] | None = None
               ) -> list[torch.Tensor]:
    """Fold many averaging nodes: ``nodes`` is a sequence of
    ``(inputs, weights)`` pairs, ``weights`` ``None`` for the unweighted
    mean and ``inputs`` a sequence of 1-D tensors or one 2-D tensor whose
    rows are the inputs. CUDA tensors go through the kernel, every node of
    the call in one launch (one node of a 2-D tensor through the carry
    route); CPU tensors through :func:`fedavg_stream_plain`. Returns one
    (L_j,) f32 mean per node.

    ``carry`` gives each node an accumulator to start from (or None), in
    the node's :func:`acc_dtype`; ``finalize=False`` returns the raw
    accumulators instead of the means; ``divisors`` replaces each node's
    count or weight sum in the divide."""
    nodes = [(inputs if isinstance(inputs, torch.Tensor) else list(inputs),
              weights) for inputs, weights in nodes]
    if not nodes:
        return []
    if acc not in ("f64", "f32"):
        raise ValueError(f"acc must be 'f64' or 'f32', got {acc!r}")
    carries = [None] * len(nodes) if carry is None else list(carry)
    if len(carries) != len(nodes) or (divisors is not None
                                      and len(divisors) != len(nodes)):
        raise ValueError("carry and divisors take one entry per node")
    device = nodes[0][0][0].device
    if device.type == "cpu":
        if any(x.device.type != "cpu" for inputs, _ in nodes for x in inputs) \
                or any(c is not None and c.device.type != "cpu"
                       for c in carries):
            raise ValueError("fold inputs span devices")
        for (inputs, weights), c in zip(nodes, carries):
            _check_carry(c, weights, acc, int(inputs[0].shape[0]), device)
        return [fedavg_stream_plain(
            inputs, weights, acc, carry=c, finalize=finalize,
            divisor=None if divisors is None else divisors[j])
            for j, ((inputs, weights), c) in enumerate(zip(nodes, carries))]
    if device.type != "cuda":
        raise ValueError(f"no fold kernel for device {device}")
    if _carry_route(nodes):
        return [_launch_carry(nodes[0], carries[0],
                              None if divisors is None else divisors[0],
                              acc, finalize, device)]
    outs: list[torch.Tensor] = []
    for lo in range(0, len(nodes), _MAX_NODES):
        hi = lo + _MAX_NODES
        outs.extend(_launch(nodes[lo:hi], carries[lo:hi],
                            None if divisors is None else divisors[lo:hi],
                            acc, finalize, device))
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
