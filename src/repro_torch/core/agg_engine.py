"""Pluggable aggregation execution engines.

The simulated-Lambda aggregation path has two concerns that this module
separates:

  * **modeled platform accounting** — S3 op counts, transfer/compute time,
    billed GB-s, peak memory. Always per-invocation, always identical.
  * **actual arithmetic** — the real averaging, on torch tensors on the
    session's device, whose result feeds the bit-identity checks.

Four backends implement the same primitive-op protocol:

  * ``"streaming"`` — the reference. Arithmetic runs inline inside each
    simulated invocation, one contribution at a time (the paper's
    two-buffer aggregator), as whole-tensor torch ops.
  * ``"batched"`` — the fast path. Invocation bodies run with *lazy
    handles* (size-typed placeholders); at round end the recorded DAG of
    averages is evaluated at once. On a CUDA device every pending node,
    weighted or not, goes to the hand-written fold kernel
    (:mod:`repro_torch.kernels.fedavg_stream`) in dependency waves: one
    launch folds every node whose inputs are concrete, then their
    dependents. On the CPU the DAG runs the chunked fold, which keeps
    accumulators in L2-sized blocks, fuses all phases of a topology per
    chunk and threads across disjoint element ranges.
  * ``"host_mesh"`` — the batched DAG with its unweighted folds split
    along the element axis over several devices
    (:func:`repro_torch.core.device_agg.mesh_fold_sum`): each card (or
    each column slice of the host, on the CPU) folds its slice without
    dividing, and the joined sum takes one f32 divide.
  * ``"incremental"`` — the streaming *prefix fold*, tuned. Arithmetic is
    eager like ``streaming`` (the running prefix mean is up to date the
    moment contribution *i* lands — the natural partner of the pipelined
    round schedule), but folds in chunks with preallocated accumulators,
    so the weighted path never allocates the streaming reference's two
    full-size f64 temporaries per contribution.

Every backend replays the same per-element IEEE op sequence: unweighted —
an f32 left fold, then one f32 divide by N; weighted — an f64 fold of
``x_i·w_i``, one f64 divide by ``float(sum(w))``, a cast to f32 (a weight
of exactly 1.0 scales exactly, so skipping its multiply changes no bit).
So ``avg_flat`` is **bit-identical** across engines, schedules and
devices, and equal to the reference package's numpy result. Two rules
keep it so on CUDA: a divide takes a 0-d device tensor, never a Python
number (CUDA's true divide by a CPU scalar multiplies by the reciprocal),
and no fused op (``alpha=``, ``addcmul``, ``lerp``) appears.

Host parallelism: the CPU chunked evaluator splits disjoint element
ranges across a :class:`~repro_torch.core.fold_pool.ParallelFoldPool`
sized by the ``workers`` knob (``SessionConfig.workers`` /
``REPRO_AGG_WORKERS``); the split is element-wise, so bits never depend
on it.

All backends drive the **same invocation body template**, so every
accounting field (``puts``/``gets``, ``billed_gb_s``, ``peak_memory_mb``,
``duration_s``, phase walls) is identical by construction.

Selection: pass ``engine="streaming" | "batched" | "incremental" |
"host_mesh"`` to ``aggregate_round`` (or any topology function), or set
``REPRO_AGG_ENGINE`` in the environment; the default is ``"batched"``.
Engines compose freely with the round *schedule* knob
(``schedule="barrier" | "pipelined"`` / ``REPRO_AGG_SCHEDULE``).

**Wire codecs (decode-before-fold contract).** Under a non-identity
codec, client contributions arrive as encoded ``WirePayload`` objects.
The shared body template buffers the *encoded* bytes and decodes each
contribution exactly once, at the fold frontier, before folding it —
charging the codec's declared decode cost. Under ``identity`` the codec
layer is byte-for-byte invisible.

**Fault-tolerant rounds (subset folds)** are handled at the round-driver
level: the driver builds the aggregation program over the *surviving*
membership, so engines see an ordinary N'-client round.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import knobs
from repro_torch.core import device_agg
from repro_torch.core.fold_pool import CHUNK_ELEMS, ParallelFoldPool, get_pool
from repro_torch.core.sharding import PartitionPlan, ShardView, shard, \
    shard_views
from repro_torch.core.wire_codec import (EncodedView, WirePayload,
                                         decode_eager, decode_lazy)
from repro_torch.kernels import fedavg_stream
from repro_torch.serverless.event_sim import ReadAheadWindow
from repro_torch.store import ObjectStore
from repro_torch.tracing import span


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``like``'s dtype on its device — the
    divisor form that keeps a CUDA divide IEEE (see the module doc)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# Lazy values
# ---------------------------------------------------------------------------

def _size_of(x) -> int:
    return int(x.shape[0])


def _chunk_of(x, s: int, e: int) -> torch.Tensor:
    """Chunk [s, e) of an input: tensor slice, ShardView gather, or a lazy
    node's already-evaluated output slice."""
    if isinstance(x, LazyAverage):
        return x.out[s:e]
    if isinstance(x, (ShardView, EncodedView)):
        return x.read(s, e)
    return x[s:e]


def _device_of(x) -> torch.device:
    """The device an input's values live on."""
    if isinstance(x, LazyAverage):
        return _device_of(x.inputs[0])
    if isinstance(x, EncodedView):
        return x.materialize().device
    return x.device


class _PendingAcc:
    """Accumulator under construction inside a deferred invocation body.

    Only its byte size matters to the runtime: f64 while accumulating a
    weighted mean (matching the streaming reference's float64 running sum),
    f32 otherwise.
    """

    __slots__ = ("inputs", "weighted", "size")

    def __init__(self, first, weighted: bool):
        self.inputs = [first]
        self.weighted = weighted
        self.size = _size_of(first)

    @property
    def nbytes(self) -> int:
        return (8 if self.weighted else 4) * self.size


class LazyAverage:
    """Deferred (weighted) streaming mean of its inputs.

    Inputs are tensors, :class:`ShardView` s, or other ``LazyAverage``
    nodes (tree topologies) — the captured objects themselves, so
    materialization never re-reads the object store. ``out`` is filled by
    the DAG evaluator; until then the handle stands in for the f32 result
    tensor in the store (same ``nbytes``/``shape``/``dtype``).
    """

    __slots__ = ("inputs", "weights", "size", "out")

    dtype = torch.float32

    def __init__(self, inputs: list, weights: list[float] | None):
        self.inputs = inputs
        self.weights = weights
        self.size = _size_of(inputs[0]) if inputs else 0
        self.out: torch.Tensor | None = None

    @property
    def shape(self) -> tuple:
        return (self.size,)

    @property
    def nbytes(self) -> int:
        return 4 * self.size

    def _ancestors(self) -> list["LazyAverage"]:
        seen, order = set(), []

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for x in node.inputs:
                if isinstance(x, LazyAverage) and x.out is None:
                    visit(x)
            order.append(node)

        visit(self)
        return order

    def materialize(self) -> torch.Tensor:
        if self.out is None:
            evaluate(self._ancestors())
        return self.out


def _materialize(x):
    if isinstance(x, torch.Tensor):
        return x
    if hasattr(x, "materialize"):
        return x.materialize()
    return x


# ---------------------------------------------------------------------------
# DAG evaluators: the fold kernel on CUDA, the chunked fold on the CPU
# ---------------------------------------------------------------------------

class _Scratch:
    """Per-worker fold buffers, reused across chunks and nodes."""

    __slots__ = ("acc32", "acc64", "buf64")

    def __init__(self, chunk: int):
        self.acc32 = torch.empty(chunk, dtype=torch.float32)
        self.acc64 = torch.empty(chunk, dtype=torch.float64)
        self.buf64 = torch.empty(chunk, dtype=torch.float64)


def _node_chunk(nd: LazyAverage, s: int, e: int, scr: _Scratch) -> None:
    """Evaluate node ``nd`` over elements [s, e) on the CPU.

    Replays the exact IEEE op sequence of :class:`StreamingBackend`:
    unweighted — f32 left-fold then one f32 divide; weighted — f64
    ``x_i * w_i`` left-fold, one f64 divide by ``float(sum(w))``, f32 cast.
    """
    m = e - s
    ins = nd.inputs
    if nd.weights is None:
        acc = scr.acc32[:m]
        acc.copy_(_chunk_of(ins[0], s, e))
        for x in ins[1:]:
            acc.add_(_chunk_of(x, s, e))
        torch.div(acc, _scalar(float(len(ins)), acc), out=nd.out[s:e])
    else:
        # copy_ casts to f64 first, so every multiply runs in f64 — the
        # streaming reference's ``x.to(f64) * w``. A weight of exactly 1.0
        # scales exactly, so its multiply is skipped.
        acc, buf = scr.acc64[:m], scr.buf64[:m]
        w = nd.weights
        acc.copy_(_chunk_of(ins[0], s, e))
        if w[0] != 1.0:
            acc.mul_(w[0])
        for i in range(1, len(ins)):
            if w[i] == 1.0:
                acc.add_(_chunk_of(ins[i], s, e))
            else:
                buf.copy_(_chunk_of(ins[i], s, e))
                acc.add_(buf.mul_(w[i]))
        torch.div(acc, _scalar(float(sum(w)), acc), out=buf)
        nd.out[s:e].copy_(buf)     # f64 -> f32 cast, round to nearest


def _evaluate_nodes(pending: Sequence[LazyAverage],
                      chunk: int = CHUNK_ELEMS,
                      pool: ParallelFoldPool | None = None) -> None:
    """Fill ``out`` for every pending node on the CPU.

    Nodes are grouped by element count; within a group they are kept in
    creation (= phase/topological) order and evaluated chunk-by-chunk, all
    nodes per chunk, so a tree's level-2 fold reads its level-1 partials
    while those chunks are still cache-hot. Disjoint element ranges go to
    the :class:`~repro_torch.core.fold_pool.ParallelFoldPool`'s workers;
    chunking is element-wise so the result is bit-identical regardless of
    chunk size or worker count.
    """
    if pool is None:
        pool = get_pool()
    groups: dict[int, list[LazyAverage]] = {}
    for nd in pending:
        nd.out = torch.empty(nd.size, dtype=torch.float32)
        groups.setdefault(nd.size, []).append(nd)

    # detlint: allow[ORD001] groups is insertion-ordered by node creation
    # (= phase/topological) order — that IS the canonical fold order
    for size, group in groups.items():
        if size == 0:
            continue

        def run(lo: int, hi: int, group=group):
            scr = _Scratch(chunk)
            for s in range(lo, hi, chunk):
                e = min(s + chunk, hi)
                for nd in group:
                    _node_chunk(nd, s, e, scr)

        pool.run_spans(run, size, chunk)


def _evaluate_kernel(pending: Sequence[LazyAverage],
                     device: torch.device) -> None:
    """Fill ``out`` for every pending node through the fold kernel, in
    dependency waves: one launch folds every node whose inputs are all
    concrete, then the next wave folds their dependents."""
    for nd in pending:
        if nd.size == 0:
            nd.out = torch.empty(0, dtype=torch.float32, device=device)
    pending = [nd for nd in pending if nd.out is None]
    while pending:
        wave = [nd for nd in pending
                if not any(isinstance(x, LazyAverage) and x.out is None
                           for x in nd.inputs)]
        with span("codec.decode"):
            groups = [([_materialize(x) for x in nd.inputs], nd.weights)
                      for nd in wave]
        with span("fold.launch"):
            outs = fedavg_stream.fold_nodes(groups, acc="f64")
        for nd, out in zip(wave, outs):
            nd.out = out
        pending = [nd for nd in pending if nd.out is None]


def evaluate(nodes: Sequence[LazyAverage],
             pool: ParallelFoldPool | None = None) -> None:
    """Fill ``out`` for every pending node of ``nodes`` (given in creation
    order): through the fold kernel when the values live on a CUDA device,
    through the chunked fold on the CPU."""
    pending = [nd for nd in nodes if nd.out is None]
    if not pending:
        return
    device = _device_of(pending[0])
    if device.type == "cuda":
        _evaluate_kernel(pending, device)
    else:
        _evaluate_nodes(pending, pool=pool)


# ---------------------------------------------------------------------------
# Invocation body templates (shared by both backends)
# ---------------------------------------------------------------------------

def _avg_body(backend: "ExecutionBackend", store: ObjectStore,
              in_keys: Sequence[str], out_key: str,
              weights: Sequence[float] | None = None,
              readahead_k: int = 1):
    """Streaming fold with a bounded out-of-order read-ahead window.

    The fold itself is **strictly in in_keys (client-index) order** — the
    bit-reproducibility contract — but the body may GET up to
    ``readahead_k`` contributions at-or-ahead of the fold frontier into a
    bounded buffer (:class:`~repro_torch.serverless.event_sim.ReadAheadWindow`),
    so under the pipelined schedule a late low-index upload no longer
    blocks every later read. ``readahead_k=1`` is byte-for-byte the legacy
    one-at-a-time loop (fetch order == index order, 2-buffer bound); under
    the barrier schedule every key is available at time 0, so any ``k``
    degenerates to index order too.

    The ctx models peak memory ``(k+1)``·input + overhead: running sum +
    up to ``k`` buffered inputs (incl. the transient deserialization copy
    of the in-flight GET) — the paper's 3×input+450 MB formula at
    ``k<=2``. The backend supplies the arithmetic (inline torch ops or lazy
    handles); the ctx call sequence is identical across backends.

    **Decode-before-fold.** When a fetched value is a
    :class:`~repro_torch.core.wire_codec.WirePayload` (a lossy wire codec is
    active), the body buffers the *encoded* payload — GET latency,
    transfer time and the prefetch window's memory all see the reduced
    wire size — and decodes it the moment it reaches the fold frontier:
    the codec's declared ``decode_cost_s`` is charged, the decoded f32
    buffer is allocated, the wire buffer freed, and the fold proceeds on
    decoded values exactly as before. ``backend.decode_value`` picks the
    arithmetic: an eager decode (streaming/incremental) or a lazy
    chunk-decoding view (batched — the decode fuses into the chunked DAG
    evaluation, bitwise identical to the eager decode). Under the
    ``identity`` codec no payload ever appears and this path is
    byte-for-byte the pre-codec loop.
    """
    def body(ctx):
        acc = None
        n = len(in_keys)
        win = ReadAheadWindow([ctx.avail_time(k) for k in in_keys],
                              readahead_k)
        buffered: dict = {}
        while not win.done:
            if win.foldable:
                i = win.frontier
                arr = buffered.pop(i)
                if isinstance(arr, WirePayload):
                    # decode through the instance that encoded the payload
                    # (unregistered codec objects round-trip; a registered
                    # name collision cannot mis-decode)
                    codec = arr.codec_obj
                    ctx.work(codec.decode_cost_s(arr.raw_nbytes))
                    ctx.free(arr.nbytes)              # wire buffer released
                    arr = backend.decode_value(codec, arr)
                    ctx.alloc(backend.nbytes(arr))    # decoded f32 buffer
                    # (chunk-fused in the batched engine, so the peak
                    # stays within the (k+1)-input envelope)
                if acc is None:
                    acc = backend.init_acc(arr, weights)
                    ctx.alloc(backend.nbytes(acc))
                else:
                    acc = backend.accumulate(acc, arr, i, weights)
                    ctx.compute(backend.nbytes(arr))
                ctx.free(backend.nbytes(arr))         # buffered slot released
                win.folded()
                continue
            j = win.next_fetch(ctx.now_s)
            arr = ctx.get(store, in_keys[j])          # stalls if unavailable
            ctx.alloc(backend.nbytes(arr))            # buffered input
            buffered[j] = arr
            win.fetched(j)
        out = backend.finalize(acc, weights, n)
        ctx.compute(backend.nbytes(out))
        ctx.put(store, out_key, out, if_none_match=True)  # idempotent
        ctx.free(backend.nbytes(out))
        return out

    return body


def _colocated_body(backend: "ExecutionBackend", shared_mem: dict,
                    store: ObjectStore, in_keys: Sequence[str],
                    weights: Sequence[float], out_key: str, is_global: bool):
    """LIFL shared-memory fast path: read partials from node-local memory
    (no S3, no transfer time); only the global result is PUT."""

    def body(ctx):
        acc = None
        for i, key in enumerate(in_keys):
            ctx.wait_key(key)                         # pipelined: producer gate
            arr = shared_mem[key]                     # no S3, no transfer
            if acc is None:
                acc = backend.init_acc(arr, weights)
                ctx.alloc(backend.nbytes(acc))
            else:
                acc = backend.accumulate(acc, arr, i, weights)
                ctx.compute(backend.nbytes(arr))
        out = backend.finalize(acc, weights, len(in_keys))
        ctx.compute(backend.nbytes(out))
        if is_global:
            ctx.put(store, out_key, out, if_none_match=True)
        else:
            shared_mem[out_key] = out
        ctx.free(backend.nbytes(out))
        return out

    return body


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------

class ExecutionBackend:
    """Primitive-op protocol an engine implements (see module docstring)."""

    name = "?"

    # -- arithmetic primitives used by the body templates --------------------
    def init_acc(self, arr, weights):
        raise NotImplementedError

    def accumulate(self, acc, arr, i, weights):
        raise NotImplementedError

    def finalize(self, acc, weights, n):
        raise NotImplementedError

    def nbytes(self, x) -> int:
        return int(x.nbytes)

    def decode_value(self, codec, payload):
        """Decoded form of a wire payload reaching the fold frontier.
        Default: eager decode (the streaming/incremental engines fold real
        tensors the moment they reach the frontier)."""
        return decode_eager(payload)

    # -- body construction ---------------------------------------------------
    def avg_body(self, store, in_keys, out_key, weights=None,
                 readahead_k=1):
        return _avg_body(self, store, in_keys, out_key, weights,
                         readahead_k)

    def colocated_body(self, shared_mem, store, in_keys, weights, out_key,
                       is_global):
        return _colocated_body(self, shared_mem, store, in_keys, weights,
                               out_key, is_global)

    # -- client-side sharding ------------------------------------------------
    def shard_values(self, flat: torch.Tensor, plan: PartitionPlan) -> list:
        """Per-shard values a client uploads (tensors or zero-copy views)."""
        return shard(flat, plan)

    # -- round lifecycle -----------------------------------------------------
    def end_round(self, store: ObjectStore) -> None:
        """Execute any deferred arithmetic and materialize store contents."""


class StreamingBackend(ExecutionBackend):
    """Reference backend: the inline client-by-client fold."""

    name = "streaming"

    def init_acc(self, arr, weights):
        if weights is not None:
            return arr.to(torch.float64) * weights[0]
        return arr.to(torch.float32, copy=True)

    def accumulate(self, acc, arr, i, weights):
        if weights is not None:
            acc += arr.to(torch.float64) * weights[i]
        else:
            acc += arr
        return acc

    def finalize(self, acc, weights, n):
        if weights is not None:
            return (acc / _scalar(float(sum(weights)), acc)).to(torch.float32)
        return (acc / _scalar(float(n), acc)).to(torch.float32)


class _PrefixState:
    """Running prefix-fold accumulator of :class:`IncrementalBackend`.

    ``acc`` is the live running sum (f64 when weighted, matching the
    streaming reference's float64 weighted path; f32 otherwise). Scratch is
    one chunk-sized f64 buffer per device, shared per backend instance,
    replacing the full-size ``x.to(f64) * w`` temporaries of the reference.
    """

    __slots__ = ("acc", "weighted", "size")

    def __init__(self, acc: torch.Tensor, weighted: bool):
        self.acc = acc
        self.weighted = weighted
        self.size = int(acc.shape[0])

    @property
    def nbytes(self) -> int:
        return int(self.acc.nbytes)


class IncrementalBackend(ExecutionBackend):
    """Eager chunked prefix folds: streaming semantics, batched locality.

    Each contribution is folded into a preallocated accumulator the moment
    the body reads it, chunk by chunk (``CHUNK_ELEMS``), replaying the exact
    per-element IEEE op order of :class:`StreamingBackend` — left-fold
    accumulate, single divide, f32 cast — so ``avg_flat`` is bit-identical.
    Unlike ``batched`` there is no deferred DAG: partial results exist as
    real tensors throughout the round, and ``end_round`` is a no-op.
    """

    name = "incremental"

    def __init__(self) -> None:
        self._buf64: dict[torch.device, torch.Tensor] = {}

    def _buf(self, like: torch.Tensor, n: int) -> torch.Tensor:
        buf = self._buf64.get(like.device)
        if buf is None:
            buf = self._buf64[like.device] = torch.empty(
                CHUNK_ELEMS, dtype=torch.float64, device=like.device)
        return buf[:n]

    @staticmethod
    def _as_tensor(arr) -> torch.Tensor:
        return arr if isinstance(arr, torch.Tensor) else _materialize(arr)

    def init_acc(self, arr, weights):
        arr = self._as_tensor(arr)
        if weights is not None:
            acc = arr.to(torch.float64, copy=True)
            if weights[0] != 1.0:          # exact: *1.0 is the identity
                acc.mul_(weights[0])
            return _PrefixState(acc, weighted=True)
        return _PrefixState(arr.to(torch.float32, copy=True), weighted=False)

    def accumulate(self, acc: _PrefixState, arr, i, weights):
        arr = self._as_tensor(arr)
        if not acc.weighted:
            acc.acc.add_(arr)
            return acc
        w = weights[i]
        for s in range(0, acc.size, CHUNK_ELEMS):
            e = min(s + CHUNK_ELEMS, acc.size)
            if w == 1.0:
                acc.acc[s:e].add_(arr[s:e])
            else:
                buf = self._buf(acc.acc, e - s)
                buf.copy_(arr[s:e])
                acc.acc[s:e].add_(buf.mul_(w))
        return acc

    def finalize(self, acc: _PrefixState, weights, n):
        div = float(sum(weights)) if weights is not None else float(n)
        if acc.weighted:
            out = torch.empty(acc.size, dtype=torch.float32,
                              device=acc.acc.device)
            d = _scalar(div, acc.acc)
            for s in range(0, acc.size, CHUNK_ELEMS):
                e = min(s + CHUNK_ELEMS, acc.size)
                buf = self._buf(acc.acc, e - s)
                torch.div(acc.acc[s:e], d, out=buf)
                out[s:e].copy_(buf)        # f64 -> f32 cast, round to nearest
            return out
        return acc.acc / _scalar(div, acc.acc)


class BatchedBackend(ExecutionBackend):
    """Deferred backend: bodies build a DAG of :class:`LazyAverage` nodes;
    ``end_round`` evaluates it at once (the fold kernel on CUDA, the
    chunked fold on the CPU)."""

    name = "batched"

    def __init__(self, workers: int | str | None = None):
        self._pool = get_pool(workers)
        self._nodes: list[LazyAverage] = []
        self._memo: dict = {}

    # -- arithmetic primitives ----------------------------------------------
    def init_acc(self, arr, weights):
        return _PendingAcc(arr, weighted=weights is not None)

    def accumulate(self, acc, arr, i, weights):
        acc.inputs.append(arr)
        return acc

    def finalize(self, acc, weights, n):
        w = [float(x) for x in weights] if weights is not None else None
        key = (tuple(id(x) for x in acc.inputs),
               tuple(w) if w is not None else None)
        node = self._memo.get(key)
        if node is None:
            # retries / speculative duplicates reuse the same node, exactly
            # as their first-write-wins PUTs reuse the same stored value
            node = LazyAverage(acc.inputs, w)
            self._memo[key] = node
            self._nodes.append(node)
        return node

    # -- client-side sharding ------------------------------------------------
    def shard_values(self, flat: torch.Tensor, plan: PartitionPlan) -> list:
        return shard_views(flat, plan)

    # -- wire payloads -------------------------------------------------------
    def decode_value(self, codec, payload):
        # lazy: the decode fuses into the chunked DAG evaluation
        # (EncodedView.read is bitwise decode(payload)[s:e])
        return decode_lazy(payload)

    # -- round lifecycle -----------------------------------------------------
    def end_round(self, store: ObjectStore) -> None:
        evaluate(self._nodes, pool=self._pool)
        for key in store.list():
            v = store.peek(key)
            if not isinstance(v, (torch.Tensor, bytes, bytearray)) \
                    and hasattr(v, "materialize"):
                store.swap(key, v.materialize())
        # release the round's DAG (it pins every client gradient) so a
        # backend instance reused across rounds doesn't accumulate them
        self._nodes = []
        self._memo = {}


class HostMeshBackend(BatchedBackend):
    """Multi-device path: the batched DAG with element-sharded folds.

    Same deferred-DAG recording as :class:`BatchedBackend`; at round end,
    unweighted nodes whose inputs are all concrete go through
    :func:`repro_torch.core.device_agg.mesh_fold_sum` — each fold device
    owns a contiguous element slice and adds the node's inputs in client
    order without dividing (the fold kernel's ``finalize=False`` form on a
    card, its plain version on the CPU) — then one f32 divide by N, a 0-d
    tensor, on the joined sum. That is the streaming reference's op
    sequence, so the result stays bit-identical to every other engine;
    weighted (f64) folds and nodes with lazy ancestors fall through to the
    batched evaluator.

    Selection: ``engine="host_mesh"`` (``SessionConfig.host_mesh`` sizes
    the mesh: that many cards on ``"cuda"``, that many column slices of
    the host on ``"cpu"``; ``None`` takes every visible card, or one slice
    a host core).
    """

    name = "host_mesh"

    def __init__(self, workers: int | str | None = None,
                 n_devices: int | None = None, device_type: str = "cuda"):
        super().__init__(workers=workers)
        self._devices = device_agg.make_fold_mesh(n_devices, device_type)

    def _evaluate_mesh(self) -> None:
        ready = [nd for nd in self._nodes
                 if nd.out is None and nd.weights is None and nd.size > 0
                 and not any(isinstance(x, LazyAverage) and x.out is None
                             for x in nd.inputs)]
        for nd in ready:
            total = device_agg.mesh_fold_sum(
                self._devices, [_materialize(x) for x in nd.inputs])
            # the single f32 divide of _node_chunk — bits preserved
            nd.out = torch.div(total, _scalar(float(len(nd.inputs)), total))

    def end_round(self, store: ObjectStore) -> None:
        self._evaluate_mesh()
        super().end_round(store)


# ---------------------------------------------------------------------------
# Selection
# ---------------------------------------------------------------------------

DEFAULT_ENGINE = "batched"

ENGINES = ("streaming", "batched", "incremental", "host_mesh")


def get_backend(engine: str | ExecutionBackend | None = None, *,
                workers: int | str | None = None,
                host_mesh: int | None = None,
                device: str | torch.device | None = None) -> ExecutionBackend:
    """Resolve the engine knob: an instance, a name, ``None``/"auto" (env
    ``REPRO_AGG_ENGINE``, else ``"batched"``).

    ``workers`` sizes the :class:`~repro_torch.core.fold_pool
    .ParallelFoldPool` behind the batched and host_mesh engines' CPU
    evaluator (``None`` defers to ``REPRO_AGG_WORKERS``, else the host's
    real core count); the streaming and incremental engines fold one
    contribution at a time, so the knob is inert there. ``host_mesh``
    sizes the ``host_mesh`` engine's fold devices, on the type of
    ``device`` (the round's values' device, ``"cuda"`` when not given),
    and is rejected for any other engine. Backends are stateful per round
    — this returns a fresh instance (pools are shared per worker count).
    """
    if isinstance(engine, ExecutionBackend):
        return engine
    if engine is None or engine == "auto":
        engine = knobs.env_engine(DEFAULT_ENGINE)
    if host_mesh is not None and engine != "host_mesh":
        raise ValueError(
            f"host_mesh={host_mesh} requires engine='host_mesh', "
            f"got engine={engine!r}")
    if engine == "host_mesh":
        device_type = torch.device(device or "cuda").type
        return HostMeshBackend(workers=workers, n_devices=host_mesh,
                               device_type=device_type)
    if engine == "streaming":
        return StreamingBackend()
    if engine == "batched":
        return BatchedBackend(workers=workers)
    if engine == "incremental":
        return IncrementalBackend()
    raise ValueError(f"unknown aggregation engine {engine!r} "
                     f"(expected one of {ENGINES} or 'auto')")
