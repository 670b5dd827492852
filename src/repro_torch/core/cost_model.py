"""Analytical cost model for serverless FL aggregation (paper §III, Table II).

Encodes, for each architecture (λ-FL, LIFL, GradsSharding):
  * per-round S3 operation counts (PUTs / GETs, split by phase),
  * per-aggregator memory (streaming bound, collect-then-average bound, and
    the empirical Lambda deployment formula 3·input + 450 MB),
  * feasibility against Lambda's 10,240 MB ceiling,
  * modeled wall-clock (S3-transfer-dominated; 45–68 MB/s per stream) and
    dollar cost (Lambda GB-s + S3 ops), matching the paper's measurements,
  * the **pipelined schedule** (:func:`pipelined_round_cost`): client
    uploads with per-client start/rate jitter (:class:`UploadModel`),
    aggregators that launch on their first contribution and stream-fold in
    index order, stalling only when the next contribution hasn't landed —
    predicting the wall-clock win of overlapping uploads with shard folds
    (the discrete-event runtime reproduces this number exactly for a
    no-fault round).

Every transfer/billing/feasibility entry is **wire-codec aware**
(``codec=`` on :func:`round_cost` / :func:`barrier_round_cost` /
:func:`pipelined_round_cost` / :func:`feasible` / :func:`lambda_memory_mb`;
``None`` resolves ``REPRO_AGG_CODEC`` exactly like the round driver):
client uploads and first-level GETs move ``codec.wire_bytes``, level-1
folds pay ``decode_cost_s`` per contribution, and the billed allocation
buffers encoded payloads (:func:`wire_alloc_bytes`). ``s3_ops`` is
deliberately codec-independent — compression changes bytes, never op
counts.

All formulas are pure functions of (N, M, |θ|) so they are property-testable.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from repro_torch.config import AGG_COMPUTE_BPS, DEFAULT_LIMITS, LambdaLimits
from repro_torch.core.wire_codec import WireCodec, get_codec
from repro_torch.serverless.event_sim import ReadAheadWindow

MB = 1024 * 1024

#: codec knob type accepted by every codec-aware cost entry: a registered
#: name, a WireCodec instance, or None/"auto" (env REPRO_AGG_CODEC ->
#: "identity") — one resolution rule with the round driver's, so the
#: analytical model and the event sim always price the same wire format.
Codec = str | WireCodec | None


# ---------------------------------------------------------------------------
# Topology descriptions
# ---------------------------------------------------------------------------

def lambda_fl_branching(n_clients: int) -> int:
    """k = max(2, ceil(sqrt(N))) clients per leaf."""
    return max(2, math.ceil(math.sqrt(n_clients)))


def lifl_branching(n_clients: int) -> int:
    """b = max(2, ceil(N^{1/3})) — the single definition the simulator's
    tree shape and the analytical model both derive from (the inner round()
    guards against fp dust in the cube root, e.g. 27**(1/3) = 3.0000…04)."""
    return max(2, math.ceil(round(n_clients ** (1 / 3), 9)))


def lifl_levels(n_clients: int) -> tuple[int, int]:
    """(L1, L2) aggregator counts for the 3-level tree."""
    b = lifl_branching(n_clients)
    l1 = math.ceil(n_clients / b)
    l2 = math.ceil(l1 / b)
    return l1, l2


def tree_groups(count: int, branch: int) -> list[list[int]]:
    """Contiguous index groups of size ``branch`` (last may be short) —
    the one grouping rule every tree topology and cost formula shares."""
    return [list(range(g * branch, min((g + 1) * branch, count)))
            for g in range(math.ceil(count / branch))]


@dataclass(frozen=True)
class S3Ops:
    puts: int
    gets_agg: int
    gets_clients: int

    @property
    def gets(self) -> int:
        return self.gets_agg + self.gets_clients

    @property
    def total(self) -> int:
        return self.puts + self.gets


def _registered(topology: str):
    """Cost-entry fallback: resolve a non-builtin topology from the
    strategy registry (lazy import — cost_model must stay importable
    without the topology layer)."""
    from repro_torch.core.topology import get_topology
    return get_topology(topology)


def _call_cost_hook(topo, hook_name: str, *args, **kwargs):
    """Invoke a topology cost hook under the v2 protocol.

    v2 (``Topology.cost_api_version == 2``) hooks take everything after
    ``limits`` keyword-only with a required ``codec=`` — the cost model
    always passes it, so a compressing codec can never be silently priced
    at raw wire bytes (the v1 signature-sniffing failure mode). A plugin
    declaring an older version, or whose hook signature rejects the v2
    keywords, gets a pointed migration error under *every* codec rather
    than working by accident under ``identity``."""
    version = getattr(topo, "cost_api_version", 1)
    if version < 2:
        raise TypeError(
            f"topology {topo.name!r} declares cost_api_version={version}; "
            f"the cost model speaks v2: {hook_name}(grad_bytes, n, m, "
            f"limits, *, ..., codec) with keyword-only codec=. Update the "
            f"plugin's cost hooks (see repro_torch.core.topology.Topology)")
    hook = getattr(topo, hook_name)
    try:
        return hook(*args, **kwargs)
    except TypeError as exc:
        msg = str(exc)
        if "codec" in msg or "keyword" in msg or "argument" in msg:
            raise TypeError(
                f"{type(topo).__name__}.{hook_name} does not match the v2 "
                f"cost-hook protocol ({hook_name}(grad_bytes, n, m, limits, "
                f"*, ..., codec) — everything after limits keyword-only, "
                f"codec= required); update the plugin signature. "
                f"Original error: {msg}") from None
        raise


def s3_ops(topology: str, n: int, m: int = 1) -> S3Ops:
    """Per-round S3 operations (paper Table II; registry topologies via
    their ``cost_s3_ops`` hook)."""
    if topology == "gradssharding":
        return S3Ops(puts=n * m + m, gets_agg=n * m, gets_clients=n * m)
    if topology == "lambda_fl":
        k = lambda_fl_branching(n)
        leaves = math.ceil(n / k)
        return S3Ops(puts=n + leaves + 1, gets_agg=n + leaves, gets_clients=n)
    if topology == "lifl":
        l1, l2 = lifl_levels(n)
        return S3Ops(puts=n + l1 + l2 + 1, gets_agg=n + l1 + l2,
                     gets_clients=n)
    return _registered(topology).cost_s3_ops(n, m)


def n_aggregators(topology: str, n: int, m: int = 1) -> int:
    if topology == "gradssharding":
        return m
    if topology == "lambda_fl":
        return math.ceil(n / lambda_fl_branching(n)) + 1
    if topology == "lifl":
        l1, l2 = lifl_levels(n)
        return l1 + l2 + 1
    return _registered(topology).cost_n_aggregators(n, m)


def n_phases(topology: str) -> int:
    """Sequential aggregation phases (dependency depth)."""
    builtin = {"gradssharding": 1, "lambda_fl": 2, "lifl": 3}
    if topology in builtin:
        return builtin[topology]
    return _registered(topology).cost_n_phases()


# ---------------------------------------------------------------------------
# Memory
# ---------------------------------------------------------------------------

def input_bytes(topology: str, grad_bytes: int, m: int = 1) -> int:
    """Bytes of a single incoming object at an aggregator."""
    if topology == "gradssharding":
        return math.ceil(grad_bytes / m)
    if topology in ("lambda_fl", "lifl"):
        return grad_bytes
    return _registered(topology).cost_input_bytes(grad_bytes, m)


def streaming_memory_bytes(topology: str, grad_bytes: int, m: int = 1,
                           readahead_k: int = 1) -> int:
    """Streaming-fold buffers: running sum + the bounded prefetch window
    (``readahead_k`` incoming contributions; the legacy two-buffer bound
    at k=1)."""
    return (1 + max(1, int(readahead_k))) \
        * input_bytes(topology, grad_bytes, m)


def collect_fanin(topology: str, n: int, m: int = 1) -> int:
    """Widest aggregator fan-in. Every topology — builtin or plugin — is
    a registered strategy, so this is one unconditional dispatch to its
    ``cost_collect_fanin`` hook (no more falling through to a wrong
    builtin branch for registry topologies)."""
    return _registered(topology).cost_collect_fanin(n, m)


def collect_memory_bytes(topology: str, grad_bytes: int, n: int,
                         m: int = 1, readahead_k: int | None = None) -> int:
    """Per-aggregator buffered bytes (RQ2 Part A): all fan-in
    contributions + the result (collect-then-average), or — given
    ``readahead_k`` — the bounded prefetch bound ``(min(k, fanin) + 1)``
    buffers, which interpolates from the 2-buffer streaming bound (k=1)
    up to full collect. Dispatches to the topology's
    ``cost_memory_bytes`` hook (the clamp lives there, once)."""
    return _registered(topology).cost_memory_bytes(
        grad_bytes, n, m, readahead_k)


def readahead_alloc_mult(readahead_k: int, fanin: int | None,
                         limits: LambdaLimits) -> float:
    """Billed-allocation input multiplier: the empirical 3× formula, or
    ``k + 1`` prefetch buffers once the read-ahead window outgrows it —
    with ``k`` clamped to the fold's fan-in (the window never buffers
    more; ``fanin=None`` skips the clamp for fan-in-agnostic callers).
    The single definition behind the driver's ``_alloc_mb`` and the
    analytical model's per-fold billing — edit here, parity holds
    everywhere."""
    k = int(readahead_k)
    if fanin is not None:
        k = min(k, int(fanin))
    return max(limits.mem_multiplier, k + 1)


def wire_alloc_bytes(in_bytes: int, limits: LambdaLimits,
                     readahead_k: int = 1, fanin: int | None = None,
                     wire_in_bytes: int | None = None,
                     weighted: bool = False) -> float:
    """Billed aggregator allocation in bytes (above runtime overhead).

    Identity-size wire (``wire_in_bytes`` None or >= ``in_bytes``): the
    legacy :func:`readahead_alloc_mult` formula, unchanged bit-for-bit.
    Compressed wire: the prefetch window buffers *encoded* payloads and
    only the fold frontier is decoded, so the bound is ``accumulator +
    decode target + (k-1) buffered wire payloads`` — ``2·input`` for the
    f32 running sum of an unweighted fold, ``3·input`` for the f64
    accumulator of a weighted (tree-merge) fold — and a 4× smaller wire
    format genuinely raises the feasibility ceiling. One definition
    behind the driver's ``_alloc_mb`` and the analytical model's per-fold
    billing (and :func:`lambda_memory_mb` / :func:`feasible`)."""
    if wire_in_bytes is None or wire_in_bytes >= in_bytes:
        return readahead_alloc_mult(readahead_k, fanin, limits) * in_bytes
    k = int(readahead_k)
    if fanin is not None:
        k = min(k, int(fanin))
    acc_buffers = 2.0 if weighted else 1.0    # f64 running sum when weighted
    return (acc_buffers + 1.0) * in_bytes + (k - 1) * int(wire_in_bytes)


def wire_alloc_mb(in_bytes: int, limits: LambdaLimits,
                  readahead_k: int = 1, fanin: int | None = None,
                  wire_in_bytes: int | None = None,
                  weighted: bool = False) -> float:
    """Allocatable Lambda size for one aggregator fold — the billing entry
    both the round driver and :func:`pipelined_round_cost` call, so sim ==
    model billing parity holds per codec by construction."""
    return allocatable_memory_mb(
        wire_alloc_bytes(in_bytes, limits, readahead_k, fanin,
                         wire_in_bytes, weighted) / MB
        + limits.runtime_overhead_mb,
        limits)


def lambda_memory_mb(topology: str, grad_bytes: int, m: int = 1,
                     limits: LambdaLimits = LambdaLimits(),
                     readahead_k: int = 1, codec: Codec = None) -> float:
    """Empirical deployment formula: 3 × input_size + 450 MB (paper RQ3).
    A ``readahead_k`` prefetch window needs ``k + 1`` input buffers, so
    the multiplier grows once k outruns the builtin formula's headroom;
    a compressed wire ``codec`` shrinks the prefetch buffers (and the
    GET transient) to wire size — see :func:`wire_alloc_bytes`, with the
    topology's ``cost_wire_weighted`` hook adding the f64-accumulator
    buffer where the encoded-input folds carry weights (LIFL), so the
    model never green-lights a config the event sim OOMs on. Callers
    bill per aggregator and clamp ``readahead_k`` to that fold's fan-in
    first (the window never buffers more)."""
    in_b = input_bytes(topology, grad_bytes, m)
    wire_b = get_codec(codec).wire_bytes(in_b)
    weighted = _registered(topology).cost_wire_weighted()
    return (wire_alloc_bytes(in_b, limits, readahead_k, None, wire_b,
                             weighted) / MB
            + limits.runtime_overhead_mb)


def allocatable_memory_mb(required_mb: float,
                          limits: LambdaLimits = LambdaLimits()) -> float:
    """Round the requirement up to an allocatable Lambda size (1 MB steps,
    clamped to [min, max])."""
    return float(min(limits.max_memory_mb,
                     max(limits.min_memory_mb, math.ceil(required_mb))))


def feasible(topology: str, grad_bytes: int, m: int = 1,
             limits: LambdaLimits = LambdaLimits(),
             readahead_k: int = 1, codec: Codec = None) -> bool:
    """True when the aggregator allocation fits the platform ceiling.
    ``readahead_k`` (pre-clamped to the fan-in by callers) matters: a
    config whose 3× formula fits can still OOM once the prefetch window
    needs ``(k+1)`` input buffers. A compressed wire ``codec`` moves the
    ceiling the other way — with ``qsgd8``'s ~4× smaller payloads the
    bound shrinks to ``2·input + (k-1)·wire`` (``3·input + (k-1)·wire``
    where the encoded-input folds are weighted, i.e. LIFL — see
    :func:`wire_alloc_bytes`), so gradients past the paper's 10 GB wall
    become feasible without resharding."""
    return lambda_memory_mb(topology, grad_bytes, m, limits,
                            readahead_k=readahead_k, codec=codec) \
        <= limits.max_memory_mb


def max_feasible_grad_mb(limits: LambdaLimits = LambdaLimits()) -> float:
    """The paper's ~3,263 MB wall for full-gradient architectures."""
    return (limits.max_memory_mb - limits.runtime_overhead_mb) \
        / limits.mem_multiplier


def min_shards_for(grad_bytes: int,
                   limits: LambdaLimits = LambdaLimits()) -> int:
    """Smallest M that makes GradsSharding feasible (paper: always exists)."""
    m = 1
    while not feasible("gradssharding", grad_bytes, m, limits):
        m *= 2
        if m > 2 ** 20:
            raise RuntimeError("unreachable: sharding always fits eventually")
    return m


# ---------------------------------------------------------------------------
# Time + dollar cost
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PhaseTiming:
    read_s: float
    compute_s: float
    write_s: float

    @property
    def total_s(self) -> float:
        return self.read_s + self.compute_s + self.write_s


# Effective aggregation arithmetic throughput on a Lambda vCPU: see
# AGG_COMPUTE_BPS in repro_torch.config (imported above; it lives there so the
# serverless runtime can use it without initializing the repro_torch.core package).


def aggregator_timing(in_bytes: int, n_contrib: int, out_bytes: int,
                      limits: LambdaLimits = LambdaLimits(),
                      wire_in_bytes: int | None = None,
                      decode_s: float = 0.0) -> PhaseTiming:
    """Single-aggregator phase timing. ``wire_in_bytes`` (default: the
    raw ``in_bytes``) is what each GET actually transfers when a wire
    codec compresses the contributions; ``decode_s`` is the codec's
    per-contribution decode cost, charged as compute. With the defaults
    this is the pre-codec formula, unchanged."""
    wire = in_bytes if wire_in_bytes is None else wire_in_bytes
    read = n_contrib * (wire / (limits.s3_read_mbps * 1e6)
                        + limits.s3_get_latency_s)
    compute = n_contrib * (in_bytes / AGG_COMPUTE_BPS + decode_s)
    write = out_bytes / (limits.s3_write_mbps * 1e6)
    return PhaseTiming(read, compute, write)


@dataclass(frozen=True)
class RoundCost:
    topology: str
    n: int
    m: int
    grad_bytes: int
    wall_clock_s: float
    lambda_gb_s: float
    lambda_cost: float
    s3_cost: float
    ops: S3Ops
    memory_mb: float
    n_invocations: int
    feasible: bool
    phase_timings: tuple = field(default_factory=tuple)

    @property
    def total_cost(self) -> float:
        return self.lambda_cost + self.s3_cost

    @property
    def cost_per_1k(self) -> float:
        return 1000.0 * self.total_cost


# ---------------------------------------------------------------------------
# Client upload/readback model (pipelined schedule)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class UploadModel:
    """Per-client network + local-compute model for round scheduling.

    ``mbps``/``download_mbps`` are per-client stream bandwidths; ``None``
    models instantaneous transfer (the legacy assumption — with it and zero
    jitter, the pipelined schedule degenerates to the barrier schedule
    exactly). ``jitter_s`` draws each client's upload start offset uniformly
    from [0, jitter_s); ``rate_jitter`` multiplies each client's transfer
    durations by a factor uniform in [1, 1 + rate_jitter). ``compute_s``
    models per-client *local training time* between becoming ready (round
    r's read-back done) and starting round r+1's upload, jittered
    uniformly into [compute_s, compute_s + compute_jitter) — in pipelined
    multi-round sessions a fast client therefore trains while stragglers
    still read back. Draws are deterministic in (seed, round), so the
    analytical model and the discrete-event runtime see identical
    per-client plans.
    """

    mbps: float | None = None
    download_mbps: float | None = None
    jitter_s: float = 0.0
    rate_jitter: float = 0.0
    compute_s: float = 0.0
    compute_jitter: float = 0.0
    seed: int = 0

    def plan(self, n: int, rnd: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """(start_offsets[n], rate_multipliers[n]) for one round."""
        rng = np.random.default_rng([self.seed, rnd])
        starts = rng.uniform(0.0, self.jitter_s, n) if self.jitter_s > 0 \
            else np.zeros(n)
        mults = 1.0 + rng.uniform(0.0, self.rate_jitter, n) \
            if self.rate_jitter > 0 else np.ones(n)
        return starts, mults

    def compute_plan(self, n: int, rnd: int = 0) -> np.ndarray:
        """Per-client local-compute durations for one round (a separate
        stream from :meth:`plan`, so adding compute never perturbs the
        established upload draws)."""
        if self.compute_s <= 0.0 and self.compute_jitter <= 0.0:
            return np.zeros(n)
        rng = np.random.default_rng([self.seed, rnd, 1])
        if self.compute_jitter > 0.0:
            return self.compute_s + rng.uniform(0.0, self.compute_jitter, n)
        return np.full(n, float(self.compute_s))

    def plan_at(self, n: int, rnd: int, idx) -> tuple[np.ndarray, np.ndarray]:
        """:meth:`plan` restricted to cohort indices ``idx`` — the lazy
        population engine's entry: O(len(idx)) draws instead of O(n),
        bit-identical to ``plan(n, rnd)`` sliced at ``idx`` (PCG64
        ``advance`` jumps the gaps; see
        :mod:`repro_torch.serverless.streams`)."""
        from repro_torch.serverless.streams import gather_stream
        idx = np.asarray(idx)
        key = [self.seed, rnd]
        if self.jitter_s > 0:
            starts = gather_stream(
                key, idx, lambda r, m: r.uniform(0.0, self.jitter_s, m))
        else:
            starts = np.zeros(len(idx))
        if self.rate_jitter > 0:
            # mults continue the same stream after the n start draws
            mults = 1.0 + gather_stream(
                key, idx, lambda r, m: r.uniform(0.0, self.rate_jitter, m),
                skip=n if self.jitter_s > 0 else 0)
        else:
            mults = np.ones(len(idx))
        return starts, mults

    def compute_plan_at(self, n: int, rnd: int, idx) -> np.ndarray:
        """:meth:`compute_plan` restricted to cohort indices ``idx``."""
        from repro_torch.serverless.streams import gather_stream
        idx = np.asarray(idx)
        if self.compute_s <= 0.0 and self.compute_jitter <= 0.0:
            return np.zeros(len(idx))
        if self.compute_jitter > 0.0:
            return self.compute_s + gather_stream(
                [self.seed, rnd, 1], idx,
                lambda r, m: r.uniform(0.0, self.compute_jitter, m))
        return np.full(len(idx), float(self.compute_s))

    def upload_s(self, nbytes: int, mult: float = 1.0) -> float:
        if self.mbps is None:
            return 0.0
        return nbytes / (self.mbps * 1e6) * mult

    def download_s(self, nbytes: int, mult: float = 1.0) -> float:
        if self.download_mbps is None:
            return 0.0
        return nbytes / (self.download_mbps * 1e6) * mult


def uniform_shard_bytes(grad_bytes: int, m: int, itemsize: int = 4
                        ) -> list[int]:
    """Byte sizes of the paper's uniform element split (matches
    ``sharding.plan_uniform``: first ``rem`` shards get one extra element)."""
    elems = grad_bytes // itemsize
    base, rem = divmod(elems, m)
    return [(base + (1 if j < rem else 0)) * itemsize for j in range(m)]


def sharded_wire_upload_bytes(grad_bytes: int, m: int = 1,
                              codec: Codec = None,
                              shard_bytes: Sequence[int] | None = None
                              ) -> int:
    """Total wire bytes of one client's M independently encoded shards —
    the shared ``cost_client_upload_bytes`` body of every topology whose
    clients upload the N·M shard keyspace (each shard pays its own codec
    framing: per-tile scales, sparse budgets), exactly like the
    simulator's per-shard PUTs."""
    c = get_codec(codec)
    sb = shard_bytes if shard_bytes is not None \
        else uniform_shard_bytes(grad_bytes, m)
    return sum(c.wire_bytes(b) for b in sb)


def client_upload_bytes(topology: str, grad_bytes: int, m: int = 1,
                        codec: Codec = None,
                        shard_bytes: Sequence[int] | None = None) -> int:
    """Total bytes one client PUTs per round, on the wire.

    Dispatches to the topology's ``cost_client_upload_bytes`` hook: the
    whole-gradient topologies upload one encoded gradient, the sharded
    topologies upload M independently encoded shards (each shard pays its
    own codec framing — per-tile scales, sparse budgets — exactly like
    the simulator's per-shard PUTs)."""
    return _registered(topology).cost_client_upload_bytes(
        grad_bytes, m, codec=codec, shard_bytes=shard_bytes)


def _fold_finish(launch_s: float, avail_s: Sequence[float],
                 in_bytes: Sequence[int], out_bytes: int,
                 limits: LambdaLimits, cold: bool,
                 readahead_k: int = 1,
                 wire_bytes: Sequence[int] | None = None,
                 decode_s: float = 0.0) -> float:
    """Finish time of one streaming prefix fold with a bounded read-ahead
    window: launch (+cold start), then drive the same deterministic
    :class:`ReadAheadWindow` schedule the simulated aggregator body runs —
    GET the next window contribution (stalling only when none has landed;
    transfers move ``wire_bytes``, the codec-encoded size), decode at the
    fold frontier (``decode_s`` per contribution), fold strictly in index
    order (accumulate compute from the 2nd contribution on, over the
    *decoded* ``in_bytes``) — then finalize + write. ``readahead_k=1``
    with an identity-size wire replays the legacy op sequence exactly."""
    t = launch_s + (limits.cold_start_s if cold else 0.0)
    wire = in_bytes if wire_bytes is None else wire_bytes
    win = ReadAheadWindow(avail_s, readahead_k)
    while not win.done:
        if win.foldable:
            t += decode_s
            if win.frontier:
                t += in_bytes[win.frontier] / AGG_COMPUTE_BPS
            win.folded()
            continue
        j = win.next_fetch(t)
        if win.avail[j] > t:
            t = win.avail[j]                        # stall for availability
        t += limits.s3_get_latency_s + wire[j] / (limits.s3_read_mbps
                                                  * 1e6)
        win.fetched(j)
    t += out_bytes / AGG_COMPUTE_BPS
    t += out_bytes / (limits.s3_write_mbps * 1e6)
    return t


def expected_fold_finish_s(launch_s: float, avail_s: Sequence[float],
                           in_bytes: Sequence[int], out_bytes: int,
                           limits: LambdaLimits, cold: bool = True,
                           readahead_k: int = 1,
                           wire_bytes: Sequence[int] | None = None,
                           decode_s: float = 0.0) -> float:
    """Public entry to the window-driven fold-finish model: the expected
    fault-free completion time of one store-reading aggregator given its
    launch, input availability frontier and read-ahead window — exactly
    the arithmetic behind :func:`pipelined_round_cost`'s event-sim
    parity. The round driver's speculative hedging replays it per
    invocation to decide whether the primary's actual finish (retries,
    backoff, cold restarts) lags far enough to launch a hedge replica."""
    return _fold_finish(launch_s, avail_s, in_bytes, out_bytes, limits,
                        cold, readahead_k=readahead_k,
                        wire_bytes=wire_bytes, decode_s=decode_s)


def _fold_finish_colocated(launch_s: float, avail_s: Sequence[float],
                           in_bytes: Sequence[int], out_bytes: int,
                           limits: LambdaLimits, cold: bool,
                           write_out: bool) -> float:
    """Finish time of a streaming fold over *node-local shared-memory*
    inputs (LIFL's colocated fast path): no per-GET latency, no read
    transfer — only availability stalls and accumulate compute. Only the
    global result (``write_out``) pays an S3 write."""
    t = launch_s + (limits.cold_start_s if cold else 0.0)
    for idx, (a, nb) in enumerate(zip(avail_s, in_bytes)):
        if a > t:
            t = a                                   # stall for availability
        if idx:
            t += nb / AGG_COMPUTE_BPS
    t += out_bytes / AGG_COMPUTE_BPS
    if write_out:
        t += out_bytes / (limits.s3_write_mbps * 1e6)
    return t


_tree_groups = tree_groups


def _resolve_readahead(readahead_k: int | None) -> int:
    """Shared knob resolution (``None``/"auto" -> ``REPRO_AGG_READAHEAD``
    env, else 1) — one definition with the round driver's."""
    from repro_torch.core.topology import get_readahead
    return get_readahead(readahead_k)


def _make_run_fold(limits: LambdaLimits, cold: bool, ra: int,
                   finishes: list, gb_s_parts: list, mem_mbs: list):
    """The pipelined per-fold timing/billing closure, shared verbatim by
    :func:`pipelined_round_cost` and the quorum/deadline walls so every
    schedule prices one fold with identical arithmetic."""

    def run_fold(avail, in_b, out_b, shared=False, write_out=True,
                 wire_b=None, decode_s=0.0, weighted=False,
                 limits_override=None):
        # billed allocation mirrors the driver's _alloc_mb: the window
        # never buffers more than the fold's fan-in, and colocated hops
        # (nothing to prefetch) keep the 3x formula and legacy gating;
        # wire_b/decode_s mark a fold over codec-encoded contributions
        # (the client->aggregator hop; inter-aggregator hops stay raw)
        # and weighted marks its f64 accumulator for the billing bound.
        # limits_override substitutes per-tier link bandwidths (geo
        # topologies) — rate fields only, so the memory formula (billed
        # MB) intentionally still uses the platform limits
        eff = limits if limits_override is None else limits_override
        if shared:
            launch = avail[0]
            end = _fold_finish_colocated(launch, avail, in_b, out_b, eff,
                                         cold, write_out)
        else:
            launch = ReadAheadWindow.launch_s(avail, ra)
            end = _fold_finish(launch, avail, in_b, out_b, eff, cold,
                               readahead_k=ra, wire_bytes=wire_b,
                               decode_s=decode_s)
        mem = wire_alloc_mb(in_b[0], limits, 1 if shared else ra,
                            len(avail),
                            wire_b[0] if wire_b is not None else None,
                            weighted)
        finishes.append(end)
        mem_mbs.append(mem)
        gb_s_parts.append(mem / 1024.0 * (end - launch))
        return end

    return run_fold


def _pipelined_fold_plan(topology: str, grad_bytes: int, n: int, m: int,
                         limits: LambdaLimits, upload: "UploadModel",
                         starts, mults, run_fold,
                         shard_bytes: Sequence[int] | None,
                         colocated: bool, cdc: WireCodec) -> None:
    """Drive ``run_fold`` through one topology's pipelined fold DAG.

    ``starts``/``mults`` are *position-indexed* over the ``n`` folded
    clients — the full cohort for :func:`pipelined_round_cost`, or the
    post-cut survivors (in fold order) for the quorum/deadline walls,
    which is exactly how the round driver rebuilds its program over the
    kept membership."""
    if topology == "gradssharding":
        sb = list(shard_bytes) if shard_bytes is not None \
            else uniform_shard_bytes(grad_bytes, m)
        wsb = [cdc.wire_bytes(b) for b in sb]
        cum = np.cumsum(wsb)
        # client i publishes shard j at start_i + sequential-PUT prefix
        # time — over the *wire* sizes, exactly like the PUT schedule
        avail = [[starts[i] + upload.upload_s(int(cum[j]), mults[i])
                  for i in range(n)] for j in range(m)]
        for j in range(m):
            run_fold(avail[j], [sb[j]] * n, sb[j], wire_b=[wsb[j]] * n,
                     decode_s=cdc.decode_cost_s(sb[j]))
    elif topology == "lambda_fl":
        k = lambda_fl_branching(n)
        wire_g = cdc.wire_bytes(grad_bytes)
        grad_avail = [starts[i] + upload.upload_s(wire_g, mults[i])
                      for i in range(n)]
        leaf_ends = []
        for members in _tree_groups(n, k):
            avail = [grad_avail[i] for i in members]
            leaf_ends.append(run_fold(avail, [grad_bytes] * len(members),
                                      grad_bytes,
                                      wire_b=[wire_g] * len(members),
                                      decode_s=cdc.decode_cost_s(
                                          grad_bytes)))
        run_fold(leaf_ends, [grad_bytes] * len(leaf_ends), grad_bytes)
    elif topology == "lifl":
        b = lifl_branching(n)
        wire_g = cdc.wire_bytes(grad_bytes)
        grad_avail = [starts[i] + upload.upload_s(wire_g, mults[i])
                      for i in range(n)]
        level_in = grad_avail
        for _level in (1, 2):
            ends = []
            for members in _tree_groups(len(level_in), b):
                avail = [level_in[i] for i in members]
                # LIFL folds are weight-carrying at every level (group
                # sizes merge), so the level-1 encoded fold bills the
                # f64-accumulator bound
                kw = {"wire_b": [wire_g] * len(members),
                      "decode_s": cdc.decode_cost_s(grad_bytes),
                      "weighted": True} \
                    if _level == 1 else {}
                ends.append(run_fold(avail, [grad_bytes] * len(members),
                                     grad_bytes,
                                     shared=colocated and _level == 2,
                                     write_out=False, **kw))
            level_in = ends
        run_fold(level_in, [grad_bytes] * len(level_in),
                 grad_bytes, shared=colocated)
    else:
        # registry topologies: the topology declares its pipelined fold
        # DAG through the cost_pipelined_plan hook; run_fold owns launch
        # gating (read-ahead window), stalls, timing and billing
        _call_cost_hook(_registered(topology), "cost_pipelined_plan",
                        grad_bytes, n, m, limits, upload=upload,
                        starts=starts, mults=mults, run_fold=run_fold,
                        shard_bytes=shard_bytes, codec=cdc)


def pipelined_round_cost(topology: str, grad_bytes: int, n: int, m: int = 1,
                         limits: LambdaLimits = LambdaLimits(),
                         upload: UploadModel | None = None,
                         rnd: int = 0, cold: bool = True,
                         shard_bytes: Sequence[int] | None = None,
                         colocated: bool = False,
                         readahead_k: int | None = None,
                         codec: Codec = None) -> RoundCost:
    """Modeled round under the **pipelined** schedule.

    Clients locally train, then upload with per-client jitter
    (``upload``); each aggregator launches when the first contribution in
    its ``readahead_k`` window lands and stream-folds in strict index
    order while prefetching up to ``k`` contributions ahead of the fold
    frontier (:class:`ReadAheadWindow` — ``k=1``, the default, is the
    legacy in-index-order schedule); tree levels chain the same way.
    ``wall_clock_s`` is the makespan from round start to the last
    aggregator's output write — reads hide under uploads, which is where
    the win over :func:`round_cost`'s phase barriers comes from. Stall
    time is billed (the function runs while it waits), and the billed
    allocation grows with the prefetch buffer (``(k+1)``·input once k
    outruns the 3× formula). ``colocated`` (LIFL only) models the
    shared-memory fast path: level ≥2 hops have zero transfer time (and,
    having nothing to prefetch, keep first-input launch gating and the
    3× allocation). Registry topologies dispatch through their
    ``cost_pipelined_plan`` hook. The 1 ms billing granularity is
    ignored here (<0.1 % on round-scale durations); the discrete-event
    runtime reproduces ``wall_clock_s`` exactly for a no-fault round.

    ``codec`` (name / instance / None → env ``REPRO_AGG_CODEC``) applies
    the wire format to the client→aggregator hop: uploads and level-1
    GETs move ``codec.wire_bytes``, level-1 folds pay ``decode_cost_s``
    per contribution, and the level-1 billed allocation buffers encoded
    payloads — all through the same :class:`ReadAheadWindow` /
    :func:`wire_alloc_mb` definitions the event sim runs, so parity to
    float epsilon holds per codec (smaller GETs legitimately shift
    window launch and fetch times; both sides shift identically).
    """
    if colocated and topology != "lifl":
        raise ValueError("colocated is the LIFL shared-memory fast path")
    ra = _resolve_readahead(readahead_k)
    cdc = get_codec(codec)
    upload = upload or UploadModel()
    starts, mults = upload.plan(n, rnd)
    starts = starts + upload.compute_plan(n, rnd)   # train, then upload
    ops = s3_ops(topology, n, m) if not colocated else None
    # feasibility must see the readahead buffers: the simulated runtime
    # OOMs mid-round on a config the 3x formula alone would green-light
    ok = feasible(topology, grad_bytes, m, limits,
                  readahead_k=min(ra, collect_fanin(topology, n, m)),
                  codec=cdc)

    finishes: list[float] = []
    gb_s_parts: list[float] = []         # per-aggregator billed GB-s
    mem_mbs: list[float] = []
    run_fold = _make_run_fold(limits, cold, ra, finishes, gb_s_parts,
                              mem_mbs)
    _pipelined_fold_plan(topology, grad_bytes, n, m, limits, upload,
                         starts, mults, run_fold, shard_bytes, colocated,
                         cdc)
    if ops is None:
        l1, l2 = lifl_levels(n)
        # colocated: N client PUTs + l1 level-1 partials + the global; GETs
        # only at level 1 (clients' grads) and the clients' read-back
        ops = S3Ops(puts=n + l1 + 1, gets_agg=n, gets_clients=n)

    wall = max(finishes)
    gb_s = sum(gb_s_parts)
    lam_cost = gb_s * limits.gb_s_price
    s3_cost = ops.puts * limits.s3_put_price + ops.gets * limits.s3_get_price
    return RoundCost(topology, n, m, grad_bytes, wall, gb_s, lam_cost,
                     s3_cost, ops, max(mem_mbs), len(mem_mbs), ok, ())


def _scheduled_round_cost(topology: str, grad_bytes: int, n: int, m: int,
                          limits: LambdaLimits, upload: "UploadModel | None",
                          rnd: int, cold: bool,
                          shard_bytes: Sequence[int] | None,
                          colocated: bool, readahead_k: int | None,
                          codec: Codec, *, sched: str,
                          quorum: int | None, deadline_s: float | None,
                          faults=None,
                          participation_k: int | None = None) -> RoundCost:
    """Shared core of :func:`quorum_round_cost` / :func:`deadline_round_cost`.

    Replays the round driver's membership pipeline analytically —
    participation sampling, seeded dropout, stalls, then the
    deadline/quorum cut on the *probed* arrival times — and prices the
    surviving fold with the pipelined arithmetic over the kept members.
    The cut uses the driver's exact per-key sequential upload sums (not
    the cumsum shortcut), so a client at the boundary lands on the same
    side in model and sim; the fold availabilities then reuse the
    existing per-topology plans, which the event sim matches to float
    epsilon. Deadline semantics clamp the wall to the deadline whenever
    a straggler was cut (a cut round is only known complete at T);
    quorum-without-deadline never clamps. The degenerate
    ``quorum > post-deadline arrivals`` raises the same ``ValueError``
    as the driver. Read-back and S3 op counts cover the delivered
    membership (the model's per-round scope)."""
    from repro_torch.serverless.event_sim import arrival_order
    from repro_torch.serverless.faults import FaultModel
    if colocated and topology != "lifl":
        raise ValueError("colocated is the LIFL shared-memory fast path")
    ra = _resolve_readahead(readahead_k)
    cdc = get_codec(codec)
    upload = upload or UploadModel()
    starts, mults = upload.plan(n, rnd)
    starts = starts + upload.compute_plan(n, rnd)   # train, then upload

    # -- membership: participation sampling, dropout, stalls (driver replay)
    if participation_k is not None and participation_k < n:
        participants = list((faults or FaultModel())
                            .participants(n, rnd, participation_k))
    else:
        participants = list(range(n))
    order = participants
    stall = None
    if faults is not None:
        drop = faults.dropout_plan(n, rnd)
        order = [i for i in participants if not drop[i]]
        st = faults.stall_plan(n, rnd)
        if st.any():
            stall = st
    if not order:
        raise RuntimeError(f"round {rnd}: no active participants")

    # -- probed arrival times: the driver's exact sequential per-key sums
    if topology in ("gradssharding", "sharded_tree"):
        sb_cut = list(shard_bytes) if shard_bytes is not None \
            else uniform_shard_bytes(grad_bytes, m)
        key_sizes = [cdc.wire_bytes(b) for b in sb_cut]
    else:
        # single-PUT cohorts (lambda_fl / lifl / registry default): the
        # whole wire payload lands as one key
        key_sizes = [client_upload_bytes(topology, grad_bytes, m,
                                         codec=cdc,
                                         shard_bytes=shard_bytes)]
    starts_eff = {}
    ends = []
    for i in order:
        t = float(starts[i])
        if stall is not None and stall[i]:
            t += float(stall[i])
        starts_eff[i] = t
        for nb in key_sizes:
            t += upload.upload_s(nb, float(mults[i]))
        ends.append(t)

    # -- deadline / quorum cut (deadline first, quorum within survivors)
    if sched == "quorum" and quorum is not None and deadline_s is not None:
        survivors = arrival_order(ends, deadline_s=deadline_s)
        if len(survivors) < quorum:
            raise ValueError(
                f"round {rnd}: quorum={quorum} exceeds the "
                f"{len(survivors)} arrival(s) left by the deadline "
                f"({deadline_s:.3f} s); the deadline cuts first and "
                f"the quorum gates within its survivors — lower the "
                f"quorum or relax the deadline")
    keep = arrival_order(ends, quorum=quorum if sched == "quorum" else None,
                         deadline_s=deadline_s)
    if not keep:
        raise RuntimeError(
            f"round {rnd}: no client upload completed by the deadline "
            f"({deadline_s:.3f} s) — nothing to aggregate")
    if sched != "quorum":
        keep.sort()               # a deadline alone never reorders the fold
    kept = [order[pos] for pos in keep]
    kept_set = set(kept)
    late = [i for i in order if i not in kept_set]

    # -- fold over the kept membership, positional like the driver rebuild
    n_del = len(kept)
    starts_kept = np.asarray([starts_eff[i] for i in kept])
    mults_kept = np.asarray([float(mults[i]) for i in kept])
    ok = feasible(topology, grad_bytes, m, limits,
                  readahead_k=min(ra, collect_fanin(topology, n_del, m)),
                  codec=cdc)
    finishes: list[float] = []
    gb_s_parts: list[float] = []
    mem_mbs: list[float] = []
    run_fold = _make_run_fold(limits, cold, ra, finishes, gb_s_parts,
                              mem_mbs)
    _pipelined_fold_plan(topology, grad_bytes, n_del, m, limits, upload,
                         starts_kept, mults_kept, run_fold, shard_bytes,
                         colocated, cdc)
    if colocated:
        l1, _l2 = lifl_levels(n_del)
        ops = S3Ops(puts=n_del + l1 + 1, gets_agg=n_del,
                    gets_clients=n_del)
    else:
        ops = s3_ops(topology, n_del, m)

    wall = max(finishes)
    if late and deadline_s is not None:
        # a cut round is only known complete at the deadline itself
        wall = max(wall, float(deadline_s))
    gb_s = sum(gb_s_parts)
    lam_cost = gb_s * limits.gb_s_price
    s3_cost = ops.puts * limits.s3_put_price + ops.gets * limits.s3_get_price
    return RoundCost(topology, n, m, grad_bytes, wall, gb_s, lam_cost,
                     s3_cost, ops, max(mem_mbs), len(mem_mbs), ok, ())


def quorum_round_cost(topology: str, grad_bytes: int, n: int, m: int = 1,
                      limits: LambdaLimits = LambdaLimits(),
                      upload: UploadModel | None = None,
                      rnd: int = 0, cold: bool = True,
                      shard_bytes: Sequence[int] | None = None,
                      colocated: bool = False,
                      readahead_k: int | None = None,
                      codec: Codec = None, *,
                      quorum: int | None,
                      deadline_s: float | None = None,
                      faults=None,
                      participation_k: int | None = None) -> RoundCost:
    """Modeled round under the **quorum** schedule: the expected q-th
    arrival under the :class:`UploadModel` jitter gates the fold, which
    then runs pipelined over the first ``quorum`` arrivals *in arrival
    order* (FedBuff-style buffered cut). ``faults`` /
    ``participation_k`` replay the driver's seeded membership (dropout,
    stalls, participation sampling) so the analytic wall tracks the
    event sim to float epsilon for ``failure_rate=0`` configs — retries
    are priced separately (:func:`expected_retry_gb_s` et al.).
    ``quorum=None`` folds every arrival in arrival order (the env-auto
    full quorum). Combined with ``deadline_s``, the deadline cuts
    first and the quorum gates within its survivors; a quorum the
    post-deadline arrivals cannot satisfy raises ``ValueError`` exactly
    like the round driver."""
    return _scheduled_round_cost(topology, grad_bytes, n, m, limits,
                                 upload, rnd, cold, shard_bytes, colocated,
                                 readahead_k, codec, sched="quorum",
                                 quorum=quorum, deadline_s=deadline_s,
                                 faults=faults,
                                 participation_k=participation_k)


def deadline_round_cost(topology: str, grad_bytes: int, n: int, m: int = 1,
                        limits: LambdaLimits = LambdaLimits(),
                        upload: UploadModel | None = None,
                        rnd: int = 0, cold: bool = True,
                        shard_bytes: Sequence[int] | None = None,
                        colocated: bool = False,
                        readahead_k: int | None = None,
                        codec: Codec = None, *,
                        deadline_s: float,
                        faults=None,
                        participation_k: int | None = None) -> RoundCost:
    """Modeled **pipelined round with a hard deadline**: arrivals after
    ``deadline_s`` are cut, the fold runs pipelined over the survivors
    in index order, and — whenever a straggler was actually cut — the
    wall clamps to the deadline (the round is only known complete at
    T). Membership replay and sim parity as in
    :func:`quorum_round_cost`."""
    return _scheduled_round_cost(topology, grad_bytes, n, m, limits,
                                 upload, rnd, cold, shard_bytes, colocated,
                                 readahead_k, codec, sched="pipelined",
                                 quorum=None, deadline_s=float(deadline_s),
                                 faults=faults,
                                 participation_k=participation_k)


def expected_hedge_cost(memory_mb: float, fold_s: float,
                        failure_rate: float,
                        limits: LambdaLimits = LambdaLimits(),
                        n_aggregators: int = 1) -> float:
    """Expected extra billed GB-s from speculative hedging, per round.

    A hedge replica launches when the primary overruns its fault-free
    expected finish — under the seeded failure model that happens
    (to first order) whenever the primary's first attempt dies, i.e.
    with probability ``failure_rate`` per aggregator. The replica is a
    fresh (cold) container that runs the fold to completion even when it
    loses the race, so each launch bills
    ``memory_mb/1024 * (cold_start_s + fold_s)`` GB-s on top of the
    primary's own accounting (retries included — those are
    :func:`expected_retry_gb_s`)."""
    p = min(max(float(failure_rate), 0.0), 1.0)
    dur = limits.cold_start_s + float(fold_s)
    return n_aggregators * p * memory_mb / 1024.0 * dur


def barrier_round_cost(topology: str, grad_bytes: int, n: int, m: int = 1,
                       limits: LambdaLimits = LambdaLimits(),
                       upload: UploadModel | None = None,
                       rnd: int = 0, cold: bool = True,
                       codec: Codec = None) -> RoundCost:
    """:func:`round_cost` extended with the same upload model and cold-start
    accounting as :func:`pipelined_round_cost`, so the two are directly
    comparable: all uploads complete (a barrier), then each aggregation
    phase runs to its slowest member before the next starts. ``codec``
    shrinks the upload span (clients PUT :func:`client_upload_bytes` on
    the wire) and the first-level read/decode terms inside
    :func:`round_cost`."""
    cdc = get_codec(codec)
    upload = upload or UploadModel()
    starts, mults = upload.plan(n, rnd)
    starts = starts + upload.compute_plan(n, rnd)   # train, then upload
    base = round_cost(topology, grad_bytes, n, m, limits, codec=cdc)
    up_bytes = client_upload_bytes(topology, grad_bytes, m, codec=cdc)
    upload_span = max((starts[i] + upload.upload_s(up_bytes, mults[i])
                       for i in range(n)), default=0.0)
    cold_s = (limits.cold_start_s if cold else 0.0) * n_phases(topology)
    wall = upload_span + cold_s + base.wall_clock_s
    return RoundCost(topology, n, m, grad_bytes, wall, base.lambda_gb_s,
                     base.lambda_cost, base.s3_cost, base.ops,
                     base.memory_mb, base.n_invocations, base.feasible,
                     base.phase_timings)


def round_cost(topology: str, grad_bytes: int, n: int, m: int = 1,
               limits: LambdaLimits = LambdaLimits(),
               concurrent: bool = True,
               memory_mb_override: float | None = None,
               codec: Codec = None) -> RoundCost:
    """Full round-trip model: client uploads -> aggregation -> read-back.

    ``memory_mb_override`` reproduces deployments that fix the allocation
    (the paper's RQ2-B sweep uses 3,008 MB at every M, which is what shapes
    its cost hump at M=4). ``codec`` applies the wire format to the
    client→aggregator hop: first-level aggregators read
    ``codec.wire_bytes`` per GET and pay ``decode_cost_s`` per
    contribution; inter-aggregator partials stay raw f32 (``s3_ops`` is
    codec-independent — compression changes bytes, never op counts)."""
    cdc = get_codec(codec)
    ops = s3_ops(topology, n, m)
    mem_mb = memory_mb_override if memory_mb_override is not None else \
        allocatable_memory_mb(
            lambda_memory_mb(topology, grad_bytes, m, limits, codec=cdc),
            limits)
    ok = feasible(topology, grad_bytes, m, limits, codec=cdc)

    timings: list[PhaseTiming] = []
    if topology == "gradssharding":
        shard_b = input_bytes(topology, grad_bytes, m)
        t = aggregator_timing(shard_b, n, shard_b, limits,
                              wire_in_bytes=cdc.wire_bytes(shard_b),
                              decode_s=cdc.decode_cost_s(shard_b))
        timings = [t] * m
        wall = t.total_s if concurrent else t.total_s * m
        gb_s = m * mem_mb / 1024.0 * t.total_s
        n_inv = m
    elif topology == "lambda_fl":
        k = lambda_fl_branching(n)
        leaves = math.ceil(n / k)
        t_leaf = aggregator_timing(grad_bytes, k, grad_bytes, limits,
                                   wire_in_bytes=cdc.wire_bytes(grad_bytes),
                                   decode_s=cdc.decode_cost_s(grad_bytes))
        t_root = aggregator_timing(grad_bytes, leaves, grad_bytes, limits)
        timings = [t_leaf] * leaves + [t_root]
        wall = t_leaf.total_s + t_root.total_s          # 2 sequential phases
        gb_s = mem_mb / 1024.0 * (leaves * t_leaf.total_s + t_root.total_s)
        n_inv = leaves + 1
    elif topology == "lifl":
        l1, l2 = lifl_levels(n)
        # slowest member of a phase = the widest fold. Contiguous grouping
        # fills groups to the branching factor (last group takes the
        # remainder), so the max fan-in is min(b, members) — NOT the
        # average ceil(members/groups), which undershoots whenever the
        # remainder group is short (e.g. N=12: groups [3,1], avg 2)
        b = lifl_branching(n)
        b1 = min(b, n)
        b2 = min(b, l1)
        t1 = aggregator_timing(grad_bytes, b1, grad_bytes, limits,
                               wire_in_bytes=cdc.wire_bytes(grad_bytes),
                               decode_s=cdc.decode_cost_s(grad_bytes))
        t2 = aggregator_timing(grad_bytes, b2, grad_bytes, limits)
        t3 = aggregator_timing(grad_bytes, l2, grad_bytes, limits)
        timings = [t1] * l1 + [t2] * l2 + [t3]
        wall = t1.total_s + t2.total_s + t3.total_s     # 3 sequential phases
        gb_s = mem_mb / 1024.0 * (l1 * t1.total_s + l2 * t2.total_s
                                  + t3.total_s)
        n_inv = l1 + l2 + 1
    else:
        # registry topologies: sequential (timing, count) phase groups;
        # invocations within a phase run concurrently, phases add
        plan = _call_cost_hook(_registered(topology), "cost_phase_plan",
                               grad_bytes, n, m, limits, codec=cdc)
        timings, wall, gb_s, n_inv = [], 0.0, 0.0, 0
        for t, count in plan:
            timings.extend([t] * count)
            wall += t.total_s if concurrent else t.total_s * count
            gb_s += mem_mb / 1024.0 * count * t.total_s
            n_inv += count

    lam_cost = gb_s * limits.gb_s_price
    s3_cost = ops.puts * limits.s3_put_price + ops.gets * limits.s3_get_price
    return RoundCost(topology, n, m, grad_bytes, wall, gb_s, lam_cost,
                     s3_cost, ops, mem_mb, n_inv, ok, tuple(timings))


# ---------------------------------------------------------------------------
# Fault-tolerant round analytics
# ---------------------------------------------------------------------------
# Analytical counterparts of the seeded disturbance machinery
# (repro_torch.serverless.faults.FaultModel + LambdaRuntime.invoke_reliable):
# expected attempt counts, the expected wall-clock stretch a retrying
# phase pays, the extra GB-s billed by failed attempts, and the expected
# arrival count under partial participation + dropout. All take the
# *per-attempt* failure probability (FaultModel.failure_rate); a failed
# attempt dies before its body runs, billing half a cold start (the
# runtime's die-midway model), and its replacement always cold-starts
# because a crash evicts the family's warm container.


def expected_attempts(failure_rate: float, max_attempts: int = 3) -> float:
    """Expected invocation-attempt count of one ``invoke_reliable`` call:
    attempt ``k`` launches iff the first ``k`` attempts all failed, so
    ``E = sum_k p^k`` for ``k in range(max_attempts)`` (= 1.0 when
    fault-free)."""
    p = float(failure_rate)
    if not 0.0 <= p < 1.0:
        raise ValueError(f"failure_rate must be in [0, 1), got {p!r}")
    return sum(p ** k for k in range(int(max_attempts)))


def expected_retry_delay_s(failure_rate: float,
                           limits: LambdaLimits = DEFAULT_LIMITS,
                           backoff_s: float = 0.0,
                           max_attempts: int = 3) -> float:
    """Expected start-time stretch of one reliable invocation: the ``j``-th
    failure (probability ``p^j``) delays the winning attempt by the dead
    attempt's half-cold-start plus the exponential backoff wait
    ``backoff_s * 2^(j-1)``."""
    p = float(failure_rate)
    dead_s = 0.5 * limits.cold_start_s
    return sum(p ** j * (dead_s + backoff_s * 2.0 ** (j - 1))
               for j in range(1, int(max_attempts)))


def expected_retry_gb_s(memory_mb: float, failure_rate: float,
                        limits: LambdaLimits = DEFAULT_LIMITS,
                        max_attempts: int = 3) -> float:
    """Expected *extra* GB-s one reliable invocation bills for its failed
    attempts (each dies after half a cold start at the full allocation) —
    the retry term of the fault-tolerance cost overhead."""
    p = float(failure_rate)
    e_failures = sum(p ** j for j in range(1, int(max_attempts)))
    return memory_mb / 1024.0 * 0.5 * limits.cold_start_s * e_failures


def expected_deliveries(n: int, participation_k: int | None = None,
                        dropout_rate: float = 0.0) -> float:
    """Expected number of client contributions that reach the fold under
    per-round sampling (``participation_k`` of ``n``) and independent
    dropout — the numerator of the expected ``delivered_fraction``."""
    k = n if participation_k is None else int(participation_k)
    if not 1 <= k <= n:
        raise ValueError(f"participation_k must be in [1, {n}], got {k}")
    if not 0.0 <= dropout_rate <= 1.0:
        raise ValueError(
            f"dropout_rate must be in [0, 1], got {dropout_rate!r}")
    return k * (1.0 - float(dropout_rate))
