"""Pluggable aggregation topologies + the shared round driver.

The paper's core claim — GradsSharding vs λ-FL vs LIFL is purely a
*topology* choice with bit-identical FedAvg output (§III-A) — is encoded
here structurally: a :class:`Topology` strategy declares *what* a round
looks like (keyspace layout, per-client uploads, phase/level plan,
per-invocation inputs/outputs/weights, read-back set), and one shared
**round driver** (:func:`run_round`) owns everything the three legacy
round functions used to triplicate:

  * client PUTs + modeled upload registration (:class:`UploadModel`
    start/rate jitter and per-client local-compute time),
  * barrier-vs-pipelined launch gating (phase barriers, or per-invocation
    launch on the first in-index-order contribution with availability
    publishes through the event heap),
  * phase sequencing, read-back accounting (O(1) redundant-GET batching),
    per-client read-back timelines, and
  * :class:`AggregationResult` assembly (walls, phases, S3 ops, billed
    memory, absolute round times for multi-round pipelining).

Because the driver is the only place scheduling and accounting happen, a
new topology composes with every engine (``streaming``/``batched``/
``incremental``) and every schedule (``barrier``/``pipelined``) for free,
and ``avg_flat`` invariants are inherited rather than re-proven.

Topologies register through :func:`register_topology`::

    @register_topology("my_topo")
    class MyTopology(Topology):
        name = "my_topo"
        def program(self, client_grads, spec, backend): ...

A plugin topology registers through this public API alone — no driver
edits. The analytical cost model (:mod:`repro_torch.core.cost_model`)
consults the same registry for unknown topology names, so a plugin
topology also gets Table-II op counts, memory/feasibility and round-cost
entries by implementing the ``cost_*`` hooks. This package registers the
paper's three builtins, ``gradssharding``, ``lambda_fl`` and ``lifl``,
and two plugins through the public API alone:
:mod:`repro_torch.core.sharded_tree` (shard the gradient into M pieces,
aggregate each shard through a ⌈√N⌉ two-level tree) and
:mod:`repro_torch.core.geo_tiered` (edge → region → global).

Client gradients, stored shards and the round's mean are torch tensors on
the gradient's device; upload schedules, read-back timelines and every
other modeled quantity stay on the host.

The user-facing entry point is :class:`repro_torch.api.FederatedSession`;
:func:`repro_torch.core.aggregation.aggregate_round` remains as a thin
delegating shim.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch import knobs
from repro_torch.config import DEFAULT_LIMITS, LambdaLimits
from repro_torch.core import cost_model as cm
from repro_torch.core.agg_engine import ExecutionBackend, get_backend
from repro_torch.core.cost_model import UploadModel
from repro_torch.core.sharding import PartitionPlan, as_grad_tensor, \
    make_plan, reconstruct
from repro_torch.core.wire_codec import WireCodec, get_codec
from repro_torch.core.wire_codec import available_codecs  # noqa: F401  (re-export)
from repro_torch.core.wire_codec import register_codec    # noqa: F401  (re-export)
from repro_torch.serverless.event_sim import ReadAheadWindow, Timeline, \
    arrival_order
from repro_torch.serverless.faults import FaultModel, StaleBuffer, StalenessPolicy
from repro_torch.serverless.runtime import FaultPlan, InvocationRecord, \
    LambdaRuntime
from repro_torch.store import ObjectStore

MB = 1024 * 1024

Engine = str | ExecutionBackend | None


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

SCHEDULES = ("barrier", "pipelined", "quorum")
DEFAULT_SCHEDULE = "barrier"


def get_schedule(schedule: str | None = None) -> str:
    """Resolve the schedule knob: a name, or ``None``/"auto" (env
    ``REPRO_AGG_SCHEDULE``, else ``"barrier"``).

    ``"quorum"`` is the FedBuff-style semi-async mode: the round fires
    once ``quorum`` contributions have arrived, folds them **in arrival
    order**, and excludes stragglers beyond the cut — a documented,
    seeded departure from the barrier/pipelined bit-identity contract
    (fold order follows the seeded arrival times, not client index).
    """
    if schedule is None or schedule == "auto":
        schedule = knobs.env_schedule(DEFAULT_SCHEDULE)
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown aggregation schedule {schedule!r} "
                         f"(expected one of {SCHEDULES} or 'auto')")
    return schedule


DEFAULT_READAHEAD = 1


def get_readahead(readahead_k: int | str | None = None) -> int:
    """Resolve the pipelined read-ahead window: an int >= 1, or
    ``None``/"auto" (env ``REPRO_AGG_READAHEAD``, else 1 — the legacy
    strictly-in-index-order fetch schedule)."""
    if readahead_k is None or readahead_k == "auto":
        readahead_k = knobs.env_readahead(DEFAULT_READAHEAD)
    try:
        k = int(readahead_k)
        if k != float(readahead_k):      # reject silent 1.5 -> 1 truncation
            raise ValueError
    except (TypeError, ValueError):
        raise ValueError(f"readahead_k must be an integer >= 1 or 'auto', "
                         f"got {readahead_k!r}") from None
    if k < 1:
        raise ValueError(f"readahead_k must be >= 1, got {k}")
    return k


def validate_fault_knobs(schedule: str, *,
                         participation_k: int | None = None,
                         deadline_s: float | None = None,
                         quorum: int | None = None,
                         faults: "FaultModel | None" = None,
                         n_clients: int | None = None,
                         staleness_policy=None,
                         hedge_factor: float | None = None,
                         allow_auto_quorum: bool = False) -> None:
    """Up-front validation of the fault-tolerance knob combinations.

    Called eagerly by :class:`repro_torch.api.FederatedSession` (without a
    cohort size) and again by :func:`run_round` (with one), so a bad
    combination fails with a clear ``ValueError`` instead of a
    deep-in-driver surprise. Rules:

      * ``participation_k`` — int >= 1, and <= the cohort size when known;
      * ``deadline_s`` — strictly positive (the round must be able to
        deliver *something*); composes with every schedule: a barrier
        round whose stragglers miss the deadline starts aggregating at
        ``T`` over the arrivals, pipelined/quorum rounds cut membership;
      * ``quorum`` — requires ``schedule="quorum"`` (a count-gated fold
        frontier is meaningless under a barrier), int >= 1, and bounded
        by the participant count when known; conversely
        ``schedule="quorum"`` requires an explicit ``quorum`` — except
        when the schedule came from the env (``allow_auto_quorum``, set
        by the resolving caller): ``REPRO_AGG_SCHEDULE=quorum`` without
        an explicit ``quorum=`` runs the *full*-quorum semi-async fold
        (every arrival folds, in arrival order);
      * ``deadline_s`` **+** ``quorum`` — the documented precedence is
        **deadline cuts first, the quorum gates within its survivors**
        (:func:`repro_torch.serverless.event_sim.arrival_order` filters the
        deadline before truncating to the first q). The degenerate case
        — fewer post-deadline arrivals than the quorum — is a per-round
        ``ValueError`` raised by the driver and by
        :func:`repro_torch.core.cost_model.quorum_round_cost`, since it
        depends on the seeded arrival times;
      * ``staleness_policy`` — a
        :class:`~repro_torch.serverless.faults.StalenessPolicy` (weights a
        dropped/late client's round-r gradient when it re-enters a later
        fold) or ``None``;
      * ``hedge_factor`` — launches a speculative replica of an
        aggregator whose actual finish lags its expected finish by this
        factor; must be > 1.0 (at exactly 1.0 float jitter on the
        expected-finish parity would hedge fault-free rounds) and
        requires a non-barrier schedule (a barrier phase has no frontier
        to lag behind);
      * ``faults`` — a :class:`~repro_torch.serverless.faults.FaultModel`
        (rates already validated by its constructor) or ``None``.
    """
    if participation_k is not None:
        if int(participation_k) != participation_k or participation_k < 1:
            raise ValueError(
                f"participation_k must be an integer >= 1, got "
                f"{participation_k!r}")
        if n_clients is not None and participation_k > n_clients:
            raise ValueError(
                f"participation_k={participation_k} exceeds the cohort "
                f"size ({n_clients} clients)")
    if deadline_s is not None and not deadline_s > 0.0:
        raise ValueError(
            f"deadline_s must be > 0 (a round must be able to deliver "
            f"at least one contribution), got {deadline_s!r}")
    if schedule == "quorum":
        if quorum is None and not allow_auto_quorum:
            raise ValueError(
                "schedule='quorum' requires an explicit quorum= (the "
                "contribution count that fires the fold)")
    elif quorum is not None:
        raise ValueError(
            f"quorum={quorum} requires schedule='quorum' (got "
            f"schedule={schedule!r}: a count-gated fold frontier has no "
            f"meaning under a barrier or plain pipelined round)")
    if quorum is not None:
        if int(quorum) != quorum or quorum < 1:
            raise ValueError(f"quorum must be an integer >= 1, got "
                             f"{quorum!r}")
        cap = participation_k if participation_k is not None else n_clients
        if cap is not None and quorum > cap:
            raise ValueError(
                f"quorum={quorum} exceeds the participant count ({cap})")
    if staleness_policy is not None \
            and not hasattr(staleness_policy, "weight"):
        raise TypeError(
            f"staleness_policy must be a repro_torch.serverless.faults"
            f".StalenessPolicy (got {type(staleness_policy).__name__})")
    if hedge_factor is not None:
        if not hedge_factor > 1.0:
            raise ValueError(
                f"hedge_factor must be > 1.0 (the factor by which an "
                f"aggregator's actual finish must lag its expected finish "
                f"before a hedge launches), got {hedge_factor!r}")
        if schedule == "barrier":
            raise ValueError(
                "hedge_factor requires a non-barrier schedule (pipelined "
                "or quorum): a barrier phase has no per-invocation "
                "frontier for a replica to race")
    if faults is not None and not hasattr(faults, "dropout_plan"):
        raise TypeError(
            f"faults must be a repro_torch.serverless.faults.FaultModel (got "
            f"{type(faults).__name__}); raw FaultPlan schedules attach to "
            f"the runtime, not the round driver")


# ---------------------------------------------------------------------------
# Keyspace
# ---------------------------------------------------------------------------

def k_client_grad(rnd: int, i: int) -> str:
    return f"round{rnd:05d}/client{i:04d}/grad"

def k_client_shard(rnd: int, i: int, j: int) -> str:
    return f"round{rnd:05d}/client{i:04d}/shard{j:04d}"

def k_avg_shard(rnd: int, j: int) -> str:
    return f"round{rnd:05d}/avg/shard{j:04d}"

def k_partial(rnd: int, level: int, g: int) -> str:
    return f"round{rnd:05d}/partial/l{level}/g{g:04d}"

def k_global(rnd: int) -> str:
    return f"round{rnd:05d}/avg/global"

def round_prefix(rnd: int) -> str:
    """Store-key prefix every object of round ``rnd`` lives under."""
    return f"round{rnd:05d}/"


# ---------------------------------------------------------------------------
# Result record
# ---------------------------------------------------------------------------

@dataclass
class AggregationResult:
    topology: str
    avg_flat: torch.Tensor
    wall_clock_s: float
    # barrier: per-phase *durations* (wall_clock_s == upload span + their
    # sum). pipelined: per-phase *completion offsets* from round start —
    # phases overlap, so durations don't exist; wall_clock_s == phases_s[-1]
    phases_s: tuple
    records: list[InvocationRecord] = field(default_factory=list)
    puts: int = 0
    gets: int = 0
    memory_mb: float = 0.0
    peak_memory_mb: float = 0.0
    engine: str = "streaming"
    schedule: str = "barrier"
    readahead_k: int = 1
    # the wire codec contributions travelled under, and — for lossy
    # codecs — the deterministic per-round max-abs deviation of avg_flat
    # from the uncompressed streaming-mean reference (0.0 under identity:
    # accuracy impact is observable, never silent)
    codec: str = "identity"
    codec_error: float = 0.0
    # absolute logical times on the session timeline (multi-round pipelining)
    round_start_s: float = 0.0
    round_end_s: float = 0.0
    client_done_s: tuple = ()            # per-client read-back completion
    #   (float64 ndarray cohort-indexed; () once compacted away)
    # fault-tolerant rounds: the cohort indices invited this round, the
    # subset actually folded (in fold order — arrival order under
    # schedule="quorum", index order otherwise), seeded dropouts, clients
    # cut by the deadline/quorum, the delivered fraction
    # (len(arrivals) / len(participants)) and the count of failed
    # aggregator attempts that were retried. A fault-free full-
    # participation round reads participants == arrivals == 0..n-1,
    # delivered_fraction == 1.0, retries == 0.
    participants: tuple = ()
    arrivals: tuple = ()
    dropped: tuple = ()
    late: tuple = ()
    delivered_fraction: float = 1.0
    retries: int = 0
    # semi-async re-entry: ``(client, staleness)`` pairs whose buffered
    # round-(rnd - staleness) gradients re-entered this round's fold
    # (weighted by the session's StalenessPolicy), plus the sorted
    # ``(staleness, count)`` histogram. Fresh-only rounds read () / ().
    stale_folded: tuple = ()
    staleness_histogram: tuple = ()
    # speculative hedging: replicas launched against lagging aggregators
    # this round, and how many finished before their primary (losers are
    # still billed — their records carry speculative=True)
    hedges: int = 0
    hedge_wins: int = 0
    # the platform limits this round was simulated (and is priced) under —
    # keeps per-round dollar figures consistent with the session's totals
    # when SessionConfig.limits overrides the defaults
    limits: LambdaLimits = DEFAULT_LIMITS

    @property
    def lambda_cost(self) -> float:
        return sum(r.billed_gb_s for r in self.records) \
            * self.limits.gb_s_price

    def s3_cost(self, limits: LambdaLimits | None = None) -> float:
        limits = limits or self.limits
        return self.puts * limits.s3_put_price + self.gets * limits.s3_get_price

    def total_cost(self, limits: LambdaLimits | None = None) -> float:
        return self.lambda_cost + self.s3_cost(limits)


def _alloc_mb(in_bytes: int, limits: LambdaLimits,
              readahead_k: int = 1, fanin: int | None = None,
              wire_in_bytes: int | None = None,
              weighted: bool = False) -> float:
    # the empirical 3x formula covers the 2-buffer fold plus the transient
    # GET copy; a readahead_k prefetch window needs (k+1) input buffers, so
    # the allocation (and its billing) grows once k outgrows the formula.
    # A compressed wire codec shrinks the window's buffers to wire size
    # (the accumulator — f64 when the fold is weighted — and the decode
    # target stay full-size). One shared definition with the analytical
    # model's per-fold billing.
    return cm.wire_alloc_mb(in_bytes, limits, readahead_k, fanin,
                            wire_in_bytes, weighted)


def tier_limits(limits: LambdaLimits, read_mbps: float | None = None,
                write_mbps: float | None = None) -> LambdaLimits:
    """Platform limits with a tier's link bandwidths substituted for the
    S3 stream rates (caps, prices and the per-GET latency floor stay the
    platform's). Shared by the round driver and the geo-tiered cost
    hooks, so the simulator and the analytical model price a tier's
    transfers from one definition."""
    if read_mbps is None and write_mbps is None:
        return limits
    return replace(
        limits,
        s3_read_mbps=limits.s3_read_mbps if read_mbps is None
        else float(read_mbps),
        s3_write_mbps=limits.s3_write_mbps if write_mbps is None
        else float(write_mbps))


# ---------------------------------------------------------------------------
# Declarative round programs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InvocationSpec:
    """One simulated aggregator invocation, declaratively.

    ``in_keys`` are read in index order (the bit-reproducible fold order);
    ``alloc_bytes`` is the single-input byte size feeding the 3×input+450 MB
    memory formula. ``weights`` selects the weighted f64 fold (tree levels
    combining unequal group sizes); ``None`` is the unweighted f32 fold.
    ``colocated_in`` reads inputs from node-local shared memory instead of
    the store (LIFL fast path); ``shared_copy`` additionally mirrors the
    S3 output into shared memory (LIFL level 1 feeding colocated level 2);
    ``global_out`` marks the round's final output (colocated invocations
    still PUT it to S3 for client read-back). ``wire_in_bytes`` is the
    codec-encoded size of one input when this invocation reads encoded
    client contributions (the client→aggregator hop); ``None`` means raw
    f32 inputs (inter-aggregator partials, or the identity codec) and
    keeps the legacy billing formula bit-for-bit.

    ``read_mbps``/``write_mbps`` override the platform's S3 stream rates
    for this one invocation — hierarchical geo topologies model each
    tier's link bandwidth this way (the driver hands the runtime a
    rate-replaced :class:`LambdaLimits`; caps, prices and latency floors
    stay the platform's). ``None`` keeps the platform rate.
    """

    fn_name: str
    in_keys: tuple
    out_key: str
    alloc_bytes: int
    weights: tuple | None = None
    colocated_in: bool = False
    shared_copy: bool = False
    global_out: bool = False
    wire_in_bytes: int | None = None
    read_mbps: float | None = None
    write_mbps: float | None = None


@dataclass(frozen=True)
class RoundProgram:
    """Everything the driver needs to execute one round of a topology."""

    topology: str
    # ordered (key, value) client PUTs; values may be zero-copy shard views
    client_puts: tuple
    # per client, in-order (key, nbytes) upload schedule for the network model
    uploads: tuple
    # sequential phases of concurrent invocations
    phases: tuple
    # (key, nbytes) every client reads back after aggregation
    readback: tuple
    # read-back values -> the round's flat averaged gradient
    collect: Callable[[list], torch.Tensor]


@dataclass(frozen=True)
class RoundSpec:
    """Per-round scalars handed to :meth:`Topology.program`.

    ``codec`` is the resolved wire codec the round runs under; topologies
    thread it through :func:`sharded_client_uploads` /
    :func:`full_grad_uploads` so client PUTs carry encoded payloads and
    the upload schedule carries wire bytes.

    ``weights`` — per-position fold weights parallel to ``client_grads``
    (the driver appends staleness-weighted re-entries after the fresh
    members), or ``None`` for the plain unweighted mean. Topologies must
    thread them into every fold so the average becomes
    ``sum(w_i * g_i) / sum(w_i)``; ``None`` keeps the legacy unweighted
    f32 folds bit-for-bit.
    """

    rnd: int
    n: int
    grad_bytes: int
    limits: LambdaLimits
    options: Mapping[str, Any] = field(default_factory=dict)
    codec: WireCodec = field(default_factory=get_codec)
    weights: tuple | None = None

    def opt(self, name: str, default=None):
        return self.options.get(name, default)


# ---------------------------------------------------------------------------
# Topology strategy interface + registry
# ---------------------------------------------------------------------------

# options every topology may receive (and is free to ignore) — the legacy
# ``aggregate_round`` signature threads them unconditionally
COMMON_OPTIONS = frozenset({"n_shards", "partition", "tensor_sizes", "plan"})


class Topology:
    """Strategy interface: declare a round, inherit the driver.

    Subclasses implement :meth:`program` (the simulator side) and may
    implement the ``cost_*`` hooks (the analytical side — consulted by
    :mod:`repro_torch.core.cost_model` for non-builtin names).
    """

    name = "?"
    #: topology-specific option names beyond :data:`COMMON_OPTIONS`
    options_used: frozenset = frozenset()
    #: cost-hook protocol version. v2 (this base): ``cost_phase_plan`` /
    #: ``cost_pipelined_plan`` take everything after ``limits`` as
    #: keyword-only arguments with an explicit required ``codec=``. The
    #: cost model refuses hooks that declare an older version (or whose
    #: signature rejects the v2 keywords) with a pointed error instead of
    #: sniffing signatures — silently pricing raw wire bytes under a
    #: compressing codec was the failure mode v1 invited.
    cost_api_version = 2

    # -- simulator side -------------------------------------------------------
    def program(self, client_grads: Sequence[torch.Tensor], spec: RoundSpec,
                backend: ExecutionBackend) -> RoundProgram:
        raise NotImplementedError

    def validate_options(self, options: Mapping[str, Any]) -> None:
        unknown = set(options) - COMMON_OPTIONS - self.options_used
        if unknown:
            raise TypeError(
                f"topology {self.name!r} got unexpected option(s) "
                f"{sorted(unknown)}")

    # -- analytical cost-model hooks (optional) -------------------------------
    def cost_s3_ops(self, n: int, m: int = 1) -> "cm.S3Ops":
        raise NotImplementedError(
            f"topology {self.name!r} declares no S3-op model")

    def cost_n_aggregators(self, n: int, m: int = 1) -> int:
        raise NotImplementedError(
            f"topology {self.name!r} declares no aggregator-count model")

    def cost_n_phases(self) -> int:
        raise NotImplementedError(
            f"topology {self.name!r} declares no phase-depth model")

    def cost_input_bytes(self, grad_bytes: int, m: int = 1) -> int:
        """Bytes of a single incoming object at an aggregator."""
        return grad_bytes

    def cost_phase_plan(self, grad_bytes: int, n: int, m: int,
                        limits: LambdaLimits, *,
                        codec: "cm.Codec") -> list:
        """Sequential phases as (PhaseTiming, invocation_count) pairs —
        drives the generic :func:`repro_torch.core.cost_model.round_cost`
        fallback for registered topologies. ``codec`` (keyword-only,
        always passed by the cost model — v2 protocol, see
        :attr:`cost_api_version`) is the resolved wire codec; phases
        reading client contributions should price wire-size GETs plus
        per-contribution decode."""
        raise NotImplementedError(
            f"topology {self.name!r} declares no round-cost model")

    def cost_client_upload_bytes(self, grad_bytes: int, m: int = 1,
                                 codec: "cm.Codec" = None,
                                 shard_bytes=None) -> int:
        """Total wire bytes one client PUTs per round. Default: one
        encoded whole gradient; sharded topologies override to sum their
        M independently encoded shards."""
        return get_codec(codec).wire_bytes(grad_bytes)

    def cost_wire_weighted(self) -> bool:
        """True when the folds that read *encoded client contributions*
        carry weights (an f64 running sum — one extra input buffer in the
        compressed-wire memory bound of
        :func:`repro_torch.core.cost_model.wire_alloc_bytes`). Raw-input folds
        higher up a tree don't matter here: the legacy 3× formula already
        covers their f64 accumulator."""
        return False

    def cost_collect_fanin(self, n: int, m: int = 1) -> int:
        """Widest aggregator fan-in — the contribution count behind the
        collect-then-average memory bound and the cap on a read-ahead
        prefetch window (drives
        :func:`repro_torch.core.cost_model.collect_memory_bytes`)."""
        raise NotImplementedError(
            f"topology {self.name!r} declares no aggregator fan-in model")

    def cost_memory_bytes(self, grad_bytes: int, n: int, m: int = 1,
                          readahead_k: int | None = None) -> int:
        """Per-aggregator buffered bytes: all fan-in inputs + the result
        (collect-then-average), or — given ``readahead_k`` — the bounded
        prefetch bound ``(min(k, fanin) + 1)``·input, which interpolates
        from the 2-buffer streaming bound (k=1) up to full collect."""
        fanin = self.cost_collect_fanin(n, m)
        buffers = fanin if readahead_k is None \
            else min(max(1, int(readahead_k)), fanin)
        return (buffers + 1) * self.cost_input_bytes(grad_bytes, m)

    def cost_pipelined_plan(self, grad_bytes: int, n: int, m: int,
                            limits: LambdaLimits, *, upload, starts, mults,
                            run_fold, shard_bytes=None,
                            codec: "cm.Codec") -> None:
        """Drive :func:`repro_torch.core.cost_model.pipelined_round_cost` for a
        registered topology: compute per-input availability times from the
        jittered client plan (``starts``/``mults``) and call ``run_fold
        (avail_s, in_bytes, out_bytes)`` once per aggregator (its return
        value is the fold's finish time, so tree levels can chain).
        Everything after ``limits`` is keyword-only (v2 protocol, see
        :attr:`cost_api_version`) and ``codec`` is always passed.
        ``run_fold`` owns launch gating (read-ahead window), cold starts,
        stalls, transfer/compute time and billing accumulation; folds over
        encoded client contributions pass ``wire_b``/``decode_s`` so
        transfers move ``codec.wire_bytes`` and pay the decode."""
        raise NotImplementedError(
            f"topology {self.name!r} declares no pipelined round-cost "
            f"model")


_REGISTRY: dict[str, Topology] = {}


def register_topology(name: str, *, replace: bool = False):
    """Class decorator: register a :class:`Topology` under ``name``.

    The registry is the extension point the whole stack dispatches on —
    the round driver, ``aggregate_round``, :class:`~repro_torch.api
    .FederatedSession`, and the cost-model fallbacks. Duplicate names
    raise unless ``replace=True`` (deliberate override, e.g. in tests).
    """

    def deco(cls):
        if not replace and name in _REGISTRY:
            raise ValueError(
                f"topology {name!r} is already registered "
                f"({type(_REGISTRY[name]).__name__}); pass replace=True "
                f"to override")
        instance = cls() if isinstance(cls, type) else cls
        instance.name = name
        _REGISTRY[name] = instance
        return cls

    return deco


def get_topology(name: str) -> Topology:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown topology {name!r} (registered: "
            f"{sorted(_REGISTRY)})") from None


def available_topologies() -> tuple:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# Client upload / read-back timing (schedule plumbing)
# ---------------------------------------------------------------------------

@dataclass
class _UploadTimes:
    """Per-client modeled upload timeline for one round."""

    start_s: list[float]                 # upload start (ready + compute + jitter)
    end_s: list[float]                   # last PUT completed
    mults: np.ndarray                    # per-client transfer-rate multiplier
    span_end_s: float                    # max end over clients


def _upload_schedule(upload: UploadModel | None, members: Sequence[int],
                     n_cohort: int, rnd: int, base_s: float,
                     client_ready_s: Sequence[float] | None,
                     key_bytes: Sequence[Sequence[tuple]],
                     stall_s: Sequence[float] | None = None
                     ) -> tuple[_UploadTimes, list]:
    """Pure per-client upload timing: local compute, then start jitter
    (plus any injected stall), then sequential PUTs in ``key_bytes`` order
    at the client's (jittered) uplink rate.

    ``members`` are the *cohort indices* of the uploading clients (the
    full cohort, or the fault-tolerant driver's surviving subset);
    ``key_bytes`` is position-indexed (parallel to ``members``). Jitter /
    compute / rate draws are always taken over the full ``n_cohort`` so a
    client keeps its own draw regardless of who else participates — the
    determinism contract behind the seeded dropout/participation streams.
    Returns the per-position :class:`_UploadTimes` plus the per-position
    ``[(key, completion_time), ...]`` PUT schedules; no runtime state is
    touched, so the fault-tolerant driver can probe arrival times before
    committing to a membership (:func:`_publish_uploads` then registers
    the chosen schedule's availability events).
    """
    upload = upload or UploadModel()
    starts, mults = upload.plan(n_cohort, rnd)
    computes = upload.compute_plan(n_cohort, rnd)
    t_start, t_end, put_times = [], [], []
    for pos, i in enumerate(members):
        ready = base_s if client_ready_s is None else float(client_ready_s[i])
        t = ready + float(computes[i]) + float(starts[i])
        if stall_s is not None and stall_s[i]:
            t += float(stall_s[i])
        t_start.append(t)
        puts = []
        for key, nb in key_bytes[pos]:
            t += upload.upload_s(nb, float(mults[i]))
            puts.append((key, t))
        put_times.append(puts)
        t_end.append(t)
    member_mults = np.asarray([float(mults[i]) for i in members])
    return _UploadTimes(t_start, t_end, member_mults,
                        max(t_end, default=base_s)), put_times


def _publish_uploads(runtime: LambdaRuntime, put_times: Sequence) -> None:
    """Push every PUT completion as an availability-publish event and
    drain the heap, so keys become readable in deterministic time order."""
    for puts in put_times:
        for key, t in puts:
            runtime.sim.at(t, runtime.avail.publish, key, t)
    runtime.sim.drain()


def _readback_times(sched: str, runtime: LambdaRuntime,
                    upload: UploadModel | None, up: _UploadTimes,
                    out_keys_bytes: Sequence[tuple],
                    agg_end_s: float) -> tuple:
    """Per-client read-back completion times (a :class:`Timeline` fold).

    Barrier: the round is phase-structured — every output exists at
    ``agg_end_s`` and each client then downloads them sequentially at its
    jittered downlink rate. Pipelined: each client independently reads the
    outputs in key order *as they become available*. Downloads are
    instantaneous when the model has no ``download_mbps``, collapsing both
    cases to ``agg_end_s`` (the legacy semantics). Vectorized over the
    members (one ``maximum``/``add`` pair per output key instead of a
    per-client Python :class:`Timeline`); ``max(t, a) + rate * mult`` per
    element is bit-for-bit the scalar fold."""
    n = len(up.end_s)
    upload = upload or UploadModel()
    # barrier: every output exists at round end, clients download back to
    # back. pipelined: a client is busy until its own upload ends, then
    # reads each output the moment it is published.
    if sched == "barrier":
        t = np.full(n, float(agg_end_s))
    else:
        t = np.asarray(up.end_s, np.float64).copy()
    for key, nb in out_keys_bytes:
        if sched != "barrier":
            np.maximum(t, runtime.avail.time_of(key, agg_end_s), out=t)
        if upload.download_mbps is not None:
            t += (nb / (upload.download_mbps * 1e6)) * up.mults
    return t


def _round_base(runtime: LambdaRuntime,
                client_ready_s: Sequence[float] | None) -> float:
    """The round's zero point: the runtime cursor, or — when per-client
    ready times from a previous round are supplied — the earliest client
    activity (rounds overlap, so the cursor may legitimately be later)."""
    if client_ready_s is None:
        return runtime.now
    return float(min(client_ready_s))


# ---------------------------------------------------------------------------
# The shared round driver
# ---------------------------------------------------------------------------

def _build_body(backend: ExecutionBackend, store: ObjectStore, shared: dict,
                inv: InvocationSpec, readahead_k: int = 1):
    """Materialize an :class:`InvocationSpec` into a runnable body using
    the engine's invocation-body templates. The read-ahead window applies
    to store-reading bodies only: a colocated (shared-memory) fold has no
    transfers to prefetch, so it keeps the plain in-order wait."""
    weights = list(inv.weights) if inv.weights is not None else None
    if inv.colocated_in:
        return backend.colocated_body(shared, store, list(inv.in_keys),
                                      weights, inv.out_key,
                                      is_global=inv.global_out)
    inner = backend.avg_body(store, list(inv.in_keys), inv.out_key,
                             weights=weights, readahead_k=readahead_k)
    if not inv.shared_copy:
        return inner

    def body(ctx, inner=inner, out_key=inv.out_key):
        result = inner(ctx)
        shared[out_key] = result          # zero-copy mirror, no extra time
        return result

    return body


_NO_FAULTS = FaultModel()   # seeds participation sampling when faults=None


def _bind_runtime_faults(runtime: LambdaRuntime, fm: FaultModel) -> None:
    """Attach the round's :class:`FaultModel` to the runtime's
    invocation-failure hook (the runtime is the single source of truth
    for per-attempt failures, slowdowns and retry backoff). Binding is
    idempotent across a session's rounds; a runtime that already carries
    a different, non-empty fault configuration is a conflict — silently
    preferring either side would make a fault study measure the wrong
    thing."""
    cur = runtime.faults
    if cur is fm:
        return
    if isinstance(cur, FaultPlan) and cur.is_empty:
        runtime.faults = fm
        return
    raise ValueError(
        "run_round(faults=...) conflicts with the runtime's existing "
        "fault configuration; configure faults in exactly one place")


def run_round(topology: str | Topology,
              client_grads: Sequence[torch.Tensor], *, rnd: int,
              store: ObjectStore, runtime: LambdaRuntime,
              engine: Engine = None, schedule: str | None = None,
              upload: UploadModel | None = None,
              client_ready_s: Sequence[float] | None = None,
              straggler_threshold_s: float | None = None,
              readahead_k: int | None = None,
              codec: str | WireCodec | None = None,
              track_codec_error: bool = True,
              faults: FaultModel | None = None,
              participation_k: int | None = None,
              deadline_s: float | None = None,
              quorum: int | None = None,
              staleness_policy: StalenessPolicy | None = None,
              stale_buffer: StaleBuffer | None = None,
              hedge_factor: float | None = None,
              workers: int | str | None = None,
              **options) -> AggregationResult:
    """Execute one aggregation round of any registered topology.

    This is the machinery formerly triplicated across the monolithic round
    functions; every topology-specific decision comes from the
    :class:`RoundProgram` the topology declares. ``readahead_k`` (env
    ``REPRO_AGG_READAHEAD``) bounds the pipelined schedule's out-of-order
    prefetch window — launch gating and fetch order generalize from "next
    in-index contribution" to "frontier + window", while the fold itself
    stays strictly client-index order (bit-identity by construction). The
    barrier schedule has no frontier to run ahead of, so ``readahead_k``
    is inert there.

    ``codec`` (env ``REPRO_AGG_CODEC``) selects the wire representation
    of client contributions (:mod:`repro_torch.core.wire_codec`): clients PUT
    encoded payloads, the upload schedule and every GET/stall/billing
    term see wire bytes, and aggregators decode-before-fold. With the
    default ``identity`` codec this path is byte-for-byte the raw-f32
    round; lossy codecs stay deterministic and report ``codec_error`` —
    whose uncompressed reference costs an extra O(N·|θ|) host pass per
    round, so throughput-bound sweeps can set
    ``track_codec_error=False`` (``codec_error`` then reads NaN, never a
    misleading 0.0).

    The fault-tolerance knobs degrade the round gracefully instead of
    assuming the all-N fault-free best case:

      * ``faults`` — a seeded :class:`~repro_torch.serverless.faults
        .FaultModel`; its dropout/stall streams shape the upload
        timeline, and its invocation-failure stream is bound to the
        runtime (idempotent retries with exponential backoff).
      * ``participation_k`` — sample K of N cohort clients per round
        from the model's seeded participation stream.
      * ``deadline_s`` — aggregate whatever landed by ``round start +
        deadline_s``; stragglers past the cut are excluded and the
        round is only declared complete at the deadline when someone
        was cut.
      * ``quorum`` (with ``schedule="quorum"``) — the FedBuff-style
        semi-async mode: the fold covers the first ``quorum`` arrivals
        **in arrival order** (deterministic ``(time, index)``
        tie-breaking from the seeded upload plan) — a documented
        departure from the barrier/pipelined bit-identity contract.
        Combined with ``deadline_s`` the precedence is **deadline cuts
        first, quorum gates within the survivors**; fewer post-deadline
        arrivals than the quorum is a ``ValueError``. An env-resolved
        quorum schedule without an explicit ``quorum=`` folds *every*
        arrival in arrival order (the full quorum).
      * ``staleness_policy`` + ``stale_buffer`` — semi-async re-entry: a
        dropped/late client's gradient lands in the session's
        :class:`~repro_torch.serverless.faults.StaleBuffer` with its
        deterministic re-entry time, and a later round whose cut it
        precedes folds it with the policy's staleness weight appended
        after the fresh members (the engines' weighted f64 folds divide
        by ``n_fresh + sum(w_stale)``). The quorum counts *fresh*
        arrivals only — stale entries ride along, they never fire the
        fold. Rounds that fold no stale entries stay bit-for-bit the
        zero-policy path.
      * ``hedge_factor`` — speculative hedging (non-barrier schedules):
        after each store-reading aggregator completes, its actual finish
        is compared against ``launch + factor * (expected fault-free
        finish − launch)`` (the :func:`~repro_torch.core.cost_model
        .expected_fold_finish_s` replay of its read-ahead frontier); a
        lagging primary gets a hedge replica on the same keyspace under
        ``<fn>~hedge`` (own warm slot, own failure stream), the earlier
        finisher wins via the availability map's first-write-wins
        publish, and the loser stays billed.

    In every case the program is built over the surviving subset, so the
    average divides by the number of *arrivals*, never the cohort size,
    and tree weights reflect the delivered group sizes. With all knobs
    off this path is bit-for-bit the legacy fault-free round.

    ``workers`` (env ``REPRO_AGG_WORKERS``) sizes the host fold pool
    behind the batched engine's CPU evaluator. It moves wall-clock only —
    ``avg_flat``, op counts and billing are invariant at every worker
    count (the fold pool's determinism contract).

    ``client_grads`` are flat f32 tensors (numpy arrays are taken as CPU
    tensors); the fold runs on their device.
    """
    topo = topology if isinstance(topology, Topology) \
        else get_topology(topology)
    topo.validate_options(options)
    backend = get_backend(engine, workers=workers)
    sched = get_schedule(schedule)
    barrier = sched == "barrier"
    # validate unconditionally (a bad knob must not pass silently just
    # because the schedule is barrier); apply only where it means something
    readahead = get_readahead(readahead_k)
    if barrier:
        readahead = 1
    cdc = get_codec(codec)
    client_grads = [as_grad_tensor(g) for g in client_grads]
    n = len(client_grads)
    validate_fault_knobs(sched, participation_k=participation_k,
                         deadline_s=deadline_s, quorum=quorum,
                         faults=faults, n_clients=n,
                         staleness_policy=staleness_policy,
                         hedge_factor=hedge_factor,
                         allow_auto_quorum=schedule is None
                         or schedule == "auto")
    limits = runtime.limits
    p0, g0 = store.stats.puts, store.stats.gets
    rec_start = len(runtime.records)
    base = _round_base(runtime, client_ready_s)

    # -- membership: participation sampling, dropout, stalls -----------------
    if faults is not None:
        _bind_runtime_faults(runtime, faults)
    if participation_k is not None and participation_k < n:
        participants = list((faults or _NO_FAULTS)
                            .participants(n, rnd, participation_k))
    else:
        participants = list(range(n))
    dropped: tuple = ()
    stalls = None
    order = participants
    if faults is not None:
        drop = faults.dropout_plan(n, rnd)
        dropped = tuple(i for i in participants if drop[i])
        order = [i for i in participants if not drop[i]]
        st = faults.stall_plan(n, rnd)
        if st.any():
            stalls = st
    if not order:
        detail = "" if faults is None else (
            f" (dropout_rate={faults.dropout_rate}, seed={faults.seed})")
        raise RuntimeError(f"round {rnd}: no active participants{detail}")

    def build(members, stale=()):
        """Program + pure upload schedule over one membership (cohort
        indices), plus any staleness-weighted re-entries appended after
        the fresh members (their PUTs complete at the buffered re-entry
        times, not this round's upload schedule). Nothing here touches
        runtime or store state, so the fault-tolerant path can probe
        arrival times before committing."""
        sub = [client_grads[i] for i in members] \
            + [e.grad for e, _w in stale]
        weights = None if not stale else tuple(
            [1.0] * len(members) + [w for _e, w in stale])
        spec = RoundSpec(rnd=rnd, n=len(sub),
                         grad_bytes=int(sub[0].nbytes),
                         limits=limits, options=options, codec=cdc,
                         weights=weights)
        prog = topo.program(sub, spec, backend)
        up, put_times = _upload_schedule(
            upload, members, n, rnd, base, client_ready_s,
            prog.uploads[:len(members)], stalls)
        for pos in range(len(members), len(sub)):
            e, _w = stale[pos - len(members)]
            put_times.append([(key, e.ready_s)
                              for key, _nb in prog.uploads[pos]])
        return sub, prog, up, put_times

    sub, prog, up, put_times = build(order)

    # stale re-entry bookkeeping needs the *pre-cut* probe: a late
    # client's re-entry time is its probed upload completion, and a
    # dropped client's upload shape (key count / byte sizes) is the same
    # as any member's
    stale_active = staleness_policy is not None and stale_buffer is not None
    if stale_active:
        probe_end = {i: up.end_s[pos] for pos, i in enumerate(order)}
        probe_key_bytes = tuple(prog.uploads[0])

    # -- deadline / quorum cut on the probed arrival times -------------------
    late: tuple = ()
    deadline_abs = None if deadline_s is None else base + float(deadline_s)
    if deadline_abs is not None or sched == "quorum":
        if sched == "quorum" and quorum is not None \
                and deadline_abs is not None:
            # precedence: the deadline cuts first, the quorum gates
            # within its survivors — a quorum the post-deadline arrivals
            # cannot satisfy is a config error, not a silent smaller fold
            survivors = arrival_order(up.end_s, deadline_s=deadline_abs)
            if len(survivors) < quorum:
                raise ValueError(
                    f"round {rnd}: quorum={quorum} exceeds the "
                    f"{len(survivors)} arrival(s) left by the deadline "
                    f"({deadline_s:.3f} s); the deadline cuts first and "
                    f"the quorum gates within its survivors — lower the "
                    f"quorum or relax the deadline")
        keep = arrival_order(up.end_s, quorum=quorum,
                             deadline_s=deadline_abs)
        if not keep:
            raise RuntimeError(
                f"round {rnd}: no client upload completed by the deadline "
                f"({deadline_s:.3f} s) — nothing to aggregate")
        if sched != "quorum":
            keep.sort()           # a deadline alone never reorders the fold
        kept = [order[pos] for pos in keep]
        kept_set = set(kept)
        late = tuple(i for i in order if i not in kept_set)
        if kept != order:
            # membership shrank (or the quorum reordered the fold):
            # rebuild over the survivors. The probe's puts were never
            # stored and its events never registered, so only this final
            # program touches runtime/store state.
            order = kept
            sub, prog, up, put_times = build(order)

    # -- stale re-entry: fold buffered gradients available by the cut --------
    # the cut is this round's deterministic completion frontier: the
    # deadline when one is set, else the (post-cut) fresh upload span —
    # which under schedule="quorum" is exactly the q-th fresh arrival.
    # Stale entries never gate the quorum; they ride along, weighted.
    stale_sel: list = []
    if stale_active:
        cut_s = deadline_abs if deadline_abs is not None else up.span_end_s
        stale_sel = stale_buffer.take_ready(cut_s, rnd, staleness_policy)
        if stale_sel:
            sub, prog, up, put_times = build(order, stale_sel)

    # -- client uploads: values land immediately, availability is modeled ----
    for key, value in prog.client_puts:
        store.put(key, value)
    _publish_uploads(runtime, put_times)

    # -- aggregation phases ---------------------------------------------------
    shared: dict = {}
    handles = []
    hedges = hedge_wins = 0
    hedging = hedge_factor is not None and not barrier
    prev_end = max(base, up.span_end_s)
    if stale_sel:
        # a barrier waits for every folded input, stale re-entries included
        prev_end = max(prev_end, max(e.ready_s for e, _w in stale_sel))
    if barrier and late and deadline_abs is not None:
        # stragglers were cut: the barrier only learns membership at T
        prev_end = max(prev_end, deadline_abs)
    first_start = prev_end
    for phase in prog.phases:
        ph = runtime.phase(start_s=prev_end if barrier else base)
        for inv in phase:
            body = _build_body(backend, store, shared, inv, readahead)
            # colocated hops have nothing to prefetch and keep the 3x
            # formula; _alloc_mb clamps the window to the fan-in
            inv_k = 1 if inv.colocated_in else readahead
            mem = _alloc_mb(inv.alloc_bytes, limits, inv_k,
                            fanin=len(inv.in_keys),
                            wire_in_bytes=inv.wire_in_bytes,
                            weighted=inv.weights is not None)
            inv_limits = tier_limits(limits, inv.read_mbps, inv.write_mbps)
            if barrier:
                ph.invoke_reliable(
                    body, fn_name=inv.fn_name, memory_mb=mem,
                    straggler_threshold_s=straggler_threshold_s,
                    limits=None if inv_limits is limits else inv_limits)
            else:
                # launch on the first available input inside the window
                # [frontier, frontier + k) — k=1 is the legacy "first
                # in-index contribution" gating
                avail = [runtime.avail.time_of(key, base)
                         for key in inv.in_keys[:inv_k]]
                launch = max(base, ReadAheadWindow.launch_s(avail, inv_k))
                hedge_this = hedging and not inv.colocated_in
                if hedge_this:
                    was_warm = runtime.is_warm(inv.fn_name)
                ph.invoke_reliable(
                    body, fn_name=inv.fn_name, memory_mb=mem,
                    straggler_threshold_s=straggler_threshold_s,
                    launch_s=launch, wait_avail=True, out_key=inv.out_key,
                    limits=None if inv_limits is limits else inv_limits)
                if hedge_this:
                    # speculative hedging: replay the aggregator's fault-
                    # free expected finish off its read-ahead frontier
                    # (the exact cost-model parity arithmetic); a primary
                    # whose retry chain overran the hedge threshold races
                    # a replica on the same keyspace — first finisher
                    # wins, the loser stays billed
                    rec = ph.winners[-1]
                    exp = cm.expected_fold_finish_s(
                        launch,
                        [runtime.avail.time_of(key, base)
                         for key in inv.in_keys],
                        [inv.alloc_bytes] * len(inv.in_keys),
                        inv.alloc_bytes, inv_limits, cold=not was_warm,
                        readahead_k=inv_k,
                        wire_bytes=None if inv.wire_in_bytes is None
                        else [inv.wire_in_bytes] * len(inv.in_keys),
                        decode_s=cdc.decode_cost_s(inv.alloc_bytes)
                        if inv.wire_in_bytes is not None else 0.0)
                    thresh = launch + float(hedge_factor) * (exp - launch)
                    if rec.end_s > thresh:
                        hedges += 1
                        hedge_wins += int(ph.hedge_last(
                            body, fn_name=inv.fn_name + "~hedge",
                            memory_mb=mem, launch_s=thresh,
                            out_key=inv.out_key,
                            limits=None if inv_limits is limits
                            else inv_limits))
        prev_end = runtime.finish_phase(ph, barrier=barrier)
        handles.append(ph)
    agg_end = prev_end
    if not barrier and late and deadline_abs is not None:
        # a cut round is only known complete at the deadline itself
        agg_end = max(agg_end, deadline_abs)
        runtime.advance_to(agg_end)
    if barrier:
        wall = (first_start - base) + sum(ph.wall_s for ph in handles)
        phases = tuple(ph.wall_s for ph in handles)
    else:
        wall = agg_end - base
        phases = tuple(ph.end_s - base for ph in handles)
    backend.end_round(store)

    # -- client read-back (N-1 redundant sweeps batch-accounted in O(1)) -----
    # the whole cohort reads the round result back (next round's local
    # training needs it), so read-back op counts stay at cohort size even
    # when the fold covered a subset
    values = [store.get(key) for key, _nb in prog.readback]
    if n > 1:
        for key, _nb in prog.readback:
            store.account_gets(key, n - 1)
    avg = prog.collect(values)
    member_done = _readback_times(sched, runtime, upload, up,
                                  prog.readback, agg_end)
    if order == list(range(n)):
        client_done = member_done
    else:
        # excluded clients re-sync when the aggregate lands (they rejoin
        # the next round from there); delivered members keep their
        # modeled download timelines. member_done is fold-position
        # indexed, so remap to cohort indices for the session threading.
        client_done = np.full(n, float(agg_end))
        client_done[np.asarray(order, dtype=np.intp)] = member_done
    round_end = max(agg_end, float(client_done.max())
                    if len(client_done) else agg_end)
    runtime.advance_to(round_end)

    # -- stale admission: this round's casualties re-enter later rounds ------
    if stale_active:
        # late clients: the upload actually completed — at its probed
        # (pre-cut) time — the round just moved on without it
        for i in late:
            stale_buffer.add(i, rnd, probe_end[i], client_grads[i])
        if dropped:
            # dropped clients: the device died mid-round and retries its
            # upload after coming back — probed completion (same seeded
            # membership-independent draws) plus the policy's fixed
            # re-entry delay
            dm = list(dropped)
            up_d, _ = _upload_schedule(
                upload, dm, n, rnd, base, client_ready_s,
                [probe_key_bytes] * len(dm), stalls)
            for pos, i in enumerate(dm):
                stale_buffer.add(
                    i, rnd,
                    up_d.end_s[pos] + staleness_policy.reentry_delay_s,
                    client_grads[i])

    stale_folded = tuple((e.client, rnd - e.origin_rnd)
                         for e, _w in stale_sel)
    hist: dict = {}
    for _c, s in stale_folded:
        hist[s] = hist.get(s, 0) + 1
    fold_weights = None if not stale_sel else tuple(
        [1.0] * len(order) + [w for _e, w in stale_sel])

    recs = runtime.records[rec_start:]
    return AggregationResult(
        topology=prog.topology, avg_flat=avg,
        wall_clock_s=wall, phases_s=phases, records=recs,
        puts=store.stats.puts - p0, gets=store.stats.gets - g0,
        memory_mb=max(r.memory_mb for r in recs),
        peak_memory_mb=max(r.peak_memory_mb for r in recs),
        engine=backend.name, schedule=sched, readahead_k=readahead,
        codec=cdc.name,
        codec_error=_codec_error(cdc, avg, sub, fold_weights)
        if track_codec_error else float("nan"),
        round_start_s=base, round_end_s=round_end,
        client_done_s=client_done,
        participants=tuple(participants), arrivals=tuple(order),
        dropped=dropped, late=late,
        delivered_fraction=len(order) / len(participants),
        retries=sum(1 for r in recs if r.failed and not r.speculative),
        stale_folded=stale_folded,
        staleness_histogram=tuple(sorted(hist.items())),
        hedges=hedges, hedge_wins=hedge_wins,
        limits=limits)


def _codec_error(codec: WireCodec, avg: torch.Tensor,
                 client_grads: Sequence[torch.Tensor],
                 weights: Sequence[float] | None = None) -> float:
    """Max-abs deviation of the round's average from the uncompressed
    streaming-mean reference — the per-round accuracy cost of a lossy
    wire codec, deterministic across engines, schedules and arrival
    permutations (encode/decode are pure functions of the inputs).
    Identity is 0.0 by definition (bit-identity holds by construction);
    for tree topologies the reference's f32 left-fold differs from the
    weighted f64 fold by ~1 ulp, which lossy-codec errors dwarf. A
    staleness-weighted round compares against the matching weighted
    mean (``weights`` parallel to ``client_grads``)."""
    if codec.lossless or avg.numel() == 0:
        return 0.0

    def f32(x):
        return torch.full((), float(np.float32(x)), dtype=torch.float32,
                          device=avg.device)

    if weights is None:
        ref = client_grads[0].to(torch.float32, copy=True)
        for g in client_grads[1:]:
            ref += g
        ref /= f32(len(client_grads))
    else:
        ref = client_grads[0].to(torch.float32) * f32(weights[0])
        for g, w in zip(client_grads[1:], weights[1:]):
            ref += g.to(torch.float32) * f32(w)
        ref /= f32(np.float32(sum(weights)))
    return float(torch.max(torch.abs(avg - ref)))


# ---------------------------------------------------------------------------
# Shared helpers (public: plugin topologies build their programs with them)
# ---------------------------------------------------------------------------

# the one grouping rule shared with the analytical model (cost_model owns it
# so both layers derive the tree shape from the same definition)
tree_groups = cm.tree_groups


def resolve_partition_plan(spec: RoundSpec, total_elems: int) -> PartitionPlan:
    """The sharded topologies' common option handling: an explicit ``plan``
    wins; otherwise build one from ``partition``/``n_shards``/
    ``tensor_sizes``."""
    plan = spec.opt("plan")
    if plan is not None:
        return plan
    return make_plan(spec.opt("partition", "uniform"), total_elems,
                     spec.opt("n_shards", 4), spec.opt("tensor_sizes"))


def sharded_client_uploads(client_grads, rnd: int, plan: PartitionPlan,
                           backend: ExecutionBackend,
                           codec: WireCodec | None = None):
    """Per-client shard PUTs + upload schedule shared by every topology
    whose clients upload the GradsSharding N·M shard keyspace (Step 1+2;
    zero-copy views under the batched engine). Each shard is encoded
    through the round's wire ``codec`` before its PUT, and the upload
    schedule carries *wire* bytes — under the identity codec both are
    the raw values, byte-for-byte. Returns
    ``(client_puts, uploads, shard_bytes, wire_shard_bytes)``."""
    codec = get_codec(codec)
    m = plan.n_shards
    shard_bytes = [s * 4 for s in plan.shard_sizes()]
    wire_bytes = [codec.wire_bytes(b) for b in shard_bytes]
    puts, uploads = [], []
    for i, g in enumerate(client_grads):
        puts.extend((k_client_shard(rnd, i, j), codec.encode(sh))
                    for j, sh in enumerate(backend.shard_values(g, plan)))
        uploads.append([(k_client_shard(rnd, i, j), wire_bytes[j])
                        for j in range(m)])
    return tuple(puts), tuple(uploads), shard_bytes, wire_bytes


# ---------------------------------------------------------------------------
# Built-in topologies (paper §III-A)
# ---------------------------------------------------------------------------

@register_topology("gradssharding")
class GradsShardingTopology(Topology):
    """M concurrent shard aggregators, single phase (paper §III-A3)."""

    def program(self, client_grads, spec, backend):
        rnd, n = spec.rnd, spec.n
        plan = resolve_partition_plan(spec, int(client_grads[0].numel()))
        m = plan.n_shards
        puts, uploads, shard_bytes, wire_bytes = sharded_client_uploads(
            client_grads, rnd, plan, backend, codec=spec.codec)

        phase = tuple(
            InvocationSpec(
                fn_name=f"r{rnd}-shard{j}",
                in_keys=tuple(k_client_shard(rnd, i, j) for i in range(n)),
                out_key=k_avg_shard(rnd, j),
                alloc_bytes=shard_bytes[j],
                weights=spec.weights,
                wire_in_bytes=wire_bytes[j])
            for j in range(m))
        readback = tuple((k_avg_shard(rnd, j), shard_bytes[j])
                         for j in range(m))
        return RoundProgram(
            topology="gradssharding", client_puts=puts,
            uploads=uploads, phases=(phase,), readback=readback,
            collect=lambda shards: reconstruct(shards, plan))

    # the analytical entries for the builtins stay in cost_model (they are
    # the paper's published formulas); the hooks mirror them for uniformity
    def cost_s3_ops(self, n, m=1):
        return cm.s3_ops("gradssharding", n, m)

    def cost_n_aggregators(self, n, m=1):
        return m

    def cost_n_phases(self):
        return 1

    def cost_input_bytes(self, grad_bytes, m=1):
        return math.ceil(grad_bytes / m)

    def cost_collect_fanin(self, n, m=1):
        return n                      # single-phase: every client's shard

    def cost_client_upload_bytes(self, grad_bytes, m=1, codec=None,
                                 shard_bytes=None):
        return cm.sharded_wire_upload_bytes(grad_bytes, m, codec,
                                            shard_bytes)


def full_grad_uploads(client_grads, rnd, codec: WireCodec | None = None):
    """Whole-gradient client PUTs shared by the tree topologies: each
    client's gradient is codec-encoded before its PUT and the upload
    schedule carries wire bytes. Returns
    ``(client_puts, uploads, grad_bytes, wire_grad_bytes)``."""
    codec = get_codec(codec)
    grad_bytes = int(client_grads[0].nbytes)
    wire_grad_bytes = codec.wire_bytes(grad_bytes)
    puts = tuple((k_client_grad(rnd, i), codec.encode(g))
                 for i, g in enumerate(client_grads))
    uploads = tuple([(k_client_grad(rnd, i), wire_grad_bytes)]
                    for i in range(len(client_grads)))
    return puts, uploads, grad_bytes, wire_grad_bytes


@register_topology("lambda_fl")
class LambdaFLTopology(Topology):
    """Two-level tree, ⌈√N⌉ branching, 2 sequential phases (§III-A1)."""

    def program(self, client_grads, spec, backend):
        rnd, n = spec.rnd, spec.n
        puts, uploads, grad_bytes, wire_grad = full_grad_uploads(
            client_grads, rnd, codec=spec.codec)
        k = cm.lambda_fl_branching(n)
        groups = tree_groups(n, k)
        w = spec.weights
        leaves = tuple(
            InvocationSpec(
                fn_name=f"r{rnd}-leaf{leaf}",
                in_keys=tuple(k_client_grad(rnd, i) for i in members),
                out_key=k_partial(rnd, 1, leaf),
                alloc_bytes=grad_bytes,
                weights=None if w is None
                else tuple(w[i] for i in members),
                wire_in_bytes=wire_grad)
            for leaf, members in enumerate(groups))
        root = InvocationSpec(
            fn_name=f"r{rnd}-root",
            in_keys=tuple(k_partial(rnd, 1, leaf)
                          for leaf in range(len(groups))),
            out_key=k_global(rnd),
            alloc_bytes=grad_bytes,
            weights=tuple(float(len(members)) if w is None
                          else float(sum(w[i] for i in members))
                          for members in groups),
            global_out=True)
        return RoundProgram(
            topology="lambda_fl", client_puts=puts, uploads=uploads,
            phases=(leaves, (root,)),
            readback=((k_global(rnd), grad_bytes),),
            collect=lambda values: values[0])

    def cost_s3_ops(self, n, m=1):
        return cm.s3_ops("lambda_fl", n, m)

    def cost_n_aggregators(self, n, m=1):
        return math.ceil(n / cm.lambda_fl_branching(n)) + 1

    def cost_n_phases(self):
        return 2

    def cost_collect_fanin(self, n, m=1):
        return cm.lambda_fl_branching(n)   # leaf fan-in >= root fan-in


@register_topology("lifl")
class LIFLTopology(Topology):
    """Three-level hierarchy, ⌈∛N⌉ branching, 3 sequential phases
    (§III-A2). ``colocated=True`` models LIFL's native shared-memory fast
    path: level ≥2 hops read node-local memory (no S3 ops, no transfer
    time) and only the global result is PUT."""

    options_used = frozenset({"colocated"})

    def program(self, client_grads, spec, backend):
        rnd, n = spec.rnd, spec.n
        colocated = bool(spec.opt("colocated", False))
        puts, uploads, grad_bytes, wire_grad = full_grad_uploads(
            client_grads, rnd, codec=spec.codec)

        b = cm.lifl_branching(n)
        phases = []
        level_keys = [k_client_grad(rnd, i) for i in range(n)]
        # every LIFL level is already weight-carrying, so staleness
        # weights simply seed the level-1 weights instead of all-ones
        level_weights = list(spec.weights) if spec.weights is not None \
            else [1.0] * n
        n_levels = 3
        for level in range(1, n_levels + 1):
            groups = tree_groups(len(level_keys), b) if level < n_levels \
                else [list(range(len(level_keys)))]
            invs, out_keys, out_weights = [], [], []
            for g_idx, members in enumerate(groups):
                is_global = level == n_levels
                out_key = k_global(rnd) if is_global \
                    else k_partial(rnd, level, g_idx)
                invs.append(InvocationSpec(
                    fn_name=f"r{rnd}-l{level}g{g_idx}",
                    in_keys=tuple(level_keys[i] for i in members),
                    out_key=out_key,
                    alloc_bytes=grad_bytes,
                    weights=tuple(level_weights[i] for i in members),
                    colocated_in=colocated and level >= 2,
                    shared_copy=colocated and level == 1,
                    global_out=is_global,
                    # only level 1 reads encoded client uploads
                    wire_in_bytes=wire_grad if level == 1 else None))
                out_keys.append(out_key)
                out_weights.append(float(sum(level_weights[i]
                                             for i in members)))
            phases.append(tuple(invs))
            level_keys, level_weights = out_keys, out_weights

        return RoundProgram(
            topology="lifl", client_puts=puts, uploads=uploads,
            phases=tuple(phases),
            readback=((k_global(rnd), grad_bytes),),
            collect=lambda values: values[0])

    def cost_s3_ops(self, n, m=1):
        return cm.s3_ops("lifl", n, m)

    def cost_n_aggregators(self, n, m=1):
        l1, l2 = cm.lifl_levels(n)
        return l1 + l2 + 1

    def cost_n_phases(self):
        return 3

    def cost_collect_fanin(self, n, m=1):
        l1, _ = cm.lifl_levels(n)
        return math.ceil(n / l1)

    def cost_wire_weighted(self):
        # every LIFL level folds with group-size weights — including
        # level 1, which reads the encoded client gradients, so its
        # compressed-wire memory bound must budget the f64 accumulator
        return True


# The plugin topologies register themselves through the public API above;
# importing them here makes them available wherever the registry is (the
# imports must follow the registry definitions).
import repro_torch.core.sharded_tree  # noqa: E402,F401  (registration side effect)
import repro_torch.core.geo_tiered  # noqa: E402,F401  (registration side effect)
