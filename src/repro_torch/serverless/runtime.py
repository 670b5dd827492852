"""Serverless (AWS-Lambda-like) runtime simulation.

Executes aggregator function bodies *for real* (numpy arithmetic) while
modeling the platform around them:

  * memory accounting + enforcement of the 10,240 MB cap — functions
    register buffer allocations through their context; peak usage beyond the
    allocated size raises :class:`LambdaOOM` (the paper derived its
    3×input+450 MB formula from exactly such failures);
  * billing at 1 ms granularity: allocated-GB × billed-duration, with the
    modeled S3 transfer times (45–68 MB/s per stream, plus the ~40 ms
    per-GET first-byte latency floor, matching
    :func:`repro_torch.core.cost_model.aggregator_timing`) dominating — the
    paper's 91–99 % I/O share;
  * cold starts against a **function-family warm pool**: warm state is
    keyed on the round-stripped function name (``r{3}-shard{7}`` and
    ``r{4}-shard{7}`` are the same family), so multi-round simulations pay
    one cold start per family, not one per round. ``warm_pool_size`` caps
    how many families stay warm (LRU eviction); ``None`` = unbounded;
  * per-invocation straggler slowdowns and fault injection with idempotent
    retry (first-write-wins PUTs) and speculative re-execution — the
    fault-tolerance substrate for production rounds;
  * a discrete-event logical clock (:mod:`repro_torch.serverless.event_sim`):
    every invocation is anchored at an absolute ``start_s``/``end_s`` on
    the round timeline, cross-entity dependencies synchronise through an
    :class:`~event_sim.AvailabilityMap`, and the event heap replays
    uploads/completions with deterministic tie-breaking — no real threads,
    fully deterministic. (:class:`~event_sim.Timeline` is the standalone
    per-entity clock; the scheduling layer uses it for client read-back
    folds.)

Two scheduling policies drive the clock (knob: ``schedule=`` on the
aggregation round functions, or env ``REPRO_AGG_SCHEDULE``):

  * ``"barrier"`` (default, the legacy semantics): invocations of a
    :class:`PhaseHandle` start together at the phase start; the phase wall
    is the max duration over winning attempts; sequential phases add.
  * ``"pipelined"``: an invocation launches when the *first* of its inputs
    becomes available and each subsequent ``ctx.get`` stalls until that
    key's published availability — the streaming prefix fold. Stall time is
    billed (the function is running while it waits) and recorded in
    ``InvocationRecord.stall_s``.
"""
from __future__ import annotations

import math
import re
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.config import AGG_COMPUTE_BPS, DEFAULT_LIMITS, LambdaLimits
from repro_torch.serverless.event_sim import AvailabilityMap, EventSim
from repro_torch.store import ObjectStore

MB = 1024 * 1024

# "r{rnd}-" prefix of per-round function names; stripping it yields the
# function *family* that warm-container state is keyed on.
_ROUND_PREFIX = re.compile(r"^r\d+-")


def fn_family(fn_name: str) -> str:
    """Round-stripped function name: ``r3-shard7`` -> ``shard7``."""
    return _ROUND_PREFIX.sub("", fn_name)


class LambdaOOM(RuntimeError):
    """Function exceeded its allocated memory."""


class LambdaTimeout(RuntimeError):
    """Function exceeded its configured timeout."""


class InjectedFault(RuntimeError):
    """Fault-injection: the invocation died mid-flight."""


@dataclass
class FaultPlan:
    """Deterministic fault/straggler schedule keyed by (function, attempt).

    ``retry_backoff_s`` is the base wait before a failed attempt is
    re-launched (doubling per further failure); 0.0 is the legacy
    retry-immediately-at-death semantics. The probabilistic counterpart —
    :class:`repro_torch.serverless.faults.FaultModel` — duck-types this
    interface, so either can drive a :class:`LambdaRuntime`.
    """

    fail: set = field(default_factory=set)        # {(fn_name, attempt_idx)}
    slow: dict = field(default_factory=dict)      # {(fn_name, attempt_idx): x}
    retry_backoff_s: float = 0.0

    def failure(self, fn_name: str, attempt: int) -> bool:
        return (fn_name, attempt) in self.fail

    def slowdown(self, fn_name: str, attempt: int) -> float:
        return self.slow.get((fn_name, attempt), 1.0)

    @property
    def is_empty(self) -> bool:
        return not self.fail and not self.slow and self.retry_backoff_s <= 0.0


@dataclass
class InvocationRecord:
    fn_name: str
    memory_mb: float
    duration_s: float
    billed_gb_s: float
    cold_start: bool
    read_bytes: int = 0
    write_bytes: int = 0
    compute_bytes: int = 0
    peak_memory_mb: float = 0.0
    attempt: int = 0
    failed: bool = False
    speculative: bool = False
    # modeled time split (pre-slowdown; duration_s applies the straggler
    # multiplier on top of cold start + these three components + stalls)
    read_s: float = 0.0
    write_s: float = 0.0
    compute_s: float = 0.0
    # absolute logical times on the round timeline, and time spent stalled
    # waiting for input availability (pipelined schedule only)
    start_s: float = 0.0
    end_s: float = 0.0
    stall_s: float = 0.0

    @property
    def family(self) -> str:
        return fn_family(self.fn_name)

    @property
    def cost(self) -> float:
        return self.billed_gb_s * DEFAULT_LIMITS.gb_s_price


class LambdaContext:
    """Per-invocation context handed to the function body.

    The body does its arithmetic with numpy; the context tracks *modeled*
    time (transfer + compute + availability stalls) and *actual* registered
    buffer bytes. ``start_s`` anchors the invocation on the round's absolute
    timeline; when an :class:`AvailabilityMap` is attached (pipelined
    schedule), ``get``/``wait_key`` stall until the key's published time.
    """

    def __init__(self, runtime: "LambdaRuntime", memory_mb: float,
                 timeout_s: float, fn_name: str, attempt: int,
                 start_s: float = 0.0,
                 avail: AvailabilityMap | None = None,
                 limits: LambdaLimits | None = None):
        self._rt = runtime
        self.memory_mb = memory_mb
        self.timeout_s = timeout_s
        self.fn_name = fn_name
        self.attempt = attempt
        # per-invocation limits override: hierarchical topologies replace
        # the S3 transfer rates with the tier's link bandwidth (platform
        # caps and prices stay the runtime's)
        self.limits = runtime.limits if limits is None else limits
        self.read_bytes = 0
        self.write_bytes = 0
        self.compute_bytes = 0
        self.read_s = 0.0
        self.write_s = 0.0
        self.compute_s = 0.0
        self.stall_s = 0.0
        self.start_s = float(start_s)
        self._avail = avail
        self._held = 0
        self.peak_bytes = 0
        self.time_s = 0.0

    @property
    def now_s(self) -> float:
        """Absolute logical time inside this invocation (pre-slowdown)."""
        return self.start_s + self.time_s

    # -- memory -------------------------------------------------------------
    def alloc(self, nbytes: int) -> None:
        self._held += int(nbytes)
        self.peak_bytes = max(self.peak_bytes, self._held)
        used_mb = self.limits.runtime_overhead_mb + self.peak_bytes / MB
        if used_mb > self.memory_mb:
            raise LambdaOOM(
                f"{self.fn_name}: peak {used_mb:.0f} MB > allocated "
                f"{self.memory_mb:.0f} MB")

    def free(self, nbytes: int) -> None:
        self._held = max(0, self._held - int(nbytes))

    # -- availability (pipelined schedule) -----------------------------------
    def avail_time(self, key: str) -> float:
        """Published availability of ``key`` (0.0 under the barrier
        schedule, where phase structure already guarantees every input
        exists — so a read-ahead window degenerates to index order)."""
        if self._avail is None:
            return 0.0
        return self._avail.time_of(key)

    def wait_key(self, key: str) -> None:
        """Stall until ``key`` is available (no-op under the barrier
        schedule, whose phase structure already guarantees ordering)."""
        if self._avail is None:
            return
        stall = self._avail.time_of(key) - self.now_s
        if stall > 0.0:
            self.stall_s += stall
            self._advance(stall)

    def stall_until(self, time_s: float) -> None:
        """Array-driven twin of :meth:`wait_key`: stall until an absolute
        availability time computed by the caller rather than published in
        the map (the population engine's client contributions are never
        store keys). Same arithmetic — ``stall = t - now_s`` — so a
        virtualized fold replays the eager body's stalls bit-for-bit."""
        stall = float(time_s) - self.now_s
        if stall > 0.0:
            self.stall_s += stall
            self._advance(stall)

    # -- store I/O (billed time) ---------------------------------------------
    def get(self, store: ObjectStore, key: str):
        self.wait_key(key)
        value = store.get(key)
        nb = value.nbytes if hasattr(value, "nbytes") else len(value)
        self.read_bytes += nb
        t = self.limits.s3_get_latency_s + nb / (self.limits.s3_read_mbps
                                                 * 1e6)
        self.read_s += t
        # transient deserialization copy: the 3x formula's third buffer
        self.alloc(nb)
        self._advance(t)
        self.free(nb)
        return value

    def read_modeled(self, nbytes: int) -> None:
        """Account one GET of ``nbytes`` without a store object.

        The population engine models N client contributions that are never
        materialized as store keys; their reads are still billed traffic.
        Time split, ``read_bytes`` and the transient deserialization copy
        are identical to :meth:`get` — the store-side op/byte counters are
        settled in bulk by the driver via ``ObjectStore.account_io``."""
        nb = int(nbytes)
        self.read_bytes += nb
        t = self.limits.s3_get_latency_s + nb / (self.limits.s3_read_mbps
                                                 * 1e6)
        self.read_s += t
        self.alloc(nb)
        self._advance(t)
        self.free(nb)

    def put(self, store: ObjectStore, key: str, value, *,
            if_none_match: bool = False) -> bool:
        nb = value.nbytes if hasattr(value, "nbytes") else len(value)
        self.write_bytes += nb
        t = nb / (self.limits.s3_write_mbps * 1e6)
        self.write_s += t
        self._advance(t)
        return store.put(key, value, if_none_match=if_none_match)

    def write_modeled(self, nbytes: int) -> None:
        """Account one PUT of ``nbytes`` without a store object — the
        modeled twin of :meth:`put` (same time split and ``write_bytes``).
        The population engine uses it for virtualized intermediate
        partials that no later phase dereferences; the store-side op/byte
        counters are settled by the caller via ``ObjectStore.account_io``
        (mirroring the conditional PUT's first-write-wins accounting)."""
        nb = int(nbytes)
        self.write_bytes += nb
        t = nb / (self.limits.s3_write_mbps * 1e6)
        self.write_s += t
        self._advance(t)

    def compute(self, nbytes: int) -> None:
        """Model arithmetic over nbytes of data (element-wise accumulate)."""
        self.compute_bytes += int(nbytes)
        t = nbytes / AGG_COMPUTE_BPS
        self.compute_s += t
        self._advance(t)

    def work(self, seconds: float) -> None:
        """Model auxiliary CPU work at a caller-declared cost (e.g. a wire
        codec's payload decode, whose throughput the codec — not the
        accumulate constant — defines). Billed as compute time."""
        if seconds <= 0.0:
            return
        self.compute_s += seconds
        self._advance(seconds)

    def _advance(self, seconds: float) -> None:
        self.time_s += seconds
        if self.time_s > self.timeout_s:
            raise LambdaTimeout(
                f"{self.fn_name}: {self.time_s:.1f} s > timeout "
                f"{self.timeout_s:.0f} s")


class PhaseHandle:
    """One concurrent aggregation phase under the logical clock.

    Invocations issued through the handle run logically in parallel: the
    phase's wall-clock is the max duration over *winning* attempts (failed
    retries and speculative losers are billed but don't define the phase).
    Because invocation accounting is value-agnostic (keyed on byte counts,
    not array contents), a deferred execution engine can run a whole phase's
    invocations with lazy handles and batch the actual arithmetic afterwards
    while every per-invocation record stays identical.

    ``start_s`` anchors the phase on the absolute timeline (defaults to the
    runtime cursor). Under the barrier schedule every invocation launches at
    ``start_s``; the pipelined scheduler passes a per-invocation
    ``launch_s`` instead. When ``out_key`` is given, the winning attempt's
    completion publishes that key's availability through the event heap.
    """

    def __init__(self, runtime: "LambdaRuntime", start_s: float | None = None):
        self._rt = runtime
        self.start_s = runtime.now if start_s is None else float(start_s)
        self.end_s = self.start_s
        self.rec_start = len(runtime.records)
        self.winners: list[InvocationRecord] = []

    def invoke_reliable(self, fn, *, launch_s: float | None = None,
                        out_key: str | None = None,
                        wait_avail: bool = False, **kw):
        start = self.start_s if launch_s is None else float(launch_s)
        result, rec = self._rt.invoke_reliable(
            fn, start_s=start, wait_avail=wait_avail, **kw)
        self.winners.append(rec)
        self.end_s = max(self.end_s, rec.end_s)
        if out_key is not None:
            # completion event: publishes availability when the heap drains
            self._rt.sim.at(rec.end_s, self._rt.avail.publish, out_key,
                            rec.end_s, priority=1)
        return result, rec

    def hedge_last(self, fn, *, fn_name: str, memory_mb: float,
                   launch_s: float, out_key: str | None = None,
                   timeout_s: float | None = None,
                   limits: LambdaLimits | None = None) -> bool:
        """Launch a speculative hedge replica racing the phase's last
        reliable invocation: a single best-effort attempt under its own
        function name (own warm-pool slot, own failure stream), flagged
        ``speculative`` so it never counts as a retry. The earlier
        finisher becomes the invocation's winner — ties keep the primary
        (the event sim's deterministic tie-break) — and the loser stays
        billed. A winning hedge republishes ``out_key`` at its earlier
        completion (the availability map keeps the minimum, so
        first-finisher-wins composes with the primary's publish).
        Returns True iff the hedge won."""
        primary = self.winners[-1]
        _result, rec = self._rt.invoke(
            fn, fn_name=fn_name, memory_mb=memory_mb, timeout_s=timeout_s,
            attempt=0, speculative=True, start_s=launch_s, wait_avail=True,
            limits=limits)
        if rec.failed or rec.end_s >= primary.end_s:
            return False
        self.winners[-1] = rec
        self.end_s = max((r.end_s for r in self.winners),
                         default=self.start_s)
        if out_key is not None:
            self._rt.sim.at(rec.end_s, self._rt.avail.publish, out_key,
                            rec.end_s, priority=1)
        return True

    @property
    def wall_s(self) -> float:
        return max((r.duration_s for r in self.winners), default=0.0)

    @property
    def records(self) -> list[InvocationRecord]:
        """All attempts of this phase, incl. failed and speculative ones."""
        return self._rt.records[self.rec_start:]


class LambdaRuntime:
    """Invokes function bodies under platform semantics."""

    def __init__(self, limits: LambdaLimits | None = None,
                 faults: FaultPlan | None = None,
                 warm_pool_size: int | None = None):
        self.limits = limits or DEFAULT_LIMITS
        self.faults = faults or FaultPlan()
        self.warm_pool_size = warm_pool_size
        self.records: list[InvocationRecord] = []
        # cumulative billing over *all* invocations ever run, including
        # records dropped by compact() — keeps total_cost()/total_gb_s()
        # exact in bounded-memory long sessions
        self._billed_gb_s = 0.0
        self._warm: OrderedDict[str, bool] = OrderedDict()
        self.sim = EventSim()
        self.avail = AvailabilityMap()

    # ------------------------------------------------------------------
    @property
    def now(self) -> float:
        """The runtime's logical-clock cursor."""
        return self.sim.now

    def advance_to(self, time: float) -> None:
        self.sim.advance_to(time)

    def phase(self, start_s: float | None = None) -> PhaseHandle:
        """Start a concurrent phase (see :class:`PhaseHandle`)."""
        return PhaseHandle(self, start_s)

    def finish_phase(self, ph: PhaseHandle, *, barrier: bool = True) -> float:
        """Drain the event heap (deterministic completion/publish order) and
        advance the cursor: to ``start + wall_s`` under barrier semantics
        (retries bill but don't stretch the phase — the legacy arithmetic),
        or to the true max completion time under pipelined semantics.
        Returns the new cursor position."""
        self.sim.drain()
        end = ph.start_s + ph.wall_s if barrier else ph.end_s
        self.advance_to(end)
        return end

    # -- warm pool ------------------------------------------------------------
    def prewarm(self, *fn_names: str) -> None:
        """Provision warm containers for the given functions (or families):
        their next invocation skips the cold start. Models provisioned
        concurrency; the paper's Table IV excludes cold starts this way."""
        for name in fn_names:
            self._check_warm(fn_family(name))

    def is_warm(self, fn_name: str) -> bool:
        """Read-only warm-pool probe (no LRU touch, no eviction) — lets
        the round driver predict whether an invocation will cold-start
        without perturbing the pool it is predicting."""
        return fn_family(fn_name) in self._warm

    def _check_warm(self, family: str) -> bool:
        """True if the family has a warm container; touches LRU order and
        evicts beyond ``warm_pool_size``."""
        warm = family in self._warm
        self._warm[family] = True
        self._warm.move_to_end(family)
        if self.warm_pool_size is not None:
            while len(self._warm) > self.warm_pool_size:
                self._warm.popitem(last=False)
        return warm

    # ------------------------------------------------------------------
    def invoke(self, fn: Callable[[LambdaContext], Any], *, fn_name: str,
               memory_mb: float, timeout_s: float | None = None,
               attempt: int = 0, speculative: bool = False,
               start_s: float | None = None, wait_avail: bool = False,
               limits: LambdaLimits | None = None):
        """Run one invocation; returns (result, record). Raises on OOM (a
        permanent config error) but records injected faults for retry.
        ``limits`` overrides the runtime's platform model for this one
        invocation (tiered topologies vary the link bandwidths per tier;
        caps/prices are expected to match the runtime's)."""
        eff = self.limits if limits is None else limits
        if memory_mb > eff.max_memory_mb:
            raise LambdaOOM(
                f"{fn_name}: requested {memory_mb:.0f} MB > platform max "
                f"{eff.max_memory_mb} MB")
        timeout_s = timeout_s or eff.max_timeout_s
        start = self.now if start_s is None else float(start_s)
        ctx = LambdaContext(self, memory_mb, timeout_s, fn_name, attempt,
                            start_s=start,
                            avail=self.avail if wait_avail else None,
                            limits=eff)
        cold = not self._check_warm(fn_family(fn_name))
        if cold:
            ctx.time_s += eff.cold_start_s

        failed = False
        result = None
        raised: Exception | None = None
        try:
            if self.faults.failure(fn_name, attempt):
                # die midway: half the work billed, no output written
                ctx.time_s *= 0.5
                raise InjectedFault(f"{fn_name} attempt {attempt}")
            result = fn(ctx)
        except InjectedFault:
            failed = True
        except Exception as exc:
            # a body that raises (OOM, timeout, a bug) is still a crashed
            # container: bill the accrued duration, mark the record failed,
            # and re-raise after the finally block finishes accounting
            failed = True
            raised = exc
        finally:
            slow = self.faults.slowdown(fn_name, attempt)
            # the straggler multiplier stretches *work* (cold start, I/O,
            # compute), not availability stalls: waiting for an upload that
            # lands at a fixed absolute time doesn't slow with the CPU
            duration = (ctx.time_s - ctx.stall_s) * slow + ctx.stall_s
            billed = math.ceil(duration * 1000) / 1000  # 1 ms granularity
            rec = InvocationRecord(
                fn_name=fn_name, memory_mb=memory_mb, duration_s=duration,
                billed_gb_s=memory_mb / 1024.0 * billed, cold_start=cold,
                read_bytes=ctx.read_bytes, write_bytes=ctx.write_bytes,
                compute_bytes=ctx.compute_bytes,
                peak_memory_mb=eff.runtime_overhead_mb
                + ctx.peak_bytes / MB,
                attempt=attempt, failed=failed, speculative=speculative,
                read_s=ctx.read_s, write_s=ctx.write_s,
                compute_s=ctx.compute_s,
                start_s=start, end_s=start + duration,
                stall_s=ctx.stall_s)
            self.records.append(rec)
            self._billed_gb_s += rec.billed_gb_s
        if failed:
            # the container died with the attempt: release its warm-pool
            # slot so the retry (or the family's next round) cold-starts
            # instead of inheriting a phantom warm container
            self._warm.pop(fn_family(fn_name), None)
        if raised is not None:
            raise raised
        if failed:
            return None, rec
        return result, rec

    def invoke_reliable(self, fn, *, fn_name: str, memory_mb: float,
                        timeout_s: float | None = None, max_attempts: int = 3,
                        straggler_threshold_s: float | None = None,
                        start_s: float | None = None,
                        wait_avail: bool = False,
                        limits: LambdaLimits | None = None):
        """Invoke with retry-on-failure and optional speculative duplicate.

        Retries are safe because aggregators write with first-write-wins
        conditional PUTs (idempotent); a retry launches when its failed
        predecessor dies (``start_s`` chains through ``end_s``), plus the
        fault plan's ``retry_backoff_s`` doubling per further failure
        (0.0 — the default — is the legacy immediate relaunch). If the
        attempt's modeled duration exceeds ``straggler_threshold_s``, a
        speculative duplicate is launched and the faster of the two defines
        wall-clock (the paper's cold-start-variance mitigation, Kim et al.
        [26]).
        """
        last = None
        backoff = getattr(self.faults, "retry_backoff_s", 0.0)
        start = self.now if start_s is None else float(start_s)
        for attempt in range(max_attempts):
            result, rec = self.invoke(fn, fn_name=fn_name,
                                      memory_mb=memory_mb,
                                      timeout_s=timeout_s, attempt=attempt,
                                      start_s=start, wait_avail=wait_avail,
                                      limits=limits)
            last = rec
            if not rec.failed:
                if (straggler_threshold_s is not None
                        and rec.duration_s > straggler_threshold_s):
                    dup, dup_rec = self.invoke(
                        fn, fn_name=fn_name, memory_mb=memory_mb,
                        timeout_s=timeout_s, attempt=attempt + 100,
                        speculative=True, start_s=start,
                        wait_avail=wait_avail, limits=limits)
                    if not dup_rec.failed and \
                            dup_rec.duration_s < rec.duration_s:
                        return dup, dup_rec
                return result, rec
            # retry launches after the death, plus exponential backoff
            start = rec.end_s
            if backoff > 0.0:
                start += backoff * (2.0 ** attempt)
        raise RuntimeError(
            f"{fn_name}: all {max_attempts} attempts failed ({last})")

    # -- aggregate stats -----------------------------------------------------
    def total_cost(self) -> float:
        return self._billed_gb_s * self.limits.gb_s_price

    def total_gb_s(self) -> float:
        return self._billed_gb_s

    def compact(self) -> None:
        """Drop per-invocation records and published availability entries
        (both grow linearly with rounds in a long session) while keeping
        cumulative billing exact and the warm pool / logical clock intact.
        Called between rounds by ``FederatedSession`` when
        ``keep_records=False``; safe there because finished rounds' keys
        are never queried again (the keyspace is round-prefixed)."""
        self.records.clear()
        self.avail.clear()

    def reset(self) -> None:
        self.records.clear()
        self._billed_gb_s = 0.0
        self._warm.clear()
        self.sim.reset()
        self.avail.clear()
