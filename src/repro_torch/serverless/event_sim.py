"""Discrete-event simulation core for the serverless runtime.

Three small, composable pieces:

  * :class:`EventSim` — a binary event heap with a logical cursor (``now``)
    and **deterministic tie-breaking**: events fire in ``(time, priority,
    seq)`` order, where ``seq`` is the scheduling sequence number, so two
    events at the same instant always replay in the order they were
    scheduled, independent of hash order or thread timing.
  * :class:`Timeline` — a per-entity logical clock (a client's uplink, an
    aggregator invocation, a download stream). Entities advance their own
    timelines independently; cross-entity synchronisation happens through
    events and the availability map, never through a shared mutable clock.
  * :class:`AvailabilityMap` — publish/query times at which object-store
    keys become readable. First-write-wins: publishing an earlier time for
    an already-published key keeps the minimum (a speculative duplicate
    that finishes first defines availability, exactly like its conditional
    PUT defines the stored value).
  * :class:`ReadAheadWindow` — the bounded out-of-order prefetch schedule
    of the pipelined round schedule's ``readahead_k`` knob: fetch up to
    ``k`` contributions ahead of the fold frontier (deterministic
    ``(time, index)`` tie-breaking), fold strictly in index order. Shared
    by the simulated aggregator bodies and the analytical cost model.

:class:`~repro_torch.serverless.runtime.LambdaRuntime` owns one ``EventSim`` and
one ``AvailabilityMap``; scheduling policies (barrier vs pipelined, see
:mod:`repro_torch.core.aggregation`) are built on top. The heap is drained at
phase boundaries with :meth:`EventSim.drain`, which fires events in
deterministic order **without** moving the cursor — round drivers move the
cursor explicitly via :meth:`EventSim.advance_to` so the legacy barrier
wall-clock arithmetic stays bit-identical to the pre-event-sim runtime.
"""
from __future__ import annotations

import heapq
import math
from typing import Any, Callable

INF = math.inf


class Event:
    """One scheduled callback. Ordered by ``(time, priority, seq)``."""

    __slots__ = ("time", "priority", "seq", "fn", "args")

    def __init__(self, time: float, priority: int, seq: int,
                 fn: Callable[..., Any] | None, args: tuple):
        self.time = time
        self.priority = priority
        self.seq = seq
        self.fn = fn
        self.args = args

    def _key(self):
        return (self.time, self.priority, self.seq)

    def __lt__(self, other: "Event") -> bool:
        return self._key() < other._key()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        name = getattr(self.fn, "__name__", repr(self.fn))
        return f"Event(t={self.time:.6g}, prio={self.priority}, " \
               f"seq={self.seq}, fn={name})"


class EventSim:
    """Deterministic discrete-event engine.

    ``at``/``after`` push events; ``run`` pops them in ``(time, priority,
    seq)`` order, advancing ``now`` to each event's time; ``drain`` pops in
    the same order but leaves ``now`` alone (used at phase boundaries where
    the round driver owns cursor movement). Events may be scheduled earlier
    than ``now`` — pipelined multi-round drivers overlap rounds, so a new
    round's upload events can legitimately predate the cursor left by the
    previous round's barrier bookkeeping.
    """

    def __init__(self) -> None:
        self._heap: list[Event] = []
        self._seq = 0
        self.now = 0.0
        self.fired = 0

    def __len__(self) -> int:
        return len(self._heap)

    # -- scheduling ----------------------------------------------------------
    def at(self, time: float, fn: Callable[..., Any] | None = None,
           *args: Any, priority: int = 0) -> Event:
        ev = Event(float(time), priority, self._seq, fn, args)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    def after(self, delay: float, fn: Callable[..., Any] | None = None,
              *args: Any, priority: int = 0) -> Event:
        return self.at(self.now + delay, fn, *args, priority=priority)

    def peek_time(self) -> float:
        return self._heap[0].time if self._heap else INF

    # -- execution -----------------------------------------------------------
    def _fire(self, ev: Event) -> None:
        self.fired += 1
        if ev.fn is not None:
            ev.fn(*ev.args)

    def run(self, until: float = INF) -> float:
        """Pop and fire events with ``time <= until``, advancing ``now``
        monotonically to each event's time. Returns the final ``now``."""
        while self._heap and self._heap[0].time <= until:
            ev = heapq.heappop(self._heap)
            if ev.time > self.now:
                self.now = ev.time
            self._fire(ev)
        return self.now

    def drain(self) -> int:
        """Fire every pending event in deterministic order without moving
        the cursor. Returns the number of events fired."""
        n = 0
        while self._heap:
            self._fire(heapq.heappop(self._heap))
            n += 1
        return n

    def advance_to(self, time: float) -> None:
        """Move the cursor forward (no-op for past times)."""
        if time > self.now:
            self.now = float(time)

    def reset(self) -> None:
        self._heap.clear()
        self.now = 0.0
        self.fired = 0


class Timeline:
    """Per-entity logical clock.

    ``advance`` models the entity doing work; ``wait_until`` models the
    entity stalling for an external dependency and returns the stall
    duration (0 when the dependency is already in the past).
    """

    __slots__ = ("t",)

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def advance(self, duration: float) -> float:
        self.t += duration
        return self.t

    def wait_until(self, time: float) -> float:
        stall = time - self.t
        if stall <= 0.0:
            return 0.0
        self.t = float(time)
        return stall


class ReadAheadWindow:
    """Bounded out-of-order prefetch scheduler for a streaming fold.

    An aggregator folds contributions **strictly in index order** (the
    bit-reproducibility contract), but may GET up to ``k`` contributions
    at-or-ahead of the fold frontier into a bounded buffer, so a late
    low-index upload no longer blocks every later read (the head-of-line
    stall of the plain pipelined schedule). ``k = 1`` is exactly the
    legacy behavior: the window holds only the frontier, so fetches happen
    in index order and the buffer never exceeds the 2-buffer streaming
    bound; general ``k`` bounds the buffer at ``k`` inputs (peak memory
    ``(k+1)``·input alongside the running accumulator).

    The schedule is deterministic: among window keys already available the
    **lowest index** is fetched first (the frontier unblocks the fold
    soonest); when none is available, the earliest prefetch-completion
    event — ordered by ``(availability time, index)``, the same
    tie-breaking discipline as the event heap — defines the next fetch.
    Both the discrete-event runtime and the analytical cost model drive
    this one class, which is what keeps them in lock-step to float
    epsilon.
    """

    __slots__ = ("avail", "k", "n", "frontier", "_buffered")

    def __init__(self, avail_s, k: int = 1):
        self.k = int(k)
        if self.k < 1:
            raise ValueError(f"readahead_k must be >= 1, got {k!r}")
        self.avail = [float(a) for a in avail_s]
        self.n = len(self.avail)
        self.frontier = 0            # next index to fold
        self._buffered: set[int] = set()   # fetched, not yet folded

    @classmethod
    def launch_s(cls, avail_s, k: int = 1) -> float:
        """When a windowed aggregator launches: the earliest availability
        among the first ``min(k, n)`` inputs (``k = 1`` degenerates to the
        legacy first-in-index-order gating)."""
        window = list(avail_s[:max(1, min(int(k), len(avail_s)))])
        return min(window) if window else 0.0

    @property
    def done(self) -> bool:
        return self.frontier >= self.n

    @property
    def foldable(self) -> bool:
        """True when the frontier contribution is buffered (fold it now)."""
        return self.frontier in self._buffered

    def window(self) -> range:
        return range(self.frontier, min(self.frontier + self.k, self.n))

    def next_fetch(self, now: float) -> int | None:
        """Index of the next contribution to GET at time ``now`` (stall
        until its availability if it hasn't landed), or ``None`` when the
        whole window is already buffered."""
        cand = [j for j in self.window() if j not in self._buffered]
        if not cand:
            return None
        for j in cand:                       # lowest available index wins
            if self.avail[j] <= now:
                return j
        return min(cand, key=lambda j: (self.avail[j], j))

    def fetched(self, j: int) -> None:
        self._buffered.add(j)

    def folded(self) -> None:
        """Consume the frontier contribution and advance the window."""
        self._buffered.discard(self.frontier)
        self.frontier += 1


def arrival_order(avail_s, *, quorum: int | None = None,
                  deadline_s: float | None = None) -> list[int]:
    """Deterministic arrival cut for the quorum/deadline round drivers.

    Returns the indices of ``avail_s`` sorted by ``(time, index)`` — the
    same tie-breaking discipline as the event heap and the read-ahead
    window — restricted to arrivals at or before ``deadline_s`` (when
    given) and truncated to the first ``quorum`` (when given). This is
    the FedBuff-style frontier rule: the fold fires on the ``quorum``-th
    buffered contribution, in arrival order, and stragglers beyond the
    cut are excluded from the round.
    """
    order = sorted(range(len(avail_s)), key=lambda j: (avail_s[j], j))
    if deadline_s is not None:
        order = [j for j in order if avail_s[j] <= deadline_s]
    if quorum is not None:
        if quorum < 1:
            raise ValueError(f"quorum must be >= 1, got {quorum}")
        order = order[:int(quorum)]
    return order


class AvailabilityMap:
    """Key -> earliest time the object under that key is readable.

    Unpublished keys default to time 0.0 (always available): the legacy
    barrier schedule never registers uploads, and its phase structure
    already guarantees ordering, so a zero default makes availability
    waits a strict no-op there.
    """

    __slots__ = ("_t",)

    def __init__(self) -> None:
        self._t: dict[str, float] = {}

    def publish(self, key: str, time: float) -> None:
        prev = self._t.get(key)
        if prev is None or time < prev:
            self._t[key] = float(time)

    def time_of(self, key: str, default: float = 0.0) -> float:
        return self._t.get(key, default)

    def known(self, key: str) -> bool:
        return key in self._t

    def clear(self) -> None:
        self._t.clear()
