"""Shard-parallel host execution: the :class:`ParallelFoldPool`.

The batched engine's CPU evaluator (:mod:`repro_torch.core.agg_engine`)
folds element ranges that are arithmetically independent: FedAvg is
element-wise, so element ``i``'s IEEE op sequence never depends on how
the index space is split across workers.  This module owns that split.
On a CUDA device the fold kernel owns the parallelism and the pool is
idle.

**Determinism contract.**  ``partition(size, workers, chunk)`` produces
contiguous, chunk-aligned element spans; each worker replays the exact
sequential op order inside its span.  Because the per-element op sequence
is independent of the split, the result is **bit-identical for every
worker count** (1, 2, 4, 8, …) and equal to the single-threaded
reference.
Parallelism here moves *wall-clock*, never bits.

**Sizing.**  The default worker count is the host's *real* core count
(``sched_getaffinity`` — container CPU masks respected — falling back to
``os.cpu_count()``), overridable per call (``workers=``, threaded from
``SessionConfig.workers`` through every driver) or via the
``REPRO_AGG_WORKERS`` env knob (precedence: explicit > env > auto; see
:mod:`repro_torch.knobs`).  Oversubscribing (``workers=8`` on a 2-core host)
is allowed — it changes nothing but scheduling, by the contract above.

torch releases the GIL inside the large element-wise ops these workers
run, so a thread pool gets real core-parallel speedup without the fork
cost or the pickling constraints of processes.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

from repro_torch import knobs

# Fold-chunk size in elements: 256 K elements = 1 MB f32 / 2 MB f64, small
# enough that a running accumulator stays cache-resident (measured ~1.6x
# over full-size temporaries on 2-core hosts, more where DRAM is slower).
CHUNK_ELEMS = 1 << 18
# Below this many total elements a fold stays single-threaded (the pool
# hand-off costs more than it saves on test-sized arrays).
PARALLEL_MIN_ELEMS = 1 << 21


def host_cores() -> int:
    """The host's *usable* core count: the scheduling affinity mask when
    the platform exposes one (container/cgroup CPU masks respected), else
    ``os.cpu_count()``."""
    try:
        return max(1, len(os.sched_getaffinity(0)))
    except AttributeError:                    # non-Linux
        return max(1, os.cpu_count() or 1)


def get_workers(workers: int | str | None = None) -> int:
    """Resolve the fold-pool worker knob: an int >= 1, or ``None``/"auto"
    (env ``REPRO_AGG_WORKERS``, else the host's real core count)."""
    if workers is None or workers == "auto":
        workers = knobs.env_workers()
        if workers is None or workers == "auto":
            return host_cores()
    try:
        w = int(workers)
        if w != float(workers):          # reject silent 1.5 -> 1 truncation
            raise ValueError
    except (TypeError, ValueError):
        raise ValueError(f"workers must be an integer >= 1 or 'auto', "
                         f"got {workers!r}") from None
    if w < 1:
        raise ValueError(f"workers must be >= 1, got {w}")
    return w


def partition(size: int, workers: int,
              chunk: int = CHUNK_ELEMS) -> list[tuple[int, int]]:
    """Deterministic per-worker work split of ``range(size)``.

    Contiguous spans, one per worker at most, each a multiple of
    ``chunk`` except the last — so a worker's chunk walk lines up with
    the single-threaded evaluator's and partial chunks only ever occur at
    the tail.  Pure function of ``(size, workers, chunk)``; the spans
    cover ``[0, size)`` exactly, in order.
    """
    if size <= 0:
        return []
    if workers <= 1:
        return [(0, size)]
    span = -(-size // workers)
    span += (-span) % chunk                   # align splits to chunks
    return [(lo, min(lo + span, size)) for lo in range(0, size, span)]


class ParallelFoldPool:
    """A sized worker pool + the deterministic work-partitioning API.

    One instance serves a whole session (or process — see
    :func:`get_pool`); the executor spins up lazily on first parallel
    use, so ``workers=1`` (and every sub-threshold fold) never pays for
    threads.  ``run_spans(fn, size)`` is the single entry point the
    evaluators use: it partitions ``[0, size)`` with :func:`partition`
    and calls ``fn(lo, hi)`` once per span — inline when one span
    suffices, on the pool otherwise.  Exceptions propagate to the
    caller either way.
    """

    def __init__(self, workers: int | str | None = None, *,
                 chunk: int = CHUNK_ELEMS,
                 min_parallel_elems: int = PARALLEL_MIN_ELEMS):
        self.workers = get_workers(workers)
        self.chunk = chunk
        self.min_parallel_elems = min_parallel_elems
        self._executor: ThreadPoolExecutor | None = None
        self._lock = threading.Lock()

    # -- work partitioning ---------------------------------------------------
    def spans(self, size: int,
              chunk: int | None = None) -> list[tuple[int, int]]:
        """The spans ``run_spans`` would execute for a ``size``-element
        fold: one span (single-threaded) below ``min_parallel_elems``,
        the chunk-aligned :func:`partition` otherwise.  ``chunk``
        overrides the pool's alignment quantum (evaluators that chunk at
        a custom granularity keep their splits aligned to it)."""
        if size < self.min_parallel_elems or self.workers <= 1:
            return [(0, size)] if size > 0 else []
        return partition(size, self.workers, chunk or self.chunk)

    # -- execution -----------------------------------------------------------
    def _pool(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=self.workers,
                    thread_name_prefix="repro-fold")
        return self._executor

    def run_spans(self, fn, size: int, chunk: int | None = None) -> None:
        """Run ``fn(lo, hi)`` over the deterministic spans of ``size``."""
        spans = self.spans(size, chunk)
        if len(spans) <= 1:
            for lo, hi in spans:
                fn(lo, hi)
            return
        self.map(fn, spans)

    def map(self, fn, tasks) -> list:
        """``[fn(*t) for t in tasks]``, on the pool when it helps.

        Results keep task order; any worker exception re-raises here."""
        tasks = list(tasks)
        if self.workers <= 1 or len(tasks) <= 1:
            return [fn(*t) for t in tasks]
        return list(self._pool().map(lambda t: fn(*t), tasks))

    def close(self) -> None:
        with self._lock:
            if self._executor is not None:
                self._executor.shutdown(wait=True)
                self._executor = None

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"ParallelFoldPool(workers={self.workers})"


# ---------------------------------------------------------------------------
# Process-wide pool cache
# ---------------------------------------------------------------------------

_POOLS: dict[int, ParallelFoldPool] = {}
_POOLS_LOCK = threading.Lock()


def get_pool(workers: int | str | None = None) -> ParallelFoldPool:
    """The process-wide pool for a resolved worker count.

    Backends and drivers call this per round; caching per count means a
    1000-round sweep reuses one executor instead of spawning threads
    every round, while sessions with different ``workers`` knobs coexist.
    """
    w = get_workers(workers)
    with _POOLS_LOCK:
        pool = _POOLS.get(w)
        if pool is None:
            pool = _POOLS[w] = ParallelFoldPool(w)
        return pool
