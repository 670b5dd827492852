"""S3-simulating object store.

The communication substrate for all three aggregation architectures (paper:
"PyWren-style object storage as the data plane"). Tracks every PUT/GET with
byte counts so benchmarks recover the paper's Table II op counts and dollar
costs exactly. First-write-wins conditional PUTs give idempotent aggregator
retries (fault tolerance / speculative straggler duplicates).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field

import torch


class NoSuchKey(KeyError):
    pass


@dataclass
class StoreStats:
    puts: int = 0
    gets: int = 0
    deletes: int = 0
    bytes_written: int = 0
    bytes_read: int = 0
    put_log: list = field(default_factory=list)   # (key, nbytes)
    get_log: list = field(default_factory=list)

    def reset(self) -> None:
        self.puts = self.gets = self.deletes = 0
        self.bytes_written = self.bytes_read = 0
        self.put_log.clear()
        self.get_log.clear()


def _nbytes(value) -> int:
    if isinstance(value, torch.Tensor):
        return int(value.nbytes)
    if isinstance(value, (bytes, bytearray)):
        return len(value)
    if hasattr(value, "nbytes"):          # lazy handles (simulation mode)
        return int(value.nbytes)
    return int(torch.as_tensor(value).nbytes)


class ObjectStore:
    """In-memory object store with S3 semantics (flat keyspace, atomic
    whole-object PUT/GET, list-by-prefix, eventual-consistency-free).

    ``log_ops=False`` keeps every aggregate counter (op counts, byte
    totals) exact but skips the per-op ``put_log``/``get_log`` appends —
    the mode million-client rounds need so a round's op log does not
    itself grow O(N·M) even when the session keeps records."""

    def __init__(self, *, log_ops: bool = True) -> None:
        self._objects: dict[str, torch.Tensor | bytes] = {}
        self._lock = threading.Lock()
        self.stats = StoreStats()
        self.log_ops = bool(log_ops)

    # -- data plane ---------------------------------------------------------
    def put(self, key: str, value, *, if_none_match: bool = False) -> bool:
        """PUT. With ``if_none_match`` (S3 conditional write), the PUT is a
        no-op if the key exists — first write wins. Returns True if stored."""
        if isinstance(value, torch.Tensor):
            value = value.contiguous()
        with self._lock:
            if if_none_match and key in self._objects:
                return False
            self._objects[key] = value
            self.stats.puts += 1
            nb = _nbytes(value)
            self.stats.bytes_written += nb
            if self.log_ops:
                self.stats.put_log.append((key, nb))
            return True

    def get(self, key: str):
        with self._lock:
            if key not in self._objects:
                raise NoSuchKey(key)
            value = self._objects[key]
            self.stats.gets += 1
            nb = _nbytes(value)
            self.stats.bytes_read += nb
            if self.log_ops:
                self.stats.get_log.append((key, nb))
            return value

    def account_gets(self, key: str, count: int) -> int:
        """Account ``count`` GETs of ``key`` in O(1) without re-reading it.

        Large-N round simulations issue N·M *redundant* client read-backs
        whose only observable effect is op/byte accounting (every client
        reads the same averaged shards); looping ``store.get`` over them
        burns host time linear in N·M. This bumps ``puts/gets``-visible
        stats (op count, bytes) in one lock acquisition. The per-op
        ``get_log`` is a debugging aid for individually issued GETs and is
        deliberately not expanded. Returns the object's byte size."""
        if count < 0:
            raise ValueError(f"count must be >= 0, got {count}")
        with self._lock:
            if key not in self._objects:
                raise NoSuchKey(key)
            nb = _nbytes(self._objects[key])
            self.stats.gets += count
            self.stats.bytes_read += count * nb
            return nb

    def account_io(self, *, puts: int = 0, gets: int = 0,
                   bytes_written: int = 0, bytes_read: int = 0) -> None:
        """Keyless bulk op accounting for lazily simulated traffic.

        The population engine models N client uploads without ever
        materializing N store objects; the ops and bytes are still real
        billed traffic and must land in ``stats`` exactly. One lock
        acquisition, aggregate counters only (never the op logs)."""
        if min(puts, gets, bytes_written, bytes_read) < 0:
            raise ValueError("account_io counts must be >= 0")
        with self._lock:
            self.stats.puts += int(puts)
            self.stats.gets += int(gets)
            self.stats.bytes_written += int(bytes_written)
            self.stats.bytes_read += int(bytes_read)

    # -- simulation plane (not billed, no stats) ------------------------------
    def peek(self, key: str):
        """Read without touching stats. Simulation-internal: used by deferred
        aggregation engines to materialize lazy values whose GETs were
        already accounted during the simulated invocation."""
        with self._lock:
            if key not in self._objects:
                raise NoSuchKey(key)
            return self._objects[key]

    def swap(self, key: str, value) -> None:
        """Replace a stored object in place without touching stats. Used to
        substitute a materialized tensor for the lazy handle that was PUT
        (and billed) during the simulated invocation."""
        with self._lock:
            if key not in self._objects:
                raise NoSuchKey(key)
            if isinstance(value, torch.Tensor):
                value = value.contiguous()
            self._objects[key] = value

    def head(self, key: str) -> int:
        """Metadata-only existence/size check (not billed as a GET here;
        S3 HEADs are billed like GETs — tracked separately if needed)."""
        with self._lock:
            if key not in self._objects:
                raise NoSuchKey(key)
            return _nbytes(self._objects[key])

    def exists(self, key: str) -> bool:
        with self._lock:
            return key in self._objects

    def delete(self, key: str) -> None:
        with self._lock:
            self._objects.pop(key, None)
            self.stats.deletes += 1

    def list(self, prefix: str = "") -> list[str]:
        with self._lock:
            return sorted(k for k in self._objects if k.startswith(prefix))

    def total_bytes(self) -> int:
        with self._lock:
            return sum(_nbytes(v) for v in self._objects.values())

    def clear(self) -> None:
        with self._lock:
            self._objects.clear()
