"""Seeded fault model for fault-tolerant aggregation rounds.

Production serverless FL treats client dropout, upload stalls and Lambda
invocation failures as the norm (FedLess builds failure handling into its
aggregator; IBM's adaptive aggregation advances on a participation quorum
rather than a barrier). :class:`FaultModel` is the single seeded source of
every such disturbance the simulator injects:

  * **participation sampling** — ``participants(n, rnd, k)`` draws the K
    of N clients invited to a round (``SessionConfig.participation_k``);
  * **client dropout** — ``dropout_plan(n, rnd)`` marks participants that
    never start their upload (device died / went offline mid-round);
  * **upload stalls** — ``stall_plan(n, rnd)`` adds a fixed extra delay
    before a stalled client's first PUT (a network brown-out);
  * **aggregator invocation failures** — ``failure(fn_name, attempt)``
    kills a Lambda attempt at launch (the cold-start/invocation failure
    mode FedLess reports as dominant); the runtime retries with
    ``retry_backoff_s``-exponential backoff and first-write-wins PUTs
    keep retries idempotent.

Every stream is deterministic and *independent*:

  * per-client draws are keyed by the client's **cohort index** (streams
    ``[seed, rnd, STREAM]`` of cohort length), so client ``i``'s fate is
    the same whether or not other clients are sampled, and adding one
    stream never perturbs another — the same discipline as
    :meth:`repro_torch.core.cost_model.UploadModel.plan` / ``compute_plan``;
  * per-invocation failure draws are keyed by ``(seed, crc32(fn_name),
    attempt)``, so they are independent of invocation *order* (barrier
    vs pipelined vs quorum replay the same failures).

``failure`` injects at most ``max_failures`` consecutive failures per
invocation, and validation keeps ``max_failures`` below the runtime's
retry budget — a seeded faulty round always completes (the simulator
asserts graceful degradation, not crash loops).

**Stale re-entry determinism contract.** A dropped/late client's round-r
gradient persists in a per-session :class:`StaleBuffer` and re-enters a
later round's fold weighted by a :class:`StalenessPolicy`. Everything
about re-entry is a pure function of ``(seed, round)``: a late client's
re-entry time is its probed upload completion (drawn from the same
membership-independent ``[seed, rnd, STREAM]`` cohort streams above), a
dropped client's is that probed completion plus the policy's fixed
``reentry_delay_s``, and eligibility is decided against the round's
deterministic cut (deadline, q-th fresh arrival, or fresh upload span).
No new random stream is introduced, so stale re-entry replays
identically across engines and schedules, and a round that folds no
stale entries is bit-for-bit the zero-policy path.

The model duck-types :class:`repro_torch.serverless.runtime.FaultPlan`
(``failure``/``slowdown``/``retry_backoff_s``), so it plugs straight into
``LambdaRuntime(faults=...)``; the round driver binds it there itself
when handed one (see ``run_round(faults=...)``).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np

from repro_torch import knobs

# per-round substream ids (UploadModel owns [seed, rnd] and [seed, rnd, 1])
_S_PARTICIPATION = 11
_S_DROPOUT = 12
_S_STALL = 13
# failure draws are round-free: fn_name already carries the round prefix
_S_FAILURE = 14

#: the runtime retries up to this many attempts (LambdaRuntime.invoke_reliable)
MAX_ATTEMPTS = 3


@dataclass(frozen=True)
class FaultModel:
    """Seeded, deterministic disturbance generator for one session.

    All rates are probabilities in ``[0, 1]``; every field defaults to
    "off", and an all-default model is a strict no-op (zero-fault rounds
    stay bit-identical to the fault-free driver path).
    """

    dropout_rate: float = 0.0      # P(a participant never uploads)
    stall_rate: float = 0.0        # P(a participant's upload stalls)
    stall_s: float = 0.0           # extra seconds a stalled upload waits
    failure_rate: float = 0.0      # P(an aggregator attempt dies at launch)
    max_failures: int = MAX_ATTEMPTS - 1   # consecutive failures injected, cap
    retry_backoff_s: float = 0.0   # base backoff before a retry (doubles)
    seed: int = 0

    def __post_init__(self) -> None:
        for name in ("dropout_rate", "stall_rate", "failure_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"FaultModel.{name} must be in [0, 1], "
                                 f"got {v!r}")
        if self.stall_s < 0.0 or self.retry_backoff_s < 0.0:
            raise ValueError("FaultModel.stall_s/retry_backoff_s must be "
                             ">= 0")
        if not 0 <= self.max_failures < MAX_ATTEMPTS:
            raise ValueError(
                f"FaultModel.max_failures must be in [0, {MAX_ATTEMPTS - 1}] "
                f"(the runtime retries {MAX_ATTEMPTS} attempts, and a seeded "
                f"round must always complete), got {self.max_failures!r}")

    # -- seeded per-round streams -------------------------------------------
    def participants(self, n: int, rnd: int, k: int) -> tuple:
        """The K of N cohort indices invited to round ``rnd`` (sorted)."""
        if not 1 <= k <= n:
            raise ValueError(f"participation_k must be in [1, {n}], got {k}")
        if k == n:
            return tuple(range(n))
        rng = np.random.default_rng([self.seed, rnd, _S_PARTICIPATION])
        return tuple(sorted(rng.choice(n, size=k, replace=False).tolist()))

    def dropout_plan(self, n: int, rnd: int) -> np.ndarray:
        """Boolean dropout flags keyed by cohort index."""
        if self.dropout_rate <= 0.0:
            return np.zeros(n, dtype=bool)
        rng = np.random.default_rng([self.seed, rnd, _S_DROPOUT])
        return rng.random(n) < self.dropout_rate

    def stall_plan(self, n: int, rnd: int) -> np.ndarray:
        """Per-client extra upload delay (seconds) keyed by cohort index."""
        if self.stall_rate <= 0.0 or self.stall_s <= 0.0:
            return np.zeros(n)
        rng = np.random.default_rng([self.seed, rnd, _S_STALL])
        return np.where(rng.random(n) < self.stall_rate, self.stall_s, 0.0)

    # -- lazy cohort-slice variants (the population engine's entries:
    # O(len(idx)) draws, bit-identical to the full plan sliced at idx) ----
    def participants_arr(self, n: int, rnd: int, k: int) -> np.ndarray:
        """:meth:`participants` as an int64 array — million-client
        cohorts skip the O(N) Python tuple (same draws, same order)."""
        if not 1 <= k <= n:
            raise ValueError(f"participation_k must be in [1, {n}], got {k}")
        if k == n:
            return np.arange(n, dtype=np.int64)
        rng = np.random.default_rng([self.seed, rnd, _S_PARTICIPATION])
        return np.sort(rng.choice(n, size=k, replace=False)).astype(np.int64)

    def dropout_at(self, n: int, rnd: int, idx) -> np.ndarray:
        """:meth:`dropout_plan` flags at cohort indices ``idx``."""
        from repro_torch.serverless.streams import gather_stream
        if self.dropout_rate <= 0.0:
            return np.zeros(len(idx), dtype=bool)
        u = gather_stream([self.seed, rnd, _S_DROPOUT], idx,
                          lambda r, m: r.random(m))
        return u < self.dropout_rate

    def stall_at(self, n: int, rnd: int, idx) -> np.ndarray:
        """:meth:`stall_plan` delays at cohort indices ``idx``."""
        from repro_torch.serverless.streams import gather_stream
        if self.stall_rate <= 0.0 or self.stall_s <= 0.0:
            return np.zeros(len(idx))
        u = gather_stream([self.seed, rnd, _S_STALL], idx,
                          lambda r, m: r.random(m))
        return np.where(u < self.stall_rate, self.stall_s, 0.0)

    # -- FaultPlan interface (consumed by LambdaRuntime) ---------------------
    def failure(self, fn_name: str, attempt: int) -> bool:
        """Whether this (invocation, attempt) dies at launch. Keyed by the
        function name (not call order), so barrier/pipelined/quorum replays
        inject identical failures; capped at ``max_failures`` consecutive
        deaths so retry always converges."""
        if self.failure_rate <= 0.0 or attempt >= self.max_failures:
            return False
        rng = np.random.default_rng(
            [self.seed, _S_FAILURE, zlib.crc32(fn_name.encode()), attempt])
        return bool(rng.random() < self.failure_rate)

    def slowdown(self, fn_name: str, attempt: int) -> float:
        return 1.0

    @property
    def is_empty(self) -> bool:
        return (self.dropout_rate <= 0.0 and self.stall_rate <= 0.0
                and self.failure_rate <= 0.0 and self.retry_backoff_s <= 0.0)


_STALENESS_KINDS = ("constant", "polynomial", "cutoff")


@dataclass(frozen=True)
class StalenessPolicy:
    """How much a stale gradient counts when it re-enters a later fold.

    ``weight(s)`` maps a staleness ``s = fold_round - origin_round``
    (always >= 1) to a fold weight; fresh contributions always weigh 1.0.

      * ``constant`` — stale counts like fresh (weight 1.0);
      * ``polynomial`` — ``1 / (1 + s) ** alpha``, the FedBuff-style
        polynomial staleness discount;
      * ``cutoff`` — weight 1.0 up to ``max_staleness``, discarded after.

    ``max_staleness`` composes with any kind (entries older than S are
    dropped from the buffer); ``cutoff`` requires it. ``reentry_delay_s``
    is the fixed extra delay before a *dropped* client's gradient becomes
    available again (its device retries the upload after coming back);
    late clients re-enter at their probed upload completion unchanged.
    Deterministic: ``weight`` draws no randomness.
    """

    kind: str = "polynomial"
    alpha: float = 0.5
    max_staleness: int | None = None
    reentry_delay_s: float = 0.0

    def __post_init__(self) -> None:
        if self.kind not in _STALENESS_KINDS:
            raise ValueError(f"StalenessPolicy.kind must be one of "
                             f"{_STALENESS_KINDS}, got {self.kind!r}")
        if self.alpha < 0.0:
            raise ValueError("StalenessPolicy.alpha must be >= 0")
        if self.reentry_delay_s < 0.0:
            raise ValueError("StalenessPolicy.reentry_delay_s must be >= 0")
        if self.max_staleness is not None and self.max_staleness < 1:
            raise ValueError("StalenessPolicy.max_staleness must be >= 1")
        if self.kind == "cutoff" and self.max_staleness is None:
            raise ValueError("StalenessPolicy(kind='cutoff') requires "
                             "max_staleness")

    def weight(self, staleness: int) -> float:
        """Fold weight of a gradient ``staleness`` rounds old (0.0 = drop)."""
        if staleness < 1:
            raise ValueError(f"staleness must be >= 1, got {staleness}")
        if self.max_staleness is not None and staleness > self.max_staleness:
            return 0.0
        if self.kind == "polynomial":
            return (1.0 + float(staleness)) ** -self.alpha
        return 1.0


@dataclass(frozen=True)
class StaleEntry:
    """One buffered stale contribution: who, from which round, available
    when (absolute session time), and the gradient itself (held by
    reference — callers must not mutate round gradients after the fact)."""

    client: int
    origin_rnd: int
    ready_s: float
    grad: object    # np.ndarray; object-typed to keep the dataclass frozen


class StaleBuffer:
    """Per-session FIFO of dropped/late clients' gradients awaiting re-entry.

    The round driver ``add``s entries when a client is cut (deterministic
    insertion order: late clients in cohort-index order, then dropped
    clients in cohort-index order, per round) and ``take_ready``s the
    eligible ones at the next round's cut. Entries whose policy weight
    has decayed to zero (``cutoff`` past ``max_staleness``) are pruned —
    staleness only grows, so they could never fold later.
    """

    def __init__(self) -> None:
        self._entries: list[StaleEntry] = []

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def entries(self) -> tuple:
        return tuple(self._entries)

    def add(self, client: int, origin_rnd: int, ready_s: float,
            grad) -> None:
        self._entries.append(
            StaleEntry(int(client), int(origin_rnd), float(ready_s), grad))

    def take_ready(self, cut_s: float, rnd: int,
                   policy: StalenessPolicy) -> list:
        """Pop entries available by ``cut_s`` with nonzero weight at round
        ``rnd``; returns ``[(entry, weight), ...]`` in buffer order and
        prunes expired entries."""
        taken, kept = [], []
        for e in self._entries:
            w = policy.weight(rnd - e.origin_rnd) if rnd > e.origin_rnd \
                else 1.0
            if w <= 0.0:
                continue            # expired for good — prune
            if e.ready_s <= cut_s and rnd > e.origin_rnd:
                taken.append((e, w))
            else:
                kept.append(e)
        self._entries = kept
        return taken


def fault_model_from_env(env: str = "REPRO_AGG_FAULTS",
                         seed: int = 0) -> FaultModel | None:
    """Opt-in env resolution of a fault model for tests and examples.

    ``REPRO_AGG_FAULTS`` unset/empty/``off``/``0`` -> ``None`` (no faults);
    ``on`` -> a canonical nonzero model (the CI fault matrix job); a float
    ``r`` -> dropout/stall/failure all at rate ``r``. Sessions never read
    this env themselves — injected faults change walls and billing, so
    fault injection is strictly explicit (``SessionConfig.faults``); this
    helper just gives the opt-in callers one shared spelling (the
    canonical knob read lives in :mod:`repro_torch.knobs`; a non-default
    ``env`` name reads that variable instead).
    """
    raw = (knobs.env_faults() if env == knobs.ENV_FAULTS
           else knobs.env_raw(env)).strip().lower()
    if raw in ("", "off", "0", "0.0", "false", "none"):
        return None
    if raw in ("on", "true", "1"):
        return FaultModel(dropout_rate=0.1, stall_rate=0.1, stall_s=4.0,
                          failure_rate=0.25, retry_backoff_s=0.5, seed=seed)
    try:
        rate = float(raw)
    except ValueError:
        raise ValueError(
            f"{env} must be 'on', 'off' or a rate in [0, 1], got {raw!r}"
        ) from None
    return FaultModel(dropout_rate=rate, stall_rate=rate, stall_s=4.0,
                      failure_rate=rate, retry_backoff_s=0.5, seed=seed)
