"""Public session API: :class:`FederatedSession` + :class:`SessionConfig`.

One object owns the whole serverless-FL substrate — object store, Lambda
runtime, engine, schedule, upload model, partition plan, device — built
from a single declarative config::

    from repro_torch import FederatedSession, SessionConfig

    session = FederatedSession(SessionConfig(
        topology="gradssharding", n_shards=8, schedule="pipelined",
        upload=UploadModel(mbps=16.0, jitter_s=5.0, compute_s=2.0)))
    result = session.round(client_grads)          # one aggregation round
    for result in session.run(grad_fn, rounds=50):  # a multi-round session
        ...

``session.round`` threads multi-round pipelining internally: each round's
per-client read-back completion times (``client_done_s``) become the next
round's ``client_ready_s``, so — under ``schedule="pipelined"`` — round
r+1 local compute and uploads overlap round r read-back.

Client gradients (numpy arrays or tensors) move to the session's device
(``SessionConfig.device``, ``"cuda"`` unless the caller asks for the CPU)
as contiguous f32 tensors; on a CUDA device the batched engine folds them
in the hand-written kernel.

Topologies dispatch through the :mod:`repro_torch.core.topology` registry,
so a ``@register_topology`` plugin (e.g. ``sharded_tree``) is immediately
usable by name. Long sessions can set ``keep_records=False`` to compact
per-round runtime records, availability-map entries, store objects and op
logs after each round — aggregate billing/op counters survive, so
1k-round sweeps run in bounded memory.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Iterator, Mapping, Sequence

from repro_torch import knobs
from repro_torch.config import LambdaLimits
from repro_torch.core.agg_engine import ENGINES
from repro_torch.core.cost_model import UploadModel
from repro_torch.core.fold_pool import get_workers
from repro_torch.core.sharding import as_grad_tensor, resolve_device
from repro_torch.core.topology import (AggregationResult, available_topologies,
                                 get_codec, get_readahead, get_schedule,
                                 get_topology, round_prefix, run_round,
                                 validate_fault_knobs)
from repro_torch.serverless.faults import FaultModel, StaleBuffer, StalenessPolicy
from repro_torch.serverless.population import (ClientPopulation,
                                               run_population_round)
from repro_torch.serverless.runtime import FaultPlan, LambdaRuntime
from repro_torch.store import ObjectStore


@dataclass(frozen=True)
class SessionConfig:
    """Everything a federated aggregation session needs, in one place.

    ``topology`` names a registered :class:`~repro_torch.core.topology
    .Topology` (builtins: ``gradssharding``, ``lambda_fl``, ``lifl``, plus
    the ``sharded_tree`` and ``geo_tiered`` plugins).
    ``engine``/``schedule`` accept the usual
    knob values or ``None`` (env ``REPRO_AGG_ENGINE`` /
    ``REPRO_AGG_SCHEDULE``). ``upload`` models client networks *and*
    per-client local-compute time (``UploadModel.compute_s`` /
    ``compute_jitter``), which pipelined multi-round sessions overlap with
    the previous round's read-back. ``keep_records=False`` compacts
    per-round records/availability/store state after every round (bounded
    memory for 1k-round sweeps; aggregate cost and op counters survive).
    ``topology_options`` passes extra options to plugin topologies.
    ``device`` is where the value plane lives; ``"cuda"`` without a card
    raises rather than running on the CPU.
    """

    topology: str = "gradssharding"
    n_shards: int = 4
    partition: str = "uniform"
    tensor_sizes: Sequence[int] | None = None
    engine: str | None = None
    schedule: str | None = None
    # pipelined schedule's bounded out-of-order prefetch window: GET up to
    # k contributions ahead of the fold frontier (fold order — and thus
    # avg_flat — is unchanged); None defers to REPRO_AGG_READAHEAD / 1
    readahead_k: int | None = None
    # on-the-wire representation of client contributions (repro_torch.core
    # .wire_codec registry: identity, fp16, qsgd8, topk); None defers to
    # REPRO_AGG_CODEC / "identity". Lossy codecs shrink upload bytes, GET
    # latency, billing and the feasibility ceiling, stay deterministic,
    # and report their accuracy cost as AggregationResult.codec_error
    codec: str | None = None
    # the codec_error reference is an extra O(N·|grad|) host pass per
    # lossy round; throughput-bound sweeps can turn it off (codec_error
    # then reads NaN, never a misleading 0.0)
    track_codec_error: bool = True
    upload: UploadModel | None = None
    # convenience override for UploadModel.compute_s (modeled per-client
    # local training time per round); 0.0 defers to the upload model
    local_compute_s: float = 0.0
    colocated: bool = False              # LIFL shared-memory fast path
    straggler_threshold_s: float | None = None
    # -- fault-tolerant rounds ------------------------------------------------
    # seeded disturbance model (client dropout, upload stalls, aggregator
    # invocation failures + retry backoff); None = fault-free. The model
    # also seeds the participation stream.
    faults: FaultModel | None = None
    # sample K of N cohort clients per round (seeded stream); None = all N
    participation_k: int | None = None
    # aggregate whatever landed by round start + deadline_s; stragglers
    # past the cut are excluded and the average divides by the arrivals
    deadline_s: float | None = None
    # with schedule="quorum": the FedBuff-style semi-async fold fires once
    # this many contributions arrived, folding them in arrival order (a
    # documented, seeded departure from barrier/pipelined bit-identity).
    # Combined with deadline_s the deadline cuts first and the quorum
    # gates within its survivors (degenerate combos raise per round)
    quorum: int | None = None
    # stale re-entry: keep a cut straggler's (or dropped client's) upload
    # in a per-session buffer and fold it into a later round with this
    # policy's staleness weight (constant / polynomial 1/(1+s)^alpha /
    # cutoff at max_staleness); None = legacy drop-forever semantics,
    # bit-for-bit identical folds
    staleness_policy: StalenessPolicy | None = None
    # speculative hedging (pipelined/quorum schedules): once an
    # aggregator's actual finish overruns hedge_factor x its fault-free
    # expected finish, race a replica on the same keyspace — first
    # finisher wins, the loser stays billed. Must be > 1.0; None = off
    hedge_factor: float | None = None
    limits: LambdaLimits | None = None
    warm_pool_size: int | None = None
    keep_records: bool = True
    # per-op PUT/GET logs on the session's store. False keeps every
    # aggregate counter (op counts, byte totals, billing) exact but skips
    # the per-op put_log/get_log appends — required at million-client
    # scale, where the op log itself would be the O(N·M) residency
    log_ops: bool = True
    # lazy synthetic cohort: rounds run through the O(active)
    # population engine (repro_torch.serverless.population) instead of
    # eager per-client gradients — call ``session.round()`` with no
    # ``client_grads``. Bit-identical to the eager driver over
    # ``population.materialize(rnd)``; on a CUDA device its chunked folds
    # run in the fold kernel with a carried accumulator. Pair with
    # ``log_ops=False`` (and ``keep_records=False`` for multi-round) at
    # million-client scale
    population: ClientPopulation | None = None
    # host fold-pool width behind the batched engine's CPU evaluation:
    # int >= 1, "auto"/None (env REPRO_AGG_WORKERS, else every host
    # core). Work is split along the element axis only, so avg_flat is
    # bit-identical at every worker count
    workers: int | str | None = None
    # multi-device fold engine of the reference package: not ported yet
    # (ROADMAP queue 1, item 10); anything but None raises
    host_mesh: int | None = None
    topology_options: Mapping[str, Any] = field(default_factory=dict)
    # where client gradients, shards and the mean live
    device: str = "cuda"

    @classmethod
    def from_env(cls, **overrides) -> "SessionConfig":
        """A config with every ``REPRO_AGG_*`` knob resolved *now*.

        Snapshots the engine / schedule / readahead / codec / faults /
        workers environment knobs into explicit field values, so the
        returned config is immune to later ``os.environ`` changes. Set
        knobs are parsed and validated *eagerly* through their resolvers
        (a bad ``REPRO_AGG_READAHEAD=zero`` raises here, not mid-round;
        ``REPRO_AGG_WORKERS=auto`` pins the host's core count). Explicit
        keyword overrides beat the environment, which beats the defaults
        — the precedence contract of :mod:`repro_torch.knobs`. Unset env knobs
        stay ``None`` (resolver defaults) rather than being pinned.
        """
        from repro_torch.serverless.faults import fault_model_from_env
        env: dict[str, Any] = {}
        if knobs.env_engine(None) is not None:
            engine = knobs.env_engine(None)
            if engine not in ENGINES:
                raise ValueError(
                    f"unknown aggregation engine {engine!r} in "
                    f"{knobs.ENV_ENGINE} (expected one of {ENGINES})")
            env["engine"] = engine
        if knobs.env_schedule(None) is not None:
            env["schedule"] = get_schedule(None)
        if knobs.env_readahead(None) is not None:
            env["readahead_k"] = get_readahead(None)
        if knobs.env_codec(None) is not None:
            env["codec"] = get_codec(None).name
        if knobs.env_faults():
            env["faults"] = fault_model_from_env()
        if knobs.env_workers(None) is not None:
            env["workers"] = get_workers(None)
        env.update(overrides)
        return cls(**env)

    def round_options(self) -> dict:
        """The topology-option dict one round receives."""
        opts = {"n_shards": self.n_shards, "partition": self.partition,
                "tensor_sizes": self.tensor_sizes}
        if self.colocated:
            opts["colocated"] = True
        opts.update(self.topology_options)
        return opts

    def resolved_upload(self) -> UploadModel | None:
        """The effective upload model: ``local_compute_s`` folded in."""
        if self.local_compute_s <= 0.0:
            return self.upload
        return replace(self.upload or UploadModel(),
                       compute_s=self.local_compute_s)


class FederatedSession:
    """Facade over the store/runtime/driver stack for multi-round FL.

    Construct from a :class:`SessionConfig` (or keyword overrides of one);
    pre-built ``store``/``runtime``/``faults`` may be injected for tests
    and fault-injection studies. The session validates the topology name
    eagerly, owns the round counter, and carries per-client timing across
    rounds so pipelined sessions overlap round r+1 uploads (and local
    compute) with round r read-back.
    """

    def __init__(self, config: SessionConfig | None = None, *,
                 store: ObjectStore | None = None,
                 runtime: LambdaRuntime | None = None,
                 faults: FaultPlan | None = None, **overrides):
        config = config or SessionConfig()
        if overrides:
            config = replace(config, **overrides)
        if isinstance(faults, FaultModel):
            # a seeded FaultModel drives membership (dropout/participation)
            # through the round driver, not just the runtime — promote it
            # to the config so both layers see it
            if config.faults is not None:
                raise ValueError(
                    "FaultModel given twice: SessionConfig.faults and the "
                    "faults= keyword; configure one")
            config = replace(config, faults=faults)
            faults = None
        self.config = config
        if config.host_mesh is not None:
            raise NotImplementedError(
                "the host_mesh engine is not ported yet (ROADMAP queue 1, "
                "item 10: device collectives and the multi-device engine)")
        self.device = resolve_device(config.device)      # fail fast
        self.topology = get_topology(config.topology)   # fail fast
        get_codec(config.codec)                         # fail fast too
        get_workers(config.workers)                     # and on workers
        # fail fast on bad fault/participation/deadline/quorum combos
        # (cohort-size-dependent bounds re-check per round)
        validate_fault_knobs(get_schedule(config.schedule),
                             participation_k=config.participation_k,
                             deadline_s=config.deadline_s,
                             quorum=config.quorum, faults=config.faults,
                             staleness_policy=config.staleness_policy,
                             hedge_factor=config.hedge_factor,
                             allow_auto_quorum=config.schedule
                             in (None, "auto"))
        if faults is not None and config.faults is not None:
            raise ValueError(
                "cannot combine SessionConfig.faults (a seeded FaultModel) "
                "with an injected FaultPlan; configure one fault source")
        self.store = store if store is not None \
            else ObjectStore(log_ops=config.log_ops)
        if runtime is not None:
            # an injected runtime already fixed these; silently dropping
            # them would make a fault-injection or pricing study measure
            # the wrong configuration
            clash = [name for name, val in
                     [("limits", config.limits), ("faults", faults),
                      ("warm_pool_size", config.warm_pool_size)]
                     if val is not None]
            if clash:
                raise ValueError(
                    f"cannot combine an injected runtime with {clash}: "
                    f"configure them on the runtime itself")
            self.runtime = runtime
        else:
            self.runtime = LambdaRuntime(
                limits=config.limits, faults=faults or config.faults,
                warm_pool_size=config.warm_pool_size)
        self.rounds_run = 0
        # stale re-entry buffer: cut stragglers' uploads persist here
        # across rounds (and across keep_records=False compaction) until
        # a later round folds them, staleness-weighted
        self.stale_buffer = StaleBuffer() \
            if config.staleness_policy is not None else None
        self._client_ready: tuple | None = None
        self._session_start_s: float | None = None
        self._session_end_s = 0.0
        self._round_walls_sum = 0.0
        # cumulative fault accounting: survives per-round compaction
        # (keep_records=False), unlike the per-round records it is
        # derived from
        self._fault_totals = {"retries": 0, "dropped": 0, "late": 0,
                              "stale_folded": 0, "hedges": 0,
                              "hedge_wins": 0}

    # ------------------------------------------------------------------
    def round(self, client_grads: Sequence | None = None, *,
              rnd: int | None = None) -> AggregationResult:
        """Run one aggregation round; rounds auto-number from 0.

        ``client_grads`` are flat f32 gradients, numpy arrays or tensors;
        they move to the session's device as contiguous f32 tensors.
        Population-backed sessions (``SessionConfig.population``) take no
        ``client_grads`` — the lazy cohort generates its own."""
        cfg = self.config
        rnd = self.rounds_run if rnd is None else rnd
        if cfg.population is not None:
            if client_grads is not None:
                raise ValueError(
                    "a population-backed session generates its own client "
                    "gradients; call round() without client_grads")
            return self._population_round(rnd)
        if client_grads is None:
            raise ValueError(
                "client_grads is required unless SessionConfig.population "
                "is set")
        client_grads = [as_grad_tensor(g, self.device) for g in client_grads]
        if self._client_ready is not None \
                and len(self._client_ready) != len(client_grads):
            # per-round client sampling: carried read-back times index the
            # previous round's cohort, so a resized cohort starts fresh
            # from the runtime cursor instead of inheriting wrong times
            self._client_ready = None
        result = run_round(
            self.topology, client_grads, rnd=rnd, store=self.store,
            runtime=self.runtime, engine=cfg.engine, schedule=cfg.schedule,
            upload=cfg.resolved_upload(),
            client_ready_s=self._client_ready,
            straggler_threshold_s=cfg.straggler_threshold_s,
            readahead_k=cfg.readahead_k, codec=cfg.codec,
            track_codec_error=cfg.track_codec_error,
            faults=cfg.faults, participation_k=cfg.participation_k,
            deadline_s=cfg.deadline_s, quorum=cfg.quorum,
            staleness_policy=cfg.staleness_policy,
            stale_buffer=self.stale_buffer,
            hedge_factor=cfg.hedge_factor, workers=cfg.workers,
            **cfg.round_options())
        return self._finish_round(result, rnd)

    def _population_round(self, rnd: int) -> AggregationResult:
        """One round through the O(active) population engine on the
        session's device — same knob threading and session bookkeeping as
        the eager path."""
        cfg = self.config
        result = run_population_round(
            self.topology, cfg.population, rnd=rnd, store=self.store,
            runtime=self.runtime, engine=cfg.engine, schedule=cfg.schedule,
            upload=cfg.resolved_upload(),
            client_ready_s=self._client_ready,
            straggler_threshold_s=cfg.straggler_threshold_s,
            readahead_k=cfg.readahead_k, codec=cfg.codec,
            track_codec_error=cfg.track_codec_error,
            faults=cfg.faults, participation_k=cfg.participation_k,
            deadline_s=cfg.deadline_s, quorum=cfg.quorum,
            staleness_policy=cfg.staleness_policy,
            stale_buffer=self.stale_buffer,
            hedge_factor=cfg.hedge_factor, workers=cfg.workers,
            device=self.device, **cfg.round_options())
        return self._finish_round(result, rnd)

    def _finish_round(self, result: AggregationResult,
                      rnd: int) -> AggregationResult:
        self._observe(result)
        if not self.config.keep_records:
            self._compact(rnd)
            # the per-client read-back array is threaded into the next
            # round via _client_ready; retaining a copy on every yielded
            # result would grow O(N·rounds) in callers that keep results
            result.client_done_s = ()
        self.rounds_run = max(self.rounds_run, rnd + 1)
        return result

    def run(self, client_grad_fn: Callable[[int], Sequence] | None = None,
            rounds: int = 1) -> Iterator[AggregationResult]:
        """Iterate ``rounds`` aggregation rounds; ``client_grad_fn(rnd)``
        supplies each round's client gradients (flat f32 vectors —
        typically local-SGD deltas; population-backed sessions pass
        ``None``). Lazily yields each :class:`AggregationResult` so
        1k-round sweeps need not hold every result (pair with
        ``keep_records=False`` for bounded memory)."""
        for _ in range(rounds):
            rnd = self.rounds_run
            grads = None if client_grad_fn is None else client_grad_fn(rnd)
            yield self.round(grads, rnd=rnd)

    # ------------------------------------------------------------------
    def _observe(self, result: AggregationResult) -> None:
        if self._session_start_s is None:
            self._session_start_s = result.round_start_s
        done = result.client_done_s
        self._client_ready = done if len(done) else None
        self._session_end_s = max(self._session_end_s, result.round_end_s)
        self._round_walls_sum += result.wall_clock_s
        t = self._fault_totals
        t["retries"] += result.retries
        t["dropped"] += len(result.dropped)
        t["late"] += len(result.late)
        t["stale_folded"] += len(result.stale_folded)
        t["hedges"] += result.hedges
        t["hedge_wins"] += result.hedge_wins

    def _compact(self, rnd: int) -> None:
        """Drop the finished round's per-op state (records, availability
        entries, stored objects, op logs); aggregate counters survive."""
        self.runtime.compact()
        for key in self.store.list(round_prefix(rnd)):
            self.store.delete(key)
        self.store.stats.put_log.clear()
        self.store.stats.get_log.clear()

    # -- session timing / cost -----------------------------------------------
    @property
    def session_wall_s(self) -> float:
        """Makespan of the session (first upload to last read-back) —
        under the pipelined schedule this is below the sum of round walls
        because adjacent rounds overlap."""
        if self._session_start_s is None:
            return 0.0
        return self._session_end_s - self._session_start_s

    @property
    def sum_round_walls_s(self) -> float:
        """What a fully barriered session would report."""
        return self._round_walls_sum

    def lambda_cost(self) -> float:
        return self.runtime.total_cost()

    def s3_cost(self) -> float:
        limits = self.runtime.limits
        return self.store.stats.puts * limits.s3_put_price \
            + self.store.stats.gets * limits.s3_get_price

    def total_cost(self) -> float:
        return self.lambda_cost() + self.s3_cost()

    @property
    def fault_totals(self) -> dict:
        """Cumulative fault/robustness counters over the whole session
        (retries, dropped, late, stale_folded, hedges, hedge_wins) —
        accumulated per round in :meth:`_observe`, so they survive
        ``keep_records=False`` compaction."""
        return dict(self._fault_totals)

    def summary(self) -> dict:
        return {
            "topology": self.config.topology,
            "codec": get_codec(self.config.codec).name,
            "rounds": self.rounds_run,
            "session_wall_s": self.session_wall_s,
            "sum_round_walls_s": self.sum_round_walls_s,
            "lambda_cost": self.lambda_cost(),
            "s3_cost": self.s3_cost(),
            "total_cost": self.total_cost(),
            "puts": self.store.stats.puts,
            "gets": self.store.stats.gets,
            "fault_totals": self.fault_totals,
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"FederatedSession(topology={self.config.topology!r}, "
                f"rounds_run={self.rounds_run}, "
                f"available={available_topologies()})")
