"""Functional entry point for serverless FL aggregation (paper §III-A).

The aggregation stack lives behind two abstractions:

  * :class:`repro_torch.api.FederatedSession` /
    :class:`repro_torch.api.SessionConfig` — the user-facing facade. One
    config declares topology, engine, schedule, upload/compute model,
    partition plan, platform limits and device; ``session.round(grads)``
    runs one round.
  * :mod:`repro_torch.core.topology` — the strategy layer. Each topology
    (builtins ``gradssharding``, ``lambda_fl``, ``lifl``) *declares* its
    keyspace, uploads, phase/level plan and per-invocation specs; one
    shared round driver (:func:`~repro_torch.core.topology.run_round`)
    owns upload registration, barrier-vs-pipelined launch gating,
    read-back accounting and result assembly.

Engine (``streaming``/``batched``/``incremental``, env
``REPRO_AGG_ENGINE``) and schedule (``barrier``/``pipelined``, env
``REPRO_AGG_SCHEDULE``) knobs compose freely with every topology;
``avg_flat`` is bit-identical across engines and schedules by
construction (pipelining moves *time*, never arithmetic). The wire codec
knob (env ``REPRO_AGG_CODEC``) follows the decode-before-fold contract of
:mod:`repro_torch.core.wire_codec`.

This module keeps the functional surface: ``aggregate_round`` (the
functional alias of ``FederatedSession.round``), with the driver's names
re-exported.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.config import DEFAULT_LIMITS, FLConfig, LambdaLimits  # noqa: F401
from repro_torch.core import cost_model as cm                           # noqa: F401
from repro_torch.core.agg_engine import ExecutionBackend, get_backend   # noqa: F401
from repro_torch.core.cost_model import UploadModel
from repro_torch.core.sharding import PartitionPlan, make_plan, reconstruct  # noqa: F401
from repro_torch.core.topology import (                                 # noqa: F401
    DEFAULT_SCHEDULE,
    MB,
    SCHEDULES,
    AggregationResult,
    Engine,
    available_codecs,
    available_topologies,
    get_codec,
    get_readahead,
    get_schedule,
    get_topology,
    k_avg_shard,
    k_client_grad,
    k_client_shard,
    k_global,
    k_partial,
    register_codec,
    register_topology,
    run_round,
)
from repro_torch.core.wire_codec import WireCodec, WirePayload          # noqa: F401
from repro_torch.serverless.runtime import InvocationRecord, LambdaRuntime  # noqa: F401
from repro_torch.store import ObjectStore


def aggregate_round(topology: str, client_grads: Sequence, *,
                    rnd: int, store: ObjectStore, runtime: LambdaRuntime,
                    n_shards: int = 4, partition: str = "uniform",
                    tensor_sizes: Sequence[int] | None = None,
                    engine: Engine = None,
                    schedule: str | None = None,
                    upload: UploadModel | None = None,
                    client_ready_s: Sequence[float] | None = None,
                    straggler_threshold_s: float | None = None,
                    readahead_k: int | None = None,
                    codec: str | WireCodec | None = None,
                    track_codec_error: bool = True,
                    faults=None,
                    participation_k: int | None = None,
                    deadline_s: float | None = None,
                    quorum: int | None = None,
                    staleness_policy=None,
                    stale_buffer=None,
                    hedge_factor: float | None = None,
                    workers: int | str | None = None,
                    **kw) -> AggregationResult:
    """One aggregation round of any registered topology (functional form
    of :meth:`repro_torch.api.FederatedSession.round`). The fault-tolerance
    knobs (``faults``/``participation_k``/``deadline_s``/``quorum``),
    the robustness knobs (``staleness_policy`` + caller-owned
    ``stale_buffer`` for cross-round stale re-entry, ``hedge_factor``
    for speculative aggregator hedging) and the host-parallelism knob
    (``workers`` fold-pool width) mirror
    :class:`repro_torch.api.SessionConfig`; see
    :func:`repro_torch.core.topology.run_round`."""
    return run_round(
        topology, client_grads, rnd=rnd, store=store, runtime=runtime,
        engine=engine, schedule=schedule, upload=upload,
        client_ready_s=client_ready_s,
        straggler_threshold_s=straggler_threshold_s,
        readahead_k=readahead_k, codec=codec,
        track_codec_error=track_codec_error,
        faults=faults, participation_k=participation_k,
        deadline_s=deadline_s, quorum=quorum,
        staleness_policy=staleness_policy, stale_buffer=stale_buffer,
        hedge_factor=hedge_factor,
        workers=workers,
        n_shards=n_shards, partition=partition, tensor_sizes=tensor_sizes,
        **kw)
