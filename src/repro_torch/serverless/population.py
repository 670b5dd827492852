"""Million-client cohort engine: lazy schedules, virtualized client folds.

The eager round driver (:func:`repro_torch.core.topology.run_round`) holds
one Python object per client: a gradient tensor, N store keys, N
availability entries, N upload events, N-entry fold bodies. At N = 10^6
that is tens of GB of state for a *model* whose observable outputs —
walls, billed GB-s, op counts, the averaged gradient — depend on the
clients only through per-client byte counts and seeded timing draws.

:class:`ClientPopulation` + :func:`run_population_round` reproduce the
eager driver bit-for-bit while keeping live state O(active):

* **Lazy, vectorized schedules** — membership, dropout, stalls, start
  jitter, rate multipliers and local-compute times are gathered for the
  participating cohort slice only (PCG64 ``advance`` over the gaps, see
  :mod:`repro_torch.serverless.streams`), then the per-key PUT-completion
  recurrence is replayed with elementwise numpy ops whose IEEE op order
  matches the eager scalar loop exactly.
* **Virtualized folds** — client contributions never become store keys
  or availability entries. Every aggregator runs as a real
  :class:`~repro_torch.serverless.runtime.LambdaRuntime` invocation (cold
  starts, injected failures, retries, speculative duplicates, per-tier
  limits all apply) whose body replays the engine fold body's exact
  op sequence against modeled byte counts:
  ``stall_until``/``read_modeled``/``write_modeled`` twins of the
  store-backed calls. Store op/byte totals are settled through
  ``ObjectStore.account_io`` (op logs are not expanded — totals stay
  exact). Only the round's read-back outputs are materialized.
* **Value plane** — ``avg_flat`` is computed separately from timing, on
  the round's device, by chunked left folds over synthetic per-client
  gradients, depth-first through fold trees so at most one group's
  partials are alive at a time. A chunk of ``CHUNK_ROWS`` rows is formed
  on the device (``scale[:, None] * base[None, :]``, one f32 multiply per
  element) and folded into the running accumulator by
  :func:`repro_torch.kernels.fedavg_stream.fold_nodes` with a carry: on a
  CUDA device one launch of the fold kernel's carry route per chunk (the
  chunk's base pointer and row stride by value), the last one dividing;
  on the CPU its plain version. Per element that is the
  streaming backend's sequential f32 (unweighted) or f64 all-ones
  weighted fold — the bits of the reference's ``np.add.accumulate``.
  Device memory stays O(one chunk + the live accumulators), whatever N.

The control plane stays on the host: the round's ``base`` and the
per-client ``scales`` are numpy PCG64 draws under the reference's
``[seed, round, stream]`` keys, and membership arrays are int64 numpy.

Per-topology entries register through :func:`register_population_plan`
(gradssharding, lambda_fl, lifl, geo_tiered ship built-in). Determinism
contract: with identical knobs, ``run_population_round`` returns the
same walls, phase times, op counts, billed memory, records, membership
and bit-identical ``avg_flat`` as :func:`run_round` over
``pop.materialize(rnd)``. Membership fields
(``participants``/``arrivals``/``dropped``/``late``) are int64 arrays
rather than tuples (a 10^6-entry Python tuple is exactly the O(N)
residency this engine exists to avoid).

Not supported (raise ``NotImplementedError``): staleness re-entry
(``staleness_policy``/``stale_buffer``), speculative hedging
(``hedge_factor``) and LIFL's colocated fast path.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import cost_model as cm
from repro_torch.core.agg_engine import get_backend
from repro_torch.core.cost_model import UploadModel, tree_groups
from repro_torch.core.fold_pool import get_pool
from repro_torch.core.geo_tiered import k_edge_partial, k_region_partial
from repro_torch.core.sharding import make_plan, reconstruct, \
    resolve_device, shard
from repro_torch.core.topology import (AggregationResult, Topology, _alloc_mb,
                                       _bind_runtime_faults, _NO_FAULTS,
                                       _readback_times, _UploadTimes,
                                       get_readahead, get_schedule,
                                       get_topology, k_avg_shard, k_global,
                                       k_partial, tier_limits,
                                       validate_fault_knobs)
from repro_torch.core.wire_codec import WireCodec, WirePayload, \
    decode_eager, get_codec
from repro_torch.kernels import fedavg_stream
from repro_torch.serverless.event_sim import ReadAheadWindow
from repro_torch.serverless.faults import FaultModel
from repro_torch.serverless.runtime import LambdaRuntime
from repro_torch.serverless.streams import gather_stream
from repro_torch.store import ObjectStore

# population-owned sub-stream ids (disjoint from FaultModel's 11-14 and
# UploadModel's [seed, rnd] / [seed, rnd, 1] keying)
_S_SCALE = 21      # [seed, 0, _S_SCALE]: per-client magnitude, round-free
_S_BASE = 22       # [seed, rnd, _S_BASE]: per-round shared direction

#: rows per synthetic-gradient batch in the chunked value plane
CHUNK_ROWS = 512


class ClientPopulation:
    """A synthetic cohort whose gradients are a deterministic function of
    ``(seed, round, cohort index)`` — any slice can be generated on
    demand, so no round ever materializes all N clients.

    ``grads(rnd, idx)`` returns rank-one rows ``scale[i] * base_r``: a
    per-round shared direction (``standard_normal``) scaled per client
    (uniform in [0.5, 1.5), gathered lazily). Rank-one keeps generation
    O(len(idx) + grad_elems) while still exercising every fold path; the
    per-client scales make each contribution distinct so fold-order and
    membership bugs change ``avg_flat``. The draws are host numpy; the
    rows are formed on the requested device by one f32 multiply per
    element, which gives the same bits on either side.
    """

    def __init__(self, n_clients: int, grad_elems: int = 4096,
                 seed: int = 0):
        if n_clients < 1:
            raise ValueError(f"n_clients must be >= 1, got {n_clients}")
        if grad_elems < 1:
            raise ValueError(f"grad_elems must be >= 1, got {grad_elems}")
        self.n_clients = int(n_clients)
        self.grad_elems = int(grad_elems)
        self.seed = int(seed)

    @property
    def grad_bytes(self) -> int:
        return self.grad_elems * 4

    def round_base(self, rnd: int) -> np.ndarray:
        """The round's shared gradient direction (f32, ``grad_elems``)."""
        rng = np.random.default_rng([self.seed, rnd, _S_BASE])
        return rng.standard_normal(self.grad_elems).astype(np.float32)

    def client_scales(self, idx) -> np.ndarray:
        """Per-client magnitudes at cohort indices ``idx`` (f32,
        uniform in [0.5, 1.5), lazily gathered, round-independent)."""
        u = gather_stream([self.seed, 0, _S_SCALE], idx,
                          lambda r, m: r.random(m))
        return (0.5 + u).astype(np.float32)

    @staticmethod
    def _rows(scales: np.ndarray, base: torch.Tensor) -> torch.Tensor:
        return torch.from_numpy(scales).to(base.device)[:, None] \
            * base[None, :]

    def _base(self, rnd: int, device) -> torch.Tensor:
        return torch.from_numpy(self.round_base(rnd)).to(device)

    def grads(self, rnd: int, idx, device: str | torch.device = "cpu"
              ) -> torch.Tensor:
        """Gradient rows for cohort indices ``idx`` (f32, len(idx) x G)
        on ``device``."""
        idx = np.asarray(idx, dtype=np.int64)
        return self._rows(self.client_scales(idx), self._base(rnd, device))

    def grad(self, rnd: int, i: int, device: str | torch.device = "cpu"
             ) -> torch.Tensor:
        return self.grads(rnd, [int(i)], device)[0]

    def iter_grads(self, rnd: int, idx, chunk: int = CHUNK_ROWS,
                   device: str | torch.device = "cpu"):
        """Chunked :meth:`grads` — the value plane's streaming entry."""
        base = self._base(rnd, device)
        idx = np.asarray(idx, dtype=np.int64)
        for s in range(0, len(idx), chunk):
            yield self._rows(self.client_scales(idx[s:s + chunk]), base)

    def materialize(self, rnd: int, device: str | torch.device = "cpu"
                    ) -> list:
        """All N gradients as an eager list — the small-N equivalence
        tests feed this to :func:`run_round` to compare drivers."""
        rows = self.grads(rnd, np.arange(self.n_clients), device)
        return [rows[i] for i in range(self.n_clients)]


# ---------------------------------------------------------------------------
# Value plane: chunked replays of the streaming backend's arithmetic
# ---------------------------------------------------------------------------

def _accumulate_rows(acc: torch.Tensor | None, rows: torch.Tensor,
                     weighted: bool, count: int | None = None
                     ) -> torch.Tensor:
    """One step of the chunked left fold: ``acc + rows[0] + … + rows[-1]``
    down the row axis, independently per column (``rows[0] + …`` when
    ``acc`` is None), in f32 or, ``weighted``, as an f64 fold with
    all-ones weights. Without ``count`` it returns the raw accumulator;
    with it, the f32 mean ``acc / count`` (the last chunk). One fold-kernel
    launch on a CUDA device."""
    weights = [1.0] * int(rows.shape[0]) if weighted else None
    return fedavg_stream.fold_nodes(
        [(rows, weights)], acc="f64", carry=[acc], finalize=count is not None,
        divisors=None if count is None else [float(count)])[0]


def _fold_chunks(chunks, weighted: bool, count: int) -> torch.Tensor:
    """Left-fold row chunks exactly like ``StreamingBackend``: f32
    sequential adds (unweighted) or f64 all-ones weighted adds, one
    divide by ``float(count)``, f32 cast. Each chunk carries the previous
    one's accumulator and the last divides, so the bits are those of the
    scalar client-by-client loop."""
    it = iter(chunks)
    rows = next(it)
    acc = None
    for nxt in it:
        acc = _accumulate_rows(acc, rows, weighted)
        rows = nxt
    return _accumulate_rows(acc, rows, weighted, count)


def _decode_rows(rows: torch.Tensor, cdc: WireCodec) -> torch.Tensor:
    """Wire round-trip of whole-gradient rows (what a lossy codec's
    aggregator actually folds)."""
    out = torch.empty_like(rows)
    for r in range(rows.shape[0]):
        out[r] = decode_eager(cdc.encode(rows[r]))
    return out


def _decode_rows_sharded(rows: torch.Tensor, cdc: WireCodec,
                         plan) -> torch.Tensor:
    """Per-shard wire round-trip: each shard is encoded independently
    (its own codec framing), exactly like the eager client PUTs."""
    out = torch.empty_like(rows)
    for r in range(rows.shape[0]):
        dec = [decode_eager(cdc.encode(sh)) for sh in shard(rows[r], plan)]
        out[r] = reconstruct(dec, plan)
    return out


def _client_fold(pop: ClientPopulation, rnd: int, member_ids, cdc,
                 wire: bool, weighted: bool, device) -> torch.Tensor:
    """One aggregator's output over a contiguous member slice."""
    chunks = pop.iter_grads(rnd, member_ids, device=device)
    if wire:
        chunks = (_decode_rows(rows, cdc) for rows in chunks)
    return _fold_chunks(chunks, weighted, len(member_ids))


def _key_fold(values: Sequence[torch.Tensor], weights) -> torch.Tensor:
    """A non-leaf fold over already-finalized child outputs: the engines'
    weighted fold (f64 ``x·w``, one divide by ``float(sum(w))``, f32
    cast), through the fold kernel on a CUDA device."""
    return fedavg_stream.fold_nodes(
        [(list(values), [float(w) for w in weights])], acc="f64")[0]


def _pop_codec_error(cdc: WireCodec, avg: torch.Tensor,
                     pop: ClientPopulation, rnd: int, members) -> float:
    """Chunked twin of ``topology._codec_error`` (unweighted branch —
    the population engine folds no stale re-entries)."""
    if cdc.lossless or avg.numel() == 0:
        return 0.0
    ref = _fold_chunks(pop.iter_grads(rnd, members, device=avg.device),
                       weighted=False, count=len(members))
    return float(torch.max(torch.abs(avg - ref)))


# ---------------------------------------------------------------------------
# Virtual folds: timing plan
# ---------------------------------------------------------------------------

@dataclass
class VirtualFold:
    """One aggregator invocation, virtualized.

    Timing-only twin of :class:`~repro_torch.core.topology.InvocationSpec`:
    the body replays the engine fold's op sequence against byte counts.
    ``avail`` carries client-tier input availability (the vectorized
    PUT-completion times); keys-source folds set ``in_keys`` instead and
    read the availability map like the eager body. ``value`` is the
    precomputed output, stored only when ``store_out`` (read-back keys);
    other outputs are write-modeled with first-write-wins accounting.
    """

    fn_name: str
    out_key: str
    n_in: int
    in_nb: int                     # stored bytes of one input (wire or raw)
    raw_nb: int                    # decoded input bytes (== alloc_bytes)
    wire: bool                     # inputs travel as WirePayloads
    wire_in_bytes: int | None      # declared wire size (billing formula)
    decode_s: float
    weighted: bool
    avail: np.ndarray | None = None
    in_keys: tuple | None = None
    value: torch.Tensor | None = None
    store_out: bool = False
    read_mbps: float | None = None
    write_mbps: float | None = None
    _written: bool = field(default=False, repr=False)


@dataclass(frozen=True)
class PopulationProgram:
    """Virtual twin of :class:`~repro_torch.core.topology.RoundProgram`."""

    topology: str
    phases: tuple
    readback: tuple
    collect: Callable[[list], torch.Tensor]


@dataclass(frozen=True)
class PopPlan:
    """What a population entry declares before membership is known:
    the per-key client upload sizes ``(wire_nb, store_nb)`` (identical
    for every client) and a ``build(members, put_cols)`` closure that
    lays out the round's virtual folds once the surviving membership
    and its per-key PUT-completion columns exist."""

    upload_key_bytes: tuple
    build: Callable


_POP_PLANS: dict[str, Callable] = {}


def register_population_plan(name: str, *, replace: bool = False):
    """Register a topology's population entry: a callable
    ``fn(topo, pop, rnd, cdc, limits, options, device) -> PopPlan``.
    The name must match the topology-registry name
    :func:`run_population_round` dispatches on; ``device`` is the round's
    value-plane device (thread it into ``_fold_chunks``/``_client_fold``
    so every fold runs there)."""

    def deco(fn):
        if not replace and name in _POP_PLANS:
            raise ValueError(
                f"population plan {name!r} is already registered; pass "
                f"replace=True to override")
        _POP_PLANS[name] = fn
        return fn

    return deco


def population_topologies() -> tuple:
    return tuple(sorted(_POP_PLANS))


def _wire_probe(cdc: WireCodec, elems: int) -> tuple[bool, int]:
    """Whether this codec produces wire payloads, and the exact stored
    bytes of one encoded ``elems``-element contribution (codec framing
    is value-independent, so a zeros probe on the host is exact)."""
    enc = cdc.encode(torch.zeros(int(elems), dtype=torch.float32))
    if isinstance(enc, WirePayload):
        return True, int(enc.nbytes)
    return False, int(elems) * 4


def _virtual_body(f: VirtualFold, store: ObjectStore, readahead_k: int,
                  pipelined: bool):
    """Replay ``agg_engine._avg_body``'s exact op sequence against
    modeled byte counts. Failed attempts never run (the fault is
    injected before the body), so per-execution accounting mirrors the
    eager store traffic including retries and speculative duplicates."""

    def body(ctx):
        n = f.n_in
        if pipelined:
            avail = f.avail if f.avail is not None \
                else [ctx.avail_time(k) for k in f.in_keys]
        else:
            # barrier: ctx.avail_time reads 0.0 for every key
            avail = np.zeros(n)
        win = ReadAheadWindow(avail, readahead_k)
        first = True
        while not win.done:
            if win.foldable:
                if f.wire:
                    ctx.work(f.decode_s)
                    ctx.free(f.in_nb)
                    ctx.alloc(f.raw_nb)
                if first:
                    first = False
                    ctx.alloc(2 * f.raw_nb if f.weighted else f.raw_nb)
                else:
                    ctx.compute(f.raw_nb)
                ctx.free(f.raw_nb)
                win.folded()
                continue
            j = win.next_fetch(ctx.now_s)
            ctx.stall_until(float(avail[j]))
            ctx.read_modeled(f.in_nb)
            ctx.alloc(f.in_nb)
            win.fetched(j)
        ctx.compute(f.raw_nb)                    # finalize pass
        if f.store_out:
            ctx.put(store, f.out_key, f.value, if_none_match=True)
            store.account_io(gets=n, bytes_read=n * f.in_nb)
        else:
            ctx.write_modeled(f.raw_nb)
            if f._written:                       # conditional PUT lost
                store.account_io(gets=n, bytes_read=n * f.in_nb)
            else:
                f._written = True
                store.account_io(puts=1, bytes_written=f.raw_nb,
                                 gets=n, bytes_read=n * f.in_nb)
        ctx.free(f.raw_nb)
        return f.value

    return body


# ---------------------------------------------------------------------------
# Built-in population entries
# ---------------------------------------------------------------------------

@register_population_plan("gradssharding")
def _plan_gradssharding(topo, pop, rnd, cdc, limits, options, device):
    plan = options.get("plan") or make_plan(
        options.get("partition", "uniform"), pop.grad_elems,
        options.get("n_shards", 4), options.get("tensor_sizes"))
    m = plan.n_shards
    shard_elems = plan.shard_sizes()
    shard_bytes = [s * 4 for s in shard_elems]
    wire_nb = [cdc.wire_bytes(b) for b in shard_bytes]
    # detlint: allow[ORD001] size-keyed probe cache; iteration only
    # builds a lookup dict, no value folds through it
    probes = {e: _wire_probe(cdc, e) for e in set(shard_elems)}

    def build(members, put_cols):
        nm = len(members)
        chunks = pop.iter_grads(rnd, members, device=device)
        if probes[shard_elems[0]][0]:
            chunks = (_decode_rows_sharded(rows, cdc, plan)
                      for rows in chunks)
        # elementwise adds commute with the shard partition, so one full
        # fold pass yields every per-shard fold at once
        avg_full = _fold_chunks(chunks, weighted=False, count=nm)
        shard_avgs = shard(avg_full, plan)
        folds = tuple(
            VirtualFold(
                fn_name=f"r{rnd}-shard{j}", out_key=k_avg_shard(rnd, j),
                n_in=nm, in_nb=probes[shard_elems[j]][1],
                raw_nb=shard_bytes[j], wire=probes[shard_elems[j]][0],
                wire_in_bytes=wire_nb[j],
                decode_s=cdc.decode_cost_s(shard_bytes[j]),
                weighted=False, avail=put_cols[j],
                value=shard_avgs[j], store_out=True)
            for j in range(m))
        readback = tuple((k_avg_shard(rnd, j), shard_bytes[j])
                         for j in range(m))
        return PopulationProgram(
            "gradssharding", (folds,), readback,
            collect=lambda vals: reconstruct(vals, plan))

    return PopPlan(
        tuple((wire_nb[j], probes[shard_elems[j]][1]) for j in range(m)),
        build)


@register_population_plan("lambda_fl")
def _plan_lambda_fl(topo, pop, rnd, cdc, limits, options, device):
    gb = pop.grad_bytes
    wire_g = cdc.wire_bytes(gb)
    wire, store_g = _wire_probe(cdc, pop.grad_elems)

    def build(members, put_cols):
        nm = len(members)
        avail = put_cols[0]
        groups = tree_groups(nm, cm.lambda_fl_branching(nm))
        leaves, leaf_vals = [], []
        for leaf, g in enumerate(groups):
            g0, g1 = g[0], g[-1] + 1
            leaf_vals.append(_client_fold(pop, rnd, members[g0:g1], cdc,
                                          wire, weighted=False,
                                          device=device))
            leaves.append(VirtualFold(
                fn_name=f"r{rnd}-leaf{leaf}", out_key=k_partial(rnd, 1, leaf),
                n_in=len(g), in_nb=store_g, raw_nb=gb, wire=wire,
                wire_in_bytes=wire_g, decode_s=cdc.decode_cost_s(gb),
                weighted=False, avail=avail[g0:g1]))
        root_w = [float(len(g)) for g in groups]
        root = VirtualFold(
            fn_name=f"r{rnd}-root", out_key=k_global(rnd),
            n_in=len(groups), in_nb=gb, raw_nb=gb, wire=False,
            wire_in_bytes=None, decode_s=0.0, weighted=True,
            in_keys=tuple(k_partial(rnd, 1, leaf)
                          for leaf in range(len(groups))),
            value=_key_fold(leaf_vals, root_w), store_out=True)
        return PopulationProgram(
            "lambda_fl", (tuple(leaves), (root,)),
            readback=((k_global(rnd), gb),), collect=lambda v: v[0])

    return PopPlan(((wire_g, store_g),), build)


@register_population_plan("lifl")
def _plan_lifl(topo, pop, rnd, cdc, limits, options, device):
    gb = pop.grad_bytes
    wire_g = cdc.wire_bytes(gb)
    wire, store_g = _wire_probe(cdc, pop.grad_elems)

    def build(members, put_cols):
        nm = len(members)
        avail = put_cols[0]
        b = cm.lifl_branching(nm)
        groups1 = tree_groups(nm, b)
        w1 = [float(len(g)) for g in groups1]     # all-ones level-1 sums
        level1 = tuple(
            VirtualFold(
                fn_name=f"r{rnd}-l1g{g_idx}",
                out_key=k_partial(rnd, 1, g_idx),
                n_in=len(g), in_nb=store_g, raw_nb=gb, wire=wire,
                wire_in_bytes=wire_g, decode_s=cdc.decode_cost_s(gb),
                weighted=True, avail=avail[g[0]:g[-1] + 1])
            for g_idx, g in enumerate(groups1))
        groups2 = tree_groups(len(groups1), b)
        # value plane, depth-first: only one level-2 group's level-1
        # partials are alive at a time
        vals2, w2 = [], []
        for g in groups2:
            v1 = [_client_fold(
                pop, rnd, members[groups1[i][0]:groups1[i][-1] + 1], cdc,
                wire, weighted=True, device=device) for i in g]
            vals2.append(_key_fold(v1, [w1[i] for i in g]))
            # detlint: allow[ORD001] g is a contiguous ascending index
            # run — replays the eager driver's exact summation order
            w2.append(float(sum(w1[i] for i in g)))
        level2 = tuple(
            VirtualFold(
                fn_name=f"r{rnd}-l2g{g_idx}",
                out_key=k_partial(rnd, 2, g_idx),
                n_in=len(g), in_nb=gb, raw_nb=gb, wire=False,
                wire_in_bytes=None, decode_s=0.0, weighted=True,
                in_keys=tuple(k_partial(rnd, 1, i) for i in g))
            for g_idx, g in enumerate(groups2))
        root = VirtualFold(
            fn_name=f"r{rnd}-l3g0", out_key=k_global(rnd),
            n_in=len(groups2), in_nb=gb, raw_nb=gb, wire=False,
            wire_in_bytes=None, decode_s=0.0, weighted=True,
            in_keys=tuple(k_partial(rnd, 2, g_idx)
                          for g_idx in range(len(groups2))),
            value=_key_fold(vals2, w2), store_out=True)
        return PopulationProgram(
            "lifl", (level1, level2, (root,)),
            readback=((k_global(rnd), gb),), collect=lambda v: v[0])

    return PopPlan(((wire_g, store_g),), build)


@register_population_plan("geo_tiered")
def _plan_geo_tiered(topo, pop, rnd, cdc, limits, options, device):
    edge_fanin = int(options.get("edge_fanin", topo.edge_fanin))
    region_fanin = int(options.get("region_fanin", topo.region_fanin))
    edge_mbps = options.get("edge_mbps", topo.edge_mbps)
    region_mbps = options.get("region_mbps", topo.region_mbps)
    backbone_mbps = options.get("backbone_mbps", topo.backbone_mbps)
    gb = pop.grad_bytes
    wire_g = cdc.wire_bytes(gb)
    wire, store_g = _wire_probe(cdc, pop.grad_elems)

    def build(members, put_cols):
        nm = len(members)
        avail = put_cols[0]
        groups_e = tree_groups(nm, edge_fanin)
        edge_w = [float(len(g)) for g in groups_e]
        edges = tuple(
            VirtualFold(
                fn_name=f"r{rnd}-edge{g_idx}",
                out_key=k_edge_partial(rnd, g_idx),
                n_in=len(g), in_nb=store_g, raw_nb=gb, wire=wire,
                wire_in_bytes=wire_g, decode_s=cdc.decode_cost_s(gb),
                weighted=True, avail=avail[g[0]:g[-1] + 1],
                read_mbps=edge_mbps, write_mbps=region_mbps)
            for g_idx, g in enumerate(groups_e))
        groups_r = tree_groups(len(groups_e), region_fanin)
        vals_r, region_w = [], []
        for g in groups_r:
            ve = [_client_fold(
                pop, rnd, members[groups_e[i][0]:groups_e[i][-1] + 1], cdc,
                wire, weighted=True, device=device) for i in g]
            vals_r.append(_key_fold(ve, [edge_w[i] for i in g]))
            # detlint: allow[ORD001] g is a contiguous ascending index
            # run — replays the eager driver's exact summation order
            region_w.append(float(sum(edge_w[i] for i in g)))
        regions = tuple(
            VirtualFold(
                fn_name=f"r{rnd}-region{g_idx}",
                out_key=k_region_partial(rnd, g_idx),
                n_in=len(g), in_nb=gb, raw_nb=gb, wire=False,
                wire_in_bytes=None, decode_s=0.0, weighted=True,
                in_keys=tuple(k_edge_partial(rnd, i) for i in g),
                read_mbps=region_mbps, write_mbps=backbone_mbps)
            for g_idx, g in enumerate(groups_r))
        root = VirtualFold(
            fn_name=f"r{rnd}-georoot", out_key=k_global(rnd),
            n_in=len(groups_r), in_nb=gb, raw_nb=gb, wire=False,
            wire_in_bytes=None, decode_s=0.0, weighted=True,
            in_keys=tuple(k_region_partial(rnd, g_idx)
                          for g_idx in range(len(groups_r))),
            value=_key_fold(vals_r, region_w), store_out=True,
            read_mbps=backbone_mbps, write_mbps=backbone_mbps)
        return PopulationProgram(
            "geo_tiered", (edges, regions, (root,)),
            readback=((k_global(rnd), gb),), collect=lambda v: v[0])

    return PopPlan(((wire_g, store_g),), build)


# ---------------------------------------------------------------------------
# The population round driver
# ---------------------------------------------------------------------------

def _arrival_cut(end_s: np.ndarray, quorum: int | None,
                 deadline_abs: float | None) -> np.ndarray:
    """Vectorized :func:`~repro_torch.serverless.event_sim.arrival_order`:
    stable (time, index) order, deadline filter, quorum truncation."""
    order = np.argsort(end_s, kind="stable")
    if deadline_abs is not None:
        order = order[end_s[order] <= deadline_abs]
    if quorum is not None:
        order = order[:int(quorum)]
    return order


def run_population_round(topology: str | Topology, pop: ClientPopulation, *,
                         rnd: int, store: ObjectStore,
                         runtime: LambdaRuntime,
                         engine=None, schedule: str | None = None,
                         upload: UploadModel | None = None,
                         client_ready_s=None,
                         straggler_threshold_s: float | None = None,
                         readahead_k: int | None = None,
                         codec: str | WireCodec | None = None,
                         track_codec_error: bool = True,
                         faults: FaultModel | None = None,
                         participation_k: int | None = None,
                         deadline_s: float | None = None,
                         quorum: int | None = None,
                         staleness_policy=None, stale_buffer=None,
                         hedge_factor: float | None = None,
                         workers: int | str | None = None,
                         host_mesh: int | None = None,
                         device: str | torch.device = "cuda",
                         **options) -> AggregationResult:
    """One aggregation round over a lazy :class:`ClientPopulation`.

    Mirrors :func:`~repro_torch.core.topology.run_round` step for step —
    membership, upload schedule, deadline/quorum cut, phase sequencing,
    read-back, result assembly — with the same knobs and bit-identical
    observables, but O(active participants) live state instead of O(N).
    ``engine`` (with ``host_mesh``) is validated and ignored: invocation
    accounting is
    value-agnostic (identical across engines), and the value plane
    replays the streaming reference arithmetic every engine matches
    bit-for-bit; results report ``engine="streaming"``. ``workers`` is
    validated too: the value plane's folds are whole-chunk launches (or
    whole-tensor ops on the CPU), so no host pool splits them. ``device``
    is where the value plane runs (``"cuda"`` unless the caller asks for
    the CPU); ``avg_flat`` is a tensor there.
    """
    topo = topology if isinstance(topology, Topology) \
        else get_topology(topology)
    if topo.name not in _POP_PLANS:
        raise NotImplementedError(
            f"topology {topo.name!r} has no population entry (registered: "
            f"{population_topologies()}); use run_round or register one "
            f"via register_population_plan")
    topo.validate_options(options)
    if options.get("colocated"):
        raise NotImplementedError(
            "the population engine does not model LIFL's colocated "
            "shared-memory fast path")
    if staleness_policy is not None or stale_buffer is not None:
        raise NotImplementedError(
            "the population engine does not support staleness re-entry "
            "(staleness_policy/stale_buffer)")
    if hedge_factor is not None:
        raise NotImplementedError(
            "the population engine does not support speculative hedging "
            "(hedge_factor)")
    device = resolve_device(device)
    # fail fast on unknown names and a host_mesh the device cannot hold
    get_backend(engine, host_mesh=host_mesh, device=device)
    get_pool(workers)                # and on bad worker counts
    sched = get_schedule(schedule)
    barrier = sched == "barrier"
    readahead = get_readahead(readahead_k)
    if barrier:
        readahead = 1
    cdc = get_codec(codec)
    n = pop.n_clients
    validate_fault_knobs(sched, participation_k=participation_k,
                         deadline_s=deadline_s, quorum=quorum,
                         faults=faults, n_clients=n,
                         allow_auto_quorum=schedule is None
                         or schedule == "auto")
    limits = runtime.limits
    p0, g0 = store.stats.puts, store.stats.gets
    rec_start = len(runtime.records)
    base = runtime.now if client_ready_s is None \
        else float(np.min(client_ready_s))

    # -- membership: participation sampling, dropout, stalls -----------------
    fm = faults if faults is not None else _NO_FAULTS
    if faults is not None:
        _bind_runtime_faults(runtime, faults)
    if participation_k is not None and participation_k < n:
        participants = fm.participants_arr(n, rnd, participation_k)
    else:
        participants = np.arange(n, dtype=np.int64)
    dropped = np.empty(0, dtype=np.int64)
    order = participants
    if faults is not None:
        drop = faults.dropout_at(n, rnd, participants)
        dropped = participants[drop]
        order = participants[~drop]
    if len(order) == 0:
        detail = "" if faults is None else (
            f" (dropout_rate={faults.dropout_rate}, seed={faults.seed})")
        raise RuntimeError(f"round {rnd}: no active participants{detail}")

    plan = _POP_PLANS[topo.name](topo, pop, rnd, cdc, limits, options,
                                 device)
    um = upload or UploadModel()
    ready_all = None if client_ready_s is None \
        else np.asarray(client_ready_s, np.float64)

    def schedule_for(members):
        """Vectorized `_upload_schedule`: same IEEE op order as the
        eager scalar loop, gathered draws, per-key completion columns."""
        starts, mults = um.plan_at(n, rnd, members)
        computes = um.compute_plan_at(n, rnd, members)
        ready = np.full(len(members), float(base)) if ready_all is None \
            else ready_all[members]
        t = ready + computes
        t = t + starts
        if faults is not None:
            t = t + faults.stall_at(n, rnd, members)
        t_start = t
        cols = []
        for wire_nb, _store_nb in plan.upload_key_bytes:
            if um.mbps is not None:
                t = t + (wire_nb / (um.mbps * 1e6)) * mults
            cols.append(t)
        end = cols[-1] if cols else t
        span = float(end.max()) if len(end) else float(base)
        return _UploadTimes(t_start, end, mults, span), cols

    up, put_cols = schedule_for(order)

    # -- deadline / quorum cut on the probed arrival times -------------------
    late = np.empty(0, dtype=np.int64)
    deadline_abs = None if deadline_s is None else base + float(deadline_s)
    if deadline_abs is not None or sched == "quorum":
        if sched == "quorum" and quorum is not None \
                and deadline_abs is not None:
            survivors = int(np.count_nonzero(up.end_s <= deadline_abs))
            if survivors < quorum:
                raise ValueError(
                    f"round {rnd}: quorum={quorum} exceeds the "
                    f"{survivors} arrival(s) left by the deadline "
                    f"({deadline_s:.3f} s); the deadline cuts first and "
                    f"the quorum gates within its survivors — lower the "
                    f"quorum or relax the deadline")
        keep = _arrival_cut(up.end_s, quorum, deadline_abs)
        if len(keep) == 0:
            raise RuntimeError(
                f"round {rnd}: no client upload completed by the deadline "
                f"({deadline_s:.3f} s) — nothing to aggregate")
        if sched != "quorum":
            keep = np.sort(keep)   # a deadline alone never reorders the fold
        if len(keep) != len(order) or not np.array_equal(keep,
                                                         np.arange(len(order))):
            miss = np.ones(len(order), dtype=bool)
            miss[keep] = False
            late = order[miss]
            order = order[keep]
            # the draws are cohort-keyed, so the rebuilt schedule is the
            # probe's rows at the kept positions — no re-gather needed
            up = _UploadTimes(up.start_s[keep], up.end_s[keep],
                              up.mults[keep],
                              float(up.end_s[keep].max()))
            put_cols = [col[keep] for col in put_cols]

    prog = plan.build(order, put_cols)

    # -- client uploads: aggregate accounting, no store keys -----------------
    store.account_io(
        puts=len(order) * len(plan.upload_key_bytes),
        # detlint: allow[ORD001] integer wire-byte counts over the
        # plan's ordered upload-key tuple
        bytes_written=len(order) * sum(snb for _w, snb
                                       in plan.upload_key_bytes))

    # -- aggregation phases ---------------------------------------------------
    handles = []
    prev_end = max(base, up.span_end_s)
    if barrier and len(late) and deadline_abs is not None:
        prev_end = max(prev_end, deadline_abs)
    first_start = prev_end
    for phase in prog.phases:
        ph = runtime.phase(start_s=prev_end if barrier else base)
        for f in phase:
            body = _virtual_body(f, store, readahead, pipelined=not barrier)
            mem = _alloc_mb(f.raw_nb, limits, readahead, fanin=f.n_in,
                            wire_in_bytes=f.wire_in_bytes,
                            weighted=f.weighted)
            inv_limits = tier_limits(limits, f.read_mbps, f.write_mbps)
            if barrier:
                ph.invoke_reliable(
                    body, fn_name=f.fn_name, memory_mb=mem,
                    straggler_threshold_s=straggler_threshold_s,
                    limits=None if inv_limits is limits else inv_limits)
            else:
                if f.avail is not None:
                    window = list(f.avail[:readahead])
                else:
                    window = [runtime.avail.time_of(key, base)
                              for key in f.in_keys[:readahead]]
                launch = max(base, ReadAheadWindow.launch_s(window,
                                                            readahead))
                ph.invoke_reliable(
                    body, fn_name=f.fn_name, memory_mb=mem,
                    straggler_threshold_s=straggler_threshold_s,
                    launch_s=launch, wait_avail=True, out_key=f.out_key,
                    limits=None if inv_limits is limits else inv_limits)
        prev_end = runtime.finish_phase(ph, barrier=barrier)
        handles.append(ph)
    agg_end = prev_end
    if not barrier and len(late) and deadline_abs is not None:
        agg_end = max(agg_end, deadline_abs)
        runtime.advance_to(agg_end)
    if barrier:
        # detlint: allow[ORD001] handles is the phase list in plan order
        # — the same order the eager driver sums barrier walls in
        wall = (first_start - base) + sum(ph.wall_s for ph in handles)
        phases = tuple(ph.wall_s for ph in handles)
    else:
        wall = agg_end - base
        phases = tuple(ph.end_s - base for ph in handles)

    # -- client read-back (cohort-sized, O(1)-batched) -----------------------
    values = [store.get(key) for key, _nb in prog.readback]
    if n > 1:
        for key, _nb in prog.readback:
            store.account_gets(key, n - 1)
    avg = prog.collect(values)
    member_done = _readback_times(sched, runtime, upload, up,
                                  prog.readback, agg_end)
    if len(order) == n and np.array_equal(order, np.arange(n)):
        client_done = member_done
    else:
        client_done = np.full(n, float(agg_end))
        client_done[order] = member_done
    round_end = max(agg_end, float(client_done.max())
                    if len(client_done) else agg_end)
    runtime.advance_to(round_end)

    recs = runtime.records[rec_start:]
    return AggregationResult(
        topology=prog.topology, avg_flat=avg,
        wall_clock_s=wall, phases_s=phases, records=recs,
        puts=store.stats.puts - p0, gets=store.stats.gets - g0,
        memory_mb=max(r.memory_mb for r in recs),
        peak_memory_mb=max(r.peak_memory_mb for r in recs),
        engine="streaming", schedule=sched, readahead_k=readahead,
        codec=cdc.name,
        codec_error=_pop_codec_error(cdc, avg, pop, rnd, order)
        if track_codec_error else float("nan"),
        round_start_s=base, round_end_s=round_end,
        client_done_s=client_done,
        participants=participants, arrivals=order,
        dropped=dropped, late=late,
        delivered_fraction=len(order) / len(participants),
        retries=sum(1 for r in recs if r.failed and not r.speculative),
        limits=limits)
