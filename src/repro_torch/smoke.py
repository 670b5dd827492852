"""The reference's pinned smoke invariants, on the port.

``benchmarks/expected_smoke.json`` pins, for each topology, a tiny
fixed-seed round across the engine × schedule grid and the pipelined
``readahead_k`` sweeps at two (N, M) points: S3 op counts, billed GB-s,
modeled walls, peak memory and a SHA-256 of the averaged gradient's bytes.
Each function here recomputes one group of those keys with this package,
on any device, under the reference's key names, constants and rounding,
so a run can be held against the committed file bit for bit:

* :func:`main_path_invariants` — ``smoke/{gradssharding,lambda_fl,lifl}``
  (168 keys);
* :func:`codec_invariants` — the wire-codec gate, ``smoke/codec`` (36);
* :func:`sharded_tree_invariants` — ``smoke/sharded_tree`` (56) and
  ``smoke/sharded_tree_equals_lambda_fl`` (1);
* :func:`fault_invariants` — seeded faulty, quorum and deadline rounds,
  ``smoke/fault`` (27);
* :func:`robust_invariants` — stale re-entry and hedging over 3-round
  sessions, ``smoke/robust`` (18);
* :func:`geo_invariants` — the edge → region → global topology,
  ``smoke/geo_tiered`` (33);
* :func:`population_invariants` — the lazy cohort engine against the
  eager driver, ``smoke/population`` (24).

:func:`all_invariants` runs them all: 363 of the file's 366 keys (the
other 3, ``roofline/host_fold``, belong to the multi-device engine, which
is not ported).
"""
from __future__ import annotations

import hashlib
import json
import pathlib

import numpy as np
import torch

from repro_torch.api import FederatedSession
from repro_torch.core import cost_model as cm
from repro_torch.core.cost_model import UploadModel
from repro_torch.core.geo_tiered import GeoTieredTopology
from repro_torch.core.topology import register_topology
from repro_torch.serverless.faults import FaultModel, StalenessPolicy
from repro_torch.serverless.population import (ClientPopulation,
                                               population_topologies)

N_CLIENTS = 8
GRAD_ELEMS = 4_096
N_SHARDS = 4
# second readahead grid point: different N regime, wider sharding
N_CLIENTS_2 = 12
N_SHARDS_2 = 8
TOPOLOGIES = ("gradssharding", "lambda_fl", "lifl")
# the plugin topology held in the same grid as the main path's
SHARDED_TREE = "sharded_tree"
CODECS = ("identity", "fp16", "qsgd8", "topk")
ENGINES = ("streaming", "batched", "incremental")
SCHEDULES = ("barrier", "pipelined")
READAHEAD_KS = (1, 2, 4, 8)
READAHEAD_POINTS = {"": (N_CLIENTS, N_SHARDS), "2": (N_CLIENTS_2, N_SHARDS_2)}

UPLOAD = UploadModel(mbps=16.0, jitter_s=3.0, rate_jitter=0.5, seed=11)

# seeded disturbance model of the fault rows: dropout + upload stalls +
# aggregator failures with exponential-backoff retries
FAULTS = FaultModel(dropout_rate=0.2, stall_rate=0.2, stall_s=4.0,
                    failure_rate=0.3, retry_backoff_s=0.5, seed=9)
FAULT_CASES = (
    ("faulty_pipelined",
     dict(schedule="pipelined", faults=FAULTS, participation_k=6)),
    ("faulty_quorum",
     dict(schedule="quorum", quorum=4, faults=FAULTS, participation_k=6)),
    ("deadline",
     dict(schedule="pipelined", faults=FAULTS, deadline_s=4.0)),
)
# the robustness rows: 3-round sessions in which a tight deadline's
# casualties re-enter later rounds with polynomial staleness weights, and
# in which slow retries let a speculative hedge win
STALE_FAULTS = FaultModel(dropout_rate=0.2, stall_rate=0.3, stall_s=6.0,
                          seed=9)
STALE_POLICY = StalenessPolicy(kind="polynomial", alpha=0.5,
                               reentry_delay_s=2.0)
STALE_DEADLINE_S = 2.0
HEDGE_FAULTS = FaultModel(failure_rate=0.4, retry_backoff_s=2.0, seed=5)
HEDGE_FACTOR = 1.2
ROBUST_ROUNDS = 3
# the geo_tiered gate's configured instance, registered under its own name
# (the cost hooks read the instance's tier knobs)
GEO_NAME = "geo_smoke"
GEO_TIERS = dict(edge_fanin=4, region_fanin=2, edge_mbps=40.0,
                 region_mbps=120.0, backbone_mbps=400.0)
#: every group this module reproduces
GROUPS = TOPOLOGIES + ("codec", SHARDED_TREE, "sharded_tree_equals_lambda_fl",
                       "fault", "robust", "geo_tiered", "population")

EXPECTED_PATH = (pathlib.Path(__file__).resolve().parents[2] / "benchmarks"
                 / "expected_smoke.json")


def smoke_grads(n: int = N_CLIENTS, seed: int = 1234) -> list[np.ndarray]:
    """The smoke round's client gradients (numpy f32, seeded)."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(GRAD_ELEMS).astype(np.float32)
            for _ in range(n)]


def readahead_grads(point: str) -> list[np.ndarray]:
    return smoke_grads() if not point else \
        smoke_grads(READAHEAD_POINTS[point][0], seed=4321)


def avg_hash(avg) -> str:
    """First 16 hex digits of the SHA-256 of an average's bytes (a tensor
    on any device, or a numpy array)."""
    if isinstance(avg, torch.Tensor):
        avg = avg.detach().cpu().numpy()
    return hashlib.sha256(np.ascontiguousarray(avg).tobytes()).hexdigest()[:16]


def record(result) -> dict:
    """The pinned quantities of one round's result, rounded as pinned."""
    return {
        "puts": result.puts,
        "gets": result.gets,
        "billed_gb_s": round(sum(r.billed_gb_s for r in result.records), 12),
        "wall_s": round(result.wall_clock_s, 12),
        "peak_memory_mb": round(result.peak_memory_mb, 6),
        "avg_sha256": avg_hash(result.avg_flat),
    }


GRID_FIELDS = ("puts", "gets", "billed_gb_s", "wall_s", "avg_sha256")
READAHEAD_FIELDS = ("wall_s", "avg_sha256", "peak_memory_mb")


def grid_round(topology: str, engine: str, schedule: str, grads,
               device: str):
    return FederatedSession(
        topology=topology, n_shards=N_SHARDS, engine=engine,
        schedule=schedule, upload=UPLOAD, readahead_k=1, codec="identity",
        device=device).round(grads)


def readahead_round(topology: str, point: str, k: int, grads, device: str):
    return FederatedSession(
        topology=topology, n_shards=READAHEAD_POINTS[point][1],
        schedule="pipelined", upload=UPLOAD, readahead_k=k,
        codec="identity", device=device).round(grads)


def model_pipelined_wall_s(topology: str) -> float:
    m = N_SHARDS if topology in ("gradssharding", SHARDED_TREE) else 1
    model = cm.pipelined_round_cost(topology, GRAD_ELEMS * 4, N_CLIENTS, m,
                                    upload=UPLOAD, readahead_k=1,
                                    codec="identity")
    return round(model.wall_clock_s, 12)


def topology_invariants(topology: str, device: str = "cuda") -> dict:
    """One topology's 56 grid keys, ``smoke/<topology>/*``, computed by
    the port on ``device``."""
    out: dict = {}
    grads = smoke_grads()
    hashes = set()
    for engine in ENGINES:
        for schedule in SCHEDULES:
            rec = record(grid_round(topology, engine, schedule, grads,
                                    device))
            tag = f"smoke/{topology}/{engine}/{schedule}"
            out.update({f"{tag}/{f}": rec[f] for f in GRID_FIELDS})
            hashes.add(rec["avg_sha256"])
    for point in READAHEAD_POINTS:
        g2 = readahead_grads(point)
        for k in READAHEAD_KS:
            rec = record(readahead_round(topology, point, k, g2, device))
            tag = f"smoke/{topology}/readahead{point}_k{k}"
            out.update({f"{tag}/{f}": rec[f] for f in READAHEAD_FIELDS})
            if not point:
                hashes.add(rec["avg_sha256"])
    out[f"smoke/{topology}/model_pipelined_wall_s"] = \
        model_pipelined_wall_s(topology)
    out[f"smoke/{topology}/bit_identical"] = len(hashes) == 1
    return out


def main_path_invariants(device: str = "cuda") -> dict:
    """All 168 ``smoke/{gradssharding,lambda_fl,lifl}/*`` keys, computed by
    the port on ``device``."""
    out: dict = {}
    for topology in TOPOLOGIES:
        out.update(topology_invariants(topology, device))
    return out


def grid_hashes(keys: dict, topology: str) -> set:
    """The ``avg_sha256`` values of a topology's grid and first
    ``readahead_k`` sweep."""
    return {v for k, v in keys.items()
            if k.startswith(f"smoke/{topology}/")
            and "/readahead2_" not in k and k.endswith("/avg_sha256")}


def sharded_tree_invariants(device: str = "cuda",
                            lambda_fl_hashes=None) -> dict:
    """The 56 ``smoke/sharded_tree/*`` keys and
    ``smoke/sharded_tree_equals_lambda_fl``: the plugin's hash set must be
    λ-FL's (``lambda_fl_hashes``, computed on ``device`` when not
    given)."""
    if lambda_fl_hashes is None:
        lambda_fl_hashes = grid_hashes(
            topology_invariants("lambda_fl", device), "lambda_fl")
    out = topology_invariants(SHARDED_TREE, device)
    out["smoke/sharded_tree_equals_lambda_fl"] = \
        grid_hashes(out, SHARDED_TREE) == set(lambda_fl_hashes)
    return out


def fault_invariants(device: str = "cuda") -> dict:
    """The 27 ``smoke/fault/*`` keys: GradsSharding under the seeded
    ``FAULTS`` with partial participation (pipelined, then quorum) and with
    a deadline, every engine; delivered fraction, arrivals, retries, op
    counts, billing, wall, hash and cross-engine determinism."""
    out: dict = {}
    grads = smoke_grads()
    for name, knobs in FAULT_CASES:
        per_engine = set()
        for engine in ENGINES:
            r = FederatedSession(
                topology="gradssharding", n_shards=N_SHARDS, engine=engine,
                upload=UPLOAD, readahead_k=1, codec="identity",
                device=device, **knobs).round(grads)
            per_engine.add(avg_hash(r.avg_flat))
        tag = f"smoke/fault/{name}"
        out[f"{tag}/delivered_fraction"] = round(r.delivered_fraction, 12)
        out[f"{tag}/n_arrivals"] = len(r.arrivals)
        out[f"{tag}/retries"] = r.retries
        out[f"{tag}/puts"] = r.puts
        out[f"{tag}/gets"] = r.gets
        out[f"{tag}/billed_gb_s"] = round(
            sum(rec.billed_gb_s for rec in r.records), 12)
        out[f"{tag}/wall_s"] = round(r.wall_clock_s, 12)
        out[f"{tag}/avg_sha256"] = next(iter(per_engine))
        out[f"{tag}/engine_deterministic"] = len(per_engine) == 1
    return out


def robust_session(engine: str, device: str, hedge: bool | None = None
                   ) -> tuple:
    """One 3-round GradsSharding session of the robustness gate: stale
    re-entry when ``hedge`` is None, else hedging (``HEDGE_FACTOR``) or its
    unhedged twin. Returns the session and its round results."""
    if hedge is None:
        knobs = dict(faults=STALE_FAULTS, deadline_s=STALE_DEADLINE_S,
                     staleness_policy=STALE_POLICY)
    else:
        knobs = dict(faults=HEDGE_FAULTS,
                     hedge_factor=HEDGE_FACTOR if hedge else None)
    session = FederatedSession(
        topology="gradssharding", n_shards=N_SHARDS, engine=engine,
        schedule="pipelined", upload=UPLOAD, readahead_k=1,
        codec="identity", device=device, **knobs)
    grads = smoke_grads()
    return session, list(session.run(lambda rnd: grads,
                                     rounds=ROBUST_ROUNDS))


def robust_invariants(device: str = "cuda") -> dict:
    """The 18 ``smoke/robust/*`` keys: stale re-entry (stale folds,
    dropped and late tallies, billing, summed walls, the per-round hash
    chain) and hedging against its unhedged twin (hedges and wins,
    retries, billing, walls, the tail-wall cut, an unchanged mean)."""
    out: dict = {}
    per_engine: set = set()
    for engine in ENGINES:
        session, results = robust_session(engine, device)
        per_engine.add("|".join(avg_hash(r.avg_flat) for r in results))
    totals = session.fault_totals
    tag = "smoke/robust/stale_reentry"
    out[f"{tag}/stale_folded"] = totals["stale_folded"]
    out[f"{tag}/dropped"] = totals["dropped"]
    out[f"{tag}/late"] = totals["late"]
    out[f"{tag}/billed_gb_s"] = round(session.runtime.total_gb_s(), 12)
    out[f"{tag}/sum_walls_s"] = round(
        sum(r.wall_clock_s for r in results), 12)
    out[f"{tag}/avg_sha_chain"] = next(iter(per_engine))
    out[f"{tag}/engine_deterministic"] = len(per_engine) == 1
    runs = {}
    for hedge in (False, True):
        chains = set()
        for engine in ENGINES:
            session, results = robust_session(engine, device, hedge)
            chains.add("|".join(avg_hash(r.avg_flat) for r in results))
        runs[hedge] = (session.fault_totals,
                       sum(r.wall_clock_s for r in results),
                       session.runtime.total_gb_s(), chains)
    totals, walls, billed, chains = runs[True]
    _, walls0, billed0, chains0 = runs[False]
    tag = "smoke/robust/hedging"
    out[f"{tag}/hedges"] = totals["hedges"]
    out[f"{tag}/hedge_wins"] = totals["hedge_wins"]
    out[f"{tag}/retries"] = totals["retries"]
    out[f"{tag}/billed_gb_s"] = round(billed, 12)
    out[f"{tag}/sum_walls_s"] = round(walls, 12)
    out[f"{tag}/unhedged_sum_walls_s"] = round(walls0, 12)
    out[f"{tag}/extra_billed_gb_s"] = round(billed - billed0, 12)
    out[f"{tag}/tail_wall_cut"] = walls < walls0
    out[f"{tag}/avg_sha_chain"] = next(iter(chains))
    out[f"{tag}/avg_matches_unhedged"] = chains == chains0
    out[f"{tag}/engine_deterministic"] = len(chains) == 1
    return out


def geo_invariants(device: str = "cuda") -> dict:
    """The 33 ``smoke/geo_tiered/*`` keys: the configured edge → region →
    global instance (registered under ``GEO_NAME``, replacing any earlier
    one) across the engine × schedule grid, and the analytical pipelined
    wall with its sim == model parity."""
    name = GEO_NAME
    register_topology(name, replace=True)(GeoTieredTopology(**GEO_TIERS))
    out: dict = {}
    grads = smoke_grads()
    hashes: set = set()
    sim_wall = None
    for engine in ENGINES:
        for schedule in SCHEDULES:
            r = FederatedSession(
                topology=name, engine=engine, schedule=schedule,
                upload=UPLOAD, readahead_k=1, codec="identity",
                device=device).round(grads)
            if schedule == "pipelined":
                sim_wall = r.wall_clock_s
            rec = record(r)
            tag = f"smoke/geo_tiered/{engine}/{schedule}"
            out.update({f"{tag}/{f}": rec[f] for f in GRID_FIELDS})
            hashes.add(rec["avg_sha256"])
    out["smoke/geo_tiered/bit_identical"] = len(hashes) == 1
    model = cm.pipelined_round_cost(
        name, GRAD_ELEMS * 4, N_CLIENTS, 1, upload=UPLOAD, readahead_k=1,
        codec="identity")
    out["smoke/geo_tiered/model_pipelined_wall_s"] = \
        round(model.wall_clock_s, 12)
    out["smoke/geo_tiered/sim_model_parity"] = bool(
        abs(sim_wall - model.wall_clock_s) <= 1e-9 * abs(sim_wall))
    return out


def population_invariants(device: str = "cuda") -> dict:
    """The 24 ``smoke/population/*`` keys: per population topology, the
    same fixed-seed round through the lazy cohort engine and eagerly over
    ``pop.materialize(0)``; the population run's op counts, billing, wall
    and hash, and whether the two drivers agree on all of them."""
    out: dict = {}
    for topology in population_topologies():
        pop = ClientPopulation(N_CLIENTS, grad_elems=GRAD_ELEMS, seed=1234)
        cfg = dict(topology=topology, n_shards=N_SHARDS,
                   schedule="pipelined", upload=UPLOAD, readahead_k=2,
                   codec="identity", device=device)
        r_e = FederatedSession(**cfg).round(pop.materialize(0))
        r_p = FederatedSession(population=pop, **cfg).round()
        billed = sum(rec.billed_gb_s for rec in r_p.records)
        billed_e = sum(rec.billed_gb_s for rec in r_e.records)
        same = (avg_hash(r_p.avg_flat) == avg_hash(r_e.avg_flat)
                and r_p.puts == r_e.puts and r_p.gets == r_e.gets
                and r_p.wall_clock_s == r_e.wall_clock_s
                and billed == billed_e)
        tag = f"smoke/population/{topology}"
        out[f"{tag}/puts"] = r_p.puts
        out[f"{tag}/gets"] = r_p.gets
        out[f"{tag}/billed_gb_s"] = round(billed, 12)
        out[f"{tag}/wall_s"] = round(r_p.wall_clock_s, 12)
        out[f"{tag}/avg_sha256"] = avg_hash(r_p.avg_flat)
        out[f"{tag}/matches_eager"] = same
    return out


def all_invariants(device: str = "cuda") -> dict:
    """Every group of :data:`GROUPS` on ``device``: 363 keys."""
    out = main_path_invariants(device)
    out.update(codec_invariants(device, raw_hashes=gradssharding_hashes(out)))
    out.update(sharded_tree_invariants(
        device, lambda_fl_hashes=grid_hashes(out, "lambda_fl")))
    out.update(fault_invariants(device))
    out.update(robust_invariants(device))
    out.update(geo_invariants(device))
    out.update(population_invariants(device))
    return out


def codec_invariants(device: str = "cuda", raw_hashes=None) -> dict:
    """The 36 ``smoke/codec/*`` keys, computed by the port on ``device``:
    GradsSharding at N = 8, M = 4, pipelined, ``readahead_k=2``, every
    engine, each codec. ``identity/matches_raw_grid`` holds the identity
    hashes against ``raw_hashes``, the GradsSharding hashes of
    :func:`main_path_invariants` (computed on ``device`` when not given)."""
    if raw_hashes is None:
        raw_hashes = gradssharding_hashes(main_path_invariants(device))
    out: dict = {}
    grads = smoke_grads()
    for codec in CODECS:
        per_engine = set()
        for engine in ENGINES:
            session = FederatedSession(
                topology="gradssharding", n_shards=N_SHARDS, engine=engine,
                schedule="pipelined", upload=UPLOAD, readahead_k=2,
                codec=codec, device=device)
            r = session.round(grads)
            per_engine.add(avg_hash(r.avg_flat))
        wire = sum(nb for key, nb in session.store.stats.put_log
                   if "/avg/" not in key and "/partial/" not in key)
        model = cm.pipelined_round_cost(
            "gradssharding", GRAD_ELEMS * 4, N_CLIENTS, N_SHARDS,
            upload=UPLOAD, readahead_k=2, codec=codec)
        tag = f"smoke/codec/{codec}"
        out[f"{tag}/puts"] = r.puts
        out[f"{tag}/gets"] = r.gets
        out[f"{tag}/wire_upload_bytes"] = wire
        out[f"{tag}/billed_gb_s"] = round(
            sum(rec.billed_gb_s for rec in r.records), 12)
        out[f"{tag}/wall_s"] = round(r.wall_clock_s, 12)
        out[f"{tag}/model_wall_s"] = round(model.wall_clock_s, 12)
        out[f"{tag}/codec_error"] = round(r.codec_error, 12)
        out[f"{tag}/engine_deterministic"] = len(per_engine) == 1
        if codec == "identity":
            out[f"{tag}/matches_raw_grid"] = per_engine <= set(raw_hashes)
        else:
            out[f"{tag}/avg_sha256"] = next(iter(per_engine))
    return out


def gradssharding_hashes(main_path: dict) -> set:
    """The GradsSharding ``avg_sha256`` values of a
    :func:`main_path_invariants` result over the smoke gradients (the
    engine × schedule grid and the first ``readahead_k`` sweep): the codec
    gate's raw grid."""
    return grid_hashes(main_path, "gradssharding")


def expected_invariants(path: str | pathlib.Path = EXPECTED_PATH,
                        groups=TOPOLOGIES) -> dict:
    """The committed keys under ``smoke/<group>`` for each of ``groups``
    (default: the three builtin topologies; ``("codec",)`` for the codec
    gate; :data:`GROUPS` for every group this module reproduces)."""
    with open(path) as fh:
        pinned = json.load(fh)
    return {k: v for k, v in pinned.items()
            if k.split("/")[:2] in [["smoke", g] for g in groups]}


def mismatches(got: dict, expected: dict) -> list[str]:
    """One line per key that is missing or differs."""
    return [f"{k}: got {got.get(k)!r}, pinned {v!r}"
            for k, v in sorted(expected.items()) if got.get(k) != v]
