"""The reference's pinned smoke invariants of the main path, on the port.

``benchmarks/expected_smoke.json`` pins, for each of the three builtin
topologies, a tiny fixed-seed round across the engine × schedule grid and
the pipelined ``readahead_k`` sweeps at two (N, M) points: S3 op counts,
billed GB-s, modeled walls, peak memory and a SHA-256 of the averaged
gradient's bytes (168 keys under ``smoke/{gradssharding,lambda_fl,lifl}``).
:func:`main_path_invariants` recomputes those keys with this package, on
any device, under the reference's key names and rounding, so a run can be
held against the committed file bit for bit. :func:`codec_invariants` does
the same for the wire-codec gate (36 keys under ``smoke/codec``).
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

N_CLIENTS = 8
GRAD_ELEMS = 4_096
N_SHARDS = 4
# second readahead grid point: different N regime, wider sharding
N_CLIENTS_2 = 12
N_SHARDS_2 = 8
TOPOLOGIES = ("gradssharding", "lambda_fl", "lifl")
CODECS = ("identity", "fp16", "qsgd8", "topk")
ENGINES = ("streaming", "batched", "incremental")
SCHEDULES = ("barrier", "pipelined")
READAHEAD_KS = (1, 2, 4, 8)
READAHEAD_POINTS = {"": (N_CLIENTS, N_SHARDS), "2": (N_CLIENTS_2, N_SHARDS_2)}

UPLOAD = UploadModel(mbps=16.0, jitter_s=3.0, rate_jitter=0.5, seed=11)

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
    m = N_SHARDS if topology == "gradssharding" else 1
    model = cm.pipelined_round_cost(topology, GRAD_ELEMS * 4, N_CLIENTS, m,
                                    upload=UPLOAD, readahead_k=1,
                                    codec="identity")
    return round(model.wall_clock_s, 12)


def main_path_invariants(device: str = "cuda") -> dict:
    """All 168 ``smoke/{gradssharding,lambda_fl,lifl}/*`` keys, computed by
    the port on ``device``."""
    out: dict = {}
    grads = smoke_grads()
    for topology in TOPOLOGIES:
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
    return {v for k, v in main_path.items()
            if k.startswith("smoke/gradssharding/")
            and "/readahead2_" not in k and k.endswith("/avg_sha256")}


def expected_invariants(path: str | pathlib.Path = EXPECTED_PATH,
                        groups=TOPOLOGIES) -> dict:
    """The committed keys under ``smoke/<group>`` for each of ``groups``
    (default: the three builtin topologies; ``("codec",)`` for the codec
    gate)."""
    with open(path) as fh:
        pinned = json.load(fh)
    return {k: v for k, v in pinned.items()
            if k.split("/")[:2] in [["smoke", g] for g in groups]}


def mismatches(got: dict, expected: dict) -> list[str]:
    """One line per key that is missing or differs."""
    return [f"{k}: got {got.get(k)!r}, pinned {v!r}"
            for k, v in sorted(expected.items()) if got.get(k) != v]
