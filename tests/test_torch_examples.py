"""The port's examples (`repro_torch.examples`) on the CPU, at sizes cut by
their module constants, held against the reference: the JAX package's own
examples (`examples/*.py`, run with their `FederatedSession` recording each
session and round) or its API, on the same numpy inputs.

quickstart, faulty_round, million_clients and compression_composition
agree in `avg_flat`'s bits, puts, gets, billed GB-s, walls and costs;
elastic_reshard in its shard sizes and restored bits; serve_sharded and
train_federated_lm in shapes and dtypes with the reference (its weights
come from another RNG) and in tokens and parameters with the port's own
`serve_loop` and `federated_lm.run`.
"""
import dataclasses
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.core import cost_model as ref_cm
from repro.core.sharding import make_plan as ref_make_plan
from repro.launch.serve import serve_loop as ref_serve_loop
from repro.models import registry as ref_models
from repro_torch.configs import get_arch
from repro_torch.examples import (compression_composition, elastic_reshard,
                                  faulty_round, million_clients, quickstart,
                                  serve_sharded, train_federated_lm)
from repro_torch.launch import federated_lm
from repro_torch.launch.serve import serve_loop

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]


def reference_example(name: str, monkeypatch, **constants):
    """The reference's ``examples/<name>.py`` as a module, its constants
    set, its ``FederatedSession`` recording every session it builds and
    every round result (``session.results``)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for key, val in constants.items():
        monkeypatch.setattr(mod, key, val)
    sessions = []

    class Recording(mod.FederatedSession):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.results = []
            sessions.append(self)

        def round(self, *args, **kwargs):
            r = super().round(*args, **kwargs)
            self.results.append(r)
            return r

    monkeypatch.setattr(mod, "FederatedSession", Recording)
    return mod, sessions


def bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a), np.float32).tobytes()


QUICKSTART_ARGS = [[], ["--schedule", "pipelined", "--readahead-k", "4",
                        "--codec", "qsgd8"]]


@pytest.mark.parametrize("extra", QUICKSTART_ARGS, ids=["plain", "qsgd8"])
def test_quickstart(monkeypatch, capsys, extra):
    small = dict(N_CLIENTS=6, M=2, GRAD_SIZE=3_001)
    for key, val in small.items():
        monkeypatch.setattr(quickstart, key, val)
    got = quickstart.main(extra + CPU)
    ref, sessions = reference_example("quickstart", monkeypatch, **small)
    ref.main(extra)
    capsys.readouterr()
    assert list(got["topologies"]) == [s.config.topology for s in sessions]
    assert got.get("bit_identical", False) == (extra == [])
    for s in sessions:
        row, r = got["topologies"][s.config.topology], s.results[0]
        assert bits(row["avg_flat"]) == bits(r.avg_flat)
        assert (row["puts"], row["gets"], row["phases"]) \
            == (r.puts, r.gets, len(r.phases_s))
        assert row["billed_gb_s"] == [x.billed_gb_s for x in r.records]
        assert (row["wall_clock_s"], row["peak_memory_mb"], row["cost"]) \
            == (r.wall_clock_s, r.peak_memory_mb, s.total_cost())
        assert (row["codec"], row["codec_error"]) == (r.codec, r.codec_error)


FAULTY_ARGS = [[], ["--staleness-policy", "polynomial", "--hedge", "2"],
               ["--schedule", "quorum", "--rounds", "2"]]


@pytest.mark.parametrize("extra", FAULTY_ARGS,
                         ids=["plain", "stale-hedge", "quorum"])
def test_faulty_round(monkeypatch, capsys, extra):
    monkeypatch.setattr(faulty_round, "GRAD_SIZE", 2_003)
    got = faulty_round.main(extra + CPU)
    ref, sessions = reference_example("faulty_round", monkeypatch,
                                      GRAD_SIZE=2_003)
    ref.main(extra)
    (session,) = sessions
    capsys.readouterr()
    assert len(got["rounds"]) == len(session.results)
    for row, r in zip(got["rounds"], session.results):
        assert bits(row["avg_flat"]) == bits(r.avg_flat)
        assert row["exact"]
        assert (row["participants"], row["arrivals"], row["dropped"],
                row["late"]) == (tuple(r.participants), tuple(r.arrivals),
                                 tuple(r.dropped), tuple(r.late))
        assert (row["retries"], row["delivered_fraction"],
                row["stale_folded"], row["hedges"], row["wall_clock_s"]) \
            == (r.retries, r.delivered_fraction, tuple(r.stale_folded),
                (r.hedges, r.hedge_wins), r.wall_clock_s)
    assert (got["session_wall_s"], got["total_cost"], got["lambda_cost"],
            got["s3_cost"], got["totals"]) \
        == (session.session_wall_s, session.total_cost(),
            session.lambda_cost(), session.s3_cost(),
            dict(session.fault_totals))
    assert got["expected_deliveries"] == ref_cm.expected_deliveries(
        20, 16, 0.10)


def test_million_clients(monkeypatch, capsys):
    cohorts = (1_000, 2_000)
    monkeypatch.setattr(million_clients, "COHORTS", cohorts)
    got = million_clients.main(CPU)
    ref, _ = reference_example("million_clients", monkeypatch)
    for n in cohorts:
        for topology in million_clients.TOPOLOGIES:
            r, cost, _host = ref.one_round(topology, n)
            cell = got["cells"][n, topology]
            assert (cell["wall_clock_s"], cell["cost"]) \
                == (r.wall_clock_s, cost)
            p, p_cost, _ = million_clients.one_round(topology, n, "cpu")
            assert bits(p.avg_flat) == bits(r.avg_flat)
            assert (p.puts, p.gets, p_cost) == (r.puts, r.gets, cost)
            assert [x.billed_gb_s for x in p.records] \
                == [x.billed_gb_s for x in r.records]
        assert got["cheapest"][n] == min(
            million_clients.TOPOLOGIES,
            key=lambda t: got["cells"][n, t]["cost"])
    capsys.readouterr()


def test_compression_composition(monkeypatch, capsys):
    argv = ["--clients", "4", "--shards", "2", "--size", "20011"]
    got = compression_composition.main(argv + CPU)
    ref, sessions = reference_example("compression_composition", monkeypatch)
    ref.main(argv)
    capsys.readouterr()
    assert list(got["codecs"]) == [s.config.codec for s in sessions]
    for s in sessions:
        row, r = got["codecs"][s.config.codec], s.results[0]
        out_bytes = sum(nb for key, nb in s.store.stats.put_log
                        if "/avg/" in key or "/partial/" in key)
        assert bits(row["avg_flat"]) == bits(r.avg_flat)
        assert row["wire_mb"] == (s.store.stats.bytes_written
                                  - out_bytes) / 1e6
        assert (row["wall_clock_s"], row["codec_error"], row["codec"]) \
            == (r.wall_clock_s, r.codec_error, r.codec)
        assert row["billed_gb_s"] == sum(x.billed_gb_s for x in r.records)


def test_elastic_reshard(capsys):
    got = elastic_reshard.main(CPU)
    capsys.readouterr()
    assert got["saved_shard_sizes"] == ref_make_plan(
        "uniform", 1_000_003, 4).shard_sizes()
    assert got["resumed_shard_sizes"] == ref_make_plan(
        "uniform", 1_000_003, 8).shard_sizes()
    theta = np.random.default_rng(0).standard_normal(1_000_003).astype(
        np.float32)
    assert got["restored"].tobytes() == theta.tobytes()
    assert got["meta_extra"] == {"note": "round 100, M=4"}
    mb = 1024 * 1024
    for grad_mb, (m, mem) in got["min_shards"].items():
        assert m == ref_cm.min_shards_for(grad_mb * mb)
        assert mem == ref_cm.lambda_memory_mb("gradssharding",
                                              grad_mb * mb, m)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-2.7b",
                                  "whisper-tiny"])
def test_serve_sharded(capsys, arch):
    got = serve_sharded.main(["--arch", arch, "--new_tokens", "6"] + CPU)
    capsys.readouterr()
    own = serve_loop(get_arch(arch).smoke, batch=4, prompt_len=8,
                     max_new_tokens=6, max_len=22, device="cpu")
    assert got["generated"].tobytes() == own["generated"].tobytes()
    assert got["family"] == get_arch(arch).smoke.family
    if arch == "tinyllama-1.1b":
        ref = ref_serve_loop(ref_get_arch(arch).smoke, batch=4,
                             prompt_len=8, max_new_tokens=6, max_len=22)
        ref_gen = np.asarray(ref["generated"])
        assert (got["generated"].shape, got["generated"].dtype) \
            == (ref_gen.shape, ref_gen.dtype)


def _dotted(tree, prefix=""):
    out = {}
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            out.update(_dotted(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = (tuple(val.shape), str(val.dtype))
    return out


def test_train_federated_lm(capsys):
    argv = ["--smoke", "--rounds", "2", "--clients", "2", "--shards", "2",
            "--local_steps", "1", "--batch", "2", "--seq", "16"]
    got = train_federated_lm.main(argv + CPU)
    cfg = dataclasses.replace(get_arch("tinyllama-1.1b").smoke, remat=False)
    own = federated_lm.run(cfg, rounds=2, clients=2, shards=2, local_steps=1,
                           batch=2, seq=16, device="cpu")
    capsys.readouterr()
    assert list(got["params"]) == list(own["params"])
    for key, p in got["params"].items():
        assert torch.equal(p, own["params"][key]), key
    assert [r["mean_loss"] for r in got["rounds"]] \
        == [r["mean_loss"] for r in own["rounds"]]
    # the reference example's model: the smoke config at vocab 256
    ref_cfg = dataclasses.replace(ref_get_arch("tinyllama-1.1b").smoke,
                                  vocab=256, remat=False)
    ref_shapes = _dotted(jax.eval_shape(
        lambda: ref_models.init_params(jax.random.PRNGKey(0), ref_cfg)))
    assert {k: (tuple(p.shape), str(p.dtype).removeprefix("torch."))
            for k, p in got["params"].items()} == ref_shapes
