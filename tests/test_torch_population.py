"""The lazy million-client engine on the port, held against the JAX package.

`repro_torch.serverless.population` runs on the CPU beside
`repro.serverless.population`, live, from the same knobs: the cohort's
rows, every `run_population_round` observable (avg_flat bits, walls,
phases, op and byte counts, every invocation record, read-back times,
membership, codec error) across the four population plans × schedules ×
codecs × faults × deadline/quorum, lazy ≡ eager inside the port, the
refusals, and the session wiring. The fold kernel's carry form (a carried
accumulator, no divide until the last chunk) is held in its plain version
against numpy's `add.accumulate` in f32 and f64 over ragged chunk counts.
Then the 24 `smoke/population/*` keys of `benchmarks/expected_smoke.json`.
"""
import os
import pathlib
import resource
import subprocess
import sys
import tracemalloc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_compare as cmp  # noqa: E402
import repro.core.topology as ref_topology  # noqa: E402
import repro.serverless.population as ref_pop  # noqa: E402
import repro.serverless.runtime as ref_runtime  # noqa: E402
import repro.store as ref_store  # noqa: E402
import repro_torch.core.topology as port_topology  # noqa: E402
import repro_torch.serverless.population as port_pop  # noqa: E402
import repro_torch.serverless.runtime as port_runtime  # noqa: E402
import repro_torch.store as port_store  # noqa: E402
from repro_torch import smoke  # noqa: E402
from repro_torch.api import FederatedSession, SessionConfig  # noqa: E402
from repro_torch.kernels import fedavg_stream as fs  # noqa: E402
from repro_torch.serverless.faults import StalenessPolicy  # noqa: E402

TOPOLOGIES = ("gradssharding", "lambda_fl", "lifl", "geo_tiered")
UPLOAD = dict(mbps=12.0, jitter_s=0.4, rate_jitter=0.3, compute_s=0.2,
              compute_jitter=0.1, seed=5)
FAULTS = dict(seed=11, dropout_rate=0.15, stall_rate=0.2, stall_s=1.5,
              failure_rate=0.25)
SIDES = {
    "ref": (ref_topology.run_round, ref_pop, ref_store, ref_runtime),
    "port": (port_topology.run_round, port_pop, port_store, port_runtime),
}
PINNED = smoke.expected_invariants(groups=("population",))


def _kw(pkg, kw):
    out = cmp.build_knobs(pkg, kw)
    out.pop("device", None)
    return out


def _rounds(pkg, topo, n, rnd, elems, seed, kw):
    """The eager and the population round of one package."""
    run_round, pop_mod, store, runtime = SIDES[pkg]
    pop = pop_mod.ClientPopulation(n, grad_elems=elems, seed=seed)
    kw = _kw(pkg, kw)
    eager = run_round(topo, pop.materialize(rnd), rnd=rnd,
                      store=store.ObjectStore(),
                      runtime=runtime.LambdaRuntime(), **kw)
    extra = {"device": "cpu"} if pkg == "port" else {}
    lazy = pop_mod.run_population_round(
        topo, pop, rnd=rnd, store=store.ObjectStore(),
        runtime=runtime.LambdaRuntime(), **kw, **extra)
    return cmp.observe(eager), cmp.observe(lazy)


def _compare(topo, n=23, rnd=3, elems=257, seed=7, **kw):
    """Lazy ≡ eager inside the port, and the port's population round ≡ the
    reference's, on every observable."""
    ref_e, ref_p = _rounds("ref", topo, n, rnd, elems, seed, kw)
    port_e, port_p = _rounds("port", topo, n, rnd, elems, seed, kw)
    for key in port_p:
        assert port_p[key] == ref_p[key], f"{key}: port != reference"
        # the population engine reports engine="streaming"
        if key != "knobs":
            assert port_p[key] == port_e[key], f"{key}: lazy != eager"
    return port_p


# ---------------------------------------------------------------------------
# the cohort and the carry form of the fold
# ---------------------------------------------------------------------------

def test_population_rows_match_reference():
    ref = ref_pop.ClientPopulation(50, grad_elems=33, seed=2)
    port = port_pop.ClientPopulation(50, grad_elems=33, seed=2)
    full = port.grads(3, np.arange(50))
    assert full.numpy().tobytes() == ref.grads(3, np.arange(50)).tobytes()
    assert port.grads(3, [5, 17]).numpy().tobytes() == \
        full[[5, 17]].numpy().tobytes()
    assert torch.cat(list(port.iter_grads(3, np.arange(50), chunk=7))) \
        .numpy().tobytes() == full.numpy().tobytes()
    mats = port.materialize(3)
    assert len(mats) == 50 and torch.equal(mats[11], full[11])
    assert not torch.equal(port.grads(4, [5]), port.grads(3, [5]))
    with pytest.raises(ValueError):
        port_pop.ClientPopulation(0)
    with pytest.raises(ValueError):
        port_pop.ClientPopulation(5, grad_elems=0)


def _chunks(x, rows):
    return [x[s:s + rows] for s in range(0, len(x), rows)]


@pytest.mark.parametrize("n, rows", [(1, 512), (7, 3), (512, 512),
                                     (513, 512), (1500, 512), (97, 10)])
@pytest.mark.parametrize("weighted", [False, True])
def test_carry_form_equals_numpy_accumulate(n, rows, weighted):
    """The plain version's carry form, chunk by chunk, against numpy's
    add.accumulate down the whole client axis: raw accumulator after each
    chunk, and the final divide."""
    rng = np.random.default_rng([n, rows])
    x = (rng.standard_normal((n, 37)) * rng.uniform(0.5, 1e3, (n, 1))) \
        .astype(np.float32)
    ref = np.add.accumulate(x.astype(np.float64) if weighted else x, axis=0)
    acc, done = None, 0
    for chunk in _chunks(torch.from_numpy(x), rows):
        w = [1.0] * len(chunk) if weighted else None
        acc = fs.fedavg_stream_plain(chunk, w, carry=acc, finalize=False)
        done += len(chunk)
        assert acc.dtype == fs.acc_dtype(weighted)
        np.testing.assert_array_equal(acc.numpy(), ref[done - 1])
    mean = fs.fold_nodes([(torch.from_numpy(x[-1:]), [1.0] if weighted
                           else None)], carry=[fs.fedavg_stream_plain(
                               torch.from_numpy(x[:-1]), [1.0] * (n - 1)
                               if weighted else None, finalize=False)]
                         if n > 1 else None, divisors=[float(n)])[0]
    want = (ref[-1] / float(n)).astype(np.float32)
    assert mean.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("weighted", [False, True])
def test_fold_chunks_matches_reference(weighted):
    rng = np.random.default_rng(3)
    for n in (1, 5, 512, 1025):
        x = rng.standard_normal((n, 65)).astype(np.float32)
        want = ref_pop._fold_chunks(_chunks(x, 512), weighted, n)
        got = port_pop._fold_chunks(_chunks(torch.from_numpy(x), 512),
                                    weighted, n)
        assert got.numpy().tobytes() == want.tobytes()


def test_carry_validation():
    x = torch.zeros(3, 8)
    with pytest.raises(ValueError, match="carry"):
        fs.fold_nodes([(x, None)], carry=[torch.zeros(8, dtype=torch.float64)])
    with pytest.raises(ValueError, match="one entry per node"):
        fs.fold_nodes([(x, None)], carry=[None, None])
    # a weighted f64 fold carries f64; its raw accumulator is f64 too
    out = fs.fold_nodes([(x, [1.0] * 3)], finalize=False)[0]
    assert out.dtype == torch.float64


def test_key_fold_matches_reference():
    rng = np.random.default_rng(9)
    vals = [rng.standard_normal(129).astype(np.float32) for _ in range(5)]
    w = [3.0, 1.0, 7.0, 2.0, 5.0]
    want = ref_pop._key_fold(vals, w, ref_pop.get_backend("streaming"))
    got = port_pop._key_fold([torch.from_numpy(v) for v in vals], w)
    assert got.numpy().tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# lazy ≡ eager ≡ reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", [None, "barrier", "pipelined"])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_population_matches_eager_and_reference(topology, schedule):
    _compare(topology, schedule=schedule, upload=UPLOAD)


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_population_under_faults(topology):
    _compare(topology, schedule="pipelined", upload=UPLOAD, faults=FAULTS,
             participation_k=18, straggler_threshold_s=0.5)
    _compare(topology, schedule="quorum", quorum=10, upload=UPLOAD,
             faults=FAULTS, participation_k=18)


@pytest.mark.parametrize("codec", ["identity", "fp16", "qsgd8", "topk"])
def test_population_codecs(codec):
    _compare("gradssharding", codec=codec, upload=UPLOAD)
    _compare("geo_tiered", codec=codec, upload=UPLOAD, schedule="barrier")


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_population_deadline_quorum(topology):
    _compare(topology, upload=UPLOAD, deadline_s=1.0)
    _compare(topology, upload=UPLOAD, schedule="quorum", quorum=8,
             deadline_s=2.0)


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_population_edges_and_options(topology):
    _compare(topology, n=1, upload=UPLOAD)
    _compare(topology, n=2, upload=UPLOAD)
    _compare(topology, upload=None)
    _compare(topology, upload=UPLOAD, readahead_k=4)
    _compare(topology, upload=UPLOAD,
             client_ready_s=list(np.linspace(0.0, 3.0, 23)))
    if topology == "gradssharding":
        _compare(topology, upload=UPLOAD, n_shards=7)
        _compare(topology, upload=UPLOAD, partition="balanced", n_shards=3,
                 tensor_sizes=(64, 129, 64))
    if topology == "geo_tiered":
        _compare(topology, upload=UPLOAD, edge_fanin=3, region_fanin=2,
                 edge_mbps=20.0, backbone_mbps=300.0)


def test_population_chunked_cohort_matches_reference():
    """More members than one chunk: the carried fold spans chunks."""
    for topo in TOPOLOGIES:
        _compare(topo, n=1_300, elems=33, upload=UPLOAD, faults=FAULTS,
                 participation_k=1_200)


def test_population_session_multi_round_matches_reference():
    cfg = dict(topology="geo_tiered", schedule="pipelined", upload=UPLOAD,
               faults=FAULTS, participation_k=24, codec="fp16")
    out = {}
    for pkg in cmp.PACKAGES:
        pop_mod = SIDES[pkg][1]
        api = cmp.PACKAGES[pkg][0]
        pop = pop_mod.ClientPopulation(31, grad_elems=129, seed=3)
        se = cmp.session(pkg, **cfg)
        sp = api.FederatedSession(api.SessionConfig(
            population=pop, **cmp.build_knobs(pkg, dict(cfg, n_shards=4,
                                                        readahead_k=1))))
        obs = []
        for rnd in range(4):
            r_e = se.round(pop.materialize(rnd))
            r_p = sp.round()
            assert cmp.avg_bytes(r_p.avg_flat) == cmp.avg_bytes(r_e.avg_flat)
            assert r_p.wall_clock_s == r_e.wall_clock_s
            obs.append(cmp.observe(r_p))
        assert sp.summary() == se.summary()
        out[pkg] = (obs, cmp.observe_session(sp))
    cmp.assert_same(out)


def test_population_session_compaction_and_log_ops():
    pop = port_pop.ClientPopulation(200, grad_elems=64, seed=3)
    kw = dict(topology="lambda_fl", track_codec_error=False, device="cpu")
    ref = FederatedSession(SessionConfig(population=pop, **kw))
    lean = FederatedSession(SessionConfig(population=pop, log_ops=False,
                                          keep_records=False, **kw))
    for _ in range(3):
        r_ref = ref.round()
        r_lean = lean.round()
        assert torch.equal(r_lean.avg_flat, r_ref.avg_flat)
    s_ref, s_lean = ref.summary(), lean.summary()
    for key in ("total_cost", "puts", "gets", "session_wall_s"):
        assert s_lean[key] == s_ref[key]
    assert lean.store.stats.put_log == []
    assert lean.runtime.records == []
    assert len(ref.store.stats.put_log) > 0


def test_population_refuses_unsupported_knobs():
    pop = port_pop.ClientPopulation(8, grad_elems=32)
    kw = dict(rnd=0, store=port_store.ObjectStore(),
              runtime=port_runtime.LambdaRuntime(), device="cpu")
    run = port_pop.run_population_round
    with pytest.raises(NotImplementedError, match="staleness"):
        run("lambda_fl", pop, staleness_policy=StalenessPolicy(), **kw)
    with pytest.raises(NotImplementedError, match="hedg"):
        run("lambda_fl", pop, schedule="pipelined", hedge_factor=1.5, **kw)
    with pytest.raises(NotImplementedError, match="colocated"):
        run("lifl", pop, colocated=True, **kw)
    with pytest.raises(NotImplementedError, match="population entry"):
        run("sharded_tree", pop, **kw)
    with pytest.raises(NotImplementedError, match="item 10"):
        run("lambda_fl", pop, host_mesh=2, **kw)
    with pytest.raises(ValueError, match="client_grads"):
        FederatedSession(SessionConfig(population=pop, device="cpu")).round(
            [np.zeros(32, np.float32)])
    with pytest.raises(ValueError, match="client_grads"):
        FederatedSession(SessionConfig(device="cpu")).round()
    assert set(TOPOLOGIES) <= set(port_pop.population_topologies())
    assert port_pop.population_topologies() == \
        ref_pop.population_topologies()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run("lambda_fl", pop, **{**kw, "device": "cuda"})


def test_population_round_is_o_active(monkeypatch):
    """A 10^5-client cohort with 512 sampled participants: host residency
    (tracemalloc) stays far below the eager driver's N·|grad| floor, and
    the value plane never forms more than one chunk of rows at a time —
    every fold step carries the previous step's accumulator."""
    steps = []
    real = fs.fold_nodes

    def spy(nodes, acc="f64", **kw):
        steps.extend((int(i.shape[0]) if isinstance(i, torch.Tensor)
                      else len(i)) for i, _w in nodes)
        return real(nodes, acc, **kw)

    monkeypatch.setattr(fs, "fold_nodes", spy)
    n = 100_000
    pop = port_pop.ClientPopulation(n, grad_elems=4096, seed=1)
    tracemalloc.start()
    r = port_pop.run_population_round(
        "geo_tiered", pop, rnd=0, store=port_store.ObjectStore(log_ops=False),
        runtime=port_runtime.LambdaRuntime(),
        upload=cmp.build_knobs("port", dict(upload=UPLOAD))["upload"],
        faults=cmp.build_knobs("port", dict(faults=FAULTS))["faults"],
        participation_k=512, track_codec_error=False, device="cpu")
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert peak < 64 * 1024 * 1024, f"peak {peak / 1e6:.1f} MB"
    assert len(r.arrivals) <= 512 and r.wall_clock_s > 0.0
    assert len(r.client_done_s) == n
    assert steps and max(steps) <= port_pop.CHUNK_ROWS


CI_ROUND = """
import torch
from repro_torch.core.cost_model import UploadModel
from repro_torch.serverless.faults import FaultModel
from repro_torch.serverless.population import (ClientPopulation,
                                               run_population_round)
from repro_torch.serverless.runtime import LambdaRuntime
from repro_torch.store import ObjectStore

r = run_population_round(
    "geo_tiered", ClientPopulation(100_000, seed=1), rnd=0,
    store=ObjectStore(log_ops=False), runtime=LambdaRuntime(),
    schedule="pipelined", participation_k=4_096,
    upload=UploadModel(mbps=16.0, jitter_s=3.0, seed=11),
    faults=FaultModel(seed=7, dropout_rate=0.05, failure_rate=0.1),
    track_codec_error=False, device="cpu")
assert len(r.client_done_s) == 100_000
print("ok", len(r.records))
"""
AS_LIMIT = 1_572_864 * 1024          # the CI scale job's `ulimit -v`


def test_ci_scale_round_under_the_address_space_limit():
    """The CI `scale` job's N = 10^5 geo_tiered round, on the port's CPU
    value plane, under the job's 1.5 GiB address-space limit."""
    root = pathlib.Path(__file__).resolve().parents[1]
    probe = subprocess.run(
        [sys.executable, "-c", "import torch"], capture_output=True,
        text=True, preexec_fn=lambda: resource.setrlimit(
            resource.RLIMIT_AS, (AS_LIMIT, AS_LIMIT)))
    if probe.returncode != 0:
        pytest.skip("this PyTorch build cannot be imported under a 1.5 GiB "
                    "address-space limit")
    out = subprocess.run(
        [sys.executable, "-c", CI_ROUND], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(root / "src")},
        preexec_fn=lambda: resource.setrlimit(
            resource.RLIMIT_AS, (AS_LIMIT, AS_LIMIT)))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")


# ---------------------------------------------------------------------------
# the pinned keys
# ---------------------------------------------------------------------------

def test_pinned_population_keys_on_cpu():
    got = smoke.population_invariants("cpu")
    assert len(PINNED) == 24 and len(got) == 24
    assert smoke.mismatches(got, PINNED) == []
