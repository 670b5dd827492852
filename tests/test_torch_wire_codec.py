"""The port's wire codecs (`repro_torch.core.wire_codec`) on the main path.

The cases of the JAX package's `tests/test_wire_codec.py` that apply to the
three builtin topologies, run on the port with `device="cpu"`: registry
and knob, idempotence, `decode_range == decode`, empty payloads, wire
shrink, lossy determinism across the engine × schedule × read-ahead grid,
wire-byte accounting, sim == cost-model parity per codec, and the qsgd8
feasibility flip. Then the port against the JAX package itself: the same
payload bytes for every codec, the same round (average bits,
`codec_error`, puts, gets, billed GB-s) for each codec × topology ×
engine, and the 36 pinned `smoke/codec/*` keys of
`benchmarks/expected_smoke.json` — exactly, no tolerance.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import FederatedSession as RefSession  # noqa: E402
from repro.core import cost_model as ref_cm  # noqa: E402
from repro.core import wire_codec as ref_wc  # noqa: E402
from repro.core.cost_model import UploadModel as RefUpload  # noqa: E402
from repro_torch import smoke  # noqa: E402
from repro_torch.api import FederatedSession, SessionConfig  # noqa: E402
from repro_torch.core import agg_engine  # noqa: E402
from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.core import wire_codec as wc  # noqa: E402
from repro_torch.core.cost_model import UploadModel  # noqa: E402
from repro_torch.serverless import LambdaRuntime  # noqa: E402

MB = 1024 * 1024
ENGINES = ("streaming", "batched", "incremental")
LOSSY = ("fp16", "qsgd8", "topk")
CODECS = ("identity",) + LOSSY
TOPOLOGIES = (("gradssharding", {"n_shards": 4}), ("lambda_fl", {}),
              ("lifl", {}), ("lifl", {"colocated": True}))

JITTER = UploadModel(mbps=16.0, jitter_s=3.0, rate_jitter=0.5, seed=11)
REF_JITTER = RefUpload(mbps=16.0, jitter_s=3.0, rate_jitter=0.5, seed=11)


def _grads(n=12, size=5_003, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(size).astype(np.float32) for _ in range(n)]


def _round(topology, grads, **kw):
    return FederatedSession(topology=topology, device="cpu",
                            **kw).round(grads)


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _topo_id(p):
    return p[0] + ("_colocated" if p[1].get("colocated") else "")


@dataclasses.dataclass(frozen=True)
class FixedStarts(UploadModel):
    starts: tuple = ()

    def plan(self, n, rnd=0):
        return np.asarray(self.starts, float), np.ones(n)


# ---------------------------------------------------------------------------
# Registry + knob resolution
# ---------------------------------------------------------------------------

def test_codec_registry_and_knob(monkeypatch):
    monkeypatch.delenv("REPRO_AGG_CODEC", raising=False)
    assert wc.get_codec(None).name == "identity"
    assert wc.get_codec("auto").name == "identity"
    assert wc.get_codec("qsgd8").name == "qsgd8"
    inst = wc.get_codec("fp16")
    assert wc.get_codec(inst) is inst
    monkeypatch.setenv("REPRO_AGG_CODEC", "fp16")
    assert wc.get_codec(None).name == "fp16"
    assert wc.get_codec("topk").name == "topk"       # explicit wins
    assert wc.available_codecs() == tuple(sorted(CODECS))
    with pytest.raises(ValueError, match="unknown wire codec"):
        wc.get_codec("gzip-hope")


def test_codec_registry_rejects_duplicates():
    with pytest.raises(ValueError, match="already registered"):
        @wc.register_codec("qsgd8")
        class Clash(wc.WireCodec):
            pass

    @wc.register_codec("qsgd8", replace=True)
    class Replaced(wc.Qsgd8Codec):
        pass
    try:
        assert isinstance(wc.get_codec("qsgd8"), Replaced)
    finally:
        wc.register_codec("qsgd8", replace=True)(wc.Qsgd8Codec)
    assert type(wc.get_codec("qsgd8")) is wc.Qsgd8Codec


def test_env_codec_reaches_the_round(monkeypatch):
    monkeypatch.setenv("REPRO_AGG_CODEC", "fp16")
    r = _round("gradssharding", _grads(4, 1_024), n_shards=2)
    assert r.codec == "fp16" and r.codec_error > 0.0
    r = _round("gradssharding", _grads(4, 1_024), n_shards=2,
               codec="identity")                     # explicit wins
    assert r.codec == "identity" and r.codec_error == 0.0


def test_session_validates_codec_eagerly():
    with pytest.raises(ValueError, match="unknown wire codec"):
        FederatedSession(SessionConfig(codec="gzip-hope", device="cpu"))


def test_reference_constants():
    assert (wc.LANES, wc.BLOCK_ROWS, wc.TILE, wc.QMAX, wc.BISECT_ITERS) == \
        (ref_wc.LANES, ref_wc.BLOCK_ROWS, ref_wc.TILE, float(ref_wc.QMAX),
         ref_wc.BISECT_ITERS)
    assert wc.TopkCodec.k_per_block == ref_wc.TopkCodec.k_per_block


# ---------------------------------------------------------------------------
# Payloads: the reference's bytes, round-trip determinism, ranged decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [0, 100, 4_096, 5_003, 12_288])
@pytest.mark.parametrize("codec", LOSSY)
def test_payload_parts_equal_reference(codec, size):
    """Every part of the payload (``half``; ``codes``/``scales``;
    ``idx``/``val``), its declared wire size and its decode equal the JAX
    package's, byte for byte."""
    x = _grads(1, size, seed=1)[0]
    ref_c, c = ref_wc.get_codec(codec), wc.get_codec(codec)
    ref_p, p = ref_c.encode(x), c.encode(torch.from_numpy(x))
    assert set(p.parts) == set(ref_p.parts)
    for key, want in ref_p.parts.items():
        got = p.parts[key].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    assert (p.nbytes, p.raw_nbytes, p.n_elems) == \
        (ref_p.nbytes, ref_p.raw_nbytes, ref_p.n_elems)
    np.testing.assert_array_equal(_bits(c.decode(p)), _bits(ref_c.decode(ref_p)))


@pytest.mark.parametrize("size", [100, 4_096, 5_003, 12_288])
@pytest.mark.parametrize("codec", LOSSY)
def test_encode_decode_idempotent(codec, size):
    """decode∘encode is a projection: encoding its own output is a fixed
    point, so repeated wire round-trips never drift."""
    c = wc.get_codec(codec)
    x = torch.from_numpy(_grads(1, size, seed=3)[0])
    once = c.decode(c.encode(x))
    twice = c.decode(c.encode(once))
    assert torch.equal(once, twice)
    a, b = c.encode(x), c.encode(x)
    for part in a.parts:
        assert torch.equal(a.parts[part], b.parts[part])


@pytest.mark.parametrize("codec", LOSSY)
def test_decode_range_matches_full_decode(codec):
    c = wc.get_codec(codec)
    x = torch.from_numpy(_grads(1, 13_111, seed=5)[0])
    p = c.encode(x)
    full = c.decode(p)
    for step in (1_000, 4_096, 7_777):
        got = torch.cat([c.decode_range(p, s, min(s + step, x.numel()))
                         for s in range(0, x.numel(), step)])
        assert torch.equal(got, full)
    view = wc.EncodedView(c, p)
    assert torch.equal(view.read(100, 9_000), full[100:9_000])
    assert torch.equal(view.materialize(), full)


def test_empty_shard_payloads():
    for codec in LOSSY:
        c = wc.get_codec(codec)
        p = c.encode(torch.empty(0))
        assert p.nbytes == 0 and c.decode(p).numel() == 0


def test_encode_takes_a_shard_view():
    """Batched-engine shards arrive as zero-copy ShardViews."""
    from repro_torch.core.sharding import make_plan, shard_views
    flat = torch.from_numpy(_grads(1, 10_007, seed=6)[0])
    plan = make_plan("uniform", flat.numel(), 3)
    for codec in LOSSY:
        c = wc.get_codec(codec)
        for view, (seg,) in zip(shard_views(flat, plan), plan.segments):
            a, b = seg
            want = c.encode(flat[a:b].clone())
            got = c.encode(view)
            for part in want.parts:
                assert torch.equal(got.parts[part], want.parts[part])


@pytest.mark.parametrize("codec,ratio", [("fp16", 2.0), ("qsgd8", 3.9),
                                         ("topk", 10.0)])
def test_wire_bytes_shrink(codec, ratio):
    c = wc.get_codec(codec)
    nb = 1_000_000 * 4
    assert c.wire_bytes(nb) * ratio <= nb
    assert c.wire_bytes(nb) == ref_wc.get_codec(codec).wire_bytes(nb)
    assert wc.get_codec("identity").wire_bytes(nb) == nb


# ---------------------------------------------------------------------------
# Lossy codecs: deterministic across engines, schedules, k, arrivals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", LOSSY)
@pytest.mark.parametrize("topology", TOPOLOGIES, ids=_topo_id)
def test_lossy_codec_deterministic_across_grid(topology, codec):
    topology, kw = topology
    grads = _grads()
    ref = _round(topology, grads, codec=codec, **kw)
    assert ref.codec == codec
    assert 0.0 < ref.codec_error < 10.0
    for engine in ENGINES:
        for schedule, k in (("barrier", None), ("pipelined", 1),
                            ("pipelined", 8)):
            r = _round(topology, grads, engine=engine, schedule=schedule,
                       readahead_k=k, upload=JITTER, codec=codec, **kw)
            assert torch.equal(r.avg_flat, ref.avg_flat), \
                f"{codec} moved bits under {engine}/{schedule}/k={k}"
            assert r.codec_error == ref.codec_error
            assert (r.puts, r.gets) == (ref.puts, ref.gets), \
                "codecs change bytes, never op counts"


def test_codec_error_deterministic_across_arrival_permutations():
    n = 9
    grads = _grads(n, 4_096, seed=2)
    ref = _round("gradssharding", grads, n_shards=4, codec="qsgd8")
    for perm_seed in (1, 2, 3):
        order = np.random.default_rng(perm_seed).permutation(n) * 3.0
        up = FixedStarts(mbps=16.0, starts=tuple(float(t) for t in order))
        r = _round("gradssharding", grads, n_shards=4, codec="qsgd8",
                   schedule="pipelined", upload=up, readahead_k=4)
        assert r.codec_error == ref.codec_error
        assert torch.equal(r.avg_flat, ref.avg_flat)


def test_codec_error_ordering():
    """Aggressiveness ordering on random data: fp16 < qsgd8 < topk."""
    grads = _grads(8, 8_192, seed=4)
    errs = {codec: _round("gradssharding", grads, n_shards=4,
                          codec=codec).codec_error for codec in CODECS}
    assert errs["identity"] == 0.0
    assert 0.0 < errs["fp16"] < errs["qsgd8"] < errs["topk"]


# ---------------------------------------------------------------------------
# The platform sees wire bytes: store, op logs, GETs, records
# ---------------------------------------------------------------------------

def test_store_holds_payloads_and_accounts_wire_bytes():
    n, size, m = 8, 8_192, 4
    grads = _grads(n, size)
    raw = n * size * 4
    session = FederatedSession(topology="gradssharding", n_shards=m,
                               codec="qsgd8", device="cpu")
    r = session.round(grads)
    stats = session.store.stats
    upload_put = [(k, nb) for k, nb in stats.put_log if "/client" in k]
    assert len(upload_put) == n * m
    wire = sum(nb for _, nb in upload_put)
    assert raw / 4.2 < wire < raw / 3.8, "qsgd8 must shrink uploads ~4x"
    for key, _ in upload_put:
        v = session.store.peek(key)
        assert isinstance(v, wc.WirePayload)
        assert v.nbytes == wc.get_codec("qsgd8").wire_bytes(v.raw_nbytes)
    for key in session.store.list():
        if "/avg/" in key:
            assert isinstance(session.store.peek(key), torch.Tensor)
    expect = cm.s3_ops("gradssharding", n, m)
    assert (r.puts, r.gets) == (expect.puts, expect.gets)
    agg_read = sum(nb for k, nb in stats.get_log if "/client" in k)
    assert agg_read == wire


def test_records_read_wire_bytes():
    n, size = 6, 16_384
    grads = _grads(n, size)
    r_id = _round("lambda_fl", grads, codec="identity")
    r_q = _round("lambda_fl", grads, codec="qsgd8")
    leaf_id = [rec for rec in r_id.records if "leaf" in rec.fn_name]
    leaf_q = [rec for rec in r_q.records if "leaf" in rec.fn_name]
    assert sum(r.read_bytes for r in leaf_q) * 3.8 < \
        sum(r.read_bytes for r in leaf_id)
    assert sum(r.compute_s for r in leaf_q) > \
        sum(r.compute_s for r in leaf_id)


# ---------------------------------------------------------------------------
# Cost model: sim == model parity per codec, feasibility
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("codec", CODECS)
def test_pipelined_cost_matches_sim_per_codec(codec, k):
    n, elems, m = 12, 65_536, 4
    sim = _round("gradssharding", _grads(n, elems), n_shards=m,
                 schedule="pipelined", upload=JITTER, readahead_k=k,
                 codec=codec)
    model = cm.pipelined_round_cost("gradssharding", elems * 4, n, m,
                                    upload=JITTER, readahead_k=k,
                                    codec=codec)
    assert model.wall_clock_s == pytest.approx(sim.wall_clock_s, rel=1e-9)
    billed = sum(rec.billed_gb_s for rec in sim.records)
    assert model.lambda_gb_s == pytest.approx(billed, rel=1e-3)
    assert {rec.memory_mb for rec in sim.records} >= {model.memory_mb}


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("topology", ["lambda_fl", "lifl"])
def test_cost_parity_other_topologies(topology, codec):
    n, elems = 12, 32_768
    sim_p = _round(topology, _grads(n, elems), schedule="pipelined",
                   upload=JITTER, codec=codec)
    sim_b = _round(topology, _grads(n, elems), schedule="barrier",
                   upload=JITTER, codec=codec)
    pc = cm.pipelined_round_cost(topology, elems * 4, n, 1, upload=JITTER,
                                 codec=codec)
    bc = cm.barrier_round_cost(topology, elems * 4, n, 1, upload=JITTER,
                               codec=codec)
    assert pc.wall_clock_s == pytest.approx(sim_p.wall_clock_s, rel=1e-9)
    assert bc.wall_clock_s == pytest.approx(sim_b.wall_clock_s, rel=1e-9)


def test_colocated_cost_parity_with_codec():
    n, elems = 12, 32_768
    sim = _round("lifl", _grads(n, elems), schedule="pipelined",
                 upload=JITTER, colocated=True, codec="qsgd8",
                 readahead_k=4)
    model = cm.pipelined_round_cost("lifl", elems * 4, n, upload=JITTER,
                                    colocated=True, codec="qsgd8",
                                    readahead_k=4)
    assert model.wall_clock_s == pytest.approx(sim.wall_clock_s, rel=1e-9)


@pytest.mark.parametrize("codec", LOSSY)
@pytest.mark.parametrize("topology,m", [("gradssharding", 4),
                                        ("lambda_fl", 1), ("lifl", 1)])
def test_cost_model_equals_reference_per_codec(topology, m, codec):
    n, nbytes = 20, 134_000_000 * 4
    for k in (1, 4):
        got = cm.pipelined_round_cost(topology, nbytes, n, m, upload=JITTER,
                                      readahead_k=k, codec=codec)
        want = ref_cm.pipelined_round_cost(topology, nbytes, n, m,
                                           upload=REF_JITTER, readahead_k=k,
                                           codec=codec)
        assert (got.wall_clock_s, got.lambda_gb_s, got.memory_mb,
                got.feasible) == (want.wall_clock_s, want.lambda_gb_s,
                                  want.memory_mb, want.feasible)
    got = cm.barrier_round_cost(topology, nbytes, n, m, upload=JITTER,
                                codec=codec)
    want = ref_cm.barrier_round_cost(topology, nbytes, n, m,
                                     upload=REF_JITTER, codec=codec)
    assert (got.wall_clock_s, got.lambda_gb_s) == \
        (want.wall_clock_s, want.lambda_gb_s)


def test_qsgd8_flips_feasibility_at_the_ceiling():
    """The paper's 10,240 MB wall: a gradient the raw 3x formula rejects
    fits once the prefetch window buffers int8 payloads."""
    limits = LambdaRuntime().limits
    gb = int(4_000 * MB)                  # 3x4000+450 > 10240 > 2.25x4000+450
    assert not cm.feasible("lambda_fl", gb, limits=limits, codec="identity")
    assert cm.feasible("lambda_fl", gb, limits=limits, codec="qsgd8")
    assert cm.feasible("lambda_fl", gb, limits=limits, codec="fp16")
    assert not cm.pipelined_round_cost("lambda_fl", gb, 20, upload=JITTER,
                                       codec="identity").feasible
    assert cm.pipelined_round_cost("lambda_fl", gb, 20, upload=JITTER,
                                   codec="qsgd8").feasible
    assert gb / MB > cm.max_feasible_grad_mb(limits)


# ---------------------------------------------------------------------------
# The port against the JAX package, round for round
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("codec", LOSSY)
@pytest.mark.parametrize("topology", TOPOLOGIES, ids=_topo_id)
def test_round_equals_reference(topology, codec, engine):
    topology, kw = topology
    grads = _grads(12, 5_003, seed=8)
    kw = dict(topology=topology, engine=engine, codec=codec,
              schedule="pipelined", readahead_k=2, **kw)
    port = FederatedSession(device="cpu", upload=JITTER, **kw).round(grads)
    ref = RefSession(upload=REF_JITTER, **kw).round(grads)
    assert smoke.record(port) == smoke.record(ref)
    assert port.codec_error == ref.codec_error
    np.testing.assert_array_equal(_bits(port.avg_flat), _bits(ref.avg_flat))


def test_pinned_codec_keys_on_cpu():
    pinned = smoke.expected_invariants(groups=("codec",))
    assert len(pinned) == 36
    assert smoke.mismatches(smoke.codec_invariants("cpu"), pinned) == []


def test_wave_evaluator_reproduces_pinned_codec_keys(monkeypatch):
    """The batched engine's CUDA path (dependency waves through
    `fold_nodes`, each encoded contribution materialized once by its
    codec's decode) run on CPU tensors: every pinned codec key holds."""
    waves = []

    def via_waves(pending, pool=None):
        waves.append(len(pending))
        agg_engine._evaluate_kernel(pending, torch.device("cpu"))

    monkeypatch.setattr(agg_engine, "_evaluate_nodes", via_waves)
    raw = smoke.gradssharding_hashes(smoke.main_path_invariants("cpu"))
    got = smoke.codec_invariants("cpu", raw_hashes=raw)
    assert waves, "the batched engine never evaluated its DAG"
    assert smoke.mismatches(got, smoke.expected_invariants(
        groups=("codec",))) == []
