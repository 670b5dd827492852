"""The port's control plane and value-plane primitives against the JAX
package: partition plans, shard / reconstruct / `ShardView.read` on the
same seeded numpy inputs (bit-equal), the analytical cost model (exact),
the `REPRO_AGG_*` knob precedence, and the state conversion helpers."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import cost_model as ref_cm  # noqa: E402
from repro.core import sharding as ref_sh  # noqa: E402
from repro_torch import convert, knobs  # noqa: E402
from repro_torch.api import FederatedSession, SessionConfig  # noqa: E402
from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.core import fold_pool  # noqa: E402
from repro_torch.core import sharding as sh  # noqa: E402
from repro_torch.core.agg_engine import get_backend  # noqa: E402
from repro_torch.core.fold_pool import get_workers, host_cores  # noqa: E402
from repro_torch.core.topology import get_readahead, get_schedule  # noqa: E402
from repro_torch.core.wire_codec import get_codec  # noqa: E402
from repro_torch.serverless.faults import FaultModel  # noqa: E402

SIZES = [7, 300, 12, 5000, 1, 640, 33]          # per-tensor element counts
PLANS = [("uniform", 10_007, 1), ("uniform", 10_007, 4),
         ("uniform", 3, 8), ("uniform", 4096, 8),
         ("layer_contiguous", None, 3), ("layer_contiguous", None, 10),
         ("balanced", None, 3), ("balanced", None, 10)]


def _plan_pair(strategy, total, m):
    if strategy == "uniform":
        return (ref_sh.make_plan(strategy, total, m),
                sh.make_plan(strategy, total, m))
    total = sum(SIZES)
    return (ref_sh.make_plan(strategy, total, m, SIZES),
            sh.make_plan(strategy, total, m, SIZES))


def _flat(total, seed=0):
    return np.random.default_rng([seed, total]).standard_normal(
        total).astype(np.float32)


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.int32)


@pytest.mark.parametrize("strategy,total,m", PLANS)
def test_plans_equal_reference(strategy, total, m):
    ref, port = _plan_pair(strategy, total, m)
    assert (port.total, port.segments, port.strategy) == \
        (ref.total, ref.segments, ref.strategy)
    assert port.shard_sizes() == ref.shard_sizes()
    assert port.max_shard() == ref.max_shard()
    assert port.imbalance() == ref.imbalance()
    assert convert.plan_from_reference(ref) == port


@pytest.mark.parametrize("strategy,total,m", PLANS)
def test_shard_and_reconstruct_equal_reference(strategy, total, m):
    ref_plan, plan = _plan_pair(strategy, total, m)
    flat = _flat(plan.total)
    ref_shards = ref_sh.shard(flat, ref_plan)
    shards = sh.shard(torch.from_numpy(flat), plan)
    assert len(shards) == len(ref_shards)
    for a, b in zip(shards, ref_shards):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    back = sh.reconstruct(shards, plan)
    np.testing.assert_array_equal(_bits(back),
                                  _bits(ref_sh.reconstruct(ref_shards,
                                                           ref_plan)))
    np.testing.assert_array_equal(_bits(back), _bits(flat))


@pytest.mark.parametrize("strategy,total,m", PLANS)
def test_shard_view_read_equals_reference(strategy, total, m):
    ref_plan, plan = _plan_pair(strategy, total, m)
    flat = _flat(plan.total, seed=1)
    views = sh.shard_views(torch.from_numpy(flat), plan)
    for v, rv in zip(views, ref_sh.shard_views(flat, ref_plan)):
        assert (v.size, v.shape, v.nbytes) == (rv.size, rv.shape, rv.nbytes)
        for s, e in [(0, v.size), (0, min(1, v.size)),
                     (v.size // 3, min(v.size // 2 + 1, v.size)),
                     (max(v.size - 5, 0), v.size)]:
            np.testing.assert_array_equal(_bits(v.read(s, e)),
                                          _bits(rv.read(s, e)))
        np.testing.assert_array_equal(_bits(v.materialize()),
                                      _bits(rv.materialize()))


def test_single_segment_views_stay_zero_copy():
    flat = torch.arange(100, dtype=torch.float32)
    v = sh.shard_views(flat, sh.plan_uniform(100, 3))[1]
    assert v.materialize().data_ptr() == flat[34:67].data_ptr()


COST_GRID = [(topo, n, m) for topo in ("gradssharding", "lambda_fl", "lifl")
             for n, m in [(4, 2), (8, 4), (20, 4), (27, 1)]]


@pytest.mark.parametrize("topology,n,m", COST_GRID)
def test_round_costs_equal_reference(topology, n, m):
    grad_bytes = 4096 * 4 * 64
    up = cm.UploadModel(mbps=16.0, jitter_s=3.0, rate_jitter=0.5, seed=11)
    ref_up = ref_cm.UploadModel(mbps=16.0, jitter_s=3.0, rate_jitter=0.5,
                                seed=11)
    for fn in ("pipelined_round_cost", "barrier_round_cost"):
        for k in ((1, 3) if fn == "pipelined_round_cost" else (None,)):
            kw = {} if k is None else {"readahead_k": k}
            got = getattr(cm, fn)(topology, grad_bytes, n, m, upload=up,
                                  codec="identity", **kw)
            want = getattr(ref_cm, fn)(topology, grad_bytes, n, m,
                                       upload=ref_up, codec="identity", **kw)
            for field in ("wall_clock_s", "lambda_gb_s", "lambda_cost",
                          "s3_cost", "memory_mb", "n_invocations",
                          "feasible"):
                assert getattr(got, field) == getattr(want, field), field
            assert (got.ops.puts, got.ops.gets) == \
                (want.ops.puts, want.ops.gets)


# ---------------------------------------------------------------------------
# knobs: explicit argument > REPRO_AGG_* env var > built-in default
# ---------------------------------------------------------------------------

def _clear_env(monkeypatch):
    for var in knobs.ALL_KNOBS:
        monkeypatch.delenv(var, raising=False)


def test_all_knobs_enumerated():
    assert set(knobs.ALL_KNOBS) == {
        "REPRO_AGG_ENGINE", "REPRO_AGG_SCHEDULE", "REPRO_AGG_READAHEAD",
        "REPRO_AGG_CODEC", "REPRO_AGG_FAULTS", "REPRO_AGG_WORKERS"}
    assert not hasattr(knobs, "env_pallas")


def test_workers_precedence(monkeypatch):
    monkeypatch.delenv(knobs.ENV_WORKERS, raising=False)
    assert get_workers() == host_cores() == get_workers("auto")
    monkeypatch.setenv(knobs.ENV_WORKERS, "3")
    assert get_workers() == 3 and get_workers("auto") == 3
    assert get_workers(7) == 7 and get_workers("2") == 2
    monkeypatch.setenv(knobs.ENV_WORKERS, "auto")
    assert get_workers() == host_cores()
    monkeypatch.setenv(knobs.ENV_WORKERS, "many")
    with pytest.raises(ValueError, match="workers"):
        get_workers()


@pytest.mark.parametrize("bad", [0, -1, 1.5, "1.5", "zero", ""])
def test_workers_rejects_bad_values(bad):
    with pytest.raises(ValueError, match="workers"):
        get_workers(bad)


def test_backend_pool_width_follows_env(monkeypatch):
    monkeypatch.setenv(knobs.ENV_WORKERS, "2")
    assert get_backend("batched")._pool.workers == 2
    assert get_backend("batched", workers=5)._pool.workers == 5


def test_resolver_env_precedence(monkeypatch):
    monkeypatch.setenv(knobs.ENV_SCHEDULE, "pipelined")
    monkeypatch.setenv(knobs.ENV_READAHEAD, "4")
    monkeypatch.setenv(knobs.ENV_CODEC, "identity")
    monkeypatch.setenv(knobs.ENV_ENGINE, "incremental")
    assert get_schedule() == "pipelined"
    assert get_schedule("barrier") == "barrier"      # explicit beats env
    assert get_readahead() == 4
    assert get_readahead(2) == 2
    assert get_codec().name == "identity"
    assert get_backend().name == "incremental"
    assert get_backend("streaming").name == "streaming"
    monkeypatch.setenv(knobs.ENV_CODEC, "qsgd8")
    assert get_codec().name == "qsgd8"
    monkeypatch.setenv(knobs.ENV_CODEC, "gzip-hope")
    with pytest.raises(ValueError, match="gzip-hope"):
        get_codec()
    monkeypatch.setenv(knobs.ENV_ENGINE, "host_mesh")
    with pytest.raises(ValueError, match="host_mesh"):
        get_backend()


def test_from_env_unset_equals_defaults(monkeypatch):
    _clear_env(monkeypatch)
    assert SessionConfig.from_env() == SessionConfig()


def test_from_env_snapshots_and_kwargs_win(monkeypatch):
    _clear_env(monkeypatch)
    monkeypatch.setenv(knobs.ENV_ENGINE, "incremental")
    monkeypatch.setenv(knobs.ENV_SCHEDULE, "pipelined")
    monkeypatch.setenv(knobs.ENV_READAHEAD, "4")
    monkeypatch.setenv(knobs.ENV_CODEC, "identity")
    monkeypatch.setenv(knobs.ENV_FAULTS, "on")
    monkeypatch.setenv(knobs.ENV_WORKERS, "3")
    cfg = SessionConfig.from_env()
    assert (cfg.engine, cfg.schedule, cfg.readahead_k, cfg.codec,
            cfg.workers) == ("incremental", "pipelined", 4, "identity", 3)
    assert isinstance(cfg.faults, FaultModel)
    _clear_env(monkeypatch)                  # a snapshot: immune to env
    assert cfg.workers == 3
    monkeypatch.setenv(knobs.ENV_WORKERS, "3")
    assert SessionConfig.from_env(workers=5, topology="lifl").workers == 5


def test_from_env_validates_eagerly(monkeypatch):
    for var, raw, match in [(knobs.ENV_READAHEAD, "0", "readahead"),
                            (knobs.ENV_ENGINE, "bogus", "bogus"),
                            (knobs.ENV_WORKERS, "-2", "workers")]:
        _clear_env(monkeypatch)
        monkeypatch.setenv(var, raw)
        with pytest.raises(ValueError, match=match):
            SessionConfig.from_env()


def test_from_env_config_runs_a_round(monkeypatch):
    _clear_env(monkeypatch)
    monkeypatch.setenv(knobs.ENV_WORKERS, "2")
    monkeypatch.setenv(knobs.ENV_ENGINE, "batched")
    session = FederatedSession(SessionConfig.from_env(n_shards=2,
                                                      device="cpu"))
    grads = [np.full(512, float(i + 1), np.float32) for i in range(4)]
    result = session.round(grads)
    assert torch.equal(result.avg_flat, torch.full((512,), 2.5))


def test_pool_cache_is_per_worker_count():
    a, b, c = fold_pool.get_pool(2), fold_pool.get_pool(2), \
        fold_pool.get_pool(3)
    assert a is b and a is not c
    assert (a.workers, c.workers) == (2, 3)


# ---------------------------------------------------------------------------
# convert: the reference's state, carried across
# ---------------------------------------------------------------------------

def test_grads_from_numpy():
    rng = np.random.default_rng(3)
    grads = [rng.standard_normal(100).astype(np.float32) for _ in range(3)]
    grads.append(np.arange(10.0)[::2])               # f64, strided
    out = convert.grads_from_numpy(grads, "cpu")
    for g, t in zip(grads, out):
        assert t.dtype == torch.float32 and t.is_contiguous()
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(g, np.float32))
    same = convert.as_grad_tensor(out[0])
    assert same.data_ptr() == out[0].data_ptr()      # no copy when right


def test_plan_from_reference_duck_typed():
    class Plan:
        total = 10
        segments = [[(0, 4)], [(4, 10)]]
        strategy = "uniform"
    plan = convert.plan_from_reference(Plan())
    assert plan == sh.PartitionPlan(10, (((0, 4),), ((4, 10),)), "uniform")
    assert plan.shard_sizes() == [4, 6]
