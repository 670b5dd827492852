"""The port's main path as a whole: `repro_torch.FederatedSession` rounds.

The smoke setup of `benchmarks/smoke_invariants.py` (N = 8, 4096
elements, M = 4, `UploadModel(mbps=16, jitter_s=3, rate_jitter=0.5,
seed=11)`, gradient seed 1234) goes through the port on the CPU and
through the JAX package's `repro.api.FederatedSession`, run live. Every
topology × engine × schedule cell, every `readahead_k` sweep point and
the analytical pipelined wall must give the same op counts, billed GB-s,
walls, peak memory and `avg_sha256` in both packages, and equal the
committed `benchmarks/expected_smoke.json` — exactly, no tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import FederatedSession as RefSession  # noqa: E402
from repro.core import cost_model as ref_cm  # noqa: E402
from repro.core.cost_model import UploadModel as RefUpload  # noqa: E402
from repro.core.topology import available_topologies as \
    ref_available_topologies  # noqa: E402
from repro_torch import smoke  # noqa: E402
from repro_torch.api import FederatedSession, SessionConfig  # noqa: E402
from repro_torch.core import agg_engine  # noqa: E402
from repro_torch.core.topology import available_topologies  # noqa: E402
from repro_torch.serverless.population import ClientPopulation  # noqa: E402

REF_UPLOAD = RefUpload(mbps=16.0, jitter_s=3.0, rate_jitter=0.5, seed=11)
PINNED = smoke.expected_invariants()
GRADS = smoke.smoke_grads()


def _ref_round(grads, **kw):
    return RefSession(upload=REF_UPLOAD, codec="identity", **kw).round(grads)


@pytest.mark.parametrize("schedule", smoke.SCHEDULES)
@pytest.mark.parametrize("engine", smoke.ENGINES)
@pytest.mark.parametrize("topology", smoke.TOPOLOGIES)
def test_grid_matches_reference_and_pinned(topology, engine, schedule):
    port = smoke.record(smoke.grid_round(topology, engine, schedule, GRADS,
                                         "cpu"))
    ref = smoke.record(_ref_round(GRADS, topology=topology,
                                  n_shards=smoke.N_SHARDS, engine=engine,
                                  schedule=schedule, readahead_k=1))
    assert port == ref
    tag = f"smoke/{topology}/{engine}/{schedule}"
    assert {f: port[f] for f in smoke.GRID_FIELDS} == \
        {f: PINNED[f"{tag}/{f}"] for f in smoke.GRID_FIELDS}


@pytest.mark.parametrize("k", smoke.READAHEAD_KS)
@pytest.mark.parametrize("point", ["", "2"])
@pytest.mark.parametrize("topology", smoke.TOPOLOGIES)
def test_readahead_matches_reference_and_pinned(topology, point, k):
    grads = smoke.readahead_grads(point)
    port = smoke.record(smoke.readahead_round(topology, point, k, grads,
                                              "cpu"))
    ref = smoke.record(_ref_round(
        grads, topology=topology, n_shards=smoke.READAHEAD_POINTS[point][1],
        schedule="pipelined", readahead_k=k))
    assert port == ref
    tag = f"smoke/{topology}/readahead{point}_k{k}"
    assert {f: port[f] for f in smoke.READAHEAD_FIELDS} == \
        {f: PINNED[f"{tag}/{f}"] for f in smoke.READAHEAD_FIELDS}


@pytest.mark.parametrize("engine", smoke.ENGINES)
@pytest.mark.parametrize("topology", smoke.TOPOLOGIES)
def test_engines_match_reference_at_twelve_clients(topology, engine):
    """Off the pinned grid: at N = 12 the tree weights sum to 12, not a
    power of two, so a weighted fold divided in the wrong precision would
    change bits that N = 8 cannot show."""
    grads = smoke.readahead_grads("2")
    kw = dict(topology=topology, n_shards=smoke.N_SHARDS_2, engine=engine,
              schedule="pipelined", readahead_k=2)
    port = smoke.record(FederatedSession(
        upload=smoke.UPLOAD, codec="identity", device="cpu", **kw)
        .round(grads))
    assert port == smoke.record(_ref_round(grads, **kw))


@pytest.mark.parametrize("topology", smoke.TOPOLOGIES)
def test_model_pipelined_wall_matches_reference(topology):
    m = smoke.N_SHARDS if topology == "gradssharding" else 1
    ref = ref_cm.pipelined_round_cost(
        topology, smoke.GRAD_ELEMS * 4, smoke.N_CLIENTS, m,
        upload=REF_UPLOAD, readahead_k=1, codec="identity")
    got = smoke.model_pipelined_wall_s(topology)
    assert got == round(ref.wall_clock_s, 12)
    assert got == PINNED[f"smoke/{topology}/model_pipelined_wall_s"]


def test_all_pinned_main_path_keys_on_cpu():
    got = smoke.main_path_invariants("cpu")
    assert len(PINNED) == 168
    assert smoke.mismatches(got, PINNED) == []


def test_wave_evaluator_reproduces_pinned_keys(monkeypatch):
    """The batched engine's CUDA path (dependency waves through
    `fold_nodes`) run on CPU tensors, where `fold_nodes` takes the plain
    fold: every pinned key must still hold."""
    waves = []

    def via_waves(pending, pool=None):
        waves.append(len(pending))
        agg_engine._evaluate_kernel(pending, torch.device("cpu"))

    monkeypatch.setattr(agg_engine, "_evaluate_nodes", via_waves)
    got = smoke.main_path_invariants("cpu")
    assert waves, "the batched engine never evaluated its DAG"
    assert smoke.mismatches(got, PINNED) == []


def test_avg_flat_is_a_tensor_on_the_session_device():
    result = FederatedSession(device="cpu", n_shards=3).round(GRADS)
    assert isinstance(result.avg_flat, torch.Tensor)
    assert result.avg_flat.device.type == "cpu"
    assert result.avg_flat.dtype == torch.float32
    assert result.avg_flat.shape == (smoke.GRAD_ELEMS,)


@pytest.mark.parametrize("engine", smoke.ENGINES)
def test_tensor_and_numpy_inputs_agree(engine):
    as_np = FederatedSession(device="cpu", engine=engine).round(GRADS)
    as_t = FederatedSession(device="cpu", engine=engine).round(
        [torch.from_numpy(g.astype(np.float64)) for g in GRADS])
    assert smoke.avg_hash(as_np.avg_flat) == smoke.avg_hash(as_t.avg_flat)


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        FederatedSession(SessionConfig())            # device defaults to cuda
    with pytest.raises(ValueError, match="device"):
        FederatedSession(device="mps")


def test_unported_knobs_raise():
    """`host_mesh` is ported: on another engine it raises, as the
    reference's does, and with `engine="host_mesh"` the round equals the
    default engine's bit for bit; `population` is ported: a
    population-backed session runs its round with no client gradients and
    equals the eager round over the materialized cohort."""
    with pytest.raises(ValueError, match="requires engine='host_mesh'"):
        FederatedSession(device="cpu", host_mesh=2)
    pop = ClientPopulation(smoke.N_CLIENTS, grad_elems=smoke.GRAD_ELEMS,
                           seed=1234)
    meshed = FederatedSession(device="cpu", engine="host_mesh", host_mesh=2
                              ).round(pop.materialize(0))
    default = FederatedSession(device="cpu").round(pop.materialize(0))
    assert torch.equal(meshed.avg_flat.view(torch.int32),
                       default.avg_flat.view(torch.int32))
    lazy = FederatedSession(device="cpu", population=pop).round()
    eager = FederatedSession(device="cpu").round(pop.materialize(0))
    assert smoke.record(lazy) == smoke.record(eager)


def test_three_builtin_topologies():
    """The reference's registry assertion: the builtins and the plugins
    (`sharded_tree`, `geo_tiered`) are registered on import, as in the
    reference."""
    names = available_topologies()
    assert set(smoke.TOPOLOGIES) <= set(names)
    assert "sharded_tree" in names and "geo_tiered" in names
    assert set(ref_available_topologies()) >= {
        "gradssharding", "lambda_fl", "lifl", "sharded_tree", "geo_tiered"}


def test_all_pinned_smoke_keys_on_cpu():
    """Every group the port reproduces: all 366 keys of the file, the 3
    `roofline/host_fold` keys of the host fold's worker sweep included."""
    expected = smoke.expected_invariants(groups=smoke.GROUPS)
    assert len(expected) == 366
    got = smoke.all_invariants("cpu")
    assert set(got) == set(expected)
    assert smoke.mismatches(got, expected) == []


def test_roofline_group_matches_reference_host_fold():
    """The `roofline` group's computation, run through the reference's own
    evaluator (`repro.core.agg_engine._evaluate_nodes` on its
    `ParallelFoldPool`) on the same numpy inputs, gives the same bits at
    every worker count, and the port's keys carry its hash."""
    from repro.core import agg_engine as ref_engine
    from repro.core.fold_pool import CHUNK_ELEMS as REF_CHUNK, \
        ParallelFoldPool as RefPool
    inputs = smoke.roofline_inputs()
    assert len(inputs) == 6 and inputs[0].shape == (4 * REF_CHUNK,)
    got = smoke.roofline_invariants()
    assert got["roofline/host_fold/workers_grid"] == "1,2,4,8"
    for workers in smoke.FOLD_WORKER_GRID:
        pool = RefPool(workers, min_parallel_elems=1)
        node = ref_engine.LazyAverage(inputs, None)
        try:
            ref_engine._evaluate_nodes([node], pool=pool)
        finally:
            pool.close()
        assert smoke.avg_hash(node.out) == got["roofline/host_fold/avg_hash"]
    assert got["roofline/host_fold/bit_identical"] is True
