"""The plugin topologies on the port, held against the JAX package.

`sharded_tree` (M shards × a ⌈√N⌉ two-level tree) and `geo_tiered`
(edge → region → global) run through `repro_torch` on the CPU and through
`repro`, live, from the same knobs and seeded numpy gradients, across
engines × schedules, codecs, partitions and tier options: every observable
must agree exactly. The cost hooks (op counts, phases, memory, barrier and
pipelined walls) must equal the reference's and the port's own event sim.
Then the 56 `smoke/sharded_tree/*`, the `smoke/sharded_tree_equals_lambda_fl`
and the 33 `smoke/geo_tiered/*` keys of `benchmarks/expected_smoke.json`.
"""
import pytest

torch = pytest.importorskip("torch")

import _torch_compare as cmp  # noqa: E402
from repro.core import cost_model as ref_cm  # noqa: E402
from repro.core import topology as ref_topo  # noqa: E402
from repro.core.geo_tiered import GeoTieredTopology as RefGeo  # noqa: E402
from repro_torch import smoke  # noqa: E402
from repro_torch.core import agg_engine  # noqa: E402
from repro_torch.core import cost_model as port_cm  # noqa: E402
from repro_torch.core import topology as port_topo  # noqa: E402
from repro_torch.core.geo_tiered import GeoTieredTopology  # noqa: E402

ENGINES = ("streaming", "batched", "incremental")
SCHEDULES = ("barrier", "pipelined")
PLUGINS = ("sharded_tree", "geo_tiered")
PINNED = smoke.expected_invariants(
    groups=("sharded_tree", "sharded_tree_equals_lambda_fl", "geo_tiered"))


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("topology", PLUGINS)
def test_plugin_rounds_match_reference(topology, engine, schedule):
    cmp.assert_same(cmp.run_both(topology=topology, engine=engine,
                                 schedule=schedule,
                                 grad_list=cmp.grads(n=13, elems=513)))


@pytest.mark.parametrize("codec", ("fp16", "qsgd8", "topk"))
@pytest.mark.parametrize("topology", PLUGINS)
def test_plugin_codec_rounds_match_reference(topology, codec):
    cmp.assert_same(cmp.run_both(topology=topology, codec=codec,
                                 readahead_k=2, engine="batched"))


@pytest.mark.parametrize("engine", ENGINES)
def test_sharded_tree_equals_lambda_fl_like_reference(engine):
    """Per shard the leaf and root op sequence is λ-FL's, so the mean is
    λ-FL's bit for bit, for any M and partition."""
    g = cmp.grads(elems=5_003)
    lam = cmp.session("port", topology="lambda_fl").round(g)
    for m in (1, 3, 8):
        out = cmp.run_both(topology="sharded_tree", n_shards=m,
                           engine=engine, grad_list=g)
        cmp.assert_same(out)
        assert out["port"][0][0]["avg"] == cmp.avg_bytes(lam.avg_flat)
    for partition in ("balanced", "layer_contiguous"):
        out = cmp.run_both(topology="sharded_tree", n_shards=4,
                           partition=partition, grad_list=g,
                           tensor_sizes=[1_000, 3, 4_000], engine=engine)
        cmp.assert_same(out)
        assert out["port"][0][0]["avg"] == cmp.avg_bytes(lam.avg_flat)


@pytest.mark.parametrize("n", [1, 2, 5, 32, 33, 65])
def test_geo_tree_shapes_match_reference(n):
    cmp.assert_same(cmp.run_both(topology="geo_tiered",
                                 grad_list=cmp.grads(n=n, elems=129)))


def test_geo_tier_options_match_reference():
    g = cmp.grads(n=13, elems=513)
    for opts in (dict(edge_fanin=4, region_fanin=2),
                 dict(edge_fanin=4, edge_mbps=4.0),
                 dict(edge_fanin=3, region_fanin=2, edge_mbps=20.0,
                      backbone_mbps=300.0)):
        cmp.assert_same(cmp.run_both(topology="geo_tiered", grad_list=g,
                                     topology_options=opts))
    with pytest.raises(TypeError, match="unexpected option"):
        cmp.session("port", topology="geo_tiered",
                    topology_options={"nonsense_knob": 3}).round(g)
    with pytest.raises(ValueError, match="fan-ins"):
        GeoTieredTopology(edge_fanin=1)


def test_geo_fault_knobs_compose_like_reference():
    cmp.assert_same(cmp.run_both(
        topology="geo_tiered", grad_list=cmp.grads(n=13, elems=513),
        faults=dict(seed=4, dropout_rate=0.2, failure_rate=0.3),
        participation_k=10, deadline_s=6.0,
        topology_options={"edge_fanin": 3}))


def test_available_topologies_match_reference():
    assert set(ref_topo.available_topologies()) >= set(PLUGINS)
    for name in ("gradssharding", "lambda_fl", "lifl") + PLUGINS:
        assert name in port_topo.available_topologies()
        assert port_topo.get_topology(name).name == \
            ref_topo.get_topology(name).name


# ---------------------------------------------------------------------------
# the cost hooks: equal to the reference's and to the port's own event sim
# ---------------------------------------------------------------------------

COST_POINTS = [("sharded_tree", 512 * 1024 * 1024, 20, 8),
               ("sharded_tree", 4 * 513, 13, 4),
               ("geo_tiered", 4 * 513, 13, 1),
               ("geo_tiered", 512 * 1024 * 1024, 1000, 1)]


@pytest.mark.parametrize("point", range(len(COST_POINTS)))
def test_cost_entries_match_reference(point):
    name, gb, n, m = COST_POINTS[point]
    up = (ref_cm.UploadModel(**cmp.UPLOAD), port_cm.UploadModel(**cmp.UPLOAD))
    for codec in ("identity", "fp16", "qsgd8"):
        got = []
        for cm, u in zip((ref_cm, port_cm), up):
            ops = cm.s3_ops(name, n, m)
            got.append((
                (ops.puts, ops.gets), cm.n_aggregators(name, n, m),
                cm.n_phases(name),
                cm.lambda_memory_mb(name, gb, m, codec=codec),
                cm.feasible(name, gb, m, codec=codec),
                cm.round_cost(name, gb, n, m, codec=codec).wall_clock_s,
                cm.barrier_round_cost(name, gb, n, m, upload=u,
                                      codec=codec).wall_clock_s,
                cm.pipelined_round_cost(name, gb, n, m, upload=u,
                                        readahead_k=2,
                                        codec=codec).wall_clock_s))
        assert got[0] == got[1]


# the pairs the reference's own tests hold its sim to; its sharded_tree
# barrier model differs from its sim in the 8th digit, on both packages
@pytest.mark.parametrize("codec", ("identity", "fp16"))
@pytest.mark.parametrize("topology, schedule", [
    ("sharded_tree", "pipelined"), ("geo_tiered", "barrier"),
    ("geo_tiered", "pipelined")])
def test_sim_matches_cost_model(topology, codec, schedule):
    n, elems = 13, 513
    m = 4 if topology == "sharded_tree" else 1
    r = cmp.session("port", topology=topology, n_shards=m, codec=codec,
                    schedule=schedule).round(cmp.grads(n=n, elems=elems))
    up = port_cm.UploadModel(**cmp.UPLOAD)
    if schedule == "barrier":
        model = port_cm.barrier_round_cost(topology, elems * 4, n, m,
                                           upload=up, codec=codec)
    else:
        model = port_cm.pipelined_round_cost(topology, elems * 4, n, m,
                                             upload=up, readahead_k=1,
                                             codec=codec)
    assert r.wall_clock_s == pytest.approx(model.wall_clock_s, rel=1e-9)
    ops = port_cm.s3_ops(topology, n, m)
    assert (r.puts, r.gets) == (ops.puts, ops.gets)


def test_custom_geo_instance_parity_matches_reference():
    tiers = dict(edge_fanin=3, region_fanin=2, edge_mbps=24.0,
                 region_mbps=96.0, backbone_mbps=320.0)
    ref_topo.register_topology("geo_test_port", replace=True)(RefGeo(**tiers))
    port_topo.register_topology("geo_test_port", replace=True)(
        GeoTieredTopology(**tiers))
    out = cmp.run_both(topology="geo_test_port", schedule="pipelined",
                       grad_list=cmp.grads(n=13, elems=513))
    cmp.assert_same(out)
    model = port_cm.pipelined_round_cost(
        "geo_test_port", 513 * 4, 13, 1,
        upload=port_cm.UploadModel(**cmp.UPLOAD), readahead_k=1)
    assert out["port"][0][0]["wall"] == pytest.approx(model.wall_clock_s,
                                                      rel=1e-9)


# ---------------------------------------------------------------------------
# the pinned keys
# ---------------------------------------------------------------------------

def test_pinned_sharded_tree_keys_on_cpu():
    got = smoke.sharded_tree_invariants("cpu")
    expected = {k: v for k, v in PINNED.items()
                if k.startswith("smoke/sharded_tree")}
    assert len(expected) == 57 and len(got) == 57
    assert smoke.mismatches(got, expected) == []


def test_pinned_geo_keys_on_cpu():
    got = smoke.geo_invariants("cpu")
    expected = {k: v for k, v in PINNED.items()
                if k.startswith("smoke/geo_tiered/")}
    assert len(expected) == 33 and len(got) == 33
    assert smoke.mismatches(got, expected) == []


def test_pinned_plugin_keys_through_kernel_waves(monkeypatch):
    """The batched engine's CUDA path (dependency waves through
    `fold_nodes`) on CPU tensors: every plugin key must still hold."""
    waves = []

    def via_waves(pending, pool=None):
        waves.append(len(pending))
        agg_engine._evaluate_kernel(pending, torch.device("cpu"))

    monkeypatch.setattr(agg_engine, "_evaluate_nodes", via_waves)
    got = smoke.sharded_tree_invariants("cpu")
    got.update(smoke.geo_invariants("cpu"))
    assert waves
    assert smoke.mismatches(got, PINNED) == []
