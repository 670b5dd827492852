"""The port's device collectives and the `host_mesh` aggregation engine.

The collectives (`repro_torch.core.device_agg`) run in 4 CPU gloo ranks
(`_torch_ranks.run_ranks`, a `file://` store, no port) on the meshes
(2, 2, 1) ("pod", "data", "model") and (4, 1) ("data", "model"), each rank
with its own seeded tree, and are held against numpy means of the four
trees at rtol 1e-6 / atol 1e-6 (the ranks' sums run in gloo's order: a
few f32 ulps of the inputs, which lie within ±4).

The `host_mesh` engine never sums across ranks: each fold device adds its
column slice of every client in client order, so its rounds are held bit
for bit against the streaming engine, a numpy chain, and the reference's
`host_mesh` round on 4 fake CPU devices (a subprocess with
`XLA_FLAGS=--xla_force_host_platform_device_count=4`, as
`tests/test_distributed.py` runs it).
"""
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_rank_bodies as bodies  # noqa: E402
from _torch_ranks import run_ranks  # noqa: E402
from repro_torch.api import FederatedSession, SessionConfig  # noqa: E402
from repro_torch.core import agg_engine, device_agg  # noqa: E402
from repro_torch.core.aggregation import aggregate_round  # noqa: E402
from repro_torch.core.topology import run_round  # noqa: E402
from repro_torch.serverless.population import ClientPopulation  # noqa: E402
from repro_torch.serverless.runtime import LambdaRuntime  # noqa: E402
from repro_torch.store import ObjectStore  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
ROUNDS = [("lambda_fl", {}), ("gradssharding", {"n_shards": 4})]

REFERENCE = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
from repro.core.topology import run_round
from repro.serverless.runtime import LambdaRuntime
from repro.store import ObjectStore

rng = np.random.default_rng(3)
grads = [rng.standard_normal(4_099).astype(np.float32) for _ in range(9)]
out = {}
for topology, opts in %r:
    r = run_round(topology, grads, rnd=0, store=ObjectStore(),
                  runtime=LambdaRuntime(), engine="host_mesh", host_mesh=4,
                  **opts)
    out[topology] = (np.asarray(r.avg_flat), r.puts, r.gets,
                     r.wall_clock_s)
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
""" % (ROUNDS,)


def _grads():
    rng = np.random.default_rng(3)
    return [rng.standard_normal(4_099).astype(np.float32) for _ in range(9)]


def _bits(t) -> np.ndarray:
    return np.asarray(t, np.float32).view(np.int32)


@pytest.fixture(scope="module")
def collective_ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("collectives"),
                     "_torch_rank_bodies:collectives", 4)


@pytest.fixture(scope="module")
def reference_rounds(tmp_path_factory):
    out = tmp_path_factory.mktemp("host_mesh") / "reference.pkl"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-6000:]
    return pickle.loads(out.read_bytes())


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(bodies.MESHES))
def test_collectives_match_numpy(collective_ranks, mesh):
    """all_reduce_mean (flat and hierarchical), psum, reduce-scatter,
    all-gather and the per-axis forms against numpy over the 4 ranks'
    trees; rank d owns shard d of the replica axes (pod slowest)."""
    trees = [bodies.rank_tree(r) for r in range(4)]
    mean = {k: np.mean([t[k] for t in trees], axis=0) for k in trees[0]}
    flat_of = lambda t: np.concatenate([t["a"].ravel(), t["b"]])
    flats = [flat_of(t) for t in trees]
    flat_mean = flat_of(mean)
    tol = dict(rtol=1e-6, atol=1e-6)
    for rank, res in enumerate(r[mesh] for r in collective_ranks):
        m, pad = res["m"], res["pad"]
        assert m == 4 and pad == (-41) % 4 and res["index"] == rank
        for key in ("pmean", "hier"):
            for leaf in mean:
                np.testing.assert_allclose(res[key][leaf], mean[leaf], **tol)
        np.testing.assert_allclose(res["psum"], np.sum(flats, axis=0), **tol)
        padded = np.concatenate([flat_mean, np.zeros(pad, np.float32)])
        k = padded.size // m
        np.testing.assert_allclose(res["shard"],
                                   padded[rank * k:(rank + 1) * k], **tol)
        np.testing.assert_allclose(res["gathered"], padded, **tol)
        # the last replica axis alone: "data" of size 2 on the pod mesh
        axis = {"pod2_data2": [[0, 1], [2, 3]],
                "data4": [[0, 1, 2, 3]]}[mesh]
        group = next(g for g in axis if rank in g)
        pos = group.index(rank)
        sub = np.mean([np.concatenate([flats[r], np.zeros(pad, np.float32)])
                       for r in group], axis=0)
        k = sub.size // len(group)
        np.testing.assert_allclose(res["scatter_last"],
                                   sub[pos * k:(pos + 1) * k], **tol)
        np.testing.assert_array_equal(
            res["gather_last"],
            np.concatenate([flats[r][:m] for r in group]))


def test_hierarchical_mean_equals_flat_mean(collective_ranks):
    """Pod-local then cross-pod averaging is the joint mean (equal group
    sizes) to rounding."""
    for r in collective_ranks:
        for leaf in ("a", "b"):
            np.testing.assert_allclose(r["pod2_data2"]["hier"][leaf],
                                       r["pod2_data2"]["pmean"][leaf],
                                       rtol=1e-6, atol=1e-6)


def test_pad_to_multiple():
    flat = torch.arange(10, dtype=torch.float32)
    padded, pad = device_agg.pad_to_multiple(flat, 4)
    assert pad == 2 and padded.shape == (12,)
    assert torch.equal(padded[10:], torch.zeros(2))
    same, pad = device_agg.pad_to_multiple(flat, 5)
    assert pad == 0 and same is flat


# ---------------------------------------------------------------------------
# The host_mesh fold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_devices", [1, 2, 4])
def test_mesh_fold_sum_bit_identical_to_numpy_chain(n_devices):
    """The element-sliced left fold replays the streaming reference's f32
    add chain: bit for bit, at every slice count; the one divide after it
    completes the engine's op sequence."""
    rng = np.random.default_rng(2)
    stack = rng.standard_normal((7, 5_003)).astype(np.float32)
    ref = stack[0].copy()
    for i in range(1, 7):
        ref = ref + stack[i]
    devices = device_agg.make_fold_mesh(n_devices, "cpu")
    assert devices == [torch.device("cpu")] * n_devices
    total = device_agg.mesh_fold_sum(devices, torch.from_numpy(stack))
    np.testing.assert_array_equal(_bits(total), _bits(ref))
    rows = device_agg.mesh_fold_sum(
        devices, [torch.from_numpy(r) for r in stack])
    np.testing.assert_array_equal(_bits(rows), _bits(ref))
    avg = torch.div(total, torch.full((), 7.0))
    np.testing.assert_array_equal(_bits(avg), _bits(ref / np.float32(7.0)))


@pytest.mark.parametrize("topology,opts", ROUNDS)
def test_host_mesh_round_bit_identical(topology, opts, reference_rounds,
                                       monkeypatch):
    """run_round(engine='host_mesh') == streaming == the reference's
    host_mesh round on 4 devices, bit for bit, with the same op counts and
    modeled wall, at 1, 2 and 4 fold slices; the unweighted nodes go
    through the mesh fold, the weighted ones fall through to the batched
    evaluator."""
    grads = _grads()
    calls = []
    fold = device_agg.mesh_fold_sum
    monkeypatch.setattr(device_agg, "mesh_fold_sum",
                        lambda d, s: calls.append(len(d)) or fold(d, s))
    ref = run_round(topology, grads, rnd=0, store=ObjectStore(),
                    runtime=LambdaRuntime(), engine="streaming", **opts)
    jax_avg, puts, gets, wall = reference_rounds[topology]
    np.testing.assert_array_equal(_bits(ref.avg_flat), _bits(jax_avg))
    for n in (1, 2, 4):
        got = run_round(topology, grads, rnd=0, store=ObjectStore(),
                        runtime=LambdaRuntime(), engine="host_mesh",
                        host_mesh=n, **opts)
        assert got.engine == "host_mesh"
        np.testing.assert_array_equal(_bits(got.avg_flat), _bits(jax_avg))
        assert (got.puts, got.gets) == (ref.puts, ref.gets) == (puts, gets)
        assert got.wall_clock_s == ref.wall_clock_s == wall
        assert calls and set(calls[-1:]) == {n}
    via = aggregate_round(topology, grads, rnd=0, store=ObjectStore(),
                          runtime=LambdaRuntime(), engine="host_mesh",
                          host_mesh=2, **opts)
    np.testing.assert_array_equal(_bits(via.avg_flat), _bits(jax_avg))


def test_host_mesh_session_and_population():
    """SessionConfig(engine='host_mesh', host_mesh=N) drives the engine
    through the facade, for eager and population rounds, bit for bit
    against the streaming engine."""
    grads = [g[:2_048] for g in _grads()[:6]]
    kw = dict(topology="lifl", device="cpu")
    ref = FederatedSession(SessionConfig(engine="streaming", **kw)) \
        .round(grads)
    got = FederatedSession(SessionConfig(engine="host_mesh", host_mesh=4,
                                         **kw)).round(grads)
    np.testing.assert_array_equal(_bits(got.avg_flat), _bits(ref.avg_flat))
    pop = ClientPopulation(n_clients=64, grad_elems=1_000, seed=5)
    rounds = {}
    for engine, hm in (("streaming", None), ("host_mesh", 2)):
        session = FederatedSession(SessionConfig(
            topology="gradssharding", population=pop, engine=engine,
            host_mesh=hm, device="cpu"))
        rounds[engine] = session.round()
    np.testing.assert_array_equal(_bits(rounds["host_mesh"].avg_flat),
                                  _bits(rounds["streaming"].avg_flat))


def test_host_mesh_errors():
    """More cards than are visible is an error that names the count and
    CUDA_VISIBLE_DEVICES; a count below 1 and the knob on another engine
    are rejected, in the engine resolver and in the session facade."""
    with pytest.raises(ValueError, match="CUDA_VISIBLE_DEVICES"):
        device_agg.make_fold_mesh(torch.cuda.device_count() + 1, "cuda")
    with pytest.raises(ValueError, match=">= 1"):
        device_agg.make_fold_mesh(0, "cpu")
    with pytest.raises(ValueError, match="requires engine='host_mesh'"):
        agg_engine.get_backend("batched", host_mesh=2)
    with pytest.raises(ValueError, match="requires engine='host_mesh'"):
        FederatedSession(SessionConfig(engine="streaming", host_mesh=2,
                                       device="cpu"))
    with pytest.raises(ValueError, match="requires engine='host_mesh'"):
        run_round("lambda_fl", _grads()[:2], rnd=0, store=ObjectStore(),
                  runtime=LambdaRuntime(), engine="batched", host_mesh=2)
    assert "host_mesh" in agg_engine.ENGINES
    backend = agg_engine.get_backend("host_mesh", host_mesh=3, device="cpu")
    assert isinstance(backend, agg_engine.HostMeshBackend)
