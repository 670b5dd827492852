"""The port's host-only modules against the JAX package: ``adamw``
(`repro_torch.optim`), the data partitions and ``SyntheticVision``
(`repro_torch.data`), and the checkpoint manager and elastic reshard
(`repro_torch.checkpoint`).

Inputs are seeded numpy, carried into each package. Tolerances: ``adamw``
f32 rtol 1e-6, atol 1e-7 (the two packages' ``pow`` and ``sqrt`` may
round the last bit apart); everything else is compared for equality:
index arrays, histograms, image bytes, and checkpoint files, which either
package restores from the other.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as ref_ckpt  # noqa: E402
from repro import optim as ref_optim  # noqa: E402
from repro.core import sharding as ref_sh  # noqa: E402
from repro.data import partition as ref_part  # noqa: E402
from repro.data import synthetic as ref_syn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager,
    load_resharded,
    save_sharded,
)
from repro_torch.core.sharding import make_plan, reconstruct  # noqa: E402
from repro_torch.data import (  # noqa: E402
    SyntheticVision,
    client_label_histogram,
    dirichlet_partition,
    iid_partition,
    lm_batch_specs,
)
from repro_torch.optim import AdamState, adamw, apply_updates  # noqa: E402

# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

SHAPES = {"b": (7,), "layers.w": (3, 5, 4), "w": (33, 9)}


def _adam_inputs(steps=5, seed=0):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (3.0 * rng.standard_normal(s)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]
    return params, grads


def _nest(flat):
    """Dotted names as the reference's nested tree."""
    out = {}
    for name, val in flat.items():
        *path, leaf = name.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(val)
    return out


def _flat_np(tree):
    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("grad_clip_norm", [None, 1.0])
def test_adamw_matches_reference_over_five_steps(weight_decay,
                                                 grad_clip_norm):
    params, grads = _adam_inputs()
    kw = dict(lr=0.05, weight_decay=weight_decay,
              grad_clip_norm=grad_clip_norm)
    ref_opt, opt = ref_optim.adamw(**kw), adamw(**kw)
    ref_p = _nest(params)
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ref_state, state = ref_opt.init(ref_p), opt.init(p)
    assert isinstance(state, AdamState) and state.step.dtype == torch.int32
    for g in grads:
        ref_upd, ref_state = ref_opt.update(_nest(g), ref_state, ref_p)
        upd, state = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                                state, p)
        ref_p = ref_optim.apply_updates(ref_p, ref_upd)
        p = apply_updates(p, upd)
        assert int(state.step) == int(ref_state.step)
        for got, want in ((upd, ref_upd), (state.mu, ref_state.mu),
                          (state.nu, ref_state.nu), (p, ref_p)):
            want = _flat_np(want)
            assert sorted(got) == sorted(want)
            for name, t in got.items():
                assert t.dtype == torch.float32
                np.testing.assert_allclose(t.numpy(), want[name], rtol=1e-6,
                                           atol=1e-7, err_msg=name)


@pytest.mark.parametrize("make_opt", [
    lambda: adamw(0.2), lambda: adamw(0.2, grad_clip_norm=1.0)])
def test_adamw_converges_on_quadratic(make_opt):
    opt = make_opt()
    params = {"x": torch.zeros(3), "y": torch.zeros(2)}
    state = opt.init(params)
    loss = lambda p: torch.sum((p["x"] - 3.0) ** 2) \
        + torch.sum((p["y"] + 1.0) ** 2)
    for _ in range(200):
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        g = dict(zip(leaves, torch.autograd.grad(loss(leaves),
                                                 list(leaves.values()))))
        upd, state = opt.update(g, state, params)
        params = apply_updates(params, upd)
    assert float(loss(params)) < 1e-3


def test_adamw_weight_decay_shrinks():
    opt = adamw(0.1, weight_decay=0.5)
    params = {"x": torch.full((4,), 10.0)}
    state = opt.init(params)
    for _ in range(50):
        g = {k: torch.zeros_like(v) for k, v in params.items()}
        upd, state = opt.update(g, state, params)
        params = apply_updates(params, upd)
    assert float(params["x"].abs().max()) < 1.0


# ---------------------------------------------------------------------------
# Partitions and synthetic data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,clients,seed", [(1000, 7, 1), (50_000, 100, 0),
                                            (10, 10, 3), (5, 8, 2)])
def test_iid_partition_equals_reference(n, clients, seed):
    got = iid_partition(n, clients, seed)
    want = ref_part.iid_partition(n, clients, seed)
    assert len(got) == len(want) == clients
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(np.unique(np.concatenate(got))) == n


@pytest.mark.parametrize("alpha,clients,min_per", [
    (0.1, 20, 1), (0.5, 20, 1), (100.0, 20, 1), (0.05, 40, 30)])
def test_dirichlet_partition_and_histogram_equal_reference(alpha, clients,
                                                           min_per):
    labels = np.random.default_rng(0).integers(0, 10, 5000)
    got = dirichlet_partition(labels, clients, alpha, seed=2,
                              min_per_client=min_per)
    want = ref_part.dirichlet_partition(labels, clients, alpha, seed=2,
                                        min_per_client=min_per)
    assert len(got) == len(want) == clients
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    assert all(len(p) >= min_per for p in got)
    assert len(np.unique(np.concatenate(got))) == 5000
    hist = client_label_histogram(labels, got)
    np.testing.assert_array_equal(
        hist, ref_part.client_label_histogram(labels, want))
    assert hist.sum() == 5000


@pytest.mark.parametrize("kw,labels", [
    (dict(), None), (dict(n_classes=4, img_size=8, seed=3, noise=0.1), None),
    (dict(n_classes=100, img_size=16, channels=1, seed=7),
     np.array([5, 99, 0, 5]))])
def test_synthetic_vision_bytes_equal_reference(kw, labels):
    got_src, want_src = SyntheticVision(**kw), ref_syn.SyntheticVision(**kw)
    assert got_src._prototypes().tobytes() == \
        want_src._prototypes().tobytes()
    for client, step in ((0, 0), (3, 11)):
        got = got_src.batch(client, step, 4, labels=labels)
        want = want_src.batch(client, step, 4, labels=labels)
        assert got["images"].dtype == torch.float32
        assert got["images"].shape == want["images"].shape
        assert got["images"].numpy().tobytes() == \
            np.asarray(want["images"]).tobytes()
        assert got["labels"].dtype == torch.int64
        np.testing.assert_array_equal(got["labels"].numpy(),
                                      np.asarray(want["labels"]))


def test_lm_batch_specs_on_meta():
    got = lm_batch_specs(8, 64)
    want = ref_syn.lm_batch_specs(8, 64)
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == want[k].shape
        assert str(t.dtype) == f"torch.{np.dtype(want[k].dtype).name}"


# ---------------------------------------------------------------------------
# Checkpoints: the reference's tests on the port, then each package
# restoring the other's files
# ---------------------------------------------------------------------------

def _ref_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": jnp.asarray(rng.standard_normal((8, 4)), jnp.float32),
            "b": jnp.asarray(rng.standard_normal(4), jnp.float32),
            "inner": {"m": jnp.asarray(rng.standard_normal(10),
                                       jnp.bfloat16)}}


def _tree(seed=0):
    """The reference's tree as the port's flat state dict, bit for bit."""
    return {name: convert.tensor_from_numpy(v)
            for name, v in _flat_np(_ref_tree(seed)).items()}


def _bits(t):
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return t.view(ints[t.dtype])


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(7, tree, extra={"round": 3})
    restored, extra = mgr.restore(7, tree)
    assert extra == {"round": 3}
    assert sorted(restored) == sorted(tree)
    for name, a in tree.items():
        b = restored[name]
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))


def test_latest_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    for s in (1, 5, 9):
        mgr.save(s, tree)
    assert mgr.latest_step() == 9
    assert mgr.steps() == [5, 9]             # step 1 GC'd


def test_corrupt_checkpoint_skipped(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(1, tree)
    mgr.save(2, tree)
    # corrupt the newest: flip bits of a leaf's recorded checksum
    d = os.path.join(str(tmp_path), "step_0000000002")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    manifest["leaves"][0]["crc32"] ^= 0xFF
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with pytest.raises(IOError, match="checksum"):
        mgr.restore(2, tree)
    step, restored, _ = mgr.restore_latest(tree)
    assert step == 1                          # fell back past the corruption


def test_restore_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros(4)})
    with pytest.raises(ValueError):
        mgr.restore(1, {"w": torch.zeros(5)})
    with pytest.raises(ValueError, match="expected"):
        mgr.restore(1, {"v": torch.zeros(4)})
    assert mgr.restore_latest({"w": torch.zeros(5)}) is None


@pytest.mark.parametrize("m_old,m_new", [(4, 8), (8, 2), (1, 16), (3, 5)])
def test_elastic_reshard(tmp_path, m_old, m_new):
    """Save at M shards, resume at M'."""
    rng = np.random.default_rng(0)
    flat = rng.standard_normal(10_007).astype(np.float32)
    plan = make_plan("uniform", flat.size, m_old)
    save_sharded(str(tmp_path), torch.from_numpy(flat), plan, step=42)
    shards, new_plan, meta = load_resharded(str(tmp_path), 42, m_new)
    assert meta["step"] == 42
    assert new_plan.n_shards == m_new
    assert torch.equal(reconstruct(shards, new_plan), torch.from_numpy(flat))


def _files(d):
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(d, "arrays.npz"))
    return manifest, {k: data[k] for k in data.files}


def test_both_packages_write_the_same_files(tmp_path):
    """Same leaf names, npz keys, shapes, types and checksums; the bf16
    leaf lands on disk as f32 under ``"dtype": "bfloat16"``."""
    ref_dir = ref_ckpt.CheckpointManager(str(tmp_path / "ref")).save(
        3, _ref_tree(), extra={"round": 1})
    dir_ = CheckpointManager(str(tmp_path / "port")).save(
        3, _tree(), extra={"round": 1})
    assert os.path.basename(dir_) == os.path.basename(ref_dir)
    ref_manifest, ref_arrays = _files(ref_dir)
    manifest, arrays = _files(dir_)
    assert manifest == ref_manifest
    assert [e["name"] for e in manifest["leaves"]] == ["b", "inner/m", "w"]
    bf16 = manifest["leaves"][1]
    assert bf16["dtype"] == "bfloat16"
    assert arrays[bf16["key"]].dtype == np.float32
    assert sorted(arrays) == sorted(ref_arrays)
    for key, arr in arrays.items():
        assert arr.dtype == ref_arrays[key].dtype
        assert arr.tobytes() == ref_arrays[key].tobytes()


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    ref_ckpt.CheckpointManager(str(tmp_path)).save(5, _ref_tree(seed=4),
                                                   extra={"k": [1, 2]})
    like = {k: torch.zeros_like(v) for k, v in _tree(seed=0).items()}
    step, restored, extra = CheckpointManager(str(tmp_path)) \
        .restore_latest(like)
    assert step == 5 and extra == {"k": [1, 2]}
    want = _tree(seed=4)
    for name, t in restored.items():
        assert t.dtype == want[name].dtype
        assert torch.equal(_bits(t), _bits(want[name]))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    CheckpointManager(str(tmp_path)).save(6, _tree(seed=9))
    like = jax.tree.map(jnp.zeros_like, _ref_tree(seed=0))
    step, restored, _ = ref_ckpt.CheckpointManager(str(tmp_path)) \
        .restore_latest(like)
    assert step == 6
    want = _ref_tree(seed=9)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_sharded_checkpoint_restores_across_packages(tmp_path, writer):
    flat = np.random.default_rng(1).standard_normal(4_099).astype(np.float32)
    if writer == "reference":
        ref_ckpt.save_sharded(str(tmp_path), flat,
                              ref_sh.make_plan("uniform", flat.size, 3),
                              step=8, extra={"m": 3})
        shards, plan, meta = load_resharded(str(tmp_path), 8, 5)
        got = reconstruct(shards, plan).numpy()
    else:
        save_sharded(str(tmp_path), torch.from_numpy(flat),
                     make_plan("uniform", flat.size, 3), step=8,
                     extra={"m": 3})
        shards, plan, meta = ref_ckpt.load_resharded(str(tmp_path), 8, 5)
        got = ref_sh.reconstruct(shards, plan)
    assert meta == {"plan": {"total": 4_099, "strategy": "uniform",
                             "segments": [[[0, 1367]], [[1367, 2733]],
                                          [[2733, 4099]]]},
                    "step": 8, "extra": {"m": 3}}
    assert plan.n_shards == 5
    assert got.tobytes() == flat.tobytes()
