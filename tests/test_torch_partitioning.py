"""The port's partition specs against the JAX package's, entry for entry.

The reference computes its `PartitionSpec`s in a subprocess on 8 fake CPU
devices (`XLA_FLAGS=--xla_force_host_platform_device_count=8`, as
`tests/test_distributed.py` runs it) on real meshes (2, 2) ("data",
"model") and (2, 2, 2) ("pod", "data", "model"), for every registered
arch at its model and smoke widths, each plan, and train, prefill, decode
and batch-1 decode shapes; it hands them back as tuples through
`tmp_path`. The port computes the same from a `MeshConfig` of the same
names and sizes (its spec functions read only those), and every spec must
be equal: the same layout rule, the same divisibility fallbacks (whisper's
51,865 vocabulary), the same FSDP and ZeRO choices.
"""
import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro import config as ref_config  # noqa: E402
from repro.configs import REGISTRY  # noqa: E402
from repro_torch import config  # noqa: E402
from repro_torch.config import MeshConfig, ShapeConfig, ShardingPlan  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import partitioning as parts  # noqa: E402
from repro_torch.models import registry as models  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
ARCHS = sorted(REGISTRY)
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
PLANS = ("none", "zero1", "zero3")
SHAPES = [("train", 16, 8, "train"), ("prefill", 16, 8, "prefill"),
          ("decode", 64, 8, "decode"), ("long", 64, 1, "decode")]

REFERENCE = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from jax.sharding import PartitionSpec as P
from repro.config import ShapeConfig, ShardingPlan
from repro.configs import REGISTRY
from repro.launch import partitioning as parts
from repro.launch.mesh import make_mesh
from repro.models import registry as models
from repro.optim import adamw

MESHES, PLANS, SHAPES = %r, %r, %r

def flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {jax.tree_util.keystr(p): tuple(s) for p, s in leaves}

out = {}
for arch in sorted(REGISTRY):
    for which in ("model", "smoke"):
        cfg = getattr(REGISTRY[arch], which)
        specs = models.param_specs(cfg)
        state = jax.eval_shape(adamw(1e-3).init, specs)
        for mname, (shape, axes) in MESHES.items():
            mesh = make_mesh(shape, axes)
            res = {}
            for gs in PLANS:
                plan = ShardingPlan(grad_sharding=gs)
                p = parts.param_pspecs(cfg, mesh, plan)
                res["param", gs] = flat(p)
                res["opt", gs] = flat(parts.opt_state_pspecs(
                    cfg, mesh, plan, state, p))
            for name, seq, batch, kind in SHAPES:
                sc = ShapeConfig(name, seq_len=seq, global_batch=batch,
                                 kind=kind)
                res["batch", name] = flat(parts.batch_pspecs(cfg, sc, mesh))
                res["token", name] = tuple(parts.decode_token_pspec(sc, mesh))
                if kind == "decode":
                    res["cache", name] = flat(parts.cache_pspecs(
                        cfg, sc, mesh, models.cache_specs(cfg, batch, seq)))
            out[arch, which, mname] = res
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
""" % (MESHES, PLANS, SHAPES)


def _keystr(parts_: list) -> str:
    return "".join(parts_)


def _flat(tree, prefix=()) -> dict:
    """The port's spec tree under the reference's key-path strings: a dict
    key as ``['k']`` (a dotted name one key a part), a named tuple's field
    as ``.field``."""
    if isinstance(tree, dict):
        out = {}
        for name, val in tree.items():
            keys = tuple(f"['{p}']" for p in name.split("."))
            out.update(_flat(val, prefix + keys))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for field, val in zip(tree._fields, tree):
            out.update(_flat(val, prefix + (f".{field}",)))
        return out
    return {_keystr(list(prefix)): tuple(tree)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("partitioning") / "reference.pkl"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(out)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-6000:]
    return pickle.loads(out.read_bytes())


def _model_axes(spec) -> list:
    return [i for i, e in enumerate(spec)
            if e == "model" or (isinstance(e, tuple) and "model" in e)]


def _a_log_misread(cfg) -> bool:
    """Whether the reference's shape test reads Mamba-2's stacked ``a_log``
    (L, H) as Mamba-1's (di, ds): where H equals d_state (zamba2's smoke
    width), it splits the layer axis. The port tells the two apart by
    ``cfg.ssm.version`` (ROADMAP §3)."""
    if cfg.ssm is None or cfg.ssm.version != 2:
        return False
    shape = tuple(models.param_specs(cfg)["layers.mamba.a_log"].shape)
    return len(shape) >= 2 and shape[-1] == cfg.ssm.d_state


def _equal_but_documented(cfg, got: dict, want: dict, what, tp: int) -> None:
    """Every spec equal to the reference's but the port's two documented
    layout differences, with the same numbers (ROADMAP §3):

    * a Mamba-2 cache's B and C conv histories stay whole (no ``model``
      entry);
    * where the reference misreads Mamba-2's stacked ``a_log``, the port's
      spec is the reference's own spec for ``dt_bias`` at the same path (the
      same (L, H) shape and head rule): ``model`` on the head axis when
      ``tp`` divides the heads, else no ``model`` entry.
    """
    assert got.keys() == want.keys(), what
    v2 = cfg.ssm is not None and cfg.ssm.version == 2
    conv = ("['mamba']['conv_b']", "['mamba']['conv_c']")
    a_log = _a_log_misread(cfg)
    for k in got:
        if v2 and k.endswith(conv):
            assert _model_axes(got[k]) == [], (what, k, got[k])
        elif a_log and k.endswith("['mamba']['a_log']"):
            twin = want[k[:-len("['a_log']")] + "['dt_bias']"]
            assert got[k] == twin, (what, k, got[k], twin)
            heads = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
            assert _model_axes(got[k]) == (
                [len(got[k]) - 1] if heads % tp == 0 else []), (what, k)
        else:
            assert got[k] == want[k], (what, k)


@pytest.mark.parametrize("mname", sorted(MESHES))
@pytest.mark.parametrize("which", ["model", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_reference(reference, arch, which, mname):
    cfg = getattr(get_arch(arch), which)
    shape, axes = MESHES[mname]
    mesh = MeshConfig(shape, axes)
    tp = shape[axes.index("model")]
    ref = reference[arch, which, mname]
    state = adamw(1e-3).init(models.param_specs(cfg))
    for gs in PLANS:
        plan = ShardingPlan(grad_sharding=gs)
        p = parts.param_pspecs(cfg, mesh, plan)
        _equal_but_documented(cfg, _flat(p), ref["param", gs], (gs, "param"),
                              tp)
        got = _flat(parts.opt_state_pspecs(cfg, mesh, plan, state, p))
        _equal_but_documented(cfg, got, ref["opt", gs], (gs, "opt"), tp)
    for name, seq, batch, kind in SHAPES:
        sc = ShapeConfig(name, seq_len=seq, global_batch=batch, kind=kind)
        assert _flat(parts.batch_pspecs(cfg, sc, mesh)) == ref["batch", name]
        assert parts.decode_token_pspec(sc, mesh) == ref["token", name]
        if kind == "decode":
            cache = models.cache_specs(cfg, batch, seq)
            _equal_but_documented(cfg, _flat(parts.cache_pspecs(
                cfg, sc, mesh, cache)), ref["cache", name], name, tp)


def test_whisper_vocab_falls_back_to_d_model():
    """whisper's odd 51,865 vocabulary cannot split over `model`: the
    embedding shards d_model instead, the head its rows."""
    cfg = get_arch("whisper-tiny").model
    p = parts.param_pspecs(cfg, MeshConfig((2, 2), ("data", "model")),
                           ShardingPlan(grad_sharding="none"))
    assert cfg.vocab == 51_865
    assert p["embed"] == (None, "model")


def test_to_placements():
    """A spec becomes one placement a mesh axis: Shard(i) where tensor dim
    i names the axis (alone or in a tuple), Replicate() elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = MeshConfig((2, 2, 2), ("pod", "data", "model"))
    specs = {"w": (("pod", "data"), None, "model"), "b": (None,),
             "s": ()}
    got = parts.to_placements(mesh, specs)
    assert got["w"] == (Shard(0), Shard(0), Shard(2))
    assert got["b"] == (Replicate(),) * 3
    assert got["s"] == (Replicate(),) * 3
    plan = ShardingPlan(grad_sharding="zero1")
    cfg = get_arch("tinyllama-1.1b").smoke
    state = adamw(1e-3).init(models.param_specs(cfg))
    ospecs = parts.opt_state_pspecs(
        cfg, mesh, plan, state, parts.param_pspecs(cfg, mesh, plan))
    placed = parts.to_placements(mesh, ospecs)
    assert placed.step == (Replicate(),) * 3
    assert placed.mu["embed"] == (Shard(1), Shard(1), Shard(0))


@pytest.mark.parametrize("name", ["MeshConfig", "ShardingPlan"])
def test_config_classes_match_reference(name):
    """The mesh and plan configurations carry the reference's fields,
    defaults and derived sizes."""
    ours, theirs = getattr(config, name), getattr(ref_config, name)
    assert [(f.name, f.default) for f in dataclasses.fields(ours)] == \
        [(f.name, f.default) for f in dataclasses.fields(theirs)]
    for mesh in ("SINGLE_POD_MESH", "MULTI_POD_MESH"):
        a, b = getattr(config, mesh), getattr(ref_config, mesh)
        assert (a.shape, a.axes, a.n_devices, a.replica_axes,
                a.data_parallel_size, a.model_parallel_size) == \
            (b.shape, b.axes, b.n_devices, b.replica_axes,
             b.data_parallel_size, b.model_parallel_size)


def test_h100_spec_is_the_data_sheet():
    """The card's peaks are the data sheet's, not the reference's TPU
    model."""
    h = config.H100_SXM
    assert (h.hbm_bw, h.peak_flops_f32, h.peak_flops_f64,
            h.peak_flops_bf16, h.hbm_bytes) == \
        (3.35e12, 67e12, 34e12, 989e12, 80 * 10**9)
    assert not hasattr(config, "TPUSpec")
