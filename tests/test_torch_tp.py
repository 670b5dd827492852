"""Tensor parallelism over the ``model`` axis against the JAX package.

The port's side runs in 4 CPU gloo ranks (`_torch_ranks.run_ranks`, a
`file://` store, no port; `_torch_rank_tp.tp_everything`), the
reference's in a subprocess on 4 fake CPU devices
(`XLA_FLAGS=--xla_force_host_platform_device_count=4`, as
`tests/test_distributed.py` runs it), both at once, from the reference's
seeded weights, made in the test process and carried over by
`convert.params_from_jax`, then cut to each rank's blocks by
`partitioning.shard_params`. The reference places the same weights by its
`param_pspecs` under GSPMD on the same meshes, (2, 2) and (1, 4)
("data", "model").

Smoke configs at f32 compute: tinyllama at d_model 65 (so that the flat
vector of a rank's blocks pads), qwen3 (`qk_norm`), qwen2.5 (`qkv_bias`)
and, for the forward, gpt2-large at an odd vocabulary of 255 (the
embedding splits its d_model and the head its rows, as at 50,257). The 2
kv heads of the first three do not divide over 4 ranks, so on (1, 4)
`wk`/`wv` stay whole and each rank's q heads read the kv heads they map
to, and the decode cache is split over its length; on (2, 2) the kv
heads and the cache's kv heads are split.

Tolerances, the reference's own (`tests/test_distributed.py`), each
stated where it is used: logits and losses within rtol = atol = 2e-4;
the plans' losses within 1e-5 and their parameters within rtol 5e-4 /
atol 1e-4; the MoE dispatches' logits and gradients within rtol = atol =
2e-4; decode logits within 2e-4.
"""
import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_rank_tp as bodies  # noqa: E402
from _torch_ranks import run_ranks  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import registry as ref_models  # noqa: E402
from repro_torch.config import MeshConfig, ShapeConfig, ShardingPlan  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import partitioning as parts  # noqa: E402
from repro_torch.launch import serve as S  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.models import registry as models  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
ARCHS = ("tinyllama-1.1b", "qwen3-32b", "qwen2.5-14b", "gpt2-large")
MESHES = tuple(bodies.MESHES)

# the reference's side: the GSPMD forward and loss of each config on both
# meshes, the none and zero1 plans on (2, 2), the MoE dispatches and the
# sharded make_serve_step on both meshes
REFERENCE = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from repro.config import ShapeConfig, ShardingPlan
from repro.core.sharding import flatten
from repro.launch import partitioning as parts
from repro.launch.mesh import make_mesh
from repro.launch.serve import make_serve_step
from repro.launch.train import jit_train_step
from repro.models import meshctx, registry as R
from repro.optim import adamw

with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
meshes = {"2x2": make_mesh((2, 2), ("data", "model")),
          "1x4": make_mesh((1, 4), ("data", "model"))}
none = ShardingPlan(grad_sharding="none")
shape = ShapeConfig("t", seq_len=16, global_batch=8, kind="train")

def batch_of(toks):
    return {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
            "labels": jnp.asarray(toks[:, 1:], jnp.int32)}

def forward_loss(cfg, params, batch, mesh):
    fn = jax.jit(lambda p, b: (R.forward(p, cfg, b), R.loss_fn(p, cfg, b)[0]),
                 in_shardings=(
                     parts.to_named(mesh, parts.param_pspecs(cfg, mesh, none)),
                     parts.to_named(mesh, parts.batch_pspecs(cfg, shape,
                                                             mesh))))
    logits, loss = fn(params, batch)
    return np.asarray(logits), float(loss)

out = {"forward": {}, "plans": {}, "moe": {}, "decode": {}}
batch = batch_of(inp["tokens"])
for arch, (cfg, tree) in inp["archs"].items():
    params = jax.tree.map(jnp.asarray, tree)
    for name, mesh in meshes.items():
        out["forward"][arch, name] = forward_loss(cfg, params, batch, mesh)

cfg, tree = inp["archs"]["tinyllama-1.1b"]
params = jax.tree.map(jnp.asarray, tree)
opt = adamw(1e-3, grad_clip_norm=1.0)
for gs in ("none", "zero1"):
    state = opt.init(params)
    step = jit_train_step(cfg, shape, meshes["2x2"],
                          ShardingPlan(grad_sharding=gs), opt, state,
                          donate=False)
    new, state, m = step(params, state, batch)
    out["plans"][gs] = (np.asarray(flatten(new)[0]), float(m["loss"]),
                        float(m["grad_norm"]))

mcfg, mtree = inp["moe"]
mparams = jax.tree.map(jnp.asarray, mtree)
mbatch = batch_of(inp["moe_tokens"])
for dispatch in ("global", "local"):
    c = mcfg if dispatch == "global" else \\
        __import__("dataclasses").replace(mcfg, moe_dispatch="local")
    with meshctx.use_mesh(meshes["2x2"] if dispatch == "local" else None):
        logits = jax.jit(lambda p, b: R.forward(p, c, b))(mparams, mbatch)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: R.loss_fn(p, c, mbatch), has_aux=True))(mparams)
    out["moe"][dispatch] = (np.asarray(logits), float(loss),
                            np.asarray(flatten(grads)[0]))

scfg, stree = inp["serve"]
sparams = jax.tree.map(jnp.asarray, stree)
toks = inp["serve_tokens"]
def decode(scfg, sparams, toks, mesh):
    b, max_len = toks.shape[0], 4
    sshape = ShapeConfig("serve", seq_len=max_len, global_batch=b,
                         kind="decode")
    cache = R.init_cache(scfg, b, max_len, dtype=jnp.float32)
    step = make_serve_step(scfg, sshape, mesh, cache)
    steps = []
    for i in range(toks.shape[1]):
        logits, cache = step(sparams, jnp.asarray(toks[:, i:i + 1], jnp.int32),
                             cache)
        steps.append(np.asarray(logits))
    return np.stack(steps)

for name, mesh in meshes.items():
    out["decode"][name] = decode(scfg, sparams, toks, mesh)
mcfg, mtree = inp["serve_mqa"]
out["decode"]["2x2-b1"] = decode(mcfg, jax.tree.map(jnp.asarray, mtree),
                                 toks[:1], meshes["2x2"])
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _ref_cfg(arch, **over):
    return dataclasses.replace(ref_get_arch(arch).smoke, n_layers=2,
                               remat=False, compute_dtype=jnp.float32, **over)


def _ref_params(cfg, seed=0) -> dict:
    return jax.tree.map(np.asarray,
                        ref_models.init_params(jax.random.PRNGKey(seed), cfg))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the 4 ranks, side by side, on the
    same seeded weights (the reference's, made here)."""
    tmp = tmp_path_factory.mktemp("tp")
    archs = {a: _ref_cfg(a, **bodies.OVERRIDES.get(a, {})) for a in ARCHS}
    archs = {a: (c, _ref_params(c)) for a, c in archs.items()}
    moe = _ref_cfg("phi3.5-moe-42b-a6.6b")
    moe = dataclasses.replace(moe, moe=dataclasses.replace(
        moe.moe, capacity_factor=8.0))
    moe = (moe, _ref_params(moe, 1))
    serve = _ref_cfg("tinyllama-1.1b")
    serve = (serve, _ref_params(serve, 2))
    mqa = _ref_cfg("tinyllama-1.1b", n_kv_heads=1)
    mqa = (mqa, _ref_params(mqa, 3))
    inp = {"archs": archs, "moe": moe, "serve": serve, "serve_mqa": mqa,
           "tokens": np.random.default_rng(0).integers(0, 255, (8, 17)),
           "moe_tokens": np.random.default_rng(1).integers(0, 256, (8, 17)),
           "serve_tokens": np.random.default_rng(2).integers(0, 256,
                                                             (4, 6))}
    (tmp / "inputs.pkl").write_bytes(pickle.dumps(inp))
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE),
         str(tmp / "inputs.pkl"), str(tmp / "reference.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = run_ranks(
            tmp, "_torch_rank_tp:tp_everything", 4,
            lm=archs["tinyllama-1.1b"][1], tokens=inp["tokens"],
            archs={a: p for a, (_, p) in archs.items()}, moe=moe[1],
            moe_tokens=inp["moe_tokens"], serve=serve[1],
            serve_tokens=inp["serve_tokens"], serve_mqa=mqa[1])
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-6000:]
    return pickle.loads((tmp / "reference.pkl").read_bytes()), ranks


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(runs, arch, mesh):
    """The TP forward's logits (each rank's vocabulary block and batch
    rows, joined) and the vocabulary-parallel loss against the reference's
    GSPMD forward on the same mesh, within rtol = atol = 2e-4; every rank
    joins the same logits."""
    ref, ranks = runs
    want_logits, want_loss = ref["forward"][arch, mesh]
    logits, loss = ranks[0]["forward"][arch, mesh]
    assert logits.shape == want_logits.shape
    np.testing.assert_allclose(logits, want_logits, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(loss, want_loss, rtol=2e-4, atol=2e-4)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["forward"][arch, mesh][0], logits)


@pytest.mark.parametrize("gs", ["none", "zero1"])
def test_train_step_matches_reference(runs, gs):
    """`jit_train_step` with model = 2 on (2, 2) against the reference's
    GSPMD step on the same mesh: loss within 1e-5, the clipping norm
    within rtol 1e-5 (clipping is active: the norm is above 1), the
    parameters within rtol 5e-4 / atol 1e-4."""
    ref, ranks = runs
    want, got = ref["plans"][gs], ranks[0]["plans"][gs]
    assert want[2] > 1.0
    assert abs(got["loss"] - want[1]) < 1e-5
    np.testing.assert_allclose(got["grad_norm"], want[2], rtol=1e-5)
    np.testing.assert_allclose(got["params"], want[0], rtol=5e-4, atol=1e-4)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["plans"][gs]["params"],
                                      got["params"])


def test_zero3_matches_port_none(runs):
    """zero3 with model = 2 against the port's own `none` (the
    reference's zero3 is xfail on its fake CPU mesh): loss within 1e-5,
    parameters within rtol 5e-4 / atol 1e-4, AdamW's first moment within
    rtol 5e-4 / atol 1e-6."""
    _, ranks = runs
    base, got = ranks[0]["plans"]["none"], ranks[0]["plans"]["zero3"]
    assert abs(got["loss"] - base["loss"]) < 1e-5
    np.testing.assert_allclose(got["grad_norm"], base["grad_norm"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["params"], base["params"], rtol=5e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got["mu"], base["mu"], rtol=5e-4, atol=1e-6)


def test_clip_norm_counts_replicated_leaves_once(runs):
    """The trainer's gradient norm at model = 2 is the norm of the whole
    gathered gradient (within rtol 1e-5): the split leaves' squares are
    summed over `model`, the replicated leaves' (norms, unsplit ones)
    taken once; there are both kinds."""
    _, ranks = runs
    r = ranks[0]
    assert any(r["split_leaves"].values())
    assert not all(r["split_leaves"].values())
    for gs in T.PLANS:
        np.testing.assert_allclose(r["plans"][gs]["grad_norm"],
                                   r["whole_grad_norm"], rtol=1e-5)


@pytest.mark.parametrize("dispatch", ["global", "local"])
def test_moe_dispatch_matches_reference(runs, dispatch):
    """phi3.5-moe's smoke config on (2, 2), d_ff blocks over `model`, the
    global and the local dispatch: logits, loss and every gradient leaf
    (gathered) within rtol = atol = 2e-4 of the reference's same
    dispatch."""
    ref, ranks = runs
    logits, loss, grads = ref["moe"][dispatch]
    got = ranks[0]["moe"][dispatch]
    np.testing.assert_allclose(got["logits"], logits, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got["loss"], loss, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got["grads"], grads, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("mesh,layout", [("2x2", "heads"),
                                         ("1x4", "length"),
                                         ("2x2-b1", "length_all")])
def test_decode_matches_reference(runs, mesh, layout):
    """6 decode steps through the sharded `make_serve_step` (the ring of 4
    slots wraps): on (2, 2) the cache's kv heads are split over `model`,
    on (1, 4) its length; with one kv head at batch 1 on (2, 2) its length
    over ("data", "model"). The whole (B, 1, V) logits on every rank
    within 2e-4 of the reference's `make_serve_step` on the same mesh."""
    ref, ranks = runs
    got = ranks[0]["decode"][mesh]
    spec = got["k_spec"]
    assert (spec[3] == "model") == (layout == "heads")
    assert (spec[2] == "model") == (layout == "length")
    assert (spec[2] == ("data", "model")) == (layout == "length_all")
    assert got["idx"] == 6
    np.testing.assert_allclose(got["logits"], ref["decode"][mesh],
                               rtol=2e-4, atol=2e-4)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["decode"][mesh]["logits"],
                                      got["logits"])


@pytest.mark.parametrize("mesh", MESHES)
def test_shard_then_gather_returns_the_tree(runs, mesh):
    """`shard_params` then `gather_params` gives back every leaf bit for
    bit, in its type, for each config; `shard_params` passes a tree of
    blocks through as it is."""
    _, ranks = runs
    for r in ranks:
        assert all(r["roundtrip"][a, mesh] for a in ARCHS)


@pytest.mark.parametrize("mesh", MESHES)
def test_init_local_params_are_blocks_of_init_params(runs, mesh):
    """`init_local_params` equals `shard_params` of the one-device
    `init_params` from the same seed, bit for bit, at the shapes of
    `local_param_shapes`."""
    _, ranks = runs
    assert all(r["init_local"][mesh] for r in ranks)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b",
                                  "whisper-tiny"])
def test_families_split_entry_points_build(arch):
    """The SSM, hybrid and encoder-decoder families build through every
    entry point at model = 4, on each rank's coordinates of (1, 4):
    `shard_params` and `init_local_params` give the blocks of
    `local_param_shapes` (the same bits, drawn or cut), and
    `jit_train_step` (each plan) and the sharded `make_serve_step` build.
    `TP_FAMILIES` and `check_tp_family` are gone."""
    cfg = get_arch(arch).smoke
    shape = ShapeConfig("t", seq_len=4, global_batch=2, kind="decode")
    assert not hasattr(parts, "check_tp_family")
    assert not hasattr(parts, "TP_FAMILIES")
    whole = models.init_params(torch.Generator().manual_seed(3), cfg)
    for r in range(4):
        mesh = _FakeMesh((1, 4), ("data", "model"), (0, r))
        local = parts.local_param_shapes(cfg, mesh)
        blocks = parts.shard_params(whole, cfg, mesh)
        assert {k: tuple(t.shape) for k, t in blocks.items()} == local
        assert any(local[k] != tuple(t.shape) for k, t in whole.items())
        drawn = parts.init_local_params(torch.Generator().manual_seed(3),
                                        cfg, mesh)
        assert drawn.keys() == blocks.keys()
        assert all(torch.equal(drawn[k], blocks[k]) for k in blocks)
        for gs in T.PLANS:
            assert callable(T.jit_train_step(
                cfg, shape, mesh, ShardingPlan(grad_sharding=gs),
                adamw(1e-3)))
        assert callable(S.make_serve_step(
            cfg, shape, mesh, models.cache_specs(cfg, 2, 4)))


class _FakeMesh:
    """The axis names, sizes and one rank's coordinates of a mesh."""

    def __init__(self, shape, axes, coords):
        self.shape, self.mesh_dim_names = shape, axes
        self.coords = dict(zip(axes, coords))

    def get_local_rank(self, axis):
        return self.coords[axis]


@pytest.mark.parametrize("coords", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_blocks_follow_the_tuple_order(coords):
    """A dim split over ("data", "model") (the batch-1 decode cache's
    length) is cut into data × model blocks, block index data·|model| +
    model; `model_block` and `rank_block` both take it, and only
    `rank_block` takes a dim split over "data" alone."""
    mesh = _FakeMesh((2, 2), ("data", "model"), coords)
    spec, shape = (None, "data", ("data", "model"), None), (3, 4, 8, 5)
    d, m = coords
    lo = (d * 2 + m) * 2
    assert parts.model_block(spec, shape, mesh) == (
        slice(None), slice(None), slice(lo, lo + 2), slice(None))
    assert parts.rank_block(spec, shape, mesh) == (
        slice(None), slice(d * 2, d * 2 + 2), slice(lo, lo + 2), slice(None))
    assert parts.local_shape(spec, shape, mesh) == (3, 4, 2, 5)
    assert parts.local_shape(spec, shape, mesh, False) == (3, 2, 2, 5)


def test_local_param_shapes_and_cache_layouts():
    """qwen3-32b at full width on 4 ranks: a rank holds 16 of 64 q heads,
    2 of 8 kv heads, a quarter of d_ff and of the vocabulary, the norms
    whole, and a quarter of the 65.6 GB of bf16 parameters; the decode
    cache splits its kv heads. tinyllama's smoke config (2 kv heads)
    splits the cache's length over 4 ranks instead."""
    cfg = dataclasses.replace(get_arch("qwen3-32b").model,
                              param_dtype=torch.bfloat16)
    mesh = MeshConfig((1, 4), ("data", "model"))
    shapes = parts.local_param_shapes(cfg, mesh)
    assert shapes["layers.attn.wq"] == (64, 5120, 16, 128)
    assert shapes["layers.attn.wk"] == (64, 5120, 2, 128)
    assert shapes["layers.attn.wo"] == (64, 16, 128, 5120)
    assert shapes["layers.mlp.w1"] == (64, 5120, 6400)
    assert shapes["layers.mlp.w2"] == (64, 6400, 5120)
    assert shapes["embed"] == (151_936 // 4, 5120)
    assert shapes["lm_head"] == (5120, 151_936 // 4)
    assert shapes["layers.attn.qnorm"] == (64, 128)
    total = sum(int(np.prod(s)) for s in shapes.values())
    assert abs(total * 2 / 1e9 - 65.6 / 4) < 0.1
    shape = ShapeConfig("serve", seq_len=64, global_batch=4, kind="decode")
    like = models.cache_specs(cfg, 4, 64)
    assert parts.cache_pspecs(cfg, shape, mesh, like)["k"] == (
        None, "data", None, "model", None)
    smoke = get_arch("tinyllama-1.1b").smoke
    like = models.cache_specs(smoke, 4, 8)
    specs = parts.cache_pspecs(smoke, shape, mesh, like)
    assert specs["k"] == (None, "data", "model", None, None)
    assert parts.kv_length_axes(specs) == ("model",)


def test_plans_on_three_axes_of_eight_ranks(tmp_path):
    """The three plans on a (2, 2, 2) ("pod", "data", "model") mesh of 8
    gloo ranks (`_torch_rank_tp_families.plans_8`): tinyllama's smoke
    config at 2 layers and f32, AdamW at 1e-3, one step from the
    reference's weights, against the reference's one-device step on the
    same batch, at its plan check's tolerances
    (`tests/test_distributed.py::test_gspmd_plans_agree`): loss within
    1e-5, parameters within rtol 5e-4 / atol 1e-4."""
    from repro.core.sharding import flatten as ref_flatten
    from repro.launch.train import make_train_step as ref_step
    from repro.optim import adamw as ref_adamw

    cfg = _ref_cfg("tinyllama-1.1b")
    tree = _ref_params(cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (8, 17))
    opt = ref_adamw(1e-3)
    params = jax.tree.map(jnp.asarray, tree)
    batch = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
             "labels": jnp.asarray(toks[:, 1:], jnp.int32)}
    new, _, m = jax.jit(ref_step(cfg, opt))(params, opt.init(params), batch)
    want = np.asarray(ref_flatten(new)[0])
    ranks = run_ranks(tmp_path, "_torch_rank_tp_families:plans_8", 8,
                      lm=tree, tokens=toks)
    for gs in T.PLANS:
        got = ranks[0][gs]
        assert abs(got["loss"] - float(m["loss"])) < 1e-5, gs
        np.testing.assert_allclose(got["params"], want, rtol=5e-4,
                                   atol=1e-4)
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[gs]["params"], got["params"])
