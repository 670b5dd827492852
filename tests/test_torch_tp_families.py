"""Tensor parallelism over ``model`` for the SSM, hybrid and encoder-decoder
families against the JAX package.

As `tests/test_torch_tp.py` does for the attention families: the port's
side runs in 4 CPU gloo ranks (`_torch_ranks.run_ranks`;
`_torch_rank_tp_families.tp_families`), the reference's GSPMD in a
subprocess on 4 fake CPU devices, both at once, from the reference's
seeded weights carried over by `convert.params_from_jax`, on (2, 2) and
(1, 4) ("data", "model").

Smoke configs at f32 compute: falcon-mamba-7b (Mamba-1, d_inner 64 over
the ranks), zamba2-2.7b (Mamba-2 at its smoke depth of 4, 8 SSD heads,
the shared attention block twice; the gated norm through the rmsnorm
kernel's split route, its plain version here) and whisper-tiny at 6
heads and a vocabulary of 255: on (2, 2) its heads split, on (1, 4) they
do not (the attention runs whole, and the decode caches split over their
length: 4 of the ring's slots, 16 encoder positions), and the odd
vocabulary takes the `d_model`-split embedding and the row-parallel head.

Tolerances, the reference's own (`tests/test_distributed.py`), each
stated where it is used: logits and losses within rtol = atol = 2e-4;
decode logits within 2e-4; the plans' losses within 1e-5 and their
parameters within rtol 5e-4 / atol 1e-4 of the reference's `none` step
on the same mesh (its `zero3` is xfail on its fake CPU mesh); the split
gated norm within rtol 1e-5 / atol 1e-6 at f32 and one bf16 ulp, the
existing rmsnorm route's tolerance.
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

import _torch_rank_tp_families as bodies  # noqa: E402
from _torch_ranks import run_ranks  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import registry as ref_models  # noqa: E402
from repro_torch.config import MeshConfig, ShapeConfig, ShardingPlan  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.launch import partitioning as parts  # noqa: E402
from repro_torch.models import registry as models  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
ARCHS = bodies.ARCHS
MESHES = tuple(bodies.MESHES)

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
from repro.models import registry as R
from repro.optim import adamw

with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
meshes = {"2x2": make_mesh((2, 2), ("data", "model")),
          "1x4": make_mesh((1, 4), ("data", "model"))}
none = ShardingPlan(grad_sharding="none")
shape = ShapeConfig("t", seq_len=16, global_batch=8, kind="train")
opt = adamw(1e-3, grad_clip_norm=1.0)
out = {"forward": {}, "plans": {}, "decode": {}}
toks = inp["tokens"]
for arch, (cfg, tree) in inp["archs"].items():
    params = jax.tree.map(jnp.asarray, tree)
    batch = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
             "labels": jnp.asarray(toks[:, 1:], jnp.int32)}
    if cfg.is_encdec:
        batch["frames"] = jnp.asarray(inp["frames"])
    for name, mesh in meshes.items():
        fn = jax.jit(
            lambda p, b: (R.forward(p, cfg, b), R.loss_fn(p, cfg, b)[0]),
            in_shardings=(
                parts.to_named(mesh, parts.param_pspecs(cfg, mesh, none)),
                parts.to_named(mesh, parts.batch_pspecs(cfg, shape, mesh))))
        logits, loss = fn(params, batch)
        out["forward"][arch, name] = (np.asarray(logits), float(loss))
        step = jit_train_step(cfg, shape, mesh, none, opt, opt.init(params),
                              donate=False)
        new, _, m = step(params, opt.init(params), batch)
        out["plans"][arch, name] = (np.asarray(flatten(new)[0]),
                                    float(m["loss"]))
        dt = inp["decode_tokens"]
        b, max_len = dt.shape[0], 4
        sshape = ShapeConfig("serve", seq_len=max_len, global_batch=b,
                             kind="decode")
        if cfg.is_encdec:
            from repro.models import encdec
            cache = encdec.init_cache(cfg, b, max_len, params=params,
                                      frames=jnp.asarray(inp["frames"][:b]),
                                      dtype=jnp.float32)
        else:
            cache = R.init_cache(cfg, b, max_len, dtype=jnp.float32)
        serve = make_serve_step(cfg, sshape, mesh, cache)
        steps = []
        for i in range(dt.shape[1]):
            logits, cache = serve(params, jnp.asarray(dt[:, i:i + 1],
                                                      jnp.int32), cache)
            steps.append(np.asarray(logits))
        out["decode"][arch, name] = np.stack(steps)
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _ref_cfg(arch):
    return dataclasses.replace(ref_get_arch(arch).smoke, remat=False,
                               compute_dtype=jnp.float32,
                               **bodies.OVERRIDES[arch])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the 4 ranks, side by side."""
    tmp = tmp_path_factory.mktemp("tp_families")
    archs = {}
    for i, arch in enumerate(ARCHS):
        cfg = _ref_cfg(arch)
        archs[arch] = (cfg, jax.tree.map(np.asarray, ref_models.init_params(
            jax.random.PRNGKey(10 + i), cfg)))
    whisper = archs["whisper-tiny"][0]
    rng = np.random.default_rng(3)
    inp = {"archs": archs,
           "tokens": rng.integers(0, 255, (8, 17)),
           "frames": rng.standard_normal(
               (8, whisper.encoder_seq, whisper.frontend_dim)).astype(
                   np.float32),
           "decode_tokens": rng.integers(0, 255, (bodies.DECODE_BATCH,
                                                  bodies.DECODE_STEPS))}
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
            tmp, "_torch_rank_tp_families:tp_families", 4,
            archs={a: tree for a, (_, tree) in archs.items()},
            tokens=inp["tokens"], frames=inp["frames"],
            decode_tokens=inp["decode_tokens"])
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
    """The TP forward's logits (joined over `model` and the batch rows)
    and loss against the reference's GSPMD forward on the same mesh,
    within rtol = atol = 2e-4; every rank joins the same logits; the
    layer weights are split over `model` (at (1, 4) whisper's attention
    stays whole, its MLP splits)."""
    ref, ranks = runs
    want_logits, want_loss = ref["forward"][arch, mesh]
    logits, loss = ranks[0]["forward"][arch, mesh]
    assert logits.shape == want_logits.shape
    np.testing.assert_allclose(logits, want_logits, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(loss, want_loss, rtol=2e-4, atol=2e-4)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["forward"][arch, mesh][0], logits)
    split = ranks[0]["blocks"][arch, mesh]
    inner = {"falcon-mamba-7b": "layers.mamba.in_x",
             "zamba2-2.7b": "layers.mamba.norm_g",
             "whisper-tiny": "dec_layers.mlp.w1"}[arch]
    assert split[inner]
    if arch == "whisper-tiny":
        assert split["dec_layers.xattn.wq"] == (mesh == "2x2")
        assert split["embed"] and split["lm_head"]


@pytest.mark.parametrize("gs", ["none", "zero1", "zero3"])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_plans_match_reference(runs, arch, mesh, gs):
    """One AdamW step (clipped at 1.0) of each plan with `model` > 1
    against the reference's GSPMD `none` step on the same mesh: the loss
    within 1e-5, the parameters within rtol 5e-4 / atol 1e-4; every rank
    gathers the same parameters."""
    ref, ranks = runs
    want_params, want_loss = ref["plans"][arch, mesh]
    got = ranks[0]["plans"][arch, mesh, gs]
    assert abs(got["loss"] - want_loss) < 1e-5
    np.testing.assert_allclose(got["params"], want_params, rtol=5e-4,
                               atol=1e-4)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["plans"][arch, mesh, gs]["params"],
                                      got["params"])


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(runs, arch, mesh):
    """6 decode steps through the sharded `make_serve_step` (the ring of 4
    slots wraps) against the reference's on the same mesh, the whole
    (B, 1, V) logits within 2e-4 on every rank. The cache is each rank's
    block: a Mamba state and x history split with `d_inner` and the
    heads, the B/C histories whole; whisper's self- and cross-attention
    caches split by kv heads on (2, 2), by length on (1, 4)."""
    ref, ranks = runs
    got = ranks[0]["decode"][arch, mesh]
    assert got["idx"] == bodies.DECODE_STEPS
    np.testing.assert_allclose(got["logits"], ref["decode"][arch, mesh],
                               rtol=2e-4, atol=2e-4)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["decode"][arch, mesh]["logits"],
                                      got["logits"])
    specs, shapes = got["specs"], got["shapes"]
    if arch == "whisper-tiny":
        heads = mesh == "2x2"
        for key in ("k", "xk"):
            assert (specs[key][3] == "model") == heads
            assert (specs[key][2] == "model") == (not heads)
        assert shapes["xk"][2] == (16 if heads else 4)
    else:
        tp = bodies.MESHES[mesh][1]
        whole = models.cache_specs(bodies.family_cfg(arch),
                                   bodies.DECODE_BATCH, bodies.DECODE_LEN)
        assert shapes["mamba.h"][2] == whole["mamba"]["h"].shape[2] // tp
        if arch == "zamba2-2.7b":
            for key in ("conv_b", "conv_c"):
                assert shapes["mamba." + key][-1] == \
                    whole["mamba"][key].shape[-1]
            assert shapes["mamba.conv_x"][-1] == \
                whole["mamba"]["conv_x"].shape[-1] // tp


@pytest.mark.parametrize("what", ["out", "dx", "dg"])
@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_split_gated_norm_on_four_ranks(runs, dtype, what):
    """`layers.rmsnorm_split` over (1, 4)'s model group (a (6, 64) row cut
    into 16-wide blocks, one all-reduce forward and one backward) against
    the whole-row `layers.rmsnorm` on the whole row: output, dx and dγ
    (this rank's block) within rtol 1e-5 / atol 1e-6 at f32, one bf16 ulp
    at bf16 (dγ is f32)."""
    _, ranks = runs
    for r in ranks:
        got, want = r["split_norm"][dtype][what]
        if dtype == "torch.bfloat16" and what != "dg":
            ulp = np.abs(want) * 2.0 ** -7 + 1e-30
            assert np.all(np.abs(got - want) <= ulp), (what, got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("blocks", [1, 2, 4, 5])
def test_split_route_plain_matches_whole_row(dtype, blocks):
    """The split route's plain versions: each block's Σx²
    (`rmsnorm_sumsq_plain`) summed over the blocks, then
    `rmsnorm_scale_plain` of each block, against `rmsnorm_plain` of the
    whole row: rtol 1e-5 / atol 1e-6 at f32, one bf16 ulp; one block
    equals it bit for bit at f32. The wrappers take these on CPU tensors
    and on meta tensors (shapes and types only)."""
    rng = np.random.default_rng(blocks)
    d = 40 * blocks
    x = torch.from_numpy(rng.standard_normal((7, d)).astype(np.float32)
                         * 5).to(dtype)
    g = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    want, want_rstd = rn.rmsnorm_plain(x, g, 1e-5)
    cuts = [slice(i * 40, (i + 1) * 40) for i in range(blocks)]
    ssq = sum(rn.rmsnorm_sumsq(x[:, c]) for c in cuts)
    outs = [rn.rmsnorm_scale(x[:, c], ssq, g[c], 1e-5, d) for c in cuts]
    got = torch.cat([o for o, _ in outs], dim=1)
    for _, rstd in outs:
        np.testing.assert_allclose(rstd.numpy(), want_rstd.numpy(),
                                   rtol=1e-5)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)
        if blocks == 1:
            assert torch.equal(got, want)
    else:
        w = want.float().numpy()
        assert np.all(np.abs(got.float().numpy() - w) <= np.abs(w) * 2.0 **
                      -7 + 1e-30)
    meta = x.to("meta")
    s = rn.rmsnorm_sumsq(meta)
    o, r = rn.rmsnorm_scale(meta, s, g.to("meta"), 1e-5, d)
    assert s.shape == (7,) and s.dtype == torch.float32
    assert o.shape == meta.shape and o.dtype == dtype and r.shape == (7,)


def test_split_route_refuses_other_devices_and_bad_shapes():
    """The split route's wrappers check their inputs: a Σx² of the wrong
    length, a d_total below the block's width and a width beyond `MAX_D`
    raise."""
    x = torch.ones(3, 8)
    with pytest.raises(ValueError):
        rn.rmsnorm_scale(x, torch.ones(4), torch.ones(8), 1e-5, 8)
    with pytest.raises(ValueError):
        rn.rmsnorm_scale(x, torch.ones(3), torch.ones(8), 1e-5, 4)
    with pytest.raises(ValueError):
        rn.rmsnorm_sumsq(torch.ones(2, rn.MAX_D + 1))


@pytest.mark.parametrize("which", ["model", "smoke"])
def test_mamba2_conv_histories_stay_whole(which):
    """The port's cache rule (ROADMAP §3, a layout difference with the same
    numbers): zamba2's B and C conv histories stay whole on every rank at
    `model` = 4, where the reference splits them whenever d_state
    divides; the state splits its heads, the x history its `d_inner`."""
    cfg = getattr(get_arch("zamba2-2.7b"), which)
    mesh = MeshConfig((1, 4), ("data", "model"))
    shape = ShapeConfig("serve", seq_len=8, global_batch=4, kind="decode")
    like = models.cache_specs(cfg, 4, 8)
    assert cfg.ssm.d_state % 4 == 0
    specs = parts.cache_pspecs(cfg, shape, mesh, like)["mamba"]
    assert specs["conv_b"] == specs["conv_c"] == (None, "data", None, None)
    assert specs["conv_x"] == (None, "data", None, "model")
    assert specs["h"] == (None, "data", "model", None, None)
    assert parts.param_pspecs(cfg, mesh, ShardingPlan(
        grad_sharding="none"))["layers.mamba.a_log"] == (None, "model")


def test_collectives_reduce_contiguous_tensors(monkeypatch):
    """NCCL reduces contiguous tensors only, and under tensor parallelism a
    gradient or a product comes in any layout (Mamba-2's B and C from a
    convolution, whose output on the card is channels-last): `SumGrad`'s
    backward, `SumOut` and `psum` hand `all_reduce` a contiguous copy, with
    the values of the tensor they were given."""
    import torch.distributed as dist
    from repro_torch.core import device_agg as da

    seen = []

    def all_reduce(t, op=None, group=None):
        seen.append(t.is_contiguous())
        t.mul_(2)

    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    x = torch.arange(24.0).reshape(2, 3, 4).transpose(1, 2)
    assert not x.is_contiguous()
    out = da.SumOut.apply(x, None)
    assert torch.equal(out, 2 * x)
    leaf = torch.zeros(2, 4, 3, requires_grad=True)
    da.SumGrad.apply(leaf, (None,)).backward(x)
    assert torch.equal(leaf.grad, 2 * x)

    class _Mesh:
        mesh_dim_names, shape = ("model",), (2,)

        def get_group(self, axis):
            return None

    assert torch.equal(da.psum(_Mesh(), x, "model"), 2 * x)
    assert seen == [True, True, True]
