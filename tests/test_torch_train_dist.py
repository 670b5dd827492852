"""The port's single-program trainer against the JAX package.

The port's side runs in 4 CPU gloo ranks (`_torch_ranks.run_ranks`, a
`file://` store, no port; `_torch_rank_bodies.trainer`); the reference's
in a subprocess on 4 fake CPU devices
(`XLA_FLAGS=--xla_force_host_platform_device_count=4`, as
`tests/test_distributed.py` runs it), both at once, from the reference's
seeded weights (made in the test process, carried over by
`convert.params_from_jax`). Both hand numpy arrays back through
`tmp_path`.

The trainer runs at the smoke width with d_model 65, so that |θ| =
108,485 is odd and every M > 1 pads the flat vector (the registered widths
divide by 8); the qsgd8 run keeps the registered smoke config, as the
reference's test does.

Tolerances, the reference's own (`tests/test_distributed.py`), each
stated where it is used: the shard_map step within rtol 2e-4 / atol 2e-5
of a single-device step; the plans' losses within 1e-5 and their
parameters within rtol 5e-4 / atol 1e-4 (collectives sum ranks in another
order); the MoE local dispatch within rtol = atol = 2e-4 of the global
one; the restart within rtol 1e-4 / atol 1e-5.
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

import _torch_rank_bodies as _rank_bodies  # noqa: E402
from _torch_ranks import run_ranks  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.core.sharding import flatten as ref_flatten  # noqa: E402
from repro.launch.train import make_train_step as ref_make_train_step  # noqa: E402
from repro.models import registry as ref_models  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.sharding import flatten  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.optim import adamw, sgd  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

# the reference's side: the shard_map step on (2, 2), a plain
# single-device SGD step and the `none` plan on (2, 2, 1), on the weights
# the test process made
REFERENCE = """
import os, pickle, dataclasses, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from repro.config import ShapeConfig, ShardingPlan
from repro.core.sharding import flatten
from repro.launch.mesh import make_mesh
from repro.launch.train import jit_train_step, make_shardmap_train_step
from repro.models import registry as models
from repro.optim import adamw

with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
cfg = inp["cfg"]
params = jax.tree.map(jnp.asarray, inp["params"])
toks = inp["tokens"]
batch = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
         "labels": jnp.asarray(toks[:, 1:], jnp.int32)}
out = {}

step, init_v = make_shardmap_train_step(
    cfg, make_mesh((2, 2), ("data", "model")), lr=0.1, momentum=0.0)
new, _, loss = step(params, init_v(params), batch)
out["shardmap"] = (np.asarray(flatten(new)[0]), float(loss))

(loss1, _), grads = jax.value_and_grad(models.loss_fn, has_aux=True)(
    params, cfg, batch)
sgd = jax.tree.map(lambda p, g: p - 0.1 * g, params, grads)
out["single"] = (np.asarray(flatten(sgd)[0]), float(loss1))

opt = adamw(1e-3, grad_clip_norm=1.0)
state = opt.init(params)
step = jit_train_step(cfg, ShapeConfig("t", seq_len=16, global_batch=8,
                                       kind="train"),
                      make_mesh((2, 2, 1), ("pod", "data", "model")),
                      ShardingPlan(grad_sharding="none"), opt, state,
                      donate=False)
new, state, m = step(params, state, batch)
out["none"] = (np.asarray(flatten(new)[0]), float(m["loss"]),
               float(m["grad_norm"]))
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _ref_cfg(**over):
    return dataclasses.replace(ref_get_arch("tinyllama-1.1b").smoke,
                               n_layers=2, remat=False, **over)


def _ref_params(cfg) -> dict:
    return jax.tree.map(np.asarray,
                        ref_models.init_params(jax.random.PRNGKey(0), cfg))


def _smoke_cfg():
    return _rank_bodies.smoke_lm()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the 4 ranks, run side by side on
    the same seeded weights (the reference's, made here)."""
    tmp = tmp_path_factory.mktemp("train_dist")
    cfg = _ref_cfg(d_model=65, compute_dtype=jnp.float32)
    smoke = ref_get_arch("phi3.5-moe-42b-a6.6b").smoke
    moe_cfg = dataclasses.replace(
        smoke, compute_dtype=jnp.float32, remat=False,
        moe=dataclasses.replace(smoke.moe, capacity_factor=8.0))
    ref = {"params": _ref_params(cfg),
           "tokens": np.random.default_rng(0).integers(0, cfg.vocab,
                                                       (8, 17))}
    (tmp / "inputs.pkl").write_bytes(pickle.dumps({**ref, "cfg": cfg}))
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE),
         str(tmp / "inputs.pkl"), str(tmp / "reference.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        rng = np.random.default_rng(0)
        ranks = run_ranks(
            tmp, "_torch_rank_bodies:trainer", 4, params=ref["params"],
            tokens=ref["tokens"], qsgd_params=_ref_params(_ref_cfg()),
            qsgd_tokens=[rng.integers(0, 64, (8, 17)) for _ in range(10)],
            moe_params=_ref_params(moe_cfg),
            moe_tokens=np.random.default_rng(0).integers(0, 256, (8, 17)),
            ckpt_dir=str(tmp / "ckpt"))
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-6000:]
    ref.update(pickle.loads((tmp / "reference.pkl").read_bytes()))
    ref["ckpt"] = tmp / "ckpt"
    return ref, ranks


def _single_device_step(ref):
    """The port's plain single-device SGD step (lr 0.1) on the whole
    batch."""
    cfg = _smoke_cfg()
    params = convert.params_from_jax(ref["params"])
    toks = torch.from_numpy(np.asarray(ref["tokens"], np.int64))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    new, _, metrics = T.make_train_step(cfg, sgd(0.1))(params, (), batch)
    return flatten(new)[0].numpy(), float(metrics["loss"])


def test_shardmap_step_matches_single_device_and_reference(runs):
    """The shard_map GradsSharding step (ranks = clients, reduce-scatter
    = shard aggregators, fused-SGD on each shard) equals a single-device
    step on the whole batch, and the reference's shard_map step, within
    rtol 2e-4 / atol 2e-5; every rank ends with the same parameters."""
    ref, ranks = runs
    got = ranks[0]["shardmap"]
    single, single_loss = _single_device_step(ref)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["shardmap"]["params"], got["params"])
    np.testing.assert_allclose(got["params"], single, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got["params"], ref["shardmap"][0],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got["params"], ref["single"][0],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got["loss"], single_loss, rtol=1e-5)
    np.testing.assert_allclose(got["loss"], ref["shardmap"][1], rtol=1e-5)


def test_shardmap_velocity_is_the_rank_shard(runs):
    """Velocity is a flat f32 shard of ⌈|θ|/M⌉ (M = 2 on the (2, 2)
    mesh); at momentum 0 it holds this rank's averaged gradient shard,
    and its padded tail is zero."""
    ref, ranks = runs
    total = flatten(convert.params_from_jax(ref["params"]))[0].numel()
    k = -(-total // 2)
    vel = [r["shardmap"]["velocity"] for r in ranks]
    assert all(v.shape == (k,) and v.dtype == np.float32 for v in vel)
    # ranks (data d, model j): d = rank // 2 owns shard d
    np.testing.assert_array_equal(vel[0], vel[1])
    np.testing.assert_array_equal(vel[2], vel[3])
    np.testing.assert_array_equal(vel[2][total - k:], 0.0)


def test_qsgd8_training_still_learns(runs):
    """Compressed-gradient shard_map training (paper §VI composition):
    the loss falls over 10 steps despite int8 quantization of the
    averaged shards."""
    _, ranks = runs
    losses = ranks[0]["qsgd8_losses"]
    assert len(losses) == 10 and all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    assert all(r["qsgd8_losses"] == losses for r in ranks)


@pytest.mark.parametrize("gs", ["zero1", "zero3"])
def test_plans_agree(runs, gs):
    """Sharding plans give the replicated plan's numerics (they only change
    layout + collective order): losses within 1e-5, parameters within
    rtol 5e-4 / atol 1e-4, and the clipping norm is the whole gradient's
    (clipping is active: the norm is above 1)."""
    _, ranks = runs
    base, got = ranks[0]["none"], ranks[0][gs]
    assert base["grad_norm"] > 1.0
    assert abs(got["loss"] - base["loss"]) < 1e-5
    np.testing.assert_allclose(got["grad_norm"], base["grad_norm"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["params"], base["params"],
                               rtol=5e-4, atol=1e-4)
    np.testing.assert_allclose(got["mu"], base["mu"], rtol=5e-4, atol=1e-6)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[gs]["params"], got["params"])


@pytest.mark.parametrize("gs", T.PLANS)
def test_plans_match_reference_none(runs, gs):
    """Every plan of the port against the reference's `none` plan on the
    same (2, 2, 1) mesh (never its `zero3`, which fails on its fake CPU
    mesh): loss within 1e-5, parameters within rtol 5e-4 / atol 1e-4."""
    ref, ranks = runs
    got = ranks[0][gs]
    assert abs(got["loss"] - ref["none"][1]) < 1e-5
    np.testing.assert_allclose(got["grad_norm"], ref["none"][2], rtol=1e-5)
    np.testing.assert_allclose(got["params"], ref["none"][0],
                               rtol=5e-4, atol=1e-4)


def test_plan_layouts(runs):
    """`none` keeps whole trees; `zero1` holds AdamW's moments as this
    rank's flat shard of ⌈|θ|/4⌉; `zero3` the parameters too."""
    ref, ranks = runs
    total = flatten(convert.params_from_jax(ref["params"]))[0].numel()
    k = -(-total // 4)
    assert ranks[0]["none"]["layout"] == ("dict", "dict", ())
    assert ranks[0]["zero1"]["layout"] == ("dict", "Tensor", (k,))
    assert ranks[0]["zero3"]["layout"] == ("Tensor", "Tensor", (k,))


def test_make_train_step_matches_reference():
    """One plain AdamW step (clipped at norm 1.0) of the port's
    `make_train_step` against the reference's, jitted, on its weights: the
    loss and norm within 1e-5, the parameters within the plans' rtol 5e-4
    / atol 1e-4 (AdamW's first step divides each gradient element by its
    own magnitude, so an element near zero magnifies f32 sums taken in
    another order)."""
    rcfg = _ref_cfg(d_model=65, compute_dtype=jnp.float32)
    rparams = ref_models.init_params(jax.random.PRNGKey(1), rcfg)
    toks = np.random.default_rng(2).integers(0, rcfg.vocab, (4, 17))
    rbatch = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
              "labels": jnp.asarray(toks[:, 1:], jnp.int32)}
    ropt = ref_adamw(1e-3, grad_clip_norm=1.0)
    rnew, _, rm = jax.jit(ref_make_train_step(rcfg, ropt))(
        rparams, ropt.init(rparams), rbatch)

    cfg = _smoke_cfg()
    params = convert.params_from_jax(jax.tree.map(np.asarray, rparams))
    t = torch.from_numpy(toks.astype(np.int64))
    opt = adamw(1e-3, grad_clip_norm=1.0)
    new, state, m = T.make_train_step(cfg, opt)(
        params, opt.init(params), {"tokens": t[:, :-1], "labels": t[:, 1:]})
    assert int(state.step) == 1
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]),
                               rtol=1e-5)
    np.testing.assert_allclose(flatten(new)[0].numpy(),
                               np.asarray(ref_flatten(rnew)[0]),
                               rtol=5e-4, atol=1e-4)


def test_moe_local_dispatch_matches_global(runs):
    """The per-rank MoE dispatch on (2, 2) (each rank's rows of the batch
    over `data`, its d_ff block of the experts over `model`, one
    all-reduce; logits joined, gradients averaged over `data` and
    gathered) against the global dispatch on one device: logits within
    rtol = atol = 2e-4, the gradient's sum of absolute values and every
    gradient leaf within the same; every rank sees the same."""
    _, ranks = runs
    for r in ranks:
        loc, glob = r["moe"]["local"], r["moe"]["global"]
        np.testing.assert_allclose(loc["logits"], glob["logits"],
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(loc["grad_abs"], glob["grad_abs"],
                                   rtol=2e-4)
        np.testing.assert_allclose(loc["grads"], glob["grads"],
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(loc["logits"],
                                      ranks[0]["moe"]["local"]["logits"])


def test_train_loop_on_four_ranks_resumes_on_one(runs):
    """`train_loop` under zero1 on 4 ranks gives one rank's loss trace
    (rtol 1e-4, atol 1e-5); its checkpoint (the whole state, written by
    rank 0 alone) resumes on one rank, where the run goes on as an
    uninterrupted one-rank run does."""
    ref, ranks = runs
    ckpt = ref["ckpt"]
    cfg = dataclasses.replace(get_arch("tinyllama-1.1b").smoke,
                              n_layers=2, remat=False)
    kw = dict(batch_size=8, seq_len=16, log_every=0, device="cpu")
    one = T.train_loop(cfg, steps=4, **kw)["losses"]
    for r in ranks:
        np.testing.assert_allclose(r["train_loop"], one[:3], rtol=1e-4,
                                   atol=1e-5)
    assert sorted(p.name for p in ckpt.iterdir()) == [
        "step_0000000002", "step_0000000003"]
    resumed = T.train_loop(cfg, steps=4, ckpt_dir=str(ckpt), **kw)["losses"]
    assert len(resumed) == 1
    np.testing.assert_allclose(resumed, one[3:], rtol=1e-4, atol=1e-5)


def test_trainer_restart_continues(tmp_path):
    """Kill-and-resume: a restarted train_loop continues from the last
    checkpoint and matches an uninterrupted run's loss trace (the
    reference's `tests/test_checkpoint.py` test, on the CPU)."""
    cfg = dataclasses.replace(get_arch("tinyllama-1.1b").smoke,
                              n_layers=2, remat=False)
    kw = dict(batch_size=2, seq_len=16, ckpt_every=3, log_every=0,
              device="cpu")
    full = T.train_loop(cfg, steps=6, ckpt_dir=str(tmp_path / "a"), **kw)
    T.train_loop(cfg, steps=3, ckpt_dir=str(tmp_path / "b"), **kw)
    part2 = T.train_loop(cfg, steps=6, ckpt_dir=str(tmp_path / "b"), **kw)
    assert len(full["losses"]) == 6 and len(part2["losses"]) == 3
    np.testing.assert_allclose(part2["losses"], full["losses"][3:],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_trainer_checkpoint_restores_across_packages(tmp_path, writer):
    """The trainer's `(params, AdamState)` checkpoint has the reference's
    on-disk form (key paths `0/...`, `1/.step`, `1/.mu/...`), so a
    checkpoint either package writes restores in the other, bit for
    bit."""
    from repro.checkpoint import CheckpointManager as RefManager
    from repro_torch.checkpoint import CheckpointManager

    rcfg = _ref_cfg()
    rparams = ref_models.init_params(jax.random.PRNGKey(3), rcfg)
    ropt = ref_adamw(1e-3)
    rstate = ropt.init(rparams)
    rstate = rstate._replace(step=jnp.asarray(7, jnp.int32), mu=jax.tree.map(
        lambda x: x + 0.5, rstate.mu))
    params = convert.params_from_jax(jax.tree.map(np.asarray, rparams))
    state = adamw(1e-3).init(params)
    state = state._replace(step=torch.tensor(7, dtype=torch.int32),
                           mu={k: v + 0.5 for k, v in state.mu.items()})
    if writer == "reference":
        RefManager(str(tmp_path)).save(4, (rparams, rstate))
        step, (p, s), _ = CheckpointManager(str(tmp_path)).restore_latest(
            (params, adamw(1e-3).init(params)))
        got = flatten(p)[0], flatten(s.mu)[0], int(s.step)
    else:
        CheckpointManager(str(tmp_path)).save(4, (params, state))
        step, (p, s), _ = RefManager(str(tmp_path)).restore_latest(
            (rparams, ropt.init(rparams)))
        got = (torch.from_numpy(np.array(ref_flatten(p)[0])),
               torch.from_numpy(np.array(ref_flatten(s.mu)[0])),
               int(s.step))
    assert step == 4 and got[2] == 7
    assert torch.equal(got[0], flatten(params)[0])
    assert torch.equal(got[1], flatten(state.mu)[0])
