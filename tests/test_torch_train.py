"""The port's federated LM training path against the JAX package: the
fused-SGD plain version, the `sgd` optimizer, `flatten`/`unflatten`,
`SyntheticLM`, the FedAvg client primitives, `federated_train_loop` and
one round of `repro_torch.launch.federated_lm` against the reference's
`examples/train_federated_lm.py` logic.

Inputs are seeded numpy arrays (or the reference's seeded weights carried
over by `convert.params_from_jax`) handed to both packages. Tolerances,
each stated where it is used:

* elementwise f32 arithmetic in the same op order (fused-SGD, deltas,
  flatten, the fold of the same flats): bit for bit;
* the reference's Pallas fused-SGD in interpret mode: rtol 1e-5, atol 1e-6
  (the reference's own, `tests/test_kernels.py:166`): XLA contracts
  μ·v + g into one fused multiply-add there;
* training steps of the model at f32 compute: rtol 1e-4, atol 1e-6 (sums
  in another order; see `test_torch_models.py`).
"""
import dataclasses
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as ref_optim  # noqa: E402
from repro.api import FederatedSession as RefSession  # noqa: E402
from repro.api import SessionConfig as RefConfig  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.core import fedavg as ref_fedavg  # noqa: E402
from repro.core import sharding as ref_sharding  # noqa: E402
from repro.data import SyntheticLM as RefSyntheticLM  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_oracle  # noqa: E402
from repro.launch.train import federated_train_loop as ref_loop  # noqa: E402
from repro.models import registry as ref_models  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.core import fedavg  # noqa: E402
from repro_torch.core.sharding import flatten, unflatten  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import fused_sgd as fs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import federated_lm  # noqa: E402
from repro_torch.launch.train import federated_train_loop  # noqa: E402
from repro_torch.models import registry as models  # noqa: E402

ARCH = "tinyllama-1.1b"


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _bits_equal(got: torch.Tensor, want) -> bool:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return np.array_equal(got.detach().to(torch.float32).numpy()
                          .view(np.int32), want.view(np.int32))


# ---------------------------------------------------------------------------
# Fused SGD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length", [4096, 5000])
@pytest.mark.parametrize("p_dtype", ["f32", "bf16"])
def test_fused_sgd_plain_matches_reference(length, p_dtype):
    jdt = jnp.float32 if p_dtype == "f32" else jnp.bfloat16
    p = jnp.asarray(_rand(length, 1), jdt)
    g, v = _rand(length, 2), _rand(length, 3)
    pt = convert.tensor_from_numpy(np.asarray(p), "cpu")
    vt = torch.from_numpy(v.copy())
    got_p, got_v = fs.fused_sgd_plain(pt, torch.from_numpy(g), vt, 0.01, 0.9)
    assert got_p is pt and got_v is vt                 # in place
    assert pt.dtype == (torch.float32 if p_dtype == "f32" else
                        torch.bfloat16)
    want_p, want_v = ref_oracle.fused_sgd_ref(p, jnp.asarray(g),
                                              jnp.asarray(v), lr=0.01,
                                              momentum=0.9)
    assert _bits_equal(pt, want_p) and _bits_equal(vt, want_v)
    # the Pallas kernel in interpret mode (copies: the wrapper donates)
    pal_p, pal_v = ref_ops.sgd_momentum_update(
        jnp.array(p), jnp.asarray(g), jnp.array(v), lr=0.01, momentum=0.9,
        interpret=True)
    np.testing.assert_allclose(pt.to(torch.float32).numpy(),
                               np.asarray(pal_p.astype(jnp.float32)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(vt.numpy(), np.asarray(pal_v), rtol=1e-5,
                               atol=1e-6)


def test_pallas_fused_sgd_differs_only_by_contraction():
    """What the interpret-mode kernel computes, exactly: v' = fma(μ, v, g)
    and p' = fma(−η, v', p), each rounded once (f64 holds the product of
    two f32 exactly)."""
    p, g, v = _rand(5000, 4), _rand(5000, 5), _rand(5000, 6)
    pal_p, pal_v = ref_ops.sgd_momentum_update(
        jnp.array(p), jnp.asarray(g), jnp.array(v), lr=0.01, momentum=0.9,
        interpret=True)
    mu, lr = float(np.float32(0.9)), float(np.float32(0.01))
    v_fma = (mu * v.astype(np.float64) + g).astype(np.float32)
    p_fma = (p.astype(np.float64) - lr * v_fma.astype(np.float64)) \
        .astype(np.float32)
    assert np.array_equal(np.asarray(pal_v), v_fma)
    assert np.array_equal(np.asarray(pal_p), p_fma)


def test_sgd_momentum_update_entry_point_is_in_place():
    p = torch.from_numpy(_rand(777, 7))
    g = torch.from_numpy(_rand(777, 8)).to(torch.bfloat16)
    v = torch.zeros(777)
    want_p, want_v = p.clone(), v.clone()
    fs.fused_sgd_plain(want_p, g, want_v, 0.05, 0.9)
    got_p, got_v = ops.sgd_momentum_update(p, g, v, 0.05, 0.9)
    assert got_p is p and got_v is v
    assert torch.equal(p, want_p) and torch.equal(v, want_v)


def test_fused_sgd_rejects_what_the_kernel_does_not_take():
    p, v = torch.zeros(8), torch.zeros(8)
    with pytest.raises(TypeError):
        fs.fused_sgd(p, p.to(torch.float16), v, 0.1)
    with pytest.raises(TypeError):
        fs.fused_sgd(p, p, v.to(torch.bfloat16), 0.1)
    with pytest.raises(ValueError):
        fs.fused_sgd(p, torch.zeros(9), torch.zeros(9), 0.1)


def test_fused_sgd_multi_step_matches_optimizer():
    """The update iterated = the `sgd` optimizer on a flat vector
    (`tests/test_kernels.py:174`): bit for bit inside the port, and
    against the reference's optimizer at its tolerance."""
    opt = optim.sgd(0.05, momentum=0.9)
    ref_opt = ref_optim.sgd(0.05, momentum=0.9)
    p0 = _rand(2048, 10)
    p_opt = torch.from_numpy(p0.copy())
    v_opt = opt.init(p_opt)
    p_k, v_k = torch.from_numpy(p0.copy()), torch.zeros(2048)
    p_ref, v_ref = jnp.asarray(p0), ref_opt.init(jnp.asarray(p0))
    for step in range(5):
        g = _rand(2048, 100 + step)
        upd, v_opt = opt.update(torch.from_numpy(g), v_opt)
        p_opt = optim.apply_updates(p_opt, upd)
        ops.sgd_momentum_update(p_k, torch.from_numpy(g), v_k, lr=0.05,
                                momentum=0.9)
        ref_upd, v_ref = ref_opt.update(jnp.asarray(g), v_ref)
        p_ref = ref_optim.apply_updates(p_ref, ref_upd)
        assert torch.equal(p_k, p_opt) and torch.equal(v_k, v_opt)
        np.testing.assert_allclose(p_k.numpy(), np.asarray(p_ref),
                                   rtol=1e-5, atol=1e-6)


def test_sgd_and_global_norm_on_dicts_match_reference():
    tree = {"x": _rand(3, 11), "y": _rand((2, 2), 12)}
    grads = {"x": _rand(3, 13), "y": _rand((2, 2), 14)}
    for momentum in (0.0, 0.5):
        opt, ref_opt = optim.sgd(0.1, momentum), ref_optim.sgd(0.1, momentum)
        params = {k: torch.from_numpy(v) for k, v in tree.items()}
        state = opt.init(params)
        ref_params = {k: jnp.asarray(v) for k, v in tree.items()}
        ref_state = ref_opt.init(ref_params)
        for _ in range(2):
            upd, state = opt.update({k: torch.from_numpy(v)
                                     for k, v in grads.items()}, state)
            params = optim.apply_updates(params, upd)
            ref_upd, ref_state = ref_opt.update(
                {k: jnp.asarray(v) for k, v in grads.items()}, ref_state)
            ref_params = ref_optim.apply_updates(ref_params, ref_upd)
        for k in tree:
            np.testing.assert_allclose(params[k].numpy(),
                                       np.asarray(ref_params[k]),
                                       rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        float(optim.global_norm({k: torch.from_numpy(v)
                                 for k, v in tree.items()})),
        float(ref_optim.global_norm(tree)), rtol=1e-6)


# ---------------------------------------------------------------------------
# flatten / unflatten, SyntheticLM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_model():
    """The reference's smoke configuration at f32 compute and its seeded
    weights."""
    cfg = dataclasses.replace(ref_get_arch(ARCH).smoke,
                              compute_dtype=jnp.float32)
    params = jax.jit(ref_models.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg)
    return cfg, params


def test_flatten_matches_reference_order_and_bits(ref_model):
    _, ref_params = ref_model
    params = convert.params_from_jax(jax.tree.map(np.asarray, ref_params))
    flat, spec = flatten(params)
    want, ref_spec = ref_sharding.flatten(ref_params)
    assert flat.dtype == torch.float32 and spec.total == ref_spec.total
    assert _bits_equal(flat, want)
    assert spec.sizes == ref_spec.sizes and spec.shapes == ref_spec.shapes
    assert spec.names[:3] == ("embed", "final_norm", "layers.attn.wk")
    assert spec.names[-1] == "lm_head" and len(spec.names) == 12
    back = unflatten(flat, spec)
    assert list(back) == list(spec.names)
    for name, t in params.items():
        assert torch.equal(back[name], t)
    # the reference's unflatten of the port's vector is the same tree
    ref_back = ref_sharding.unflatten(jnp.asarray(flat.numpy()), ref_spec)
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref_back)[0]:
        name = ".".join(str(k.key) for k in path)
        assert np.array_equal(np.asarray(leaf), params[name].numpy())


def test_flatten_keeps_leaf_types_through_unflatten():
    tree = {"b.z": torch.from_numpy(_rand((2, 3), 20)).to(torch.bfloat16),
            "a": torch.from_numpy(_rand(5, 21)),
            "b.y": torch.from_numpy(_rand(4, 22))}
    flat, spec = flatten(tree)
    assert spec.names == ("a", "b.y", "b.z") and flat.shape == (15,)
    back = unflatten(flat, spec)
    assert back["b.z"].dtype == torch.bfloat16
    for name, t in tree.items():
        assert torch.equal(back[name], t)
    empty, espec = flatten({})
    assert empty.shape == (0,) and espec.total == 0


@pytest.mark.parametrize("client,step", [(0, 0), (3, 5), (1, 17)])
def test_synthetic_lm_batches_equal_reference_bytes(client, step):
    for vocab, conc in ((256, 0.5), (32_000, 0.4)):
        d = SyntheticLM(vocab=vocab, seq_len=32, seed=7,
                        markov_concentration=conc)
        ref = RefSyntheticLM(vocab=vocab, seq_len=32, seed=7,
                             markov_concentration=conc)
        got = d.batch(client, step, 4)
        want = ref.batch(client, step, 4)
        for key in ("tokens", "labels"):
            assert got[key].dtype == torch.int64
            assert np.array_equal(got[key].numpy(),
                                  np.asarray(want[key]).astype(np.int64))
    assert torch.equal(got["tokens"][:, 1:], got["labels"][:, :-1])


# ---------------------------------------------------------------------------
# FedAvg primitives
# ---------------------------------------------------------------------------

def test_streaming_mean_and_merges_match_reference():
    xs = [_rand(1000, 30 + i) for i in range(3)]
    w = [0.5, 2.0, 1.25]
    got = fedavg.streaming_mean([torch.from_numpy(x) for x in xs])
    assert np.array_equal(got.numpy(),
                          (xs[0] + xs[1] + xs[2]) / np.float32(3.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        ref_fedavg.streaming_mean([jnp.asarray(x) for x in xs])),
        rtol=1e-6)
    got_w = fedavg.streaming_mean([torch.from_numpy(x) for x in xs], w)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(
        ref_fedavg.streaming_mean([jnp.asarray(x) for x in xs], w)),
        rtol=1e-6)
    merged = fedavg.weighted_merge([torch.from_numpy(x) for x in xs], w)
    np.testing.assert_allclose(merged.numpy(), np.asarray(
        ref_fedavg.weighted_merge([jnp.asarray(x) for x in xs], w)),
        rtol=1e-6)
    trees = [{"a": torch.from_numpy(x)} for x in xs]
    assert torch.equal(fedavg.fedavg_pytrees(trees)["a"], got)
    with pytest.raises(ValueError):
        fedavg.streaming_mean([])


def test_model_delta_and_apply_delta_match_reference_bits():
    old = {"a": _rand((3, 4), 40), "b": _rand(7, 41)}
    new = {"a": _rand((3, 4), 42), "b": _rand(7, 43)}
    t = lambda tree: {k: torch.from_numpy(v) for k, v in tree.items()}
    j = lambda tree: {k: jnp.asarray(v) for k, v in tree.items()}
    delta = fedavg.model_delta(t(old), t(new))
    want = ref_fedavg.model_delta(j(old), j(new))
    applied = fedavg.apply_delta(t(old), delta)
    want_applied = ref_fedavg.apply_delta(j(old), want)
    for k in old:
        assert _bits_equal(delta[k], want[k])
        assert _bits_equal(applied[k], want_applied[k])


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_local_sgd_update_matches_reference(ref_model, momentum):
    """Two client steps on the smoke model at f32 compute, from the
    reference's weights: parameters, velocity and loss at rtol 1e-4, atol
    1e-6; the step leaves the caller's leaves updated in place."""
    ref_cfg, ref_params = ref_model
    cfg = convert.model_config_from_jax(ref_cfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, ref_params))
    data = SyntheticLM(vocab=256, seq_len=16, seed=0,
                       markov_concentration=0.4)
    ref_data = RefSyntheticLM(vocab=256, seq_len=16, seed=0,
                              markov_concentration=0.4)
    ref_step = jax.jit(lambda p, b, v: ref_fedavg.local_sgd_update(
        lambda p, b: ref_models.loss_fn(p, ref_cfg, b), p, b, lr=0.1,
        momentum=momentum, velocity=v))
    loss_fn = lambda p, b: models.loss_fn(p, cfg, b)
    vel = ref_vel = None
    for step in range(2):
        ref_params, ref_vel, want_loss = ref_step(
            ref_params, ref_data.batch(0, step, 2), ref_vel)
        before = params["embed"]
        params, vel, loss = fedavg.local_sgd_update(
            loss_fn, params, data.batch(0, step, 2), lr=0.1,
            momentum=momentum, velocity=vel)
        assert params["embed"] is before
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    flat_ref = jax.tree_util.tree_flatten_with_path
    for tree, want in ((params, ref_params), (vel, ref_vel)):
        if momentum == 0.0 and tree is vel:
            assert vel is None and ref_vel is None
            continue
        for path, leaf in flat_ref(want)[0]:
            name = ".".join(str(k.key) for k in path)
            np.testing.assert_allclose(tree[name].detach().numpy(),
                                       np.asarray(leaf), rtol=1e-4,
                                       atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# The loop: federated_train_loop, and one round of the federated LM
# ---------------------------------------------------------------------------

def test_federated_train_loop_matches_reference():
    grads = [[_rand(2_048, 100 * r + c) for c in range(5)]
             for r in range(2)]
    kw = dict(rounds=2, n_shards=4, schedule="pipelined")
    seen = []
    got = federated_train_loop(lambda rnd: grads[rnd], device="cpu",
                               on_round=lambda r, res: seen.append(r), **kw)
    want = ref_loop(lambda rnd: grads[rnd], **kw)
    assert seen == [0, 1]
    for a, b in zip(got["results"], want["results"]):
        assert _bits_equal(a.avg_flat, b.avg_flat)
        assert (a.puts, a.gets, a.round_end_s) == (b.puts, b.gets,
                                                   b.round_end_s)
    assert got["session_wall_s"] == want["session_wall_s"]
    assert got["lambda_cost"] == want["lambda_cost"]


def test_entry_points_default_to_the_card(ref_model):
    """Without a device argument the path asks for the card, and a host
    without one refuses instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        federated_train_loop(lambda rnd: [np.zeros(8, np.float32)],
                             rounds=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        federated_lm.run(convert.model_config_from_jax(ref_model[0]),
                         rounds=1)


N, M, STEPS, BATCH, SEQ, LR = 2, 2, 2, 2, 16, 0.1


def _reference_round(ref_cfg, ref_params):
    """The reference example's client loop and update
    (`examples/train_federated_lm.py:102-129`), one round."""
    data = RefSyntheticLM(vocab=256, seq_len=SEQ, seed=0,
                          markov_concentration=0.4)
    loss_fn = lambda p, b: ref_models.loss_fn(p, ref_cfg, b)
    step = jax.jit(lambda p, b, v: ref_fedavg.local_sgd_update(
        loss_fn, p, b, lr=LR, momentum=0.9, velocity=v))
    flats, losses, spec = [], [], None
    for c in range(N):
        local, vel, loss = ref_params, None, 0.0
        for s in range(STEPS):
            local, vel, loss = step(local, data.batch(c, s, BATCH), vel)
        losses.append(float(loss))
        f, spec = ref_sharding.flatten(ref_fedavg.model_delta(ref_params,
                                                              local))
        flats.append(np.asarray(f))
    res = RefSession(RefConfig(n_shards=M, engine="batched")).round(flats)
    new = ref_fedavg.apply_delta(ref_params, ref_sharding.unflatten(
        jnp.asarray(res.avg_flat), spec))
    return losses, flats, res, new


def test_federated_lm_round_matches_reference_example(ref_model):
    ref_cfg, ref_params = ref_model
    cfg = convert.model_config_from_jax(ref_cfg)
    want_losses, want_flats, want_res, want_params = _reference_round(
        ref_cfg, ref_params)
    seen = {}

    def on_round(rnd, res, flats):
        seen["avg"], seen["flats"] = res.avg_flat.clone(), list(flats)

    with redirect_stdout(io.StringIO()) as out:
        got = federated_lm.run(
            cfg, rounds=1, clients=N, shards=M, local_steps=STEPS,
            batch=BATCH, seq=SEQ, lr=LR, engine="batched", device="cpu",
            params=convert.params_from_jax(jax.tree.map(np.asarray,
                                                        ref_params)),
            on_round=on_round)
    assert "round   0  client-loss" in out.getvalue()
    rec = got["rounds"][0]
    np.testing.assert_allclose(rec["client_losses"], want_losses, rtol=1e-5)
    assert rec["mean_loss"] == pytest.approx(np.mean(rec["client_losses"]))
    assert (rec["puts"], rec["gets"]) == (want_res.puts, want_res.gets)
    assert rec["modeled_wall_s"] == want_res.wall_clock_s
    assert len(rec["client_walls_s"]) == N and rec["agg_wall_s"] > 0
    # the clients' deltas and their mean, at the training tolerance ...
    for got_flat, want_flat in zip(seen["flats"], want_flats):
        np.testing.assert_allclose(got_flat.numpy(), want_flat, rtol=1e-4,
                                   atol=1e-6)
    np.testing.assert_allclose(seen["avg"].numpy(), want_res.avg_flat,
                               rtol=1e-4, atol=1e-6)
    # ... and the fold of the port's own deltas, bit for bit
    ref_fold = RefSession(RefConfig(n_shards=M, engine="batched")).round(
        [f.numpy() for f in seen["flats"]])
    assert _bits_equal(seen["avg"], ref_fold.avg_flat)
    for path, leaf in jax.tree_util.tree_flatten_with_path(want_params)[0]:
        name = ".".join(str(k.key) for k in path)
        np.testing.assert_allclose(got["params"][name].numpy(),
                                   np.asarray(leaf), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_federated_lm_main_runs_the_smoke_config_on_cpu():
    with redirect_stdout(io.StringIO()) as out:
        got = federated_lm.main(["--smoke", "--device", "cpu", "--rounds",
                                 "2", "--clients", "2", "--shards", "2",
                                 "--local_steps", "1", "--batch", "2",
                                 "--seq", "8", "--partition", "balanced"])
    text = out.getvalue()
    assert "tinyllama-1.1b-smoke (106,816 params)" in text
    assert "round   1  client-loss" in text
    assert len(got["rounds"]) == 2
    assert all(np.isfinite(r["mean_loss"]) for r in got["rounds"])
    assert got["params"]["layers.attn.wq"].shape == (2, 64, 4, 16)
