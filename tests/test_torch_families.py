"""The port's model families (`repro_torch.models`: dense, MoE, VLM, SSM,
hybrid and encoder-decoder) against the JAX package, on the reference's
smoke configurations of all ten assigned architectures.

Both packages compute with the same weights (the reference's seeded
initialisation carried over by `convert.params_from_jax`) and the same
seeded numpy tokens and frames, at f32 compute. Tolerances:

* forward logits, loss and decode logits against the reference: rtol =
  atol = 1e-4, every family. The SSM families are no looser here: the
  port's Mamba-1 recurrence runs the reference's associative scan in the
  reference's order (a chunk's states equal bit for bit,
  `tests/test_torch_ssm_scan.py`), and what is left to rounding is the
  `exp`, the einsums and Mamba-2's SSD sums, which run in another einsum
  order; at the smoke widths (a chunk of 16 steps, d_state 8) the logits
  differ by under 1e-6, as the dense family's do;
* every gradient leaf: max |got - want| <= 1e-4 * max |want|;
* decode against the port's own forward: rtol = atol = 5e-3, the
  reference's (`tests/test_models.py:102`), with the MoE at
  capacity_factor 8.0 as there (a full forward and one-token decode see
  different token counts, so capacity drops would rightly differ);
* the perf flags against the plain forward: 2e-4, the reference's
  (`tests/test_models.py:192`);
* counts, shapes, specs and FLOPs: exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as ref_config  # noqa: E402
from repro.configs import ASSIGNED as ref_ASSIGNED  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import encdec as ref_encdec  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import registry as ref_models  # noqa: E402
from repro_torch import config, convert  # noqa: E402
from repro_torch.configs import arch_ids, get_arch  # noqa: E402
from repro_torch.models import encdec, moe  # noqa: E402
from repro_torch.models import registry as models  # noqa: E402

ARCHS = [s.arch_id for s in ref_ASSIGNED]
MOE_ARCHS = [a for a in ARCHS if ref_get_arch(a).model.moe is not None]
TOL = 1e-4


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ref_cfg(arch, capacity=None):
    cfg = dataclasses.replace(ref_get_arch(arch).smoke,
                              compute_dtype=jnp.float32, remat=False)
    if capacity is not None and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=capacity))
    return cfg


def _batch(cfg, b=2, s=16, seed=0):
    """The same seeded tokens (and frames) for both packages."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1))
    jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
          "labels": jnp.asarray(toks[:, 1:], jnp.int32)}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]),
          "labels": torch.from_numpy(toks[:, 1:])}
    if cfg.is_encdec:
        fd = cfg.frontend_dim or cfg.d_model
        frames = rng.standard_normal((b, cfg.encoder_seq, fd)
                                     ).astype(np.float32)
        jb["frames"] = jnp.asarray(frames)
        tb["frames"] = torch.from_numpy(frames)
    return jb, tb


def _flat_tree(tree, prefix=""):
    """A nested dict as {dotted name: leaf}."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _spec(leaf):
    """(shape, dtype name) of a ShapeDtypeStruct, array or tensor."""
    name = str(leaf.dtype).replace("torch.", "")
    return tuple(leaf.shape), name


def _close_to_max(got, want, tol, label):
    got = got.detach().to(torch.float32).numpy()
    assert got.shape == want.shape, label
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol * scale, label


def _init_caches(arch, ref_cfg, cfg, ref_params, params, jb, tb, t):
    if ref_cfg.is_encdec:
        return (ref_encdec.init_cache(ref_cfg, 2, t, params=ref_params,
                                      frames=jb["frames"],
                                      dtype=jnp.float32),
                encdec.init_cache(cfg, 2, t, params=params,
                                  frames=tb["frames"], dtype=torch.float32))
    return (ref_models.init_cache(ref_cfg, 2, t, dtype=jnp.float32),
            models.init_cache(cfg, 2, t, dtype=torch.float32))


@pytest.fixture(scope="module", params=ARCHS)
def both(request):
    """Logits, loss, gradients and 12 decode steps of both packages on the
    reference's weights."""
    arch = request.param
    ref_cfg = _ref_cfg(arch)
    cfg = convert.model_config_from_jax(ref_cfg)
    ref_params = ref_models.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, ref_params))
    jb, tb = _batch(ref_cfg)
    want_logits = jax.jit(lambda p, b: ref_models.forward(p, ref_cfg, b))(
        ref_params, jb)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_models.loss_fn(p, ref_cfg, b)[0]))(ref_params, jb)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    logits = models.forward(leaves, cfg, tb)
    loss, _ = models.loss_fn(leaves, cfg, tb)
    grads = torch.autograd.grad(loss, list(leaves.values()))

    # decode: lossless MoE dispatch, 12 teacher-forced steps
    t = 12
    ref_dcfg = _ref_cfg(arch, capacity=8.0)
    dcfg = convert.model_config_from_jax(ref_dcfg)
    jd, td = _batch(ref_dcfg, s=t, seed=3)
    full = models.forward(params, dcfg, td)
    ref_cache, cache = _init_caches(arch, ref_dcfg, dcfg, ref_params, params,
                                    jd, td, t)
    step = jax.jit(lambda p, tk, c: ref_models.decode_step(p, ref_dcfg, tk,
                                                          c))
    steps = []
    for i in range(t):
        want, ref_cache = step(ref_params, jd["tokens"][:, i:i + 1],
                               ref_cache)
        got, cache = models.decode_step(params, dcfg,
                                        td["tokens"][:, i:i + 1], cache)
        steps.append((got[:, 0].clone(), _np(want)[:, 0]))
    return {"arch": arch, "cfg": cfg, "params": params,
            "logits": logits.detach(), "loss": loss.detach(),
            "grads": dict(zip(leaves, grads)),
            "want_logits": _np(want_logits), "want_loss": float(want_loss),
            "want_grads": {k: _np(v) for k, v in
                           _flat_tree(want_grads).items()},
            "full": full.detach(), "steps": steps,
            "cache": _flat_tree(cache),
            "ref_cache": {k: _np(v) for k, v in
                          _flat_tree(ref_cache).items()}}


def test_forward_logits_match_reference(both):
    assert both["logits"].shape == (2, 16, both["cfg"].vocab)
    assert both["logits"].dtype == torch.float32
    np.testing.assert_allclose(both["logits"].numpy(), both["want_logits"],
                               rtol=TOL, atol=TOL)


def test_loss_matches_reference(both):
    assert np.isfinite(float(both["loss"]))
    np.testing.assert_allclose(float(both["loss"]), both["want_loss"],
                               rtol=TOL, atol=TOL)


def test_every_gradient_leaf_matches_jax_grad(both):
    assert sorted(both["grads"]) == sorted(both["want_grads"])
    for name, g in both["grads"].items():
        assert g.shape == both["params"][name].shape, name
        _close_to_max(g, both["want_grads"][name], TOL, name)


def test_decode_matches_forward(both):
    stepped = torch.stack([got for got, _ in both["steps"]], dim=1)
    np.testing.assert_allclose(stepped.numpy(), both["full"].numpy(),
                               rtol=5e-3, atol=5e-3)


def test_decode_matches_reference_decode(both):
    for i, (got, want) in enumerate(both["steps"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL,
                                   err_msg=f"step {i}")
    # the whole cache after the last step: K/V rings, SSM states, conv
    # histories, cross-attention K/V and idx
    assert sorted(both["cache"]) == sorted(both["ref_cache"])
    for name, t in both["cache"].items():
        np.testing.assert_allclose(t.to(torch.float32).numpy(),
                                   both["ref_cache"][name], rtol=TOL,
                                   atol=TOL, err_msg=name)


# ---------------------------------------------------------------------------
# Shapes, counts, specs and FLOPs (no computation)
# ---------------------------------------------------------------------------

def test_registry_is_the_reference_registry_in_order():
    assert arch_ids() == ARCHS
    for arch in ARCHS:
        ref_spec, spec = ref_get_arch(arch), get_arch(arch)
        assert spec.source == ref_spec.source
        assert spec.model == convert.model_config_from_jax(ref_spec.model)
        assert spec.smoke == convert.model_config_from_jax(ref_spec.smoke)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("width", ["smoke", "model"])
def test_param_specs_match_reference(arch, width):
    ref_cfg = getattr(ref_get_arch(arch), width)
    cfg = getattr(get_arch(arch), width)
    want = {k: _spec(v) for k, v in
            _flat_tree(ref_models.param_specs(ref_cfg)).items()}
    got = {k: _spec(v) for k, v in models.param_specs(cfg).items()}
    assert got == want
    assert models.param_shapes(cfg) == {k: s for k, (s, _) in want.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_counts_specs_and_flops_equal_reference_at_full_width(arch):
    ref_cfg, cfg = ref_get_arch(arch).model, get_arch(arch).model
    assert models.param_count(cfg) == ref_models.param_count(ref_cfg)
    assert models.active_param_count(cfg) == \
        ref_models.active_param_count(ref_cfg)
    for shape in config.LM_SHAPES:
        ref_shape = ref_config.SHAPES_BY_NAME[shape.name]
        want = {k: _spec(v) for k, v in _flat_tree(
            ref_models.input_specs(ref_cfg, ref_shape)).items()}
        got = {k: _spec(v) for k, v in _flat_tree(
            models.input_specs(cfg, shape)).items()}
        assert got == want, shape.name
        assert models.model_flops(cfg, shape) == \
            ref_models.model_flops(ref_cfg, ref_shape), shape.name


@pytest.mark.parametrize("arch", ARCHS)
def test_norms_per_decode_step_counts_the_decode_norms(arch, monkeypatch):
    """The rmsnorm calls of one decode step equal the count worked out from
    the config (on the card, the kernel's launches a step)."""
    from repro_torch.kernels import rmsnorm as rn
    cfg = dataclasses.replace(get_arch(arch).smoke,
                              compute_dtype=torch.float32)
    params = models.init_params(torch.Generator().manual_seed(0), cfg)
    calls = []
    plain = rn.rmsnorm
    monkeypatch.setattr(rn, "rmsnorm",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    cache = models.init_cache(cfg, 2, 4, dtype=torch.float32)
    models.decode_step(params, cfg, torch.zeros(2, 1, dtype=torch.long),
                       cache)
    assert len(calls) == models.norms_per_decode_step(cfg)


# ---------------------------------------------------------------------------
# MoE routing, the SWA ring, the perf flags
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_chooses_the_reference_experts_and_drops_the_same(
        arch, monkeypatch):
    """At capacity_factor 1.25 over 128 tokens, some of them past their
    experts' capacity: the same top-k experts
    (not only the same outputs), the same dropped assignments, and the
    block's output within 1e-5."""
    ref_cfg = _ref_cfg(arch, capacity=1.25)
    cfg = convert.model_config_from_jax(ref_cfg)
    ref_p = ref_moe.moe_init(jax.random.PRNGKey(0), ref_cfg, jnp.float32)
    p = convert.params_from_jax(jax.tree.map(np.asarray, ref_p))
    # tokens around one shared direction crowd the same experts past
    # their capacity
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(cfg.d_model) + 0.5 * rng.standard_normal(
        (2, 64, cfg.d_model))).astype(np.float32)
    seen = {}
    top_k, where = jax.lax.top_k, jnp.where

    def record_top_k(a, k):
        seen["top"] = top_k(a, k)
        return seen["top"]

    def record_where(cond, *args):
        # the first where on a (kT,) bool mask is the reference's `keep`
        if "keep" not in seen and getattr(cond, "dtype", None) == jnp.bool_ \
                and cond.shape == (cfg.moe.top_k * 128,):
            seen["keep"] = np.asarray(cond)
        return where(cond, *args)
    monkeypatch.setattr(jax.lax, "top_k", record_top_k)
    monkeypatch.setattr(jnp, "where", record_where)
    want = ref_moe.moe_block(ref_p, jnp.asarray(x), ref_cfg)
    monkeypatch.undo()
    xt = torch.from_numpy(x)
    top_p, top_e, _, _, keep = moe.route(p, xt, cfg)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(seen["top"][1]))
    np.testing.assert_allclose(top_p.numpy(), np.asarray(
        seen["top"][0] / jnp.sum(seen["top"][0], -1, keepdims=True)),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(keep.numpy(), seen["keep"])
    assert not keep.all(), "no assignment dropped: the check would be empty"
    np.testing.assert_allclose(moe.moe_block(p, xt, cfg).numpy(), _np(want),
                               rtol=1e-5, atol=1e-5)


def test_swa_ring_matches_windowed_forward():
    """h2o-danube's smoke window of 8 over 14 steps: the port's ring-buffer
    decode against the reference's windowed forward (5e-3)."""
    ref_cfg = _ref_cfg("h2o-danube-1.8b")
    cfg = convert.model_config_from_jax(ref_cfg)
    assert cfg.sliding_window == 8
    ref_params = ref_models.init_params(jax.random.PRNGKey(2), ref_cfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, ref_params))
    jb, tb = _batch(ref_cfg, b=1, s=14, seed=5)
    want = _np(ref_models.forward(ref_params, ref_cfg, jb))
    cache = models.init_cache(cfg, 1, 14, dtype=torch.float32)
    assert cache["k"].shape[2] == 8
    outs = []
    for i in range(14):
        lg, cache = models.decode_step(params, cfg, tb["tokens"][:, i:i + 1],
                                       cache)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), want,
                               rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_perf_flags_preserve_forward(arch):
    """attn_chunk with attn_causal_skip (the chunked and 2-D causal paths
    at S = 32, chunk 8), unroll_scans and moe_dispatch="local" with no
    mesh leave the forward as it was (2e-4)."""
    ref_cfg = _ref_cfg(arch)
    cfg = convert.model_config_from_jax(ref_cfg)
    ref_params = ref_models.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, ref_params))
    _, tb = _batch(cfg, b=2, s=32)
    base = models.forward(params, dataclasses.replace(cfg, attn_chunk=0), tb)
    flags = dict(attn_chunk=8, attn_causal_skip=True, unroll_scans=True)
    if cfg.moe is not None:
        flags["moe_dispatch"] = "local"
    opt = models.forward(params, dataclasses.replace(cfg, **flags), tb)
    np.testing.assert_allclose(opt.numpy(), base.numpy(), rtol=2e-4,
                               atol=2e-4)
