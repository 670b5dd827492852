"""The port's dense LM (`repro_torch.models`, `repro_torch.kernels.rmsnorm`,
`repro_torch.config`) against the JAX package.

Both packages compute with the same weights (the reference's seeded
initialisation carried over by `repro_torch.convert.params_from_jax`) and
the same seeded numpy tokens, on the smoke configuration of
`tinyllama-1.1b` (2 layers, d_model 64, vocab 256). Tolerances, each
stated where it is used:

* rmsnorm, f32: rtol 1e-5, atol 1e-6 (the reference's own,
  `tests/test_kernels.py:144`); the two `rsqrt`s differ by a few ulps.
* rmsnorm, bf16: at most one bf16 ulp (a product a few f32 ulps apart can
  round to the neighbouring bf16 value).
* the model at f32 compute: logits and loss rtol 1e-5, atol 1e-5; every
  gradient leaf rtol 1e-4, atol 1e-6 (sums run in another order).
* the model at bf16 compute: 2e-2 of each tensor's largest magnitude (XLA
  on the CPU may keep bf16 chains in f32 and round once; torch rounds
  after each op).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ASSIGNED as ref_ASSIGNED  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_oracle  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import registry as ref_models  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config import ModelConfig  # noqa: E402
from repro_torch.configs import arch_ids, get_arch  # noqa: E402
from repro_torch.core.sharding import leaf_order  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import registry as models  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402

ARCH = "tinyllama-1.1b"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x):
    return convert.tensor_from_numpy(np.asarray(x), "cpu")


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 ulps between two bf16 tensors."""
    def ordered(t):
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return int((ordered(a) - ordered(b)).abs().max())


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,d", [(8, 128), (33, 256), (128, 1024)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rmsnorm_plain_matches_reference(rows, d, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng([rows, d])
    x = jnp.asarray(rng.standard_normal((rows, d)), jdt)
    g = jnp.asarray(rng.standard_normal(d), jnp.float32)
    got, rstd = rn.rmsnorm_plain(_t(x), _t(g))
    assert got.dtype == tdt and rstd.shape == (rows,)
    for want in (ref_ops.rmsnorm(x, g, interpret=True),
                 ref_oracle.rmsnorm_ref(x, g), ref_layers.rmsnorm(x, g)):
        if dtype == "f32":
            np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5,
                                       atol=1e-6)
        else:
            assert _bf16_ulps(got, _t(want)) <= 1
    # the kernel's entry point on a CPU tensor is the plain version
    assert torch.equal(ops.rmsnorm(_t(x).reshape(rows, 1, d), _t(g))
                       .reshape(rows, d), got)


def test_rmsnorm_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(4, 8)
    with pytest.raises(TypeError):
        rn.rmsnorm(x.to(torch.float16), torch.ones(8))
    with pytest.raises(ValueError):
        rn.rmsnorm(x, torch.ones(7))
    with pytest.raises(ValueError):
        rn.rmsnorm(torch.zeros(4, 0), torch.ones(0))


def test_rmsnorm_gradient_matches_jax_grad():
    """The autograd Function's plain backward against `jax.grad` of the
    reference layer, f32, rtol 1e-5 and atol 1e-6."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    g = rng.standard_normal(64).astype(np.float32)
    w = rng.standard_normal((3, 5, 64)).astype(np.float32)

    def ref_loss(x, g):
        return jnp.sum(ref_layers.rmsnorm(x, g) * w)
    want_dx, want_dg = jax.grad(ref_loss, argnums=(0, 1))(jnp.asarray(x),
                                                         jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    gt = torch.from_numpy(g).requires_grad_(True)
    (layers.rmsnorm(xt, gt) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), _np(want_dx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(gt.grad.numpy(), _np(want_dg), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# The dense transformer against the reference
# ---------------------------------------------------------------------------

def _cfgs(compute):
    ref_cfg = dataclasses.replace(ref_get_arch(ARCH).smoke,
                                  compute_dtype=DTYPES[compute][0])
    return ref_cfg, convert.model_config_from_jax(ref_cfg)


def _batch(vocab, b=2, s=16, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return ({"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
             "labels": jnp.asarray(toks[:, 1:], jnp.int32)},
            {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])})


@pytest.fixture(scope="module", params=sorted(DTYPES))
def both_models(request):
    """Logits, loss and gradients of both packages on the same weights and
    tokens, at f32 or bf16 compute."""
    ref_cfg, cfg = _cfgs(request.param)
    ref_params = ref_models.init_params(jax.random.PRNGKey(0), ref_cfg)
    jb, tb = _batch(ref_cfg.vocab)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: ref_models.loss_fn(p, ref_cfg, b)[0]))
    want_loss, want_grads = grad_fn(ref_params, jb)
    want_logits = jax.jit(lambda p, b: ref_models.forward(p, ref_cfg, b))(
        ref_params, jb)
    params = convert.params_from_jax(jax.tree.map(np.asarray, ref_params))
    for p in params.values():
        p.requires_grad_(True)
    logits = models.forward(params, cfg, tb)
    loss, metrics = models.loss_fn(params, cfg, tb)
    grads = torch.autograd.grad(loss, list(params.values()))
    want_grads = {".".join(str(k.key) for k in path): _np(g) for path, g in
                  jax.tree_util.tree_flatten_with_path(want_grads)[0]}
    return {"compute": request.param, "cfg": cfg, "params": params,
            "logits": logits.detach(), "loss": loss.detach(),
            "metrics": metrics, "grads": dict(zip(params, grads)),
            "want_logits": _np(want_logits), "want_loss": float(want_loss),
            "want_grads": want_grads}


def _close(got, want, compute, rtol, atol):
    got = got.detach().to(torch.float32).numpy()
    if compute == "f32":
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    else:
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= 2e-2 * scale


def test_forward_logits_match_reference(both_models):
    m = both_models
    assert m["logits"].shape == m["want_logits"].shape == (2, 16, 256)
    assert m["logits"].dtype == m["cfg"].compute_dtype
    _close(m["logits"], m["want_logits"], m["compute"], 1e-5, 1e-5)


def test_loss_matches_reference(both_models):
    m = both_models
    assert m["metrics"]["loss"] is not None
    _close(m["loss"], np.float32(m["want_loss"]), m["compute"], 1e-5, 1e-5)


def test_every_gradient_leaf_matches_reference(both_models):
    m = both_models
    assert sorted(m["grads"]) == sorted(m["want_grads"])
    for name, g in m["grads"].items():
        assert g.shape == m["params"][name].shape, name
        _close(g, m["want_grads"][name], m["compute"], 1e-4, 1e-6)


def test_leaf_names_and_order_are_the_reference_tree():
    """Dotted names in `jax.tree.flatten` order, with the stacked layout."""
    ref_cfg, cfg = _cfgs("f32")
    ref_params = ref_models.init_params(jax.random.PRNGKey(0), ref_cfg)
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    params = models.init_params(torch.Generator().manual_seed(0), cfg)
    assert leaf_order(params) == [".".join(str(k.key) for k in path)
                                  for path, _ in ref_leaves]
    assert [tuple(params[n].shape) for n in leaf_order(params)] == \
        [tuple(leaf.shape) for _, leaf in ref_leaves]
    assert len(params) == 12
    assert params["layers.attn.wq"].shape == (2, 64, 4, 16)
    assert all(p.dtype == torch.float32 for p in params.values())
    # the seeded init's scales: embed 0.02, wq 1/sqrt(d_model), norms ones
    assert abs(float(params["embed"].std()) - 0.02) < 2e-3
    assert abs(float(params["layers.attn.wq"].std()) - 64 ** -0.5) < 1e-2
    assert torch.equal(params["layers.ln2"], torch.ones(2, 64))


def test_module_carries_the_tree_names_and_computes_the_same():
    _, cfg = _cfgs("f32")
    params = models.init_params(torch.Generator().manual_seed(1), cfg)
    model = Transformer(cfg, params)
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(params)
    _, tb = _batch(cfg.vocab, seed=1)
    want = models.forward(params, cfg, tb)
    assert torch.equal(model(tb["tokens"]), want)
    loss, _ = model.loss(tb)
    loss.backward()
    assert model.layers.attn.wq.grad.shape == (2, 64, 4, 16)


def test_remat_computes_the_same_loss_and_gradients():
    _, cfg = _cfgs("f32")
    params = models.init_params(torch.Generator().manual_seed(2), cfg)
    _, tb = _batch(cfg.vocab, seed=2)
    out = []
    for remat in (False, True):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        loss, _ = models.loss_fn(p, dataclasses.replace(cfg, remat=remat),
                                 tb)
        out.append((loss.detach(),
                    torch.autograd.grad(loss, list(p.values()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_unported_paths_raise():
    """The paths that raised until the families and long context were
    ported now compute the reference's results: the SSM's parameter count,
    attention longer than its chunk (the chunked path, GQA), and the
    hybrid architecture resolves."""
    _, cfg = _cfgs("f32")
    ssm_ref = ref_get_arch("falcon-mamba-7b")
    assert models.param_count(get_arch("falcon-mamba-7b").model) == \
        ref_models.param_count(ssm_ref.model) == 7_272_665_088
    assert models.param_count(get_arch("falcon-mamba-7b").smoke) == \
        ref_models.param_count(ssm_ref.smoke)
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 8, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 8, 2, 16)).astype(np.float32)
    pos = np.arange(8)
    want = ref_layers.attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(k), q_pos=jnp.asarray(pos),
                                k_pos=jnp.asarray(pos), chunk=4)
    got = layers.attention(_t(q), _t(k), _t(k), q_pos=torch.from_numpy(pos),
                           k_pos=torch.from_numpy(pos), chunk=4)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
    spec = get_arch("zamba2-2.7b")
    assert spec.model == convert.model_config_from_jax(
        ref_get_arch("zamba2-2.7b").model)
    assert spec.model.family == "hybrid" and cfg.family == "dense"


def test_param_count_of_tinyllama():
    cfg = get_arch(ARCH).model
    assert models.param_count(cfg) == cfg.param_count() == 1_100_048_384
    assert models.param_count(cfg) == \
        ref_models.param_count(ref_get_arch(ARCH).model)


def test_model_config_equals_reference_field_by_field():
    assert arch_ids() == [s.arch_id for s in ref_ASSIGNED]
    ref_spec, spec = ref_get_arch(ARCH), get_arch(ARCH)
    ref_fields = [f.name for f in dataclasses.fields(type(ref_spec.model))]
    assert [f.name for f in dataclasses.fields(ModelConfig)] == ref_fields
    for ref_cfg, cfg in ((ref_spec.model, spec.model),
                         (ref_spec.smoke, spec.smoke)):
        assert cfg == convert.model_config_from_jax(ref_cfg)
        for name in ref_fields:
            want = getattr(ref_cfg, name)
            if name.endswith("_dtype"):
                want = getattr(torch, np.dtype(want).name)
            assert getattr(cfg, name) == want, name
    assert spec.model.param_dtype == torch.float32
    assert spec.model.compute_dtype == torch.bfloat16
    assert spec.source == ref_spec.source
