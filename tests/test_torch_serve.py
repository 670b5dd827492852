"""The port's serving slice (`repro_torch.launch.serve`, the KV-cache
decode of `repro_torch.models`, the dense configs and the registry's
specs) against the JAX package.

Both packages decode with the same weights (the reference's seeded
initialisation carried over by `convert.params_from_jax`) and the same
seeded numpy tokens, on the smoke configurations of the five dense
architectures. Tolerances (those of `tests/test_torch_models.py`):

* f32 compute: rtol 1e-5, atol 1e-5;
* bf16 compute: max |got - want| <= 2e-2 * max |want| (XLA on the CPU may
  keep bf16 chains in f32 and round once; torch rounds after each op).

The reference's own decode tests (`tests/test_models.py`) run on the port
at their tolerances: 5e-3 for decode against the full forward, 2e-5 for
grouped against expanded decode.
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
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import registry as ref_models  # noqa: E402
from repro_torch import config, convert, knobs  # noqa: E402
from repro_torch.configs import ASSIGNED, REGISTRY, arch_ids, get_arch  # noqa: E402
from repro_torch.launch import hostenv, serve  # noqa: E402
from repro_torch.models import registry as models  # noqa: E402

DENSE = sorted(s.arch_id for s in ref_ASSIGNED if s.model.family == "dense") \
    + ["gpt2-large"]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
STEPS = {"h2o-danube-1.8b": 14}     # past the smoke window of 8: the ring wraps


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, compute, rtol=1e-5, atol=1e-5):
    got = got.detach().to(torch.float32).numpy()
    if compute == "f32":
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    else:
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= 2e-2 * scale


def _tokens(vocab, b, s, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return toks[:, :-1]


# ---------------------------------------------------------------------------
# Teacher-forced decode against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[(a, c) for a in DENSE
                                        for c in sorted(DTYPES)],
                ids=lambda p: f"{p[0]}-{p[1]}")
def both_decodes(request):
    """Every step's logits, K/V cache and idx of both packages, on the
    reference's weights: f32 cache at f32 compute, the serving default
    (bf16) at bf16 compute."""
    arch, compute = request.param
    jdt, tdt = DTYPES[compute]
    ref_cfg = dataclasses.replace(ref_get_arch(arch).smoke, compute_dtype=jdt)
    cfg = convert.model_config_from_jax(ref_cfg)
    steps = STEPS.get(arch, 12)
    toks = _tokens(cfg.vocab, 2, steps, seed=3)
    ref_params = ref_models.init_params(jax.random.PRNGKey(1), ref_cfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, ref_params))
    step = jax.jit(lambda p, t, c: ref_models.decode_step(p, ref_cfg, t, c))
    ref_cache = ref_models.init_cache(ref_cfg, 2, steps, dtype=jdt)
    cache = models.init_cache(cfg, 2, steps, dtype=tdt)
    out = []
    for i in range(steps):
        want, ref_cache = step(ref_params, jnp.asarray(toks[:, i:i + 1],
                                                        jnp.int32), ref_cache)
        got, cache = models.decode_step(
            params, cfg, torch.from_numpy(toks[:, i:i + 1]), cache)
        out.append({"logits": (got.clone(), _np(want)),
                    "k": (cache["k"].clone(), _np(ref_cache["k"])),
                    "v": (cache["v"].clone(), _np(ref_cache["v"])),
                    "idx": (int(cache["idx"]), int(ref_cache["idx"]))})
    return {"arch": arch, "compute": compute, "cfg": cfg, "steps": out,
            "cache": cache}


def test_decode_logits_match_reference_every_step(both_decodes):
    d = both_decodes
    for got, want in (s["logits"] for s in d["steps"]):
        assert got.shape == want.shape == (2, 1, d["cfg"].vocab)
        assert got.dtype == d["cfg"].compute_dtype
        _close(got, want, d["compute"])


def test_decode_kv_cache_matches_reference_every_step(both_decodes):
    d = both_decodes
    cfg = d["cfg"]
    window = cfg.sliding_window or len(d["steps"])
    assert d["cache"]["k"].shape == (cfg.n_layers, 2, window, cfg.n_kv_heads,
                                     cfg.resolved_head_dim)
    for s in d["steps"]:
        for key in ("k", "v"):
            got, want = s[key]
            assert got.shape == want.shape
            _close(got, want, d["compute"])


def test_decode_idx_matches_reference_every_step(both_decodes):
    d = both_decodes
    assert [s["idx"][0] for s in d["steps"]] == \
        [s["idx"][1] for s in d["steps"]] == list(range(1, len(d["steps"]) + 1))
    assert d["cache"]["idx"].dtype == torch.int32
    assert d["cache"]["idx"].shape == ()


# ---------------------------------------------------------------------------
# The reference's decode tests (tests/test_models.py), on the port
# ---------------------------------------------------------------------------

def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype=torch.float32, remat=False)


def _batch(cfg, b=2, s=16, seed=0):
    return {"tokens": torch.from_numpy(_tokens(cfg.vocab, b, s, seed))}


@pytest.mark.parametrize("arch_id", DENSE)
def test_decode_parity_with_forward(arch_id):
    """Cache decode over a teacher-forced prefix reproduces the
    full-sequence forward logits position by position."""
    cfg = _f32(get_arch(arch_id).smoke)
    t = 12
    params = models.init_params(torch.Generator().manual_seed(1), cfg)
    batch = _batch(cfg, b=2, s=t, seed=3)
    full_logits = models.forward(params, cfg, batch).numpy()
    cache = models.init_cache(cfg, 2, t, dtype=torch.float32)
    step_logits = []
    for i in range(t):
        lg, cache = models.decode_step(params, cfg,
                                       batch["tokens"][:, i:i + 1], cache)
        step_logits.append(lg.numpy()[:, 0])
    stepped = np.stack(step_logits, axis=1)
    np.testing.assert_allclose(stepped, full_logits, rtol=5e-3, atol=5e-3)


def test_swa_ring_buffer_matches_windowed_forward():
    """Decode past the window: ring-buffer cache == full forward with the
    SWA mask (window smaller than the sequence)."""
    cfg = _f32(get_arch("h2o-danube-1.8b").smoke)   # window=8
    assert cfg.sliding_window == 8
    t = 14                                          # > window
    params = models.init_params(torch.Generator().manual_seed(2), cfg)
    batch = _batch(cfg, b=1, s=t, seed=5)
    full_logits = models.forward(params, cfg, batch).numpy()
    cache = models.init_cache(cfg, 1, t, dtype=torch.float32)
    assert cache["k"].shape[2] == cfg.sliding_window  # ring buffer is W-sized
    outs = []
    for i in range(t):
        lg, cache = models.decode_step(params, cfg,
                                       batch["tokens"][:, i:i + 1], cache)
        outs.append(lg.numpy()[:, 0])
    np.testing.assert_allclose(np.stack(outs, 1), full_logits,
                               rtol=5e-3, atol=5e-3)


def test_grouped_decode_matches_expand_decode():
    """Grouped-query decode attention == expand-KV decode."""
    cfg = _f32(get_arch("qwen3-32b").smoke)
    cfg_g = dataclasses.replace(cfg, decode_grouped_attn=True)
    assert cfg.n_kv_heads < cfg.n_heads
    params = models.init_params(torch.Generator().manual_seed(1), cfg)
    batch = _batch(cfg, b=2, s=10, seed=3)
    c1 = models.init_cache(cfg, 2, 10, dtype=torch.float32)
    c2 = models.init_cache(cfg_g, 2, 10, dtype=torch.float32)
    for i in range(10):
        tok = batch["tokens"][:, i:i + 1]
        l1, c1 = models.decode_step(params, cfg, tok, c1)
        l2, c2 = models.decode_step(params, cfg_g, tok, c2)
        np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=2e-5,
                                   atol=2e-5)


# ---------------------------------------------------------------------------
# The whole serve loop against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-32b"])
def test_serve_loop_generates_the_reference_tokens(arch):
    ref_cfg = dataclasses.replace(ref_get_arch(arch).smoke,
                                  compute_dtype=jnp.float32)
    want = ref_serve.serve_loop(ref_cfg, seed=0)
    params = convert.params_from_jax(jax.tree.map(
        np.asarray, ref_models.init_params(jax.random.PRNGKey(0), ref_cfg)))
    got = serve.serve_loop(convert.model_config_from_jax(ref_cfg), seed=0,
                           device="cpu", params=params)
    assert got["generated"].shape == want["generated"].shape == (4, 16)
    assert got["generated"].dtype == np.int32
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert got["wall_s"] > 0
    assert got["tokens_per_s"] == pytest.approx(4 * 23 / got["wall_s"])


FAMILIES = ["phi3.5-moe-42b-a6.6b", "dbrx-132b", "falcon-mamba-7b",
            "chameleon-34b", "zamba2-2.7b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_loop_generates_the_reference_tokens_every_family(arch):
    """MoE, SSM, VLM and hybrid: the port's serve loop on the reference's
    weights greedy-decodes the reference loop's tokens (f32)."""
    ref_cfg = dataclasses.replace(ref_get_arch(arch).smoke,
                                  compute_dtype=jnp.float32)
    kw = dict(batch=2, prompt_len=4, max_new_tokens=6, max_len=16, seed=0)
    want = ref_serve.serve_loop(ref_cfg, **kw)
    params = convert.params_from_jax(jax.tree.map(
        np.asarray, ref_models.init_params(jax.random.PRNGKey(0), ref_cfg)))
    got = serve.serve_loop(convert.model_config_from_jax(ref_cfg),
                           device="cpu", params=params, **kw)
    assert got["generated"].shape == (2, 6)
    np.testing.assert_array_equal(got["generated"], want["generated"])


def test_serve_loop_encoder_decoder_runs_the_encoder_once():
    """whisper: the cache's cross-attention K/V come from seeded frames
    through the encoder, and the loop's tokens are a greedy decode of the
    reference's decode step against the same frames and weights (f32)."""
    from repro.models import encdec as ref_encdec
    ref_cfg = dataclasses.replace(ref_get_arch("whisper-tiny").smoke,
                                  compute_dtype=jnp.float32)
    cfg = convert.model_config_from_jax(ref_cfg)
    ref_params = ref_models.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, ref_params))
    b, prompt_len, new, max_len = 2, 3, 5, 12
    got = serve.serve_loop(cfg, batch=b, prompt_len=prompt_len,
                           max_new_tokens=new, max_len=max_len, seed=7,
                           device="cpu", params=params)
    frames = torch.randn((b, cfg.encoder_seq, cfg.frontend_dim),
                         generator=torch.Generator().manual_seed(8))
    cache = ref_encdec.init_cache(ref_cfg, b, max_len, params=ref_params,
                                  frames=jnp.asarray(frames.numpy()))
    assert bool(jnp.any(cache["xk"] != 0))
    prompt = np.random.default_rng(7).integers(0, cfg.vocab,
                                               (b, prompt_len))
    tok, out = jnp.asarray(prompt[:, :1], jnp.int32), []
    for t in range(prompt_len + new - 1):
        logits, cache = ref_models.decode_step(ref_params, ref_cfg, tok,
                                               cache)
        if t + 1 < prompt_len:
            tok = jnp.asarray(prompt[:, t + 1:t + 2], jnp.int32)
        else:
            tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(
                jnp.int32)
            out.append(np.asarray(tok))
    np.testing.assert_array_equal(got["generated"], np.concatenate(out, 1))


def test_serve_loop_draws_its_own_weights_and_samples_from_a_generator():
    cfg = get_arch("tinyllama-1.1b").smoke
    kw = dict(batch=2, prompt_len=3, max_new_tokens=4, max_len=8,
              device="cpu")
    a = serve.serve_loop(cfg, seed=5, **kw)
    b = serve.serve_loop(cfg, seed=5, **kw)
    np.testing.assert_array_equal(a["generated"], b["generated"])
    s1 = serve.serve_loop(cfg, seed=5, greedy=False, **kw)
    s2 = serve.serve_loop(cfg, seed=5, greedy=False, **kw)
    np.testing.assert_array_equal(s1["generated"], s2["generated"])
    assert s1["generated"].shape == (2, 4)
    assert ((0 <= s1["generated"]) & (s1["generated"] < cfg.vocab)).all()


def test_serve_loop_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve_loop(get_arch("tinyllama-1.1b").smoke)


def test_cast_for_serving_keeps_norms_and_bits():
    cfg = get_arch("qwen3-32b").smoke
    params = models.init_params(torch.Generator().manual_seed(0), cfg)
    cast = serve.cast_for_serving(params, cfg)
    assert sorted(cast) == sorted(params)
    for name, t in cast.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("ln1", "ln2", "final_norm", "qnorm", "knorm"):
            assert t is params[name]
        else:
            assert t.dtype == torch.bfloat16
            assert torch.equal(t, params[name].to(torch.bfloat16))
    assert {n.rsplit(".", 1)[-1] for n in params} \
        >= {"ln1", "ln2", "final_norm", "qnorm", "knorm"}
    toks = torch.from_numpy(_tokens(cfg.vocab, 2, 1, seed=0))
    a, _ = models.decode_step(params, cfg, toks,
                              models.init_cache(cfg, 2, 4))
    b, _ = models.decode_step(cast, cfg, toks, models.init_cache(cfg, 2, 4))
    assert torch.equal(a, b)


#: the type in which the reference's ops read each leaf: the norms' γ in
#: f32 (its rmsnorm casts γ to f32), the MoE router in f32 (an f32
#: einsum), the SSM's dt_bias, a_log and d_skip in f32 (added to, or
#: exponentiated in, f32); every other weight in the compute type (each op
#: casts it first)
F32_READS = {"ln", "ln1", "ln2", "lnx", "final_norm", "enc_norm", "qnorm",
             "knorm", "norm_g", "router", "dt_bias", "a_log", "d_skip"}


@pytest.mark.parametrize("arch", [s.arch_id for s in ref_ASSIGNED])
def test_serving_weights_have_the_types_the_reference_reads(arch):
    """bf16 serving: every leaf of ``cast_for_serving`` in the type the
    reference's op reads it in, and a decode step on the cast weights
    equal bit for bit to one on the f32 weights, with every norm and f32
    leaf perturbed so that a bf16 rounding of any of them would show."""
    cfg = get_arch(arch).smoke
    gen = torch.Generator().manual_seed(4)
    params = {k: v + 0.01 * torch.randn(v.shape, generator=gen)
              for k, v in models.init_params(gen, cfg).items()}
    cast = serve.cast_for_serving(params, cfg)
    leaves = {name.rsplit(".", 1)[-1] for name in params}
    for name, t in cast.items():
        want = torch.float32 if name.rsplit(".", 1)[-1] in F32_READS \
            else torch.bfloat16
        assert t.dtype == want, name
    if cfg.moe is not None:
        assert "router" in leaves
    if cfg.ssm is not None:
        assert {"dt_bias", "a_log", "d_skip"} <= leaves
        assert ("norm_g" in leaves) == (cfg.ssm.version == 2)
    toks = torch.from_numpy(_tokens(cfg.vocab, 2, 1, seed=0))
    outs = []
    for p in (params, cast):
        if models.is_encdec(cfg):
            from repro_torch.models import encdec
            frames = torch.randn((2, cfg.encoder_seq, cfg.frontend_dim),
                                 generator=torch.Generator().manual_seed(1))
            cache = encdec.init_cache(cfg, 2, 4, params=p, frames=frames)
        else:
            cache = models.init_cache(cfg, 2, 4)
        outs.append(models.decode_step(p, cfg, toks, cache)[0])
    assert torch.equal(outs[0], outs[1])


def test_make_serve_step_donates_or_copies_the_cache():
    cfg = _f32(get_arch("tinyllama-1.1b").smoke)
    shape = config.ShapeConfig("serve", seq_len=4, global_batch=2,
                               kind="decode")
    params = models.init_params(torch.Generator().manual_seed(0), cfg)
    tok = torch.from_numpy(_tokens(cfg.vocab, 2, 1, seed=1))
    cache = models.init_cache(cfg, 2, 4)
    keep = serve.make_serve_step(cfg, shape, cache_like=cache, donate=False)
    lg_keep, new = keep(params, tok, cache)
    assert int(cache["idx"]) == 0 and not cache["k"].any()
    assert int(new["idx"]) == 1 and new["k"].any()
    donate = serve.make_serve_step(cfg, shape, cache_like=cache)
    lg_donate, same = donate(params, tok, cache)
    assert same is cache and int(cache["idx"]) == 1
    assert torch.equal(cache["k"], new["k"]) and torch.equal(lg_keep,
                                                             lg_donate)
    # a mesh serves every family split over "model"
    # (tests/test_torch_tp.py, tests/test_torch_tp_families.py): the SSM
    # family's sharded step builds at model = 4; a plan needs a mesh
    ssm = _f32(get_arch("falcon-mamba-7b").smoke)
    assert callable(serve.make_serve_step(ssm, shape, mesh=config.MeshConfig(
        (1, 4), ("data", "model")), cache_like=models.cache_specs(
            ssm, 2, 4)))
    with pytest.raises(ValueError, match="needs a mesh"):
        serve.make_serve_step(cfg, shape, plan=config.ShardingPlan())


def test_make_serve_step_copies_a_nested_ssm_cache():
    """donate=False with a Mamba cache (nested dicts): the caller's state
    and conv histories stay as they were; the step's result equals the
    donated step's."""
    for arch in ("falcon-mamba-7b", "zamba2-2.7b"):
        cfg = _f32(get_arch(arch).smoke)
        shape = config.ShapeConfig("serve", seq_len=4, global_batch=2,
                                   kind="decode")
        params = models.init_params(torch.Generator().manual_seed(0), cfg)
        tok = torch.from_numpy(_tokens(cfg.vocab, 2, 1, seed=1))
        cache = models.init_cache(cfg, 2, 4, dtype=torch.float32)
        donate = serve.make_serve_step(cfg, shape, cache_like=cache)
        donate(params, tok, cache)              # a state that is not zero
        before = {k: v.clone() for k, v in cache["mamba"].items()}
        keep = serve.make_serve_step(cfg, shape, cache_like=cache,
                                     donate=False)
        lg_keep, new = keep(params, tok, cache)
        assert int(cache["idx"]) == 1 and int(new["idx"]) == 2
        for k, v in cache["mamba"].items():
            assert torch.equal(v, before[k]), (arch, k)
            assert new["mamba"][k] is not v
        assert not torch.equal(new["mamba"]["h"], before["h"])
        lg_donate, same = donate(params, tok, cache)
        assert same is cache and torch.equal(lg_keep, lg_donate)
        for k, v in cache["mamba"].items():
            assert torch.equal(v, new["mamba"][k]), (arch, k)


def test_serve_main_serves_the_smoke_config_on_the_cpu(capsys):
    out = serve.main(["--device", "cpu", "--new_tokens", "3", "--batch", "2"])
    assert out["generated"].shape == (2, 3)
    assert "[serve] tinyllama-1.1b:" in capsys.readouterr().out


def test_host_env_helpers(monkeypatch):
    t0 = hostenv.host_timer()
    assert hostenv.host_timer() >= t0
    assert knobs.ENV_TCMALLOC == "REPRO_TCMALLOC"
    assert knobs.ENV_TCMALLOC not in knobs.ALL_KNOBS
    monkeypatch.setenv(knobs.ENV_TCMALLOC, "off")
    assert knobs.env_tcmalloc() == "off"
    assert hostenv.maybe_preload_tcmalloc() is False
    monkeypatch.setenv(knobs.ENV_TCMALLOC, "")
    monkeypatch.setattr(hostenv, "find_tcmalloc", lambda: None)
    assert hostenv.maybe_preload_tcmalloc() is False
    monkeypatch.undo()
    found = hostenv.find_tcmalloc()
    assert found is None or found in hostenv._TCMALLOC_PATHS


# ---------------------------------------------------------------------------
# Registry, specs and configs
# ---------------------------------------------------------------------------

def _sds(tree):
    return {".".join(str(k.key) for k in path): (tuple(s.shape),
                                                 np.dtype(s.dtype).name)
            for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _meta(tree):
    assert all(t.device.type == "meta" for t in tree.values())
    return {name: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for name, t in tree.items()}


@pytest.mark.parametrize("arch", DENSE)
def test_specs_equal_reference_on_meta(arch):
    ref_spec, spec = ref_get_arch(arch), get_arch(arch)
    for ref_cfg, cfg in ((ref_spec.model, spec.model),
                         (ref_spec.smoke, spec.smoke)):
        assert _meta(models.param_specs(cfg)) == \
            _sds(ref_models.param_specs(ref_cfg))
        for ref_shape, shape in zip(ref_config.LM_SHAPES, config.LM_SHAPES):
            ref_in = ref_models.input_specs(ref_cfg, ref_shape)
            got = models.input_specs(cfg, shape)
            assert sorted(got) == sorted(ref_in)
            if "cache" in got:
                cache = got.pop("cache")
                assert _meta(cache) == _sds(ref_in.pop("cache"))
                assert _meta(models.cache_specs(cfg, shape.global_batch,
                                                shape.seq_len)) == \
                    _sds(ref_models.cache_specs(ref_cfg, shape.global_batch,
                                                shape.seq_len))
            assert _meta(got) == _sds(ref_in)
    f32 = _meta(models.cache_specs(spec.smoke, 2, 40, torch.float32))
    assert f32 == _sds(ref_models.cache_specs(ref_spec.smoke, 2, 40,
                                              jnp.float32))


@pytest.mark.parametrize("arch", DENSE)
def test_flops_and_param_counts_exact_at_full_width(arch):
    ref_cfg, cfg = ref_get_arch(arch).model, get_arch(arch).model
    assert models.param_count(cfg) == ref_models.param_count(ref_cfg) \
        == cfg.param_count()
    assert models.active_param_count(cfg) == \
        ref_models.active_param_count(ref_cfg)
    for ref_shape, shape in zip(ref_config.LM_SHAPES, config.LM_SHAPES):
        got = models.model_flops(cfg, shape)
        assert isinstance(got, float)
        assert got == ref_models.model_flops(ref_cfg, ref_shape)


def test_shape_cells_equal_reference():
    assert config.LM_SHAPES == tuple(
        config.ShapeConfig(**dataclasses.asdict(s))
        for s in ref_config.LM_SHAPES)
    assert [dataclasses.asdict(s) for s in config.SHAPES_BY_NAME.values()] \
        == [dataclasses.asdict(s) for s in ref_config.SHAPES_BY_NAME.values()]
    assert [s.is_decode for s in config.LM_SHAPES] == \
        [s.is_decode for s in ref_config.LM_SHAPES]
    for arch in DENSE:
        ref_spec, spec = ref_get_arch(arch), get_arch(arch)
        assert [(dataclasses.asdict(s), ok, why) for s, ok, why in
                spec.cells()] == [(dataclasses.asdict(s), ok, why)
                                  for s, ok, why in ref_spec.cells()]
        for s in config.LM_SHAPES:
            assert config.shape_applicable(spec.model, s) == \
                ref_config.shape_applicable(
                    ref_spec.model, ref_config.SHAPES_BY_NAME[s.name])


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "qwen2.5-14b",
                                  "qwen3-32b", "gpt2-large"])
def test_new_configs_equal_reference_field_by_field(arch):
    ref_spec, spec = ref_get_arch(arch), get_arch(arch)
    assert spec.arch_id == ref_spec.arch_id
    assert spec.source == ref_spec.source
    for ref_cfg, cfg in ((ref_spec.model, spec.model),
                         (ref_spec.smoke, spec.smoke)):
        assert cfg == convert.model_config_from_jax(ref_cfg)


def test_registry_is_the_reference_dense_subset():
    """The registry equals the reference's: all ten assigned architectures
    in its order, and GPT-2 Large in ``REGISTRY`` only."""
    assert arch_ids() == [s.arch_id for s in ref_ASSIGNED]
    assert [s.arch_id for s in ASSIGNED] == arch_ids()
    assert arch_ids(assigned_only=False) == sorted(REGISTRY) == \
        sorted(arch_ids() + ["gpt2-large"])
    assert "gpt2-large" not in arch_ids()
    for arch in arch_ids(assigned_only=False):
        ref_spec, spec = ref_get_arch(arch), get_arch(arch)
        assert spec.model == convert.model_config_from_jax(ref_spec.model)
        assert spec.smoke == convert.model_config_from_jax(ref_spec.smoke)
    assert get_arch("h2o-danube-1.8b").smoke.sliding_window == 8
    assert get_arch("qwen2.5-14b").smoke.qkv_bias
    assert get_arch("qwen3-32b").model.head_dim == 128
    assert not get_arch("gpt2-large").model.gated_mlp
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")


def test_non_dense_decode_raises():
    """The hybrid family's cache and decode inputs equal the reference's:
    one K/V ring a group of ``attn_every`` layers and the nested Mamba-2
    state of every layer."""
    for width in ("smoke", "model"):
        ref_cfg = getattr(ref_get_arch("zamba2-2.7b"), width)
        cfg = getattr(get_arch("zamba2-2.7b"), width)
        assert cfg.family == "hybrid"
        got = models.cache_specs(cfg, 2, 64)
        assert sorted(got["mamba"]) == ["conv_b", "conv_c", "conv_x", "h"]
        flat = {"idx": got["idx"], "k": got["k"], "v": got["v"],
                **{f"mamba.{k}": t for k, t in got["mamba"].items()}}
        assert _meta(flat) == _sds(ref_models.cache_specs(ref_cfg, 2, 64))
        assert got["k"].shape[0] == cfg.n_layers // cfg.attn_every
        for ref_shape, shape in zip(ref_config.LM_SHAPES, config.LM_SHAPES):
            ins = models.input_specs(cfg, shape)
            ref_ins = ref_models.input_specs(ref_cfg, ref_shape)
            assert sorted(ins) == sorted(ref_ins)
            if "cache" in ins:
                cache = ins.pop("cache")
                flat = {k: t for k, t in cache.items() if k != "mamba"}
                flat.update({f"mamba.{k}": t
                             for k, t in cache["mamba"].items()})
                assert _meta(flat) == _sds(ref_ins.pop("cache"))
            assert _meta(ins) == _sds(ref_ins)
