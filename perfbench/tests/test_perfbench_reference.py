"""The plain reference held against the port on the CPU at tiny sizes:
the fold bit for bit, λ-FL's weighted f64 tree, the qsgd8 codec, and
GPT-2 as configured (the smoke widths, the port's departures)."""
import copy
import json
import pathlib

import pytest
import torch

from perfbench import inputs
from perfbench.reference import fold, gpt2

BENCH = pathlib.Path(__file__).resolve().parents[1]
SEED = 2**33 + 17


def _session_mean(xs, topology, codec, m=4):
    from repro_torch.api import FederatedSession, SessionConfig
    s = FederatedSession(SessionConfig(topology=topology, n_shards=m,
                                       engine="batched", codec=codec,
                                       keep_records=False, device="cpu"))
    return s.round(xs).avg_flat


@pytest.mark.parametrize("topology,codec", [("gradssharding", "identity"),
                                            ("gradssharding", "qsgd8"),
                                            ("lambda_fl", "identity")])
@pytest.mark.parametrize("n,length", [(20, 40_961), (7, 12_289)])
def test_round_mean_is_the_sessions_bit_for_bit(topology, codec, n, length):
    g = inputs.client_grads(SEED, n, length, 0.01, "cpu")
    order = inputs.client_order(SEED, 3, n)
    xs = [g[i] for i in order]
    got = _session_mean(xs, topology, codec)
    want = fold.round_mean(xs, topology, codec, 4)
    assert fold.mismatches(got, want) == 0
    assert fold.mismatches(fold.round_mean(xs, topology, codec, 4,
                                           lower=True), want) > 0


def test_qsgd8_roundtrip_is_the_ports_codec():
    from repro_torch.kernels import quantize as q
    x = inputs.client_grads(SEED, 1, 3 * 4096 + 5, 1.0, "cpu")[0]
    x[7] = 0.0
    x[4096:8192] = 0.0                       # a zero tile: scale 1.0
    codes, scales = q.quantize_plain(x)
    want = q.dequantize_plain(codes, scales)
    assert fold.mismatches(fold.qsgd8_roundtrip(x), want) == 0


def test_weighted_f64_mean_is_the_ports_fold():
    from repro_torch.kernels import fedavg_stream as fs
    xs = list(inputs.client_grads(SEED, 4, 999, 1.0, "cpu"))
    w = [5.0, 5.0, 1.0, 3.0]
    want = fs.fedavg_stream_plain(xs, w, acc="f64")
    assert fold.mismatches(fold.mean_weighted_f64(xs, w), want) == 0


def test_uniform_cuts_are_the_ports_plan():
    from repro_torch.core.sharding import plan_uniform
    for length, m in ((134_000_000, 4), (10, 3), (7, 7)):
        plan = plan_uniform(length, m)
        assert fold.uniform_cuts(length, m) == [s[0] for s in plan.segments]


def tiny_gpt2(compute="float32"):
    cfg = json.loads((BENCH / "configs" / "gpt2-large.json").read_text())
    cfg.update(n_layer=2, n_embd=64, n_head=4, vocab_size=512)
    cfg["port"] = dict(cfg["port"], compute_dtype=compute)
    mix = json.loads((BENCH / "traffic" / "fedlm.json").read_text())
    mix.update(batch=2, seq=32, check_rounds=2, ref_block_rows=1)
    return cfg, mix


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_gpt2_loss_and_gradients_are_the_ports_at_f32(tied):
    from repro_torch.models import registry
    from perfbench.drivers.fedlm_round import model_config
    cfg, mix = tiny_gpt2()
    cfg["tie_word_embeddings"] = tied
    params = inputs.gpt2_params(cfg, SEED, "cpu")
    batch = inputs.ZipfTokens(cfg, mix, SEED, "cpu").batch_of(0, 1, 0)
    loss, grads = gpt2.loss_and_grads(copy.deepcopy(params), cfg, mix, batch)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    want, _ = registry.loss_fn(leaves, model_config(cfg), batch)
    want_g = torch.autograd.grad(want, list(leaves.values()))
    assert loss == pytest.approx(float(want.detach()), rel=1e-6)
    for (k, _), g in zip(leaves.items(), want_g):
        assert torch.allclose(grads[k], g, rtol=1e-4, atol=1e-6), k


def test_zipf_batches_differ_and_repeat():
    cfg, mix = tiny_gpt2()
    a = inputs.ZipfTokens(cfg, mix, SEED, "cpu")
    b = inputs.ZipfTokens(cfg, mix, SEED, "cpu")
    assert torch.equal(a.batch_of(1, 2, 1)["tokens"],
                       b.batch_of(1, 2, 1)["tokens"])
    assert not torch.equal(a.batch_of(1, 2, 1)["tokens"],
                           a.batch_of(1, 2, 0)["tokens"])
    t = a.batch_of(0, 0, 0)
    assert torch.equal(t["tokens"][:, 1:], t["labels"][:, :-1])
    assert int(t["tokens"].max()) < cfg["vocab_size"]
