"""The port's host spans (``repro_torch.tracing``): a shared no-op while
no torch profiler runs, ``record_function`` while one does, at the layer
boundaries of the aggregation round, the wire codec, the fold and the
local step, read the way the benchmark reads them
(``perfbench.trace.profiled``). The file imports no JAX, so its card test
runs on a machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_tracing.py
"""
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import trace  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.api import FederatedSession, SessionConfig  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import fedavg, sharding  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM  # noqa: E402
from repro_torch.models import registry  # noqa: E402

# the session's input conversion, then run_round's phases
ROUND_SPANS = ["agg.plan", "agg.plan", "codec.encode", "agg.upload",
               "agg.invoke", "agg.fold", "agg.readback", "codec.error",
               "agg.compact"]
ROUNDS = [("gradssharding", "qsgd8"), ("lambda_fl", "identity")]


def _grads(device="cpu", n=6, length=9_001):
    g = torch.Generator(device=device).manual_seed(5)
    return [torch.randn(length, generator=g, device=device) * 0.01
            for _ in range(n)]


def _session(topology, codec, device="cpu"):
    return FederatedSession(SessionConfig(
        topology=topology, n_shards=4, engine="batched", codec=codec,
        keep_records=False, device=device))


def _traced(fn, device="cpu"):
    with trace.profiled(True, device) as tr:
        out = fn()
    return out, tr


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _tiny_step_inputs():
    cfg = get_arch("tinyllama-1.1b").smoke
    params = registry.init_params(torch.Generator().manual_seed(0), cfg)
    batch = SyntheticLM(vocab=cfg.vocab, seq_len=16, seed=0).batch(0, 0, 2)
    return cfg, params, batch


def test_span_is_the_shared_noop_without_a_profiler(monkeypatch):
    def boom(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("agg.plan") is tracing.NO_SPAN
    with tracing.span("agg.plan") as inside:
        assert inside is None
    # every span of a round and of a local step goes through the helper
    _session("gradssharding", "qsgd8").round(_grads())
    cfg, params, batch = _tiny_step_inputs()
    fedavg.local_sgd_update(lambda p, b: registry.loss_fn(p, cfg, b),
                            params, batch, lr=0.1, momentum=0.9)


def test_span_records_while_a_profiler_runs():
    """The profiler's own flag is the switch (torch 2.x)."""
    seen = {}

    def body():
        seen["enabled"] = torch.autograd._profiler_enabled()
        seen["span"] = tracing.span("agg.plan")
        with seen["span"]:
            pass

    _, tr = _traced(body)
    assert seen["enabled"] is True
    assert isinstance(seen["span"], torch.profiler.record_function)
    assert [s[0] for s in tr["spans"]] == ["agg.plan"]
    assert not torch.autograd._profiler_enabled()


@pytest.mark.parametrize("topology,codec", ROUNDS)
def test_round_spans_in_order(topology, codec):
    session = _session(topology, codec)
    grads = _grads()
    session.round(grads)
    _, tr = _traced(lambda: session.round(grads))
    spans = tr["spans"]
    assert [s[0] for s in spans] == ROUND_SPANS
    by = {s[0]: s for s in spans}           # the last agg.plan: run_round's
    assert _inside(by["codec.encode"], by["agg.plan"])
    top = [s for s in spans if s[0] != "codec.encode"]
    for a, b in zip(top, top[1:]):
        assert a[2] <= b[1], (a[0], b[0])      # siblings, one after another


@pytest.mark.parametrize("topology,codec", ROUNDS)
def test_avg_flat_is_the_same_bits_traced_or_not(topology, codec):
    grads = _grads()
    plain = _session(topology, codec).round(grads)
    traced, tr = _traced(lambda: _session(topology, codec).round(grads))
    assert tr["spans"]
    assert torch.equal(plain.avg_flat.view(torch.int32),
                       traced.avg_flat.view(torch.int32))
    assert plain.codec_error == traced.codec_error


def test_untracked_codec_error_still_reads_nan():
    session = FederatedSession(SessionConfig(
        topology="gradssharding", n_shards=4, codec="qsgd8",
        track_codec_error=False, device="cpu"))
    res, tr = _traced(lambda: session.round(_grads()))
    assert res.codec_error != res.codec_error
    assert "codec.error" in [s[0] for s in tr["spans"]]


def test_local_step_spans_in_order():
    cfg, params, batch = _tiny_step_inputs()
    loss_fn = lambda p, b: registry.loss_fn(p, cfg, b)
    _, tr = _traced(lambda: fedavg.local_sgd_update(
        loss_fn, params, batch, lr=0.1, momentum=0.9))
    spans = tr["spans"]
    assert [s[0] for s in spans] == ["step.forward", "step.backward",
                                     "step.optimizer"]
    for a, b in zip(spans, spans[1:]):
        assert a[2] <= b[1]


def test_client_and_apply_spans():
    """A client's delta and its flat vector, then the mean's way back."""
    cfg, params, batch = _tiny_step_inputs()
    local = {k: v.detach().clone() for k, v in params.items()}
    fedavg.local_sgd_update(lambda p, b: registry.loss_fn(p, cfg, b),
                            local, batch, lr=0.1)

    def client_then_apply():
        flat, spec = sharding.flatten(fedavg.model_delta(params, local))
        return fedavg.apply_delta(params, sharding.unflatten(flat, spec))

    new, tr = _traced(client_then_apply)
    assert [s[0] for s in tr["spans"]] == ["client.delta", "flat.flatten",
                                           "flat.unflatten", "apply.delta"]
    for k in params:
        assert torch.allclose(new[k], local[k], rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_fold_and_decode_spans_on_card():
    """On the card the fold runs in waves: each wave's decodes
    (``codec.decode``, the dequantize launches under qsgd8) and its fold
    launch (``fold.launch``) sit inside ``agg.fold``, and the fold kernel
    runs on the device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    session = _session("gradssharding", "qsgd8", "cuda")
    grads = _grads("cuda", length=1_000_003)
    session.round(grads)
    torch.cuda.synchronize()
    _, tr = _traced(lambda: session.round(grads), "cuda")
    names = [s[0] for s in tr["spans"]]
    assert names.count("fold.launch") == names.count("codec.decode") == 1
    by = {s[0]: s for s in tr["spans"]}
    assert by["codec.decode"][2] <= by["fold.launch"][1]
    for name in ("codec.decode", "fold.launch"):
        assert _inside(by[name], by["agg.fold"])
    assert trace.device_us(tr["kernels"], r"fedavg_fold_kernel") > 0
    assert trace.device_us(tr["kernels"], r"dequantize_kernel") > 0
