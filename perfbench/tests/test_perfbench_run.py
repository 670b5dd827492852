"""A run end to end on the CPU at tiny sizes, past the harness's look for
a card: the result line's keys, and ``correct`` false under each fault
the cells can have (a round or step that leaves its state unchanged, half
of the batch left out, an answer altered where it is produced). On this
host the command itself exits 1 and prints nothing; on the card (tests
marked ``cuda``) a short run of the first cell is correct."""
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

import pytest
import torch

from perfbench import harness, run, spec
from perfbench.tests.test_perfbench_reference import tiny_gpt2

ROOT = pathlib.Path(__file__).resolve().parents[2]
SEED = 2**34 + 3
AGG = ("vgg16.gs-identity", "vgg16.gs-qsgd8", "vgg16.lambda-fl-identity")


def tiny(cell):
    loaded = spec.load_cell(cell)
    if loaded["traffic"]["kind"] == "agg_round":
        loaded["config"]["params"] = 65_537
    else:
        loaded["config"], loaded["traffic"] = tiny_gpt2()
    return loaded


def run_tiny(cell, traced=False, seconds=0.3):
    rec = harness.run_cell(tiny(cell), SEED, seconds, traced,
                           t_start=time.perf_counter(), device="cpu")
    entries = spec.metrics_of(spec.benchmark(), cell, traced)
    return run.result_line(rec, harness.metrics(rec, entries), 1, "cpu",
                           None)


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", [*AGG, "gpt2-large.fedlm"])
def test_result_line_keys(cell, traced):
    line = run_tiny(cell, traced)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if traced else []) \
        + ["checks"]
    assert line["correct"] is True and line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "setup_s" in line["metrics"] or traced
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"}
    json.dumps(line)


@pytest.mark.parametrize("cell", ["vgg16.gs-identity", "gpt2-large.fedlm"])
def test_a_traced_run_times_the_same_window_before_the_profiler(cell):
    """The host-clock numbers of a traced run come from the window that an
    untraced run times; the profiled rounds come after it, counted apart."""
    loaded = tiny(cell)
    rec = harness.run_cell(loaded, SEED, 0.3, True,
                           t_start=time.perf_counter(), device="cpu")
    assert rec["window_s"] >= 0.3 and rec["rounds"] == len(
        rec["round_walls_s"])
    spans = [s for s in rec["trace"]["spans"] if s[0] == harness.ROUND_SPAN]
    assert rec["trace"]["rounds"] == len(spans) >= 1
    assert rec["trace"]["rounds"] <= loaded["traffic"]["trace_rounds"]


def _unchanged_round(self, grads, rnd=None):
    res = _ROUND(self, grads, rnd=rnd)
    res.avg_flat = grads[0].clone()          # the state handed in, unfolded
    return res


def _half_round(self, grads, rnd=None):
    return _ROUND(self, list(grads)[: len(grads) // 2], rnd=rnd)


def _altered_round(self, grads, rnd=None):
    res = _ROUND(self, grads, rnd=rnd)
    res.avg_flat[len(res.avg_flat) // 3] += 1.0
    return res


from repro_torch.api import FederatedSession  # noqa: E402

_ROUND = FederatedSession.round


@pytest.mark.parametrize("fault", [_unchanged_round, _half_round,
                                   _altered_round],
                         ids=["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", AGG)
def test_aggregation_faults_are_not_correct(cell, fault, monkeypatch):
    monkeypatch.setattr(FederatedSession, "round", fault)
    assert run_tiny(cell)["correct"] is False


def _lm_faults(monkeypatch, fault):
    from repro_torch.core import fedavg
    from repro_torch.models import registry
    if fault == "unchanged":
        step = fedavg.local_sgd_update

        def unchanged(loss_fn, params, batch, lr, momentum=0.0,
                      velocity=None):
            kept = {k: v.detach().clone() for k, v in params.items()}
            _, vel, loss = step(loss_fn, params, batch, lr, momentum,
                                velocity)
            return kept, vel, loss
        monkeypatch.setattr(fedavg, "local_sgd_update", unchanged)
    elif fault == "half":
        loss_fn = registry.loss_fn

        def half(params, cfg, batch):
            rows = batch["tokens"].shape[0] // 2
            return loss_fn(params, cfg, {k: v[:rows]
                                         for k, v in batch.items()})
        monkeypatch.setattr(registry, "loss_fn", half)
    else:
        monkeypatch.setattr(FederatedSession, "round", _altered_round)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_training_faults_are_not_correct(fault, monkeypatch):
    _lm_faults(monkeypatch, fault)
    line = run_tiny("gpt2-large.fedlm")
    assert line["correct"] is False, line["checks"]


def test_the_control_is_not_correct():
    """The reference one precision below the configured one, in the
    program's place: bf16 folds fail the exact check; fp8 products fail at
    least one of the training cell's limits."""
    from perfbench.drivers import fedlm_round
    from perfbench.reference import gpt2
    cfg, mix = tiny_gpt2()
    want = gpt2.follow(cfg, mix, SEED, "cpu", mix["check_rounds"])
    got = gpt2.follow(cfg, mix, SEED, "cpu", mix["check_rounds"],
                      lower=True)
    limits = spec.load_cell("gpt2-large.fedlm")["cell"]["limits"]
    checks = fedlm_round.compare(got["losses"], got["grad_norms"],
                                 got["change_norms"], want, limits)
    assert any(v > lim for v, lim in checks.values()), checks


def test_no_card_exits_1_and_prints_nothing():
    out = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "vgg16.gs-identity", "--seed", str(2**40 + 1), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    assert out.returncode == 1 and out.stdout == ""


def test_benchmark_files_alone_exit_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "vgg16.gs-identity", "--seed", "5", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env=env)
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_first_cell_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "vgg16.gs-identity", "--seed", str(2**35 + 9), "--seconds", "2",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
