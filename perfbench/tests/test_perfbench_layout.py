"""BENCHMARK.json and the files it names: every cell, configuration, mix,
driver and metric found by its name, the names and units in the allowed
characters, and each cell reporting what its metrics move."""
import json
import pathlib
import re
import shutil

import pytest

from perfbench import spec

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _reports(cell, metric):
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert len(BENCH["command"]) <= 32
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    loaded = spec.load_cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert loaded["cell"]["config"] == entry["config"]
    assert loaded["cell"]["traffic"] == entry["traffic"]
    assert loaded["cell"]["chips"] == entry["chips"] in (1, 4)
    assert loaded["cell"]["why"] == entry["why"]
    assert hasattr(spec.driver(loaded["traffic"]["kind"]), "Driver")
    cfg = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert (ROOT / cfg["file"]).resolve() == \
        (spec.BENCH / "configs" / f"{entry['config']}.json").resolve()


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_resolves_by_name(metric):
    assert callable(spec.metric_reader(metric))


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + CELLS \
        + [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]] \
            + [k for c in BENCH["configs"] for k in c["reduced"]]:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    texts = [w["why"] for w in BENCH["workloads"]] \
        + [c["why"] for c in BENCH["configs"]] \
        + [c["source"] for c in BENCH["configs"]] \
        + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_config_files_are_distinct_and_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] \
            == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in BENCH["end_to_end"]
                if m["name"] == "setup_s")["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_what_its_metrics_move(cell):
    e2e = {m["name"] for m in BENCH["end_to_end"] if _reports(cell, m)}
    layer = [m for m in BENCH["per_layer"] if _reports(cell, m)]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e, (cell, m["name"])


def test_layers_named_alike():
    assert all(m["layer"].strip() == m["layer"] for m in BENCH["per_layer"])


def test_at_most_a_quarter_of_the_cells_on_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_a_cell_added_as_a_file_is_found(tmp_path):
    bench = tmp_path / "perfbench"
    shutil.copytree(spec.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (bench / "traffic" / "gs-identity-n12.json").write_text(json.dumps(
        dict(spec.load_cell("vgg16.gs-identity")["traffic"], n_clients=12)))
    (bench / "cells" / "vgg16.gs-identity-n12.json").write_text(json.dumps(
        {"config": "vgg16", "traffic": "gs-identity-n12", "chips": 1,
         "why": "a test cell", "limits": {"mismatched_elements": 0}}))
    loaded = spec.load_cell("vgg16.gs-identity-n12", bench=bench)
    assert loaded["traffic"]["n_clients"] == 12
    assert loaded["config"]["params"] == 134_000_000


def test_gpt2_config_is_the_registered_model_with_its_head_tied():
    """The registered model's widths; the head tied, as published."""
    import dataclasses
    from repro_torch.configs.paper_workloads import GPT2_LARGE_MODEL
    from repro_torch.models import registry
    from perfbench import inputs
    from perfbench.drivers import fedlm_round
    cfg = json.loads((spec.BENCH / "configs" / "gpt2-large.json").read_text())
    ours = fedlm_round.model_config(cfg)
    tied = dataclasses.replace(GPT2_LARGE_MODEL, tie_embeddings=True)
    for field in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab", "gated_mlp", "param_dtype", "compute_dtype",
                  "tie_embeddings", "rope_theta", "norm_eps", "attn_chunk"):
        assert getattr(ours, field) == getattr(tied, field), field
    assert cfg["tie_word_embeddings"] is True and cfg["reduced"] == []
    assert inputs.param_count(cfg) == registry.param_count(tied) \
        == cfg["params"] == 772_211_200
    shapes = registry.param_shapes(tied)
    assert {n: s for n, s, _ in inputs.gpt2_leaves(cfg)} == shapes
    untied = dict(cfg, tie_word_embeddings=False)
    assert {n: s for n, s, _ in inputs.gpt2_leaves(untied)} \
        == registry.param_shapes(GPT2_LARGE_MODEL)


def test_fedlm_mix_is_16_sequences_of_1024_a_local_step():
    """The real mix's round, read through the driver's own ``work`` on a
    stand-in (no model built): 4 clients x 2 local steps of 16 x 1,024
    tokens; both copies of the cell's ``why`` say so."""
    from types import SimpleNamespace
    from perfbench.drivers import fedlm_round
    loaded = spec.load_cell("gpt2-large.fedlm")
    stand_in = SimpleNamespace(config=loaded["config"],
                               mix=loaded["traffic"])
    assert fedlm_round.Driver.work(stand_in)["tokens"] \
        == 4 * 2 * 16 * 1024 == 131_072
    entry = next(w for w in BENCH["workloads"]
                 if w["name"] == "gpt2-large.fedlm")
    for why in (entry["why"], loaded["cell"]["why"]):
        assert "16 x 1,024" in why
