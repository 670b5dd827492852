"""Finding a cell and everything it names, by name, from files.

A cell is ``cells/<cell>.json`` (its ``config``, ``traffic``, ``chips``,
``why`` and the limits of its output check); it names a configuration,
``configs/<config>.json``, and a traffic mix, ``traffic/<mix>.json``, whose
``kind`` names the driver, ``drivers/<kind>.py``. A metric is
``metrics/<metric>.py``, a module with ``read(record) -> float | None``.
Which metrics a cell reports is read from ``BENCHMARK.json`` at the root
of the checkout: its ``end_to_end`` metrics with ``--trace 0``, its
``per_layer`` ones with ``--trace 1``, each where the entry lists the cell
under ``workloads`` or lists no cells. A new cell, mix, configuration,
driver or metric is a new file; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench: pathlib.Path = BENCH) -> dict:
    """The cell ``name`` with its configuration and mix resolved:
    ``{"name", "cell", "config", "traffic"}``."""
    cell = _json(bench / "cells" / f"{name}.json")
    return {"name": name, "cell": cell,
            "config": _json(bench / "configs" / f"{cell['config']}.json"),
            "traffic": _json(bench / "traffic" / f"{cell['traffic']}.json")}


def load_module(path: pathlib.Path):
    """A Python file as a module under a private name (metric files carry
    dots in their names, so they are not importable by name)."""
    mod_name = "perfbench_file_" + "_".join(path.relative_to(BENCH.parent)
                                            .with_suffix("").parts)
    mod_name = mod_name.replace(".", "_").replace("-", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str, bench: pathlib.Path = BENCH):
    return load_module(bench / "drivers" / f"{kind}.py")


def metric_reader(name: str, bench: pathlib.Path = BENCH):
    return load_module(bench / "metrics" / f"{name}.py").read


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def metrics_of(bench_json: dict, cell: str, traced: bool) -> list[dict]:
    """The metric entries a run of ``cell`` reports."""
    key = "per_layer" if traced else "end_to_end"
    return [m for m in bench_json[key]
            if "workloads" not in m or cell in m["workloads"]]
