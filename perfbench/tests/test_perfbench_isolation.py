"""Nothing the benchmark runs imports JAX or the JAX package, and its
reference imports nothing of the program."""
import ast
import pathlib
import subprocess
import sys

import pytest

from perfbench import run

BENCH = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_reference_package(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "repro",
                                  "benchmarks")]
    assert bad == []


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] == "repro_torch"
           or m.startswith(("perfbench.drivers", "perfbench.harness"))]
    assert bad == []


def test_forbidden_names_are_compared_whole():
    mods = {"jax": 1, "jax.numpy": 1, "jaxlib": 1, "flax.linen": 1,
            "repro": 1, "repro.core": 1, "repro_torch": 1,
            "repro_torch.api": 1, "reproduce": 1, "jaxtyping": 1}
    assert run.forbidden_modules(mods) == ["flax.linen", "jax", "jax.numpy",
                                           "jaxlib", "repro", "repro.core"]


def test_loading_every_module_loads_no_jax():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(BENCH.parent)!r}, {str(BENCH.parent / 'src')!r}]\n"
        "from perfbench import run, harness, spec, calibrate, cost, inputs\n"
        "from perfbench.reference import fold, gpt2\n"
        "import repro_torch.api, repro_torch.models.registry\n"
        "spec.driver('agg_round'); spec.driver('fedlm_round')\n"
        "for m in spec.benchmark()['end_to_end'] + spec.benchmark()['per_layer']:\n"
        "    spec.metric_reader(m['name'])\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
