"""The port's determinism linter (`repro_torch.detlint`) beside the JAX
package's (`repro.detlint`).

* Parity: every fixture source of `tests/test_detlint.py`, rebuilt under a
  tmp `src/repro/` mirror and a tmp `src/repro_torch/` mirror, gets the
  same `(line, col, code)` findings from both linters.
* The torch rules, reported under DET001 (torch's default generator and
  global seeding) and ORD001 (fused rounding, atomic accumulation and
  parallel scans in the value-plane modules): each fires, each is quiet
  when the contract holds, a pragma with a reason suppresses it, and the
  same pragma is well-formed to the reference linter.
* The CLI's exit codes and `--json`, the lint's stdlib-only import set,
  the port's tree and live registries.

Fixture files live under `tmp_path` only: a pragma-like comment in a
committed file is linted by both linters.
"""
import ast
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from repro.detlint import lint_file as ref_lint_file
from repro.detlint import lint_source as ref_lint_source
from repro_torch.detlint import (
    PRAGMA_CODE,
    available_rules,
    get_rules,
    lint_file,
    lint_paths,
    lint_source,
    run_audit,
)
from repro.detlint import available_rules as ref_available_rules
from repro_torch.detlint.audit import (
    audit_codecs,
    audit_smoke_schema,
    audit_topologies,
)
from repro_torch.detlint.cli import main as cli_main

REPO = pathlib.Path(__file__).resolve().parent.parent
REF_TESTS = REPO / "tests" / "test_detlint.py"
SMOKE = REPO / "benchmarks" / "expected_smoke.json"


def lint(source: str, rel: str = "core/mod.py", select=None):
    """Lint dedented source as if it lived at src/repro_torch/<rel>."""
    rules = get_rules(select) if select else None
    return lint_source(textwrap.dedent(source), f"src/repro_torch/{rel}",
                       rules, repro_rel=rel)


def codes(violations):
    return [v.code for v in violations]


def triples(violations):
    return [(v.line, v.col, v.code) for v in violations]


# ---------------------------------------------------------------------------
# parity with the reference linter on its own fixtures
# ---------------------------------------------------------------------------

def _str_value(node, bindings):
    """A fixture's source text: a string literal, a name bound to one, or
    ``textwrap.dedent`` of either."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return bindings.get(node.id)
    if isinstance(node, ast.Call) and ast.unparse(node.func) \
            == "textwrap.dedent" and node.args:
        return _str_value(node.args[0], bindings)
    return None


def _reference_fixtures():
    """(id, source, rel or None, foreign path) for every source the
    reference's tests lint or write: ``lint(src, rel=...)`` (a ``rel``
    bound by a ``for`` over literals expands to each), ``lint_source``
    on a foreign path, and ``write_text`` of a fixture file."""
    out = []
    tree = ast.parse(REF_TESTS.read_text())
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        bindings, loops = {}, {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                val = _str_value(node.value, {})
                if val is not None:
                    bindings[node.targets[0].id] = val
            elif isinstance(node, ast.For) and isinstance(
                    node.target, ast.Name) and isinstance(
                    node.iter, ast.Tuple):
                loops[node.target.id] = [e.value for e in node.iter.elts]
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            name = ast.unparse(node.func)
            src = _str_value(node.args[0], bindings)
            if src is None:
                continue
            if name == "lint":
                kw = {k.arg: k.value for k in node.keywords}
                rel = kw.get("rel")
                if rel is None:
                    rels = ["core/mod.py"]
                elif isinstance(rel, ast.Constant):
                    rels = [rel.value]
                else:
                    rels = loops[rel.id]
                for r in rels:
                    out.append((src, r, None))
            elif name == "lint_source":
                out.append((src, None, node.args[1].value))
            elif name.endswith(".write_text"):
                out.append((src, "core/bad.py", None))
    return [pytest.param(textwrap.dedent(src), rel, foreign,
                         id=f"{i:02d}-{rel or foreign}")
            for i, (src, rel, foreign) in enumerate(out)]


REF_FIXTURES = _reference_fixtures()


def test_reference_fixtures_found():
    # every test of test_detlint.py that lints a literal source contributes
    assert len(REF_FIXTURES) >= 34


@pytest.mark.parametrize("source,rel,foreign", REF_FIXTURES)
def test_parity_with_reference_linter(tmp_path, source, rel, foreign):
    if foreign is not None:
        path = tmp_path / foreign
        path.parent.mkdir(parents=True)
        path.write_text(source)
        ref, port = ref_lint_file(path), lint_file(path)
    else:
        ref_path = tmp_path / "src" / "repro" / rel
        port_path = tmp_path / "src" / "repro_torch" / rel
        for p in (ref_path, port_path):
            p.parent.mkdir(parents=True)
            p.write_text(source)
        ref, port = ref_lint_file(ref_path), lint_file(port_path)
    assert triples(port) == triples(ref)


def test_same_rule_codes_as_reference():
    assert available_rules() == ref_available_rules()


# ---------------------------------------------------------------------------
# DET001: torch's default generator and global seeding
# ---------------------------------------------------------------------------

#: (call template, whether it has other arguments); ``{g}`` takes the
#: generator keyword
TORCH_DRAWS = [
    ("torch.rand(3{g})", True), ("torch.randn(3{g})", True),
    ("torch.randint(0, 5, (3,){g})", True), ("torch.randperm(5{g})", True),
    ("torch.rand_like(x{g})", True), ("torch.randn_like(x{g})", True),
    ("torch.randint_like(x, 5{g})", True),
    ("torch.normal(x, 1.0{g})", True), ("torch.bernoulli(x{g})", True),
    ("torch.multinomial(x, 1{g})", True), ("torch.poisson(x{g})", True),
    ("x.uniform_({g})", False), ("x.normal_({g})", False),
    ("x.bernoulli_(0.5{g})", True), ("x.random_({g})", False),
    ("x.exponential_({g})", False), ("x.geometric_(0.5{g})", True),
    ("x.cauchy_({g})", False), ("x.log_normal_({g})", False),
    ("torch.nn.init.normal_(x{g})", True),
    ("torch.nn.init.trunc_normal_(x{g})", True),
    ("init.kaiming_uniform_(x{g})", True),
    ("nn.init.xavier_normal_(x{g})", True),
    ("T.randn(3{g})", True), ("randn(3{g})", True),
]
HEADER = ("import torch\nimport torch as T\nfrom torch import nn, randn\n"
          "from torch.nn import init\n")


def _call(template: str, has_args: bool, generator: str | None) -> str:
    if generator is None:
        return template.format(g="")
    return template.format(g=(", " if has_args else "")
                           + f"generator={generator}")


@pytest.mark.parametrize("template,has_args", TORCH_DRAWS,
                         ids=[t for t, _ in TORCH_DRAWS])
def test_det001_torch_draw_needs_a_generator(template, has_args):
    fires = lint(HEADER + "y = " + _call(template, has_args, None) + "\n")
    assert codes(fires) == ["DET001"]
    assert "generator" in fires[0].message
    assert lint(HEADER + "y = " + _call(template, has_args, "g") + "\n") == []
    # generator=None is the default generator
    assert codes(lint(HEADER + "y = " + _call(template, has_args, "None")
                      + "\n")) == ["DET001"]


@pytest.mark.parametrize("call", [
    "torch.manual_seed(0)", "torch.seed()", "torch.cuda.manual_seed(0)",
    "torch.cuda.manual_seed_all(0)", "torch.random.manual_seed(0)"])
def test_det001_torch_global_seeding(call):
    vs = lint(HEADER + call + "\n")
    assert codes(vs) == ["DET001"]
    assert "process-global" in vs[0].message


def test_det001_quiet_on_seeded_generators_and_fills():
    assert lint(HEADER + """
g = torch.Generator(device="cpu").manual_seed(0)
w = torch.empty(3)
torch.nn.init.zeros_(w)
init.constant_(w, 1.0)
y = torch.randn(3, generator=g) + torch.zeros(3)
""") == []


def test_det001_torch_scoped_to_port_tree():
    src = "import torch\nx = torch.randn(3)\n"
    assert lint_source(src, "tools/foreign.py", repro_rel=None) == []


# ---------------------------------------------------------------------------
# ORD001: fused rounding, atomic accumulation, scans in the value plane
# ---------------------------------------------------------------------------

VALUE_PLANE_HAZARDS = [
    "a.add(b, alpha=2.0)", "a.add_(b, alpha=2.0)", "torch.add(a, b, alpha=2)",
    "torch.sub(a, b, alpha=2)", "a.sub_(b, alpha=0.5)",
    "torch.addcmul(a, b, c)", "a.addcmul_(b, c, value=2)",
    "a.addcdiv(b, c)", "torch.addcdiv(a, b, c)",
    "torch.lerp(a, b, 0.5)", "a.lerp_(b, 0.5)",
    "a.index_add_(0, i, b)", "torch.index_add(a, 0, i, b)",
    "a.scatter_add_(0, i, b)", "torch.scatter_add(a, 0, i, b)",
    "a.scatter_reduce(0, i, b, 'sum')", "a.scatter_reduce_(0, i, b, 'amax')",
    "a.index_put_((i,), b, accumulate=True)", "a.index_put_((i,), b, True)",
    "torch.index_put(a, (i,), b, True)", "a.index_put((i,), b, flag)",
    "a.put_(i, b, accumulate=True)",
    "torch.bincount(i, weights=w)", "torch.bincount(i, w)", "i.bincount(w)",
    "torch.cumsum(a, 0)", "a.cumsum(0)", "a.cumsum_(0)", "a.cumprod(0)",
    "torch.cumprod(a, dim=0)",
]
VALUE_PLANE_QUIET = [
    "a.add(b)", "torch.add(a, b)", "a.sub_(b)", "a.index_put_((i,), b)",
    "a.index_put_((i,), b, accumulate=False)", "a.put_(i, b)",
    "torch.bincount(i)", "i.bincount()", "np.cumsum(x)", "np.add(a, b)",
    "numpy.cumsum(x)", "a.mul(b).add(c)", "torch.sum(a)",
]
PORT_VALUE_PLANE = ("core/fedavg.py", "core/agg_engine.py",
                    "kernels/fedavg_stream.py", "kernels/quantize.py",
                    "kernels/topk_sparsify.py", "core/wire_codec.py")
ORD_HEADER = "import numpy\nimport numpy as np\nimport torch\n"


@pytest.mark.parametrize("expr", VALUE_PLANE_HAZARDS)
def test_ord001_torch_hazard_fires_in_value_plane(expr):
    for rel in PORT_VALUE_PLANE:
        vs = lint(ORD_HEADER + f"y = {expr}\n", rel=rel)
        assert codes(vs) == ["ORD001"], rel
    assert lint(ORD_HEADER + f"y = {expr}\n", rel="launch/serve.py") == []


@pytest.mark.parametrize("expr", VALUE_PLANE_QUIET)
def test_ord001_torch_quiet_forms(expr):
    assert lint(ORD_HEADER + f"y = {expr}\n", rel="core/fedavg.py") == []


def test_ord001_value_plane_keeps_reference_paths():
    from repro.detlint.rules_order import VALUE_PLANE as REF
    from repro_torch.detlint.rules_order import VALUE_PLANE
    assert REF <= VALUE_PLANE
    assert VALUE_PLANE - REF == {
        "kernels/fedavg_stream.py", "kernels/quantize.py",
        "kernels/topk_sparsify.py", "core/wire_codec.py"}


# ---------------------------------------------------------------------------
# pragmas: the same syntax, read by both linters
# ---------------------------------------------------------------------------

PRAGMA_CASES = [
    ("""
        import torch

        # detlint: allow[DET001] fixture draw, never folded
        x = torch.randn(3)
    """, "core/mod.py", "DET001"),
    ("""
        import torch

        def fold(acc, x):
            return acc.add(x, alpha=0.5)  # detlint: allow[ORD001] fixture
    """, "core/fedavg.py", "ORD001"),
]


@pytest.mark.parametrize("source,rel,code", PRAGMA_CASES)
def test_pragma_suppresses_torch_rule_and_passes_reference(source, rel,
                                                           code):
    bare = re.sub(r"#\s*detlint:.*$", "", source, flags=re.MULTILINE)
    assert codes(lint(bare, rel=rel)) == [code]
    assert lint(source, rel=rel) == []
    assert ref_lint_source(textwrap.dedent(source), f"src/repro/{rel}",
                           repro_rel=rel) == []


def test_pragma_without_reason_rejected():
    vs = lint("""
        import torch

        x = torch.randn(3)  # detlint: allow[DET001]
    """)
    assert codes(vs) == ["DET001", PRAGMA_CODE]


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

@pytest.fixture
def bad_tree(tmp_path):
    """A tmp src/repro_torch mirror holding one torch DET001 violation."""
    mod = tmp_path / "src" / "repro_torch" / "core"
    mod.mkdir(parents=True)
    (mod / "bad.py").write_text("import torch\nx = torch.randn(3)\n")
    return tmp_path / "src"


def test_cli_exit_codes_and_json(bad_tree, tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    assert cli_main([str(clean)]) == 0
    assert "detlint: clean" in capsys.readouterr().out
    assert cli_main([str(bad_tree)]) == 1
    assert "DET001" in capsys.readouterr().out
    assert cli_main(["--json", str(bad_tree)]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["count"] == 1
    (v,) = payload["violations"]
    assert v["code"] == "DET001"
    assert v["path"].endswith("src/repro_torch/core/bad.py")
    assert set(v) == {"path", "line", "col", "code", "message"}
    assert cli_main(["--select", "ORD001", str(bad_tree)]) == 0
    capsys.readouterr()


def test_cli_usage_errors_exit_2(bad_tree, capsys):
    with pytest.raises(SystemExit) as e:
        cli_main(["--select", "NOPE999", str(bad_tree)])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        cli_main(["/no/such/path.py"])
    assert e.value.code == 2
    capsys.readouterr()


def test_cli_audit_exit_codes(tmp_path, capsys):
    assert cli_main(["audit", "--expected", str(SMOKE)]) == 0
    assert "conformant" in capsys.readouterr().out
    bad = tmp_path / "expected_smoke.json"
    bad.write_text(json.dumps({"smoke/ok/metric": [1, 2]}))
    assert cli_main(["audit", "--json", "--expected", str(bad)]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert [f["code"] for f in payload["findings"]] == ["REG004"]


def test_each_torch_rule_fails_a_port_mirror(tmp_path, capsys):
    """The port's tree copied under tmp lints clean; every torch hazard
    appended to a value-plane module of the copy is one finding."""
    mirror = tmp_path / "src" / "repro_torch"
    shutil.copytree(REPO / "src" / "repro_torch", mirror,
                    ignore=shutil.ignore_patterns("__pycache__"))
    assert cli_main([str(mirror)]) == 0
    capsys.readouterr()
    target = mirror / "core" / "fedavg.py"
    lines = target.read_text().splitlines()
    first = len(lines) + 3          # after a blank line and the def
    draws = [_call(t, a, None) for t, a in TORCH_DRAWS[:19]]
    injected = ["def _injected(a, b, c, i, w, x):"] + [
        f"    _ = {expr}" for expr in VALUE_PLANE_HAZARDS + draws
        + ["torch.manual_seed(0)"]]
    target.write_text("\n".join(lines + ["", *injected]) + "\n")
    assert cli_main(["--json", str(mirror)]) == 1
    found = json.loads(capsys.readouterr().out)["violations"]
    assert [(v["line"], v["code"]) for v in found] == [
        (first + k, "ORD001") for k in range(len(VALUE_PLANE_HAZARDS))] + [
        (first + len(VALUE_PLANE_HAZARDS) + k, "DET001")
        for k in range(len(draws) + 1)]


def test_module_entrypoint_imports_no_torch_numpy_or_reference(bad_tree):
    """``python -m repro_torch.detlint`` lints in a bare interpreter: the
    imports it makes (``-X importtime``) hold no torch, numpy or repro."""
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "repro_torch.detlint",
         "--json", str(bad_tree)],
        capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": os.defpath})
    assert proc.returncode == 1
    assert json.loads(proc.stdout)["count"] == 1
    imported = re.findall(r"^import time:.*\|\s*(\S+)\s*$", proc.stderr,
                          re.MULTILINE)
    assert "repro_torch.detlint.engine" in {m.strip() for m in imported}
    bad = sorted({m.strip() for m in imported
                  if m.strip().split(".")[0] in ("torch", "numpy", "repro")})
    assert bad == []


# ---------------------------------------------------------------------------
# registry audit on the port's registries
# ---------------------------------------------------------------------------

class _V1Topology:
    name = "legacy"
    cost_api_version = 1

    def cost_phase_plan(self, plan, link, codec):
        return 0.0

    def cost_pipelined_plan(self, plan, link, *, codec=None):
        return 0.0


def test_audit_flags_bad_port_plugins(tmp_path):
    from repro_torch.core.wire_codec import WireCodec

    class Partial(WireCodec):
        name = "partial"
        lossless = "yes"

        def encode(self, x):
            return x

        def wire_bytes(self, x):
            return 0

    assert [f.code for f in audit_topologies({"legacy": _V1Topology()})] \
        == ["REG001", "REG002"]
    reg3 = [f for f in audit_codecs({"partial": Partial()})
            if f.code == "REG003"]
    assert len(reg3) == 2
    assert [f.code for f in audit_smoke_schema(tmp_path / "no.json")] \
        == ["REG004"]


# ---------------------------------------------------------------------------
# the port's tree and registries
# ---------------------------------------------------------------------------

def test_port_tree_lints_clean():
    violations = lint_paths([REPO / "src" / "repro_torch", REPO / "tests",
                             REPO / "tools", REPO / "chip_smoke.py"])
    assert violations == [], "\n".join(v.render() for v in violations)


def test_port_registries_conformant():
    findings = run_audit(SMOKE)
    assert findings == [], "\n".join(f.render() for f in findings)
