"""``python -m repro_torch.detlint`` — the port's determinism-contract gate.

Two entry points::

    python -m repro_torch.detlint [--json] [--select CODES] PATH [PATH ...]
    python -m repro_torch.detlint audit [--json] [--expected PATH]

The first AST-lints every ``.py`` under the given paths against the
registered determinism rules (stdlib-only — runs without torch or
numpy); the second imports the port's live topology/codec registries and
checks the plugin conformance contracts. Both exit 0 when clean, 1 on findings; argparse
usage errors exit 2.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.detlint.engine import available_rules, get_rules, lint_paths


def _lint_main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.detlint",
        description="AST determinism-contract linter for the repro_torch tree")
    ap.add_argument("paths", nargs="+", metavar="PATH",
                    help="files or directories to lint")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--select", default=None, metavar="CODES",
                    help="comma-separated rule codes to run "
                         f"(default: all of {','.join(available_rules())})")
    args = ap.parse_args(argv)
    try:
        rules = get_rules(args.select.split(",") if args.select else None)
        violations = lint_paths(args.paths, rules)
    except (FileNotFoundError, ValueError) as e:
        ap.error(str(e))
    if args.as_json:
        print(json.dumps({"violations": [v.to_json() for v in violations],
                          "count": len(violations)}, indent=1))
    else:
        for v in violations:
            print(v.render())
        n = len(violations)
        print(f"detlint: {n} violation{'s' if n != 1 else ''}"
              if n else "detlint: clean")
    return 1 if violations else 0


def _audit_main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.detlint audit",
        description="registry conformance audit (topologies, codecs, "
                    "smoke-gate schema)")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--expected", default=None, metavar="PATH",
                    help="expected-smoke JSON "
                         "(default: benchmarks/expected_smoke.json)")
    args = ap.parse_args(argv)
    from repro_torch.detlint.audit import run_audit
    findings = run_audit(args.expected)
    if args.as_json:
        print(json.dumps({"findings": [f.to_json() for f in findings],
                          "count": len(findings)}, indent=1))
    else:
        for f in findings:
            print(f.render())
        n = len(findings)
        print(f"detlint audit: {n} finding{'s' if n != 1 else ''}"
              if n else "detlint audit: conformant")
    return 1 if findings else 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "audit":
        return _audit_main(argv[1:])
    return _lint_main(argv)
