"""detlint core: file contexts, import resolution, pragmas, rule registry.

The linter is pure-AST and stdlib-only — ``python -m repro_torch.detlint
src/repro_torch`` runs in a bare interpreter, without torch or numpy.

Scoping model
-------------
Every checked file gets a :class:`FileContext`. Files that live inside a
``repro_torch`` package tree (``.../src/repro_torch/<rel>`` or
``.../repro_torch/<rel>``) additionally carry ``repro_rel``, the path
relative to the package root (e.g. ``serverless/faults.py``). Rules that
enforce the port's determinism contracts (DET001/DET002/ENV001/ORD001)
scope on ``repro_rel`` and skip foreign files; structural rules (THR001,
pragma hygiene) apply everywhere. This is what lets ``python -m
repro_torch.detlint src/repro_torch tests tools chip_smoke.py`` lint the
whole port while the contracts stay anchored to the package — and what
lets tests rebuild violating files under a tmp ``src/repro_torch/``
mirror. The rule codes and the pragma syntax are those of the JAX
package's linter, which reads the same pragmas in the same files.

Suppression pragmas
-------------------
``# detlint: allow[RULE] reason`` suppresses RULE on its line; a pragma on
a comment-only line also covers the next source line. The reason is
mandatory — a bare ``allow[RULE]`` is itself a violation (PRAGMA001), as
is a pragma naming an unknown rule. Suppressions are deliberate,
documented exceptions, never free passes.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import re
from typing import Iterable, Sequence

# ---------------------------------------------------------------------------
# Violations
# ---------------------------------------------------------------------------

#: rule code for malformed / unknown suppression pragmas
PRAGMA_CODE = "PRAGMA001"
#: rule code for files the parser rejects (a syntax error is a lint failure
#: too — an unparseable file is an unchecked file)
PARSE_CODE = "PARSE001"


@dataclasses.dataclass(frozen=True, order=True)
class Violation:
    path: str
    line: int
    col: int
    code: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.code} {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Import resolution
# ---------------------------------------------------------------------------

class ImportMap:
    """Alias -> canonical dotted module path, from a file's import statements.

    Lets rules match on *canonical* names (``numpy.random.rand``,
    ``time.perf_counter``, ``os.environ``) regardless of the local
    spelling (``import numpy as np``, ``from time import perf_counter as
    clock``, ``from os import environ``).
    """

    def __init__(self, tree: ast.AST):
        self.aliases: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and not node.level:
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.aliases[a.asname or a.name] = \
                        f"{node.module}.{a.name}"

    def resolve(self, node: ast.AST) -> str | None:
        """Canonical dotted name of a Name/Attribute chain, else None."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        head = self.aliases.get(node.id)
        if head is None:
            return None
        return ".".join([head] + list(reversed(parts)))


# ---------------------------------------------------------------------------
# Pragmas
# ---------------------------------------------------------------------------

_PRAGMA_RE = re.compile(
    r"^#\s*detlint:\s*allow\[([A-Za-z0-9_]+)\]\s*(.*?)\s*$")
_PRAGMA_HINT_RE = re.compile(r"^#.*\bdetlint\s*:")


def _comments(source: str):
    """(lineno, col, text) for every real comment token (strings that
    merely *contain* pragma-looking text don't count)."""
    import io
    import tokenize
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                yield tok.start[0], tok.start[1], tok.string
    except tokenize.TokenError:
        return


def collect_pragmas(source: str, path: str,
                    known_codes: frozenset[str]) -> tuple[dict, list]:
    """Parse suppression pragmas.

    Returns ``(allow, errors)`` where ``allow`` maps line number ->
    set of suppressed rule codes and ``errors`` are PRAGMA001 violations
    (malformed pragma, missing reason, unknown rule code).
    """
    allow: dict[int, set[str]] = {}
    errors: list[Violation] = []
    for lineno, col, text in _comments(source):
        m = _PRAGMA_RE.match(text)
        if not m:
            if _PRAGMA_HINT_RE.match(text):
                errors.append(Violation(
                    path, lineno, col, PRAGMA_CODE,
                    "malformed detlint pragma (expected "
                    "'# detlint: allow[RULE] reason')"))
            continue
        code, reason = m.group(1), m.group(2)
        if code not in known_codes:
            errors.append(Violation(
                path, lineno, col, PRAGMA_CODE,
                f"pragma names unknown rule {code!r} "
                f"(known: {', '.join(sorted(known_codes))})"))
            continue
        if not reason:
            errors.append(Violation(
                path, lineno, col, PRAGMA_CODE,
                f"pragma allow[{code}] has no reason — suppressions "
                f"must say why the contract holds anyway"))
            continue
        allow.setdefault(lineno, set()).add(code)
        # a comment-only pragma covers the next statement line (reasons
        # may wrap over further comment lines; blanks don't break it)
        lines = source.splitlines()
        if col == 0 or not lines[lineno - 1][:col].strip():
            nxt = lineno + 1
            while nxt <= len(lines) and (
                    not lines[nxt - 1].strip()
                    or lines[nxt - 1].lstrip().startswith("#")):
                nxt += 1
            allow.setdefault(nxt, set()).add(code)
    return allow, errors


# ---------------------------------------------------------------------------
# File context
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FileContext:
    path: str                 #: path as reported in violations
    repro_rel: str | None     #: path inside the repro_torch package, if any
    tree: ast.AST
    lines: list[str]
    imports: ImportMap

    def in_repro(self, *prefixes: str) -> bool:
        """True when the file is inside the repro_torch package (optionally
        restricted to the given relative prefixes)."""
        if self.repro_rel is None:
            return False
        if not prefixes:
            return True
        return any(self.repro_rel == p or self.repro_rel.startswith(p)
                   for p in prefixes)


def repro_relpath(path: pathlib.Path) -> str | None:
    """Path relative to the innermost ``repro_torch`` package dir, else
    None."""
    parts = path.as_posix().split("/")
    for i in range(len(parts) - 2, -1, -1):
        if parts[i] == "repro_torch":
            return "/".join(parts[i + 1:])
    return None


# ---------------------------------------------------------------------------
# Rule registry (mirrors @register_topology / @register_codec)
# ---------------------------------------------------------------------------

class Rule:
    """One determinism contract. Subclasses set ``code``/``title`` and
    implement :meth:`check` yielding ``(node_or_lineno, col, message)``."""

    code = "?"
    title = "?"

    def check(self, ctx: FileContext) -> Iterable[tuple]:
        raise NotImplementedError


_REGISTRY: dict[str, Rule] = {}


def register_rule(cls):
    """Class decorator: register a :class:`Rule` under its ``code`` —
    the same public extension discipline as ``@register_topology``."""
    instance = cls() if isinstance(cls, type) else cls
    if instance.code in _REGISTRY:
        raise ValueError(f"rule {instance.code!r} is already registered")
    _REGISTRY[instance.code] = instance
    return cls


def available_rules() -> tuple[str, ...]:
    _load_builtin_rules()
    return tuple(sorted(_REGISTRY))


def get_rules(select: Sequence[str] | None = None) -> list[Rule]:
    _load_builtin_rules()
    if select is None:
        return [_REGISTRY[c] for c in sorted(_REGISTRY)]
    unknown = sorted(set(select) - set(_REGISTRY))
    if unknown:
        raise ValueError(
            f"unknown rule(s) {unknown} (registered: {sorted(_REGISTRY)})")
    return [_REGISTRY[c] for c in sorted(set(select))]


def _load_builtin_rules() -> None:
    # import for the registration side effect; idempotent
    from repro_torch.detlint import (  # noqa: F401
        rules_env,
        rules_order,
        rules_rng,
        rules_threads,
        rules_time,
    )


def known_codes() -> frozenset[str]:
    return frozenset(available_rules()) | {PRAGMA_CODE, PARSE_CODE}


# ---------------------------------------------------------------------------
# Runners
# ---------------------------------------------------------------------------

def lint_source(source: str, path: str,
                rules: Sequence[Rule] | None = None,
                repro_rel: str | None = None) -> list[Violation]:
    """Lint one file's source text (the unit under all the runners)."""
    if rules is None:
        rules = get_rules()
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Violation(path, e.lineno or 1, e.offset or 0, PARSE_CODE,
                          f"file does not parse: {e.msg}")]
    lines = source.splitlines()
    allow, violations = collect_pragmas(source, path, known_codes())
    ctx = FileContext(path=path, repro_rel=repro_rel, tree=tree,
                      lines=lines, imports=ImportMap(tree))
    for rule in rules:
        for hit in rule.check(ctx):
            node, col, message = hit
            line = node if isinstance(node, int) else node.lineno
            if isinstance(node, ast.AST):
                col = node.col_offset
            if rule.code in allow.get(line, ()):
                continue
            violations.append(Violation(path, line, col, rule.code, message))
    return sorted(violations)


def lint_file(path: pathlib.Path,
              rules: Sequence[Rule] | None = None) -> list[Violation]:
    return lint_source(path.read_text(), path.as_posix(), rules,
                       repro_relpath(path))


def iter_py_files(paths: Iterable[str | pathlib.Path]) -> list[pathlib.Path]:
    """Expand files/dirs into a deterministic, sorted .py file list."""
    out: set[pathlib.Path] = set()
    for p in paths:
        p = pathlib.Path(p)
        if p.is_dir():
            out.update(f for f in p.rglob("*.py")
                       if "__pycache__" not in f.parts)
        elif p.suffix == ".py":
            out.add(p)
        elif not p.exists():
            raise FileNotFoundError(f"no such path: {p}")
    return sorted(out)


def lint_paths(paths: Iterable[str | pathlib.Path],
               rules: Sequence[Rule] | None = None) -> list[Violation]:
    if rules is None:
        rules = get_rules()
    violations: list[Violation] = []
    for f in iter_py_files(paths):
        violations.extend(lint_file(f, rules))
    return violations
