"""THR001 — heuristic race check on fold-pool callables.

Contract: callables handed to ``ParallelFoldPool.map``/
``run_spans`` run concurrently on the repro-fold thread pool; they stay
deterministic because each worker touches only its *span-indexed*
scratch (``out[lo:hi] = ...`` where ``lo``/``hi`` are its parameters) or
purely local state, and returns values for the pool to collect in task
order. A callable that mutates closure-captured state any other way —
``nonlocal`` accumulation, subscript writes at indices unrelated to its
span, ``.append()`` on a shared list — races its siblings and breaks the
bit-identity-at-any-worker-count guarantee.

Heuristic, by construction: it resolves only callables defined in the
same file and only ``.map``/``.run_spans`` calls whose receiver looks
like a pool (its name contains "pool" or it comes from ``get_pool``).
False negatives are possible; a flagged site is either a real race or a
pattern worth restructuring.
"""

from __future__ import annotations

import ast

from repro_torch.detlint.engine import Rule, register_rule

_MUTATORS = frozenset({
    "append", "extend", "insert", "add", "update", "setdefault",
    "pop", "popitem", "remove", "discard", "clear", "sort", "reverse",
})


def _receiver_is_pool(func: ast.Attribute) -> bool:
    base = func.value
    if isinstance(base, ast.Name):
        return "pool" in base.id.lower()
    if isinstance(base, ast.Attribute):
        return "pool" in base.attr.lower()
    if isinstance(base, ast.Call):
        f = base.func
        name = f.id if isinstance(f, ast.Name) else \
            f.attr if isinstance(f, ast.Attribute) else ""
        return "pool" in name.lower()
    return False


def _parents(tree: ast.AST) -> dict:
    par: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            par[child] = node
    return par


def _defs_in(scope: ast.AST) -> dict:
    """name -> FunctionDef/Lambda declared anywhere inside ``scope``."""
    out: dict[str, ast.AST] = {}
    for node in ast.walk(scope):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name not in out:
            out[node.name] = node
        elif isinstance(node, ast.Assign) \
                and isinstance(node.value, ast.Lambda):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id not in out:
                    out[t.id] = node.value
    return out


def _resolve_callable(name: str, call: ast.AST, parents: dict):
    """Look the name up innermost-enclosing-scope first — two span
    workers both called ``fn`` in different functions must each resolve
    to their own definition."""
    scope = parents.get(call)
    while scope is not None:
        if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Module)):
            fn = _defs_in(scope).get(name)
            if fn is not None and fn is not scope:
                return fn
        scope = parents.get(scope)
    return None


def _param_names(fn: ast.AST) -> set[str]:
    a = fn.args
    params = [*a.posonlyargs, *a.args, *a.kwonlyargs]
    if a.vararg:
        params.append(a.vararg)
    if a.kwarg:
        params.append(a.kwarg)
    return {p.arg for p in params}


def _body(fn: ast.AST) -> list[ast.AST]:
    return [fn.body] if isinstance(fn, ast.Lambda) else fn.body


def _binding_names(t: ast.AST):
    """Names a target expression *binds* — bare names and tuple/star
    unpacks, but NOT names inside subscripts/attributes (``out[lo:hi] =``
    mutates ``out``, it does not bind it)."""
    if isinstance(t, ast.Name):
        yield t.id
    elif isinstance(t, ast.Starred):
        yield from _binding_names(t.value)
    elif isinstance(t, (ast.Tuple, ast.List)):
        for e in t.elts:
            yield from _binding_names(e)


def _bound_locals(fn: ast.AST) -> set[str]:
    """Names the callable binds itself (they shadow any closure name)."""
    bound: set[str] = set()
    for stmt in _body(fn):
        for node in ast.walk(stmt):
            targets: list[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = list(node.targets)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign,
                                   ast.For, ast.AsyncFor)):
                targets = [node.target]
            elif isinstance(node, (ast.withitem,)) and node.optional_vars:
                targets = [node.optional_vars]
            elif isinstance(node, ast.comprehension):
                targets = [node.target]
            for t in targets:
                bound.update(_binding_names(t))
    return bound


def _names_in(node: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _race_hits(fn: ast.AST):
    params = _param_names(fn)
    local = _bound_locals(fn) | params
    nonlocals: set[str] = set()
    for stmt in _body(fn):
        for node in ast.walk(stmt):
            if isinstance(node, ast.Nonlocal):
                nonlocals.update(node.names)
    for stmt in _body(fn):
        for node in ast.walk(stmt):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Name) and t.id in nonlocals:
                        yield (node, f"writes nonlocal {t.id!r}")
                    elif isinstance(t, ast.Subscript) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id not in local \
                            and not (_names_in(t.slice) & params):
                        yield (node,
                               f"writes shared {t.value.id!r} at an "
                               f"index unrelated to its span parameters")
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _MUTATORS \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id not in local:
                yield (node,
                       f"calls {node.func.value.id}.{node.func.attr}() "
                       f"on closure-captured state")


@register_rule
class FoldPoolRaceRule(Rule):
    code = "THR001"
    title = "fold-pool callable mutates shared (non-span-local) state"

    def check(self, ctx):
        parents = _parents(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("map", "run_spans")
                    and node.args and _receiver_is_pool(node.func)):
                continue
            arg = node.args[0]
            fn = arg if isinstance(arg, ast.Lambda) else \
                _resolve_callable(arg.id, node, parents) \
                if isinstance(arg, ast.Name) else None
            if fn is None:
                continue
            for offender, why in _race_hits(fn):
                yield (offender, 0,
                       f"callable handed to ParallelFoldPool."
                       f"{node.func.attr} {why} — workers race; keep "
                       f"mutation span-indexed (out[lo:hi]) or return "
                       f"values for the pool to collect")
