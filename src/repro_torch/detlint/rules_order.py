"""ORD001 — accumulation-order hazards in the value-plane modules.

Contract: ``avg_flat`` is bit-identical across topology x engine x
schedule x codec x workers because every fold replays one canonical
IEEE op order. Float addition does not commute, so in the modules that
own fold arithmetic or feed its accounting, iteration order must be
provably deterministic:

* iterating a ``set``/``frozenset`` hands the fold hash order
  (PYTHONHASHSEED-dependent for strings) — always flagged;
* iterating a dict view (``.keys()/.values()/.items()``) without
  ``sorted()`` ties the fold to insertion order — flagged so each site
  either sorts or documents (pragma) why insertion order is the
  canonical order;
* a bare ``sum()`` over a generator buries a float accumulation order in
  a one-liner — flagged (integer-literal counting like ``sum(1 for ..)``
  is exempt) so each site documents the ordered iterable it walks.

The torch value plane adds three hazards the numpy one never had:

* fused rounding: ``add``/``sub`` with ``alpha=`` and ``addcmul``/
  ``addcdiv``/``lerp`` (function, method and in-place forms) round once
  where the canonical fold rounds after the multiply and again after the
  add, so their bits differ from the unfused reference;
* order-free accumulation: ``index_add``, ``scatter_add``,
  ``scatter_reduce``, ``index_put``/``put_`` with ``accumulate=True`` and
  ``bincount`` with ``weights=`` lower to CUDA atomics, whose add order
  is whatever order the threads arrive in;
* parallel scans: ``cumsum``/``cumprod`` on a tensor do not round the
  way a left fold does.

The rule is scoped to :data:`VALUE_PLANE` — the fold/accounting modules —
rather than the whole tree; elsewhere these constructs are ordinary
Python.
"""

from __future__ import annotations

import ast

from repro_torch.detlint.engine import Rule, register_rule

#: repro_torch-relative paths of the modules that own fold arithmetic or
#: the accounting the fold's results bill against: the JAX package's seven,
#: then the port's modules that hold value-plane arithmetic in torch
VALUE_PLANE = frozenset({
    "core/agg_engine.py",
    "core/device_agg.py",
    "core/fedavg.py",
    "core/fold_pool.py",
    "core/sharding.py",
    "kernels/ops.py",
    "serverless/population.py",
    "kernels/fedavg_stream.py",
    "kernels/quantize.py",
    "kernels/topk_sparsify.py",
    "core/wire_codec.py",
})

#: ops that fuse a multiply into an add and round once
_FUSED = frozenset({"addcmul", "addcmul_", "addcdiv", "addcdiv_",
                    "lerp", "lerp_"})
#: ops whose ``alpha=`` scales the other operand inside the add
_ALPHA_OPS = frozenset({"add", "add_", "sub", "sub_"})
#: scatters that accumulate through atomics
_ATOMIC = frozenset({"index_add", "index_add_", "scatter_add",
                     "scatter_add_", "scatter_reduce", "scatter_reduce_"})
#: op -> positional index of ``accumulate`` in (method, function) form
_ACCUMULATE_POS = {"index_put": (2, 3), "index_put_": (2, 3),
                   "put_": (2, 3)}
#: parallel scans
_SCANS = frozenset({"cumsum", "cumsum_", "cumprod", "cumprod_"})

_DICT_VIEWS = frozenset({"keys", "values", "items"})


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in ("set", "frozenset"))


def _is_dict_view(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _DICT_VIEWS
            and not node.args and not node.keywords)


def _set_named(tree: ast.AST) -> frozenset[str]:
    """Names whose *every* binding in the file is a set expression —
    conservative: one non-set rebinding anywhere clears the name."""
    is_set: dict[str, bool] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            pairs = [(t, node.value) for t in node.targets]
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            pairs = [(node.target, node.value)]
        else:
            continue
        for target, value in pairs:
            if isinstance(target, ast.Name):
                is_set[target.id] = (_is_set_expr(value)
                                     and is_set.get(target.id, True))
    return frozenset(n for n, ok in is_set.items() if ok)


def _iterables(node: ast.AST):
    """(lineno-bearing node, iterable expr) pairs for loops/comprehensions."""
    if isinstance(node, (ast.For, ast.AsyncFor)):
        yield node, node.iter
    elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                           ast.GeneratorExp)):
        for gen in node.generators:
            yield node, gen.iter


def _arg(node: ast.Call, name: str, pos: int):
    """The argument passed as keyword ``name`` or at position ``pos``."""
    for k in node.keywords:
        if k.arg == name:
            return k.value
    return node.args[pos] if len(node.args) > pos else None


def _set_to(arg, value) -> bool:
    """``arg`` is given and is not the literal ``value``."""
    return arg is not None and not (isinstance(arg, ast.Constant)
                                    and arg.value is value)


def _torch_op(node: ast.Call, ctx):
    """(op name, function form?) of a torch function call or a method
    call on an expression; None for calls into other modules (numpy's
    ``np.cumsum`` is a left fold, not a hazard)."""
    canon = ctx.imports.resolve(node.func)
    if canon is not None:
        if not canon.startswith("torch."):
            return None
        return canon.rsplit(".", 1)[1], canon.count(".") == 1
    if isinstance(node.func, ast.Attribute):
        return node.func.attr, False
    return None


def _torch_hit(node: ast.Call, ctx):
    """Message for a fused-rounding, atomic or scan op, else None."""
    op = _torch_op(node, ctx)
    if op is None:
        return None
    name, function_form = op
    if name in _ALPHA_OPS and any(k.arg == "alpha" for k in node.keywords):
        return (f"{name}(..., alpha=) in a value-plane module fuses the "
                f"scale into the add and rounds once — multiply, then "
                f"add, as the canonical fold does")
    if name in _FUSED:
        return (f"{name}() in a value-plane module fuses a multiply into "
                f"the add and rounds once — keep the canonical fold's two "
                f"roundings")
    if name in _ATOMIC:
        return (f"{name}() in a value-plane module accumulates through "
                f"atomics in thread-arrival order — fold in a fixed order")
    if name in _ACCUMULATE_POS:
        pos = _ACCUMULATE_POS[name][1 if function_form else 0]
        if _set_to(_arg(node, "accumulate", pos), False):
            return (f"{name}(..., accumulate=) in a value-plane module "
                    f"accumulates through atomics in thread-arrival order "
                    f"— fold in a fixed order")
    if name == "bincount" and _set_to(
            _arg(node, "weights", 1 if function_form else 0), None):
        return ("bincount(weights=) in a value-plane module accumulates "
                "through atomics in thread-arrival order — fold in a "
                "fixed order")
    if name in _SCANS:
        return (f"{name}() on a tensor in a value-plane module is a "
                f"parallel scan that does not round as the left fold "
                f"does — fold in order, or pragma why the values are exact")
    return None


@register_rule
class AccumulationOrderRule(Rule):
    code = "ORD001"
    title = "order-sensitive accumulation in a value-plane module"

    def check(self, ctx):
        if ctx.repro_rel not in VALUE_PLANE:
            return
        set_names = _set_named(ctx.tree)
        for node in ast.walk(ctx.tree):
            for holder, it in _iterables(node):
                if _is_set_expr(it) or (isinstance(it, ast.Name)
                                        and it.id in set_names):
                    yield (holder, 0,
                           "iterating a set in a value-plane module — "
                           "set order is hash order; iterate a sorted() "
                           "or index-ordered sequence instead")
                elif _is_dict_view(it):
                    yield (holder, 0,
                           f"iterating {ast.unparse(it)} without sorted() "
                           f"in a value-plane module ties the fold to "
                           f"insertion order — sort, or pragma why "
                           f"insertion order is canonical")
            if isinstance(node, ast.Call):
                torch_msg = _torch_hit(node, ctx)
                if torch_msg is not None:
                    yield (node, 0, torch_msg)
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "sum" and node.args):
                arg = node.args[0]
                if _is_set_expr(arg) or _is_dict_view(arg):
                    yield (node, 0,
                           "sum() over an unordered collection in a "
                           "value-plane module — accumulation order is "
                           "undefined; sort first")
                elif isinstance(arg, ast.GeneratorExp):
                    elt = arg.elt
                    if isinstance(elt, ast.Constant) \
                            and isinstance(elt.value, int):
                        continue        # sum(1 for ...): pure counting
                    yield (node, 0,
                           "bare sum() over a generator in a value-plane "
                           "module hides a float accumulation order — "
                           "fold explicitly, or pragma the ordered "
                           "iterable it walks")
