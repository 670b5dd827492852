"""ENV001 — environment access outside ``repro_torch/knobs.py``.

Contract: ``repro_torch.knobs`` is the single module that reads process
environment variables; everything else takes explicit arguments or calls
a ``knobs.env_*`` reader. Scattered ``os.environ``/``os.getenv`` reads
make a config's provenance untraceable and break
``SessionConfig.from_env``'s snapshot guarantee (a config must be immune
to later env changes). Launcher-side *mutations* that must precede
interpreter state (e.g. the ``LD_PRELOAD`` re-exec) are the only
sanctioned exceptions — each carries a pragma with
its reason.
"""

from __future__ import annotations

import ast

from repro_torch.detlint.engine import Rule, register_rule

_ENV_CALLS = frozenset({"os.getenv", "os.putenv", "os.unsetenv"})


@register_rule
class EnvOutsideKnobsRule(Rule):
    code = "ENV001"
    title = "os.environ / os.getenv outside repro_torch/knobs.py"

    def check(self, ctx):
        if not ctx.in_repro() or ctx.repro_rel == "knobs.py":
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.Attribute, ast.Name)):
                if ctx.imports.resolve(node) == "os.environ":
                    yield (node, 0,
                           "os.environ access outside repro_torch/knobs.py — "
                           "route env reads through a repro_torch.knobs "
                           "reader (knobs is the single env home)")
            elif isinstance(node, ast.Call):
                canon = ctx.imports.resolve(node.func)
                if canon in _ENV_CALLS:
                    yield (node, 0,
                           f"{canon}() outside repro_torch/knobs.py — route "
                           f"env reads through a repro_torch.knobs reader")
