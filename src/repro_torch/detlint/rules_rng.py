"""DET001 — unseeded randomness inside the repro_torch package.

Contract: every random draw in the aggregation stack flows from an
explicit ``(seed, round, stream)`` key (``serverless.streams``,
``np.random.default_rng(seed)``, a ``torch.Generator`` seeded by the
caller). Module-level RNG state draws from process-global or OS entropy
and silently breaks the replay guarantees every schedule/fault/population
stream depends on. That covers:

* the ``np.random.*`` convenience functions and an argless
  ``default_rng()``;
* the stdlib ``random`` module (``random.Random(seed)`` excepted);
* torch's samplers called without ``generator=`` (``torch.randn``,
  ``torch.multinomial``, the in-place ``Tensor.normal_`` family, the
  ``torch.nn.init`` samplers): they draw from torch's default generator,
  which any other caller in the process advances;
* torch's global seeding (``torch.manual_seed``, ``torch.seed``,
  ``torch.cuda.manual_seed[_all]``): a module that reseeds the default
  generator changes every other module's draws.
"""

from __future__ import annotations

import ast

from repro_torch.detlint.engine import Rule, register_rule

#: numpy.random attributes that *construct seeded streams* — fine to call
#: (argless default_rng is handled separately)
_SEEDED_CTORS = frozenset({
    "default_rng", "Generator", "SeedSequence", "BitGenerator",
    "PCG64", "PCG64DXSM", "Philox", "MT19937", "SFC64",
})

#: stdlib ``random`` attributes that are fine to call with a seed argument
_STDLIB_SEEDED_CTORS = frozenset({"Random"})

#: ``torch.<name>`` samplers that draw from the default generator unless
#: handed one
_TORCH_SAMPLERS = frozenset({
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "normal", "bernoulli", "multinomial", "poisson",
})

#: in-place ``Tensor`` samplers (method form, any receiver)
_INPLACE_SAMPLERS = frozenset({
    "uniform_", "normal_", "bernoulli_", "random_", "exponential_",
    "geometric_", "cauchy_", "log_normal_",
})

#: ``torch.nn.init`` functions that draw (the constant fills do not)
_INIT_SAMPLERS = frozenset({
    "uniform_", "normal_", "trunc_normal_", "xavier_uniform_",
    "xavier_normal_", "kaiming_uniform_", "kaiming_normal_",
    "orthogonal_", "sparse_",
})

#: calls that seed torch's process-global generators
_TORCH_GLOBAL_SEEDING = frozenset({
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
    "torch.random.seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all",
})


def _has_generator(node: ast.Call) -> bool:
    """An explicit ``generator=`` that is not the literal None (None
    selects the default generator)."""
    return any(k.arg == "generator"
               and not (isinstance(k.value, ast.Constant)
                        and k.value.value is None)
               for k in node.keywords)


def _torch_hit(node: ast.Call, canon: str | None):
    """Message for an unseeded torch draw or a global reseed, else None."""
    if canon in _TORCH_GLOBAL_SEEDING:
        return (f"{canon}() reseeds torch's process-global generator — "
                f"draw from a torch.Generator seeded by the caller")
    if canon is not None and canon.startswith("torch.nn.init."):
        name = canon.rsplit(".", 1)[1]
        if name in _INIT_SAMPLERS and not _has_generator(node):
            return (f"{canon}() without generator= draws from torch's "
                    f"default generator — pass a seeded torch.Generator")
        return None
    if canon is not None and canon.startswith("torch.") \
            and canon.count(".") == 1:
        name = canon.split(".", 1)[1]
        if name in _TORCH_SAMPLERS and not _has_generator(node):
            return (f"{canon}() without generator= draws from torch's "
                    f"default generator — pass a seeded torch.Generator")
        return None
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in _INPLACE_SAMPLERS \
            and not _has_generator(node):
        return (f"in-place .{node.func.attr}() without generator= draws "
                f"from torch's default generator — pass a seeded "
                f"torch.Generator")
    return None


@register_rule
class UnseededRngRule(Rule):
    code = "DET001"
    title = "unseeded RNG (module-level np.random / stdlib random / " \
            "torch's default generator)"

    def check(self, ctx):
        if not ctx.in_repro():
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            canon = ctx.imports.resolve(node.func)
            torch_msg = _torch_hit(node, canon)
            if torch_msg is not None:
                yield (node, 0, torch_msg)
                continue
            if canon is None:
                continue
            if canon.startswith("numpy.random."):
                attr = canon.split(".", 2)[2]
                if attr == "default_rng":
                    if not node.args and not node.keywords:
                        yield (node, 0,
                               "argless default_rng() seeds from OS "
                               "entropy — pass an explicit seed")
                elif attr not in _SEEDED_CTORS:
                    yield (node, 0,
                           f"module-level numpy.random.{attr}() draws "
                           f"from global RNG state — use a seeded "
                           f"default_rng(seed) / streams key instead")
            elif canon.startswith("random.") and canon.count(".") == 1:
                attr = canon.split(".", 1)[1]
                if attr in _STDLIB_SEEDED_CTORS:
                    if not node.args and not node.keywords:
                        yield (node, 0,
                               "argless random.Random() seeds from OS "
                               "entropy — pass an explicit seed")
                else:
                    yield (node, 0,
                           f"stdlib random.{attr}() uses process-global "
                           f"RNG state — use a seeded "
                           f"np.random.default_rng(seed) instead")
