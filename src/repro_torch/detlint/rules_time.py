"""DET002 — wall-clock reads inside the repro_torch package.

Contract: the event-time planes (``core/``, ``serverless/``) know time
only through the deterministic event heap (``serverless.event_sim``);
simulated walls, billing and schedules must replay bit-identically on any
host, so ``time.time()``/``perf_counter()``/``datetime.now()`` are banned
there outright. Host-side code (launchers, benchmarks-in-package) times
real work through the one blessed helper,
``repro_torch.launch.hostenv.host_timer()`` — which carries the single
suppression for this rule, with its reason.
"""

from __future__ import annotations

import ast

from repro_torch.detlint.engine import Rule, register_rule

_WALL_CLOCK = frozenset({
    "time.time", "time.time_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "time.monotonic", "time.monotonic_ns",
    "time.process_time", "time.process_time_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
})

#: the planes where simulated time is the only time
_EVENT_PLANES = ("core/", "serverless/")


@register_rule
class WallClockRule(Rule):
    code = "DET002"
    title = "wall-clock read (event planes must use the event heap)"

    def check(self, ctx):
        if not ctx.in_repro():
            return
        in_event_plane = ctx.in_repro(*_EVENT_PLANES)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            canon = ctx.imports.resolve(node.func)
            if canon in _WALL_CLOCK:
                if in_event_plane:
                    yield (node, 0,
                           f"{canon}() inside the event-time plane — "
                           f"simulated time comes from the event heap "
                           f"(serverless.event_sim), never the host clock")
                else:
                    yield (node, 0,
                           f"{canon}() — host-side timing goes through "
                           f"repro_torch.launch.hostenv.host_timer()")
