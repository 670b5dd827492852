"""The device's idle share while the host is inside a local step: one
minus the part of the union of the program's model-step spans
(``step.*``) that the union of the kernels' spans covers, over the
union's length, in %. None where the trace holds no ``step.*`` span (a
program without spans) or no kernel."""
from perfbench import spans, trace


def read(rec):
    tr = rec["trace"]
    if tr is None or not tr["kernels"]:
        return None
    step = spans.union(tr["spans"], ("step.",))
    if not step:
        return None
    busy = trace.busy_intervals(tr["kernels"])
    return 100.0 * (1.0 - spans.covered(step, busy) / spans.length(step))
