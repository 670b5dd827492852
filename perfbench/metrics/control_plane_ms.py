"""The aggregation round's control plane: the host's time inside the
program's aggregation-round spans (``agg.*``, the union of their
intervals), less the part of it inside the wire codec's and the fold
kernel's spans (``codec.*``, ``fold.*``), a traced round, in ms. None
where the trace holds no ``agg.*`` span (a program without spans)."""
from perfbench import spans


def read(rec):
    tr = rec["trace"]
    if tr is None or not tr["rounds"]:
        return None
    agg = spans.union(tr["spans"], ("agg.",))
    if not agg:
        return None
    inner = spans.union(tr["spans"], ("codec.", "fold."))
    self_us = spans.length(agg) - spans.covered(agg, inner)
    return self_us / 1e3 / tr["rounds"]
