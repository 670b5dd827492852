"""The share of the traced window of federated training rounds in which no
kernel ran on the device (one minus the union of the kernels' spans over
the window), in %."""
from perfbench import trace


def read(rec):
    return trace.idle_pct(rec["trace"])
