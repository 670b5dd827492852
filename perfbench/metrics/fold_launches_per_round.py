"""Fold-kernel launches a round: ``fedavg_stream.LAUNCHES`` over the
window, over its rounds."""

COUNTER = "repro_torch.kernels.fedavg_stream.LAUNCHES"


def read(rec):
    n = rec["counters"].get(COUNTER, 0)
    return n / rec["rounds"] if n and rec["rounds"] else None
