"""The fold kernel's share of its roofline: the least time of every fold
wave of the traced rounds (``cost.wave_cost``: bytes at 3.35 TB/s, or the
weighted route's f64 operations at 34 TFLOP/s where they take longer),
over the fold launches' device time, in %."""
from perfbench import trace

KERNELS = r"fedavg_(fold|carry)_kernel"


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    busy = trace.device_us(tr["kernels"], KERNELS) / 1e6
    bound = rec["work"].get("fold_bound_s", 0.0) * tr["rounds"]
    if busy <= 0 or bound <= 0:
        return None
    return 100.0 * bound / busy
