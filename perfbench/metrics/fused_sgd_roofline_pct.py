"""The fused SGD-momentum kernel's share of its roofline: 20 bytes a
parameter of every local step of the traced rounds at 3.35 TB/s
(``cost.fused_sgd_bound_s``), over the kernel's device time, in %."""
from perfbench import trace

KERNELS = r"fused_sgd"


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    busy = trace.device_us(tr["kernels"], KERNELS) / 1e6
    bound = rec["work"].get("fused_sgd_bound_s", 0.0) * tr["rounds"]
    if busy <= 0 or bound <= 0:
        return None
    return 100.0 * bound / busy
