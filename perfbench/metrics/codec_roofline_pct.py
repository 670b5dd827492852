"""The qsgd8 codec kernels' share of their roofline: the least time of
quantizing and dequantizing every client gradient of the traced rounds
(``cost.codec_bound_s``: 5 bytes an element each way, at 3.35 TB/s), over
the quantize and dequantize launches' device time, in %."""
from perfbench import trace

KERNELS = r"quantize_kernel"      # quantize_kernel and dequantize_kernel


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    busy = trace.device_us(tr["kernels"], KERNELS) / 1e6
    bound = rec["work"].get("codec_bound_s", 0.0) * tr["rounds"]
    if busy <= 0 or bound <= 0:
        return None
    return 100.0 * bound / busy
