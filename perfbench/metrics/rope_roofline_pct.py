"""The RoPE kernel's share of its roofline: every traced local step's q and
k rotations, forward and backward, each one read and one write of
B·S·(H + KH)·hd values of the compute type (KH = H where the configuration
names no kv heads), at 3.35 TB/s, over the device time of the kernels
named ``rope_rotate_*``, in %. The table's reads are not counted, so it
reads low, never high. None where the trace holds no such kernel."""
from perfbench import cost, trace

KERNELS = r"rope_rotate_"
SIZES = {"bfloat16": 2, "float16": 2, "float32": 4}


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    busy = trace.device_us(tr["kernels"], KERNELS) / 1e6
    c, mix = rec["config"], rec["traffic"]
    if busy <= 0 or "n_layer" not in c:
        return None
    h = c["n_head"]
    kh = c.get("num_key_value_heads", h)
    size = SIZES[c["port"]["compute_dtype"]]
    steps = tr["rounds"] * mix["clients"] * mix["local_steps"]
    values = mix["batch"] * mix["seq"] * (h + kh) * (c["n_embd"] // h)
    nbytes = steps * c["n_layer"] * 2 * values * 2 * size
    return 100.0 * nbytes / cost.HBM_BPS / busy
