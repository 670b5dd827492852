"""The model steps' share of the card's bf16 peak: ``cost.py``'s train
FLOPs of every local step of the window's rounds (6 · N · tokens plus the
causal attention term, recomputation not counted), over the window's
host-clock length × 989 TFLOP/s, in %. A traced run reads the same
window, which runs before the profiler starts."""
from perfbench import cost


def read(rec):
    flops = rec["work"].get("model_flops", 0.0) * rec["rounds"]
    if flops <= 0:
        return None
    return 100.0 * flops / (rec["window_s"] * cost.BF16_FLOPS)
