"""The attention kernels' share of the card's bf16 peak: 3 × the causal
forward products (QKᵀ and PV) of every traced local step, as
``cost.model_flops_train`` counts them with no parameters, over the
kernels' device time × 989 TFLOP/s, in %. The kernels recompute products
(14 causal-half products a layer against the 3 × 2 counted), so it reads
low. None where the trace holds no ``causal_attention_*`` kernel."""
from perfbench import cost, trace

KERNELS = r"causal_attention_"


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    busy = trace.device_us(tr["kernels"], KERNELS) / 1e6
    c, mix = rec["config"], rec["traffic"]
    if busy <= 0 or "n_layer" not in c:
        return None
    steps = tr["rounds"] * mix["clients"] * mix["local_steps"]
    flops = steps * cost.model_flops_train(
        0, c["n_layer"], c["n_head"], c["n_embd"] // c["n_head"],
        mix["batch"], mix["seq"])
    return 100.0 * flops / (busy * cost.BF16_FLOPS)
