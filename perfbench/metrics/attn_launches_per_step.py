"""Attention-kernel launches a local step: ``causal_attention.LAUNCHES``
over the window, over its rounds × clients × local steps. Where every
layer's attention takes the kernel it reads the layers × 3 (one forward
launch and two backward launches a layer); None where the program has no
such counter or nothing launched."""

COUNTER = "repro_torch.kernels.causal_attention.LAUNCHES"


def read(rec):
    n = rec["counters"].get(COUNTER, 0)
    mix = rec["traffic"]
    steps = rec["rounds"] * mix.get("clients", 0) * mix.get("local_steps", 0)
    return n / steps if n and steps else None
