"""RoPE-kernel launches a local step: ``rope.LAUNCHES`` over the window,
over its rounds × clients × local steps. Where every layer's q and k take
the kernel it reads layers × 4 (q and k, one forward and one backward
launch each); None where the program has no such counter or nothing
launched."""

COUNTER = "repro_torch.kernels.rope.LAUNCHES"


def read(rec):
    n = rec["counters"].get(COUNTER, 0)
    mix = rec["traffic"]
    steps = rec["rounds"] * mix.get("clients", 0) * mix.get("local_steps", 0)
    return n / steps if n and steps else None
