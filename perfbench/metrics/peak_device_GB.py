"""``torch.cuda.max_memory_allocated()`` from process start to the
window's end, before the output check runs, in GB (1e9 bytes)."""


def read(rec):
    return rec["peak_bytes"] / 1e9 if rec["peak_bytes"] else None
