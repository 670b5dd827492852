"""The traced run's reading of the profiler: device kernels and the
benchmark's own host spans, from the raw kineto events (no operator tree
is built, so a window of ~100,000 kernels is read in seconds), and the
reductions the per-layer metrics and the ``breakdown`` share.

All times are microseconds on the profiler's clock, which holds the host
spans and the device kernels alike.
"""
from __future__ import annotations

import contextlib
import re

OUTSIDE = "outside the spans"


@contextlib.contextmanager
def profiled(enabled: bool, device: str = "cuda"):
    """``torch.profiler`` over the host and the CUDA device while the
    block runs (the host alone for a CPU run), or nothing. Yields a dict
    that holds, once the block has ended, ``kernels`` [(name, start_us,
    end_us)] and ``spans`` [(name, start_us, end_us)]: every host span of
    ``torch.profiler.record_function``, the benchmark's and the
    program's."""
    out: dict = {}
    if not enabled:
        yield out
        return
    import torch
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU]
    on_card = device.startswith("cuda")
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield out
        if on_card:
            torch.cuda.synchronize()
    kernels, spans = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                kernels.append((e.name(), start, end))
        elif e.is_user_annotation():
            spans.append((e.name(), start, end))
    kernels.sort(key=lambda k: k[1])
    spans.sort(key=lambda s: s[1])
    out["kernels"], out["spans"] = kernels, spans


def in_window(kernels, lo: float, hi: float):
    """The kernels that start inside [lo, hi]."""
    return [k for k in kernels if lo <= k[1] <= hi]


def busy_intervals(kernels) -> list[tuple[float, float]]:
    """The union of the kernels' spans, as sorted disjoint intervals."""
    out: list[list[float]] = []
    for _, s, e in sorted(kernels, key=lambda k: k[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(kernels) -> float:
    return sum(e - s for s, e in busy_intervals(kernels))


def device_us(kernels, pattern: str) -> float:
    """Summed device time of the kernels whose name matches ``pattern``
    (a regular expression, searched)."""
    rx = re.compile(pattern)
    return sum(e - s for name, s, e in kernels if rx.search(name))


def short_name(name: str, width: int = 80) -> str:
    """A kernel's name without its return type, anonymous namespace,
    arguments and template arguments, cut to ``width`` characters."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return ("".join(out).strip() or name)[:width]


def breakdown(kernels, spans, lo: float, hi: float, top: int = 10) -> dict:
    """The device operations that took most time, summed by name, and the
    device's idle time inside [lo, hi], summed by the span the host was in
    at the middle of each gap; at most ``top`` entries each, in seconds."""
    by_op: dict[str, float] = {}
    for name, s, e in kernels:
        key = short_name(name)
        by_op[key] = by_op.get(key, 0.0) + (e - s) / 1e6
    idle: dict[str, float] = {}
    spans = sorted(spans, key=lambda sp: sp[1])
    nxt, active = 0, []
    cursor = lo
    for s, e in busy_intervals(kernels) + [(hi, hi)]:
        s, e = max(s, lo), min(e, hi)
        if s > cursor:
            t = (cursor + s) / 2          # the gaps come in time order
            while nxt < len(spans) and spans[nxt][1] <= t:
                active.append(spans[nxt])
                nxt += 1
            active = [sp for sp in active if sp[2] >= t]
            key = min(active, key=lambda sp: sp[2] - sp[1])[0] if active \
                else OUTSIDE
            idle[key] = idle.get(key, 0.0) + (s - cursor) / 1e6
        cursor = max(cursor, e)
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in order(by_op)],
            "idle_gaps": [[k, v] for k, v in order(idle)]}


def idle_pct(tr: dict | None) -> float | None:
    """The traced window's share with no kernel running, in %."""
    if tr is None or tr["window_s"] <= 0 or not tr["kernels"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
