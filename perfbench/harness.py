"""One run of one cell: set-up, the measured window, the output check and
the record the metric readers take.

The cell's driver (``drivers/<kind>.py``) holds everything particular to
its kind of work. Its ``Driver(config, traffic, seed, device)`` makes the
inputs from the seed, builds the program's objects and warms up every
shape the window uses; ``round(r)`` runs one unit of the closed loop and
ends in a device synchronisation; ``work()`` gives a round's work and least times;
``release()`` frees the program's state and ``check()`` then holds what the
window produced against the plain reference, as ``{name: (value,
limit)}``, each value within its limit when correct.
"""
from __future__ import annotations

import gc
import sys
import time

from perfbench import spec, trace

#: the harness's own span around each round of the window
ROUND_SPAN = "window.round"


def _sync(device: str) -> None:
    import torch
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def counters() -> dict:
    """Every launch counter of the program's loaded modules (a module-level
    integer whose name ends in ``LAUNCHES``), by ``module.NAME``."""
    out = {}
    for name, mod in list(sys.modules.items()):
        if name.startswith("repro_torch.") and mod is not None:
            for attr, value in vars(mod).items():
                if attr.endswith("LAUNCHES") and type(value) is int:
                    out[f"{name}.{attr}"] = value
    return out


def _peak_bytes(device: str) -> int:
    import torch
    if device.startswith("cuda"):
        return int(torch.cuda.max_memory_allocated())
    return 0


def run_cell(loaded: dict, seed: int, seconds: float, traced: bool, *,
             t_start: float, device: str = "cuda") -> dict:
    """Set up, measure and check one run of the loaded cell
    (``spec.load_cell``); returns the record (see the module's docstring)
    with ``checks``. ``t_start`` is the host clock at process start.

    The window is the same traced or not: its rounds, walls, length and
    counters are the record's. A traced run then runs the mix's
    ``trace_rounds`` more under the profiler, and ``trace`` holds those
    (with their count, ``rounds``)."""
    mix = loaded["traffic"]
    drv = spec.driver(mix["kind"]).Driver(loaded["config"], mix, seed, device,
                     loaded["cell"].get("limits", {}))
    _sync(device)
    setup_s = time.perf_counter() - t_start

    # set-up's objects are out of the collector's reach while the windows
    # run: a collection there walks only the windows' own objects
    gc.collect()
    gc.freeze()
    before = counters()
    r, walls, window_s = _window(drv, drv.first_round, seconds)
    after = counters()
    tr, traced_rounds = None, 0
    if traced:
        # a window of its own under the profiler, after the timed one, so
        # that no host-clock reading pays for the profiler
        with trace.profiled(True, device) as tr:
            drv.round(r)          # the first call under the profiler can
            r += 1                # lose kernels
            r, t_walls, _ = _window(drv, r, seconds, mix.get("trace_rounds"))
        traced_rounds = len(t_walls)
    gc.unfreeze()
    peak = _peak_bytes(device)
    drv.release()
    checks = drv.check()

    rec = {"cell": loaded["name"], "config": loaded["config"],
           "traffic": mix, "seed": seed, "device": device,
           "setup_s": setup_s, "window_s": window_s, "rounds": len(walls),
           "round_walls_s": walls, "peak_bytes": peak,
           "counters": {k: after[k] - before.get(k, 0) for k in after},
           "work": drv.work(), "checks": checks, "trace": None}
    if traced:
        rec["trace"] = dict(_reduce_trace(tr), rounds=traced_rounds)
    return rec


def _window(drv, r: int, seconds: float, limit: int | None = None):
    """Whole rounds back to back from round ``r`` until ``seconds`` have
    passed (or ``limit`` rounds have run): the next round, each round's
    host wall and the window's length, from the first round's start to
    the last one's end."""
    import torch
    walls: list[float] = []
    t_w0 = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        with torch.profiler.record_function(ROUND_SPAN):
            drv.round(r)
        t1 = time.perf_counter()
        walls.append(t1 - t0)
        r += 1
        if t1 - t_w0 >= seconds or (limit and len(walls) >= limit):
            return r, walls, t1 - t_w0


def _reduce_trace(tr: dict) -> dict:
    """The traced window: its kernels and spans, its bounds on the
    profiler's clock, busy and window seconds and the breakdown."""
    rounds = [s for s in tr["spans"] if s[0] == ROUND_SPAN]
    lo, hi = rounds[0][1], rounds[-1][2]
    kernels = trace.in_window(tr["kernels"], lo, hi)
    spans = [s for s in tr["spans"] if s[1] >= lo and s[2] <= hi]
    return {"kernels": kernels, "spans": spans, "lo": lo, "hi": hi,
            "busy_s": trace.busy_us(kernels) / 1e6,
            "window_s": (hi - lo) / 1e6,
            "breakdown": trace.breakdown(kernels, spans, lo, hi)}


def metrics(rec: dict, entries: list[dict]) -> dict:
    """Each listed metric read from the record; a reader that finds
    nothing to read returns None, and the metric is left out."""
    out = {}
    for m in entries:
        value = spec.metric_reader(m["name"])(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
