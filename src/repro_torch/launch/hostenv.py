"""Host-side clock and process-bootstrap helpers for the launch scripts.

Two things live here, both deliberately *outside* the event-time planes:

* :func:`host_timer` — the one wall-clock read of the launchers. The
  simulators (``core/``, ``serverless/``) know time only through the
  deterministic event heap; the launchers time *real* work (training
  steps, token decode) and route every such read through this helper.
  A caller times device work by synchronising the device before each
  read.

* :func:`maybe_preload_tcmalloc` — re-exec the interpreter under
  ``LD_PRELOAD=libtcmalloc`` (plus the large-alloc-report silencer) when
  a tcmalloc is installed and not already preloaded. glibc malloc
  serializes the multi-gigabyte host fold allocations the launchers make;
  tcmalloc's thread caches are faster for the ``ParallelFoldPool`` span
  workers. Called only under ``__main__`` guards — never at import, so
  pytest and library users are never re-exec'd.
"""

from __future__ import annotations

import os
import sys
import time

from repro_torch import knobs


def host_timer() -> float:
    """Seconds on a monotonic host clock, for durations of real work.

    Event-plane code must never call this — simulated time comes from
    the event heap (``serverless.event_sim``).
    """
    return time.perf_counter()


#: where distro packages put tcmalloc (checked in order)
_TCMALLOC_PATHS = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/libtcmalloc.so.4",
    "/usr/lib/libtcmalloc_minimal.so.4",
)


def find_tcmalloc() -> str | None:
    for p in _TCMALLOC_PATHS:
        if os.path.exists(p):
            return p
    return None


def maybe_preload_tcmalloc() -> bool:
    """Re-exec under ``LD_PRELOAD=libtcmalloc`` when available.

    Returns False without side effects when tcmalloc is absent, already
    preloaded, or disabled via ``REPRO_TCMALLOC=off``. On success the
    call never returns (the process is replaced); the environment
    survives the exec.
    """
    if knobs.env_tcmalloc().strip().lower() in ("0", "off", "false", "no"):
        return False
    lib = find_tcmalloc()
    if lib is None:
        return False
    preload = knobs.env_raw("LD_PRELOAD")
    if "tcmalloc" in preload:
        return False
    env = dict(os.environ)
    env["LD_PRELOAD"] = f"{preload}:{lib}" if preload else lib
    # silence tcmalloc's large-alloc warnings for multi-GB fold buffers
    env.setdefault("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD", "60000000000")
    try:
        os.execve(sys.executable, [sys.executable] + sys.argv, env)
    except OSError:
        return False
