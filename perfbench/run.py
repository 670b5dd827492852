"""The port's benchmark: one run of one cell, one JSON line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``, on a machine
with as many CUDA cards as the cell asks for. The run sets up the cell
(``perfbench/cells/<cell>.json``) from the seed, drives its entry point
closed-loop for ``--seconds``, checks what the window produced against the
plain reference (``perfbench/reference``), and prints the result as the
last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``, then ``checks``:
each number compared with its limit. The same numbers close standard
error. With no card, too few cards, or JAX or the JAX package loaded once
the window has closed, it exits with 1 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: top-level module names that may not be loaded in the measuring process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Compile caches at fixed paths inside the checkout, and no JAX
    behind a library's back. Set before torch is imported."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name, whole, is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def power_limit_w() -> float | None:
    """The card's power limit, from ``nvidia-smi`` (None when it cannot
    be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def result_line(rec: dict, metrics: dict, chips: int, kind: str,
                power_w: float | None) -> dict:
    """The run's result in the contract's keys, ``checks`` last."""
    correct = all(v <= lim for v, lim in rec["checks"].values())
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": rec["peak_bytes"],
              "power_limit_w": power_w}
    out = {"correct": bool(correct), "attempted": rec["rounds"],
           "failed": 0, "metrics": metrics, "device": device}
    if rec["trace"] is not None:
        device["busy_s"] = rec["trace"]["busy_s"]
        device["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = rec["trace"]["breakdown"]
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in rec["checks"].items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _environment()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import harness, spec
    loaded = spec.load_cell(args.workload)
    entries = spec.metrics_of(spec.benchmark(), args.workload,
                              bool(args.trace))
    chips = int(loaded["cell"]["chips"])

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails here without the program)
    torch.set_num_threads(1)      # the card's host is shared: few threads
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    rec = harness.run_cell(loaded, args.seed, args.seconds,
                           bool(args.trace), t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 1
    metrics = harness.metrics(rec, entries)
    line = result_line(rec, metrics, chips, torch.cuda.get_device_name(0),
                       power_limit_w())
    for name, (value, limit) in rec["checks"].items():
        print(f"check {name} = {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
