"""Readings that set a cell's limits: the program's sound runs over many
seeds, and the control and the planted faults over a few, at the cell's
own size, in one process (the card and the program load once).

    python3 -m perfbench.calibrate --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--seconds 2]

Each reading is one JSON line on standard output: ``{"cell", "seed",
"what", "checks": {name: value}}``, ``what`` being ``program`` (a run of
the harness, short window), ``control`` (the plain reference one
precision below the configured one, put in the program's place) or a
fault planted in that reference (``half_batch``, ``altered``). The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from perfbench import run as bench_run


def _line(cell: str, seed: int, what: str, checks: dict,
          seconds: float) -> None:
    print(json.dumps({"cell": cell, "seed": seed, "what": what,
                      "checks": checks, "seconds": seconds}), flush=True)


def agg_controls(loaded: dict, seed: int, device: str) -> dict:
    """Mismatched elements of the bf16 (f64 → f32) reference against the
    configured one, over the rounds a run checks."""
    from perfbench import inputs
    from perfbench.reference import fold
    mix, n = loaded["traffic"], loaded["traffic"]["n_clients"]
    grads = inputs.client_grads(seed, n, loaded["config"]["params"],
                                mix["grad_scale"], device)
    worst = 0
    for r in range(mix["warmup_rounds"], mix["warmup_rounds"] + 2):
        xs = [grads[i] for i in inputs.client_order(seed, r, n)]
        want = fold.round_mean(xs, mix["topology"], mix["codec"],
                               mix["n_shards"])
        got = fold.round_mean(xs, mix["topology"], mix["codec"],
                              mix["n_shards"], lower=True)
        worst = max(worst, fold.mismatches(got, want))
    return {"control": {"mismatched_elements": worst}}


def fedlm_controls(loaded: dict, seed: int, device: str) -> dict:
    """The three numbers of the control and of each planted fault, against
    the configured reference over the rounds a run checks."""
    from perfbench.drivers import fedlm_round
    from perfbench.reference import gpt2
    cfg, mix = loaded["config"], loaded["traffic"]
    rounds = mix["check_rounds"]
    want = gpt2.follow(cfg, mix, seed, device, rounds)
    out = {}
    for what, kw in (("control", {"lower": True}),
                     ("half_batch", {"fault": "half_batch"}),
                     ("altered", {"fault": "altered"})):
        got = gpt2.follow(cfg, mix, seed, device, rounds, **kw)
        checks = fedlm_round.compare(
            got["losses"], got["grad_norms"], got["change_norms"], want,
            {"loss_gap": 0, "grad_norm_gap": 0, "change_norm_gap": 0})
        out[what] = {k: v for k, (v, _) in checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    bench_run._environment()
    sys.path[:0] = [str(bench_run.ROOT), str(bench_run.ROOT / "src")]
    from perfbench import harness, spec
    import torch
    if not torch.cuda.is_available():
        print("perfbench.calibrate: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in seeds:
        loaded = spec.load_cell(args.workload)
        t0 = time.perf_counter()
        rec = harness.run_cell(loaded, seed, args.seconds, False,
                               t_start=t0)
        _line(args.workload, seed, "program",
              {k: v for k, (v, _) in rec["checks"].items()},
              time.perf_counter() - t0)
        del rec
        torch.cuda.empty_cache()
    for seed in controls:
        loaded = spec.load_cell(args.workload)
        kind = loaded["traffic"]["kind"]
        fn = agg_controls if kind == "agg_round" else fedlm_controls
        t0 = time.perf_counter()
        for what, checks in fn(loaded, seed, "cuda").items():
            _line(args.workload, seed, what, checks,
                  time.perf_counter() - t0)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
