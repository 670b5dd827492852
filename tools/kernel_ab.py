#!/usr/bin/env python3
"""Time the port's kernels against a baseline version of their sources, in
one process on one NVIDIA GPU.

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/base
    python3 tools/kernel_ab.py --kernels topk_sparsify \\
        --baseline build/base/src/repro_torch/kernels/csrc

Both sides run through the port's own wrappers. For the baseline side,
:mod:`repro_torch.kernels.build` is pointed at the baseline's directory, so
its sources build with the port's flags (under a hash of their own) and
the wrappers bind their launchers from it: a baseline source must keep the
C signature of the launcher its wrapper binds. Each case runs at the main
path's shape, is held against the plain PyTorch version on both sides
(bit for bit, rmsnorm to one bf16 ulp), then timed by device time per call
under ``torch.profiler``, in turns (baseline, repo, repo, baseline), beside
a ``copy_`` of the case's input as the card's floor for one pass of that
size. The last line is a JSON object of the readings, in µs.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHARD = 33_500_000       # one VGG-16 shard: 134 M f32 / 4
TOPK_K = 128
ROWS, D = 512, 2048      # the trainer's norm: batch 8 x sequence 64, d_model
CALLS = 50               # profiled calls a reading


def device_us(fn) -> float:
    """Device time per call of ``fn``, every kernel it launches, over
    CALLS calls under the profiler; a profile that recorded nothing is
    taken again, twice at most."""
    import torch
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if times:
            return sum(times) / CALLS
    raise RuntimeError("the profiler recorded no device activity")


def cases(kernels: list[str]):
    """(kernel, label, input, call, check) at the main path's shapes; check
    takes the call's result and says whether it matches the plain
    version."""
    import torch
    from repro_torch.kernels import quantize as q
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import topk_sparsify as tk

    gen = torch.Generator(device="cuda").manual_seed(14)
    bits = lambda t: t.view(torch.int32)
    if "topk_sparsify" in kernels:
        uni = torch.rand(SHARD, generator=gen, device="cuda")
        for label, x in (
                ("gaussian", torch.randn(SHARD, generator=gen, device="cuda")),
                ("cauchy", torch.tan(torch.pi * (uni - 0.5))),
                ("misaligned", torch.randn(SHARD + 3, generator=gen,
                                           device="cuda")[3:])):
            want = bits(tk.topk_plain(x, TOPK_K))
            yield ("topk_sparsify", label, x,
                   (lambda x: lambda: tk.topk_sparsify(x, TOPK_K))(x),
                   (lambda w: lambda got: torch.equal(bits(got), w))(want))
        del uni
    if "quantize" in kernels or "dequantize" in kernels:
        x = torch.randn(SHARD, generator=gen, device="cuda")
        codes, scales = q.quantize_plain(x)
        if "quantize" in kernels:
            yield ("quantize", "gaussian", x, lambda: q.quantize(x),
                   lambda got: torch.equal(got[0], codes)
                   and torch.equal(bits(got[1]), bits(scales)))
        if "dequantize" in kernels:
            want = bits(q.dequantize_plain(codes, scales))
            yield ("dequantize", "gaussian", codes,
                   lambda: q.dequantize(codes, scales),
                   lambda got: torch.equal(bits(got), want))
    if "rmsnorm" in kernels:
        xb = torch.randn(ROWS, D, generator=gen, device="cuda").bfloat16()
        gamma = torch.randn(D, generator=gen, device="cuda")
        want, want_rstd = rn.rmsnorm_plain(xb, gamma)

        def within(got):
            out, rstd = got
            # one bf16 ulp: adjacent bf16 values differ by one in their bits
            ulps = (out.view(torch.int16).int() - want.view(torch.int16).int())
            return bool(ulps.abs().max() <= 1) and bool(
                ((rstd - want_rstd).abs() <= 1e-5 * want_rstd.abs()).all())
        yield ("rmsnorm", "bf16 x, f32 gamma", xb,
               lambda: rn.rmsnorm(xb, gamma), within)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, type=pathlib.Path,
                    help="directory holding the baseline's <kernel>.cu")
    ap.add_argument("--kernels", default="topk_sparsify",
                    help="comma-separated, of topk_sparsify, quantize, "
                         "dequantize, rmsnorm")
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: no CUDA device")
    from repro_torch.kernels import build
    from repro_torch.kernels import quantize, rmsnorm, topk_sparsify
    wrappers = (quantize, rmsnorm, topk_sparsify)
    sides = {"baseline": args.baseline.resolve(), "repo": build.CSRC}

    def use(side: str) -> None:
        build.CSRC = sides[side]
        for mod in wrappers:
            mod._launcher.cache_clear()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    readings = {"card": card, "us": {}}
    for kernel, label, x, call, check in cases(kernels):
        for side in sides:
            use(side)
            if not check(call()):
                sys.exit(f"kernel_ab: {kernel} ({side}) differs from the "
                         f"plain version on {label}")
        times = {side: [] for side in sides}
        for side in ("baseline", "repo", "repo", "baseline"):
            use(side)
            times[side].append(device_us(call))
        dst = torch.empty_like(x)
        times["copy_"] = [device_us(lambda: dst.copy_(x))]
        readings["us"][f"{kernel} {label}"] = times
        print(f"{kernel} {label}: {times} us", flush=True)
    use("repo")
    print(json.dumps(readings))


if __name__ == "__main__":
    main()
