#!/usr/bin/env python3
"""Time the port's kernels against a baseline version of their sources, in
one process on one NVIDIA GPU.

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/base
    python3 tools/kernel_ab.py --kernels fused_sgd,fedavg_carry \\
        --baseline build/base/src/repro_torch/kernels/csrc

Both sides run through the port's own wrappers. For the baseline side,
:mod:`repro_torch.kernels.build` is pointed at the baseline's directory, so
its sources build with the port's flags (under a hash of their own) and
the wrappers bind their launchers from it: a baseline source must keep the
C signature of the launcher its wrapper binds. The one exception is
``fedavg_carry``, the fold's carry form at the population's chunk: a
baseline source without the carry route (``fedavg_carry_launch``) runs the
call on its table kernel (``fedavg_fold_launch``, the table built and
copied to the card once, outside the timing). Each case runs at the main
path's shape, is held against the plain PyTorch version on both sides
(bit for bit, rmsnorm to one bf16 ulp), then timed by device time per call
(``chip_smoke.counted_device_ms``: the case's kernels by name, from
profiles that recorded each of them; the repo's kernels a call are known,
a baseline's are as many as a profile of one call records), in turns
(baseline, repo, repo, baseline), beside a ``copy_`` of the case's input
as the card's floor for one pass of that size, or beside the one PyTorch
call that computes the same function (``torch.optim.SGD(fused=True)
.step()`` for fused_sgd, ``torch.sum`` over the chunk for fedavg_carry).
The last line is a JSON object of the readings, in µs.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from chip_smoke import counted_device_ms  # noqa: E402

SHARD = 33_500_000       # one VGG-16 shard: 134 M f32 / 4
TOPK_K = 128
ROWS, D = 512, 2048      # the trainer's norm: batch 8 x sequence 64, d_model
LM_ARCH = "tinyllama-1.1b"
LR, MOMENTUM = 0.05, 0.9  # the trainer's full-width lr and momentum
CHUNK, ELEMS = 512, 4096  # a population chunk: 512 rows of 4,096 elements
KERNELS = ("topk_sparsify", "quantize", "dequantize", "rmsnorm", "fused_sgd",
           "fedavg_carry")
#: each case's kernels by name in the profile (``fedavg_``: the carry
#: kernel, or the table kernel of a source without the carry route)
TAGS = {"topk_sparsify": "::topk_kernel", "quantize": "::quantize_kernel",
        "dequantize": "::dequantize_kernel", "rmsnorm": "rmsnorm_kernel",
        "fused_sgd": "fused_sgd", "fedavg_carry": "fedavg_"}
#: the repo's kernels a call of each case (every other case: one)
KERNELS_A_CALL = {"fused_sgd": 12}


def bits(t):
    import torch
    return t.view({torch.float64: torch.int64, torch.bfloat16: torch.int16}
                  .get(t.dtype, torch.int32))


def cases(kernels: list[str]):
    """(kernel, label, make, extras) at the main path's shapes. ``make(side)``
    gives the side's call and a check that runs it against the plain
    version; ``extras`` maps a yardstick's name to its call."""
    import torch
    from repro_torch.kernels import quantize as q
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import topk_sparsify as tk

    gen = torch.Generator(device="cuda").manual_seed(14)

    def same(call, check):
        """A case whose call does not depend on the side."""
        return lambda side: (call, lambda: check(call()))

    def copy_of(x):
        dst = torch.empty_like(x)
        return {"copy_": lambda: dst.copy_(x)}

    if "topk_sparsify" in kernels:
        uni = torch.rand(SHARD, generator=gen, device="cuda")
        for label, x in (
                ("gaussian", torch.randn(SHARD, generator=gen, device="cuda")),
                ("cauchy", torch.tan(torch.pi * (uni - 0.5))),
                ("misaligned", torch.randn(SHARD + 3, generator=gen,
                                           device="cuda")[3:])):
            want = bits(tk.topk_plain(x, TOPK_K))
            yield ("topk_sparsify", label, same(
                (lambda x: lambda: tk.topk_sparsify(x, TOPK_K))(x),
                (lambda w: lambda got: torch.equal(bits(got), w))(want)),
                copy_of(x))
        del uni
    if "quantize" in kernels or "dequantize" in kernels:
        x = torch.randn(SHARD, generator=gen, device="cuda")
        codes, scales = q.quantize_plain(x)
        if "quantize" in kernels:
            yield ("quantize", "gaussian", same(
                lambda: q.quantize(x),
                lambda got: torch.equal(got[0], codes)
                and torch.equal(bits(got[1]), bits(scales))), copy_of(x))
        if "dequantize" in kernels:
            want = bits(q.dequantize_plain(codes, scales))
            yield ("dequantize", "gaussian", same(
                lambda: q.dequantize(codes, scales),
                lambda got: torch.equal(bits(got), want)), copy_of(codes))
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
        yield ("rmsnorm", "bf16 x, f32 gamma", same(
            lambda: rn.rmsnorm(xb, gamma), within), copy_of(xb))
    if "fused_sgd" in kernels:
        yield from sgd_case(gen)
    if "fedavg_carry" in kernels:
        yield from carry_cases(gen)


def sgd_case(gen):
    """One local step's update of the trainer's 12 full-width leaves."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import fused_sgd as sgd
    from repro_torch.models import transformer

    shapes = transformer.param_shapes(get_arch(LM_ARCH).model)
    p = [torch.randn(s, generator=gen, device="cuda") for s in shapes.values()]
    g = [torch.randn(s, generator=gen, device="cuda") for s in shapes.values()]
    v = [torch.randn(s, generator=gen, device="cuda") for s in shapes.values()]

    def step():
        for a, b, c in zip(p, g, v):
            sgd.fused_sgd(a, b, c, LR, MOMENTUM)

    def check():
        for a, b, c in zip(p, g, v):
            want_p, want_v = a.clone(), c.clone()
            sgd.fused_sgd_plain(want_p, b, want_v, LR, MOMENTUM)
            sgd.fused_sgd(a, b, c, LR, MOMENTUM)
            if not (torch.equal(bits(a), bits(want_p))
                    and torch.equal(bits(c), bits(want_v))):
                return False
            del want_p, want_v
        return True

    params = [torch.nn.Parameter(x.clone()) for x in p]
    for param, grad in zip(params, g):
        param.grad = grad
    opt = torch.optim.SGD(params, lr=LR, momentum=MOMENTUM, fused=True)
    opt.step()                          # creates the momentum buffers
    n = sum(x.numel() for x in p)
    yield ("fused_sgd", f"{len(p)} {LM_ARCH} leaves, {n} f32",
           lambda side: (step, check),
           {"torch.optim.SGD(fused=True).step()": opt.step})


def carry_cases(gen):
    """One population chunk continued from a carry, f32 and f64."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import fedavg_stream as fs

    rows = torch.randn(CHUNK, ELEMS, generator=gen, device="cuda")
    dev = rows.device
    for label, w in (("f32 carry", None), ("f64 carry", [1.0] * CHUNK)):
        acc = fs.fold_nodes([(rows, w)], finalize=False)[0]
        want = bits(fs.fedavg_stream_plain(rows, w, carry=acc,
                                           finalize=False))

        def make(side, w=w, acc=acc, want=want):
            if hasattr(build.load("fedavg_stream"), "fedavg_carry_launch"):
                call = lambda: fs.fold_nodes([(rows, w)], carry=[acc],
                                             finalize=False)[0]
                return call, lambda: torch.equal(bits(call()), want)
            # a source without the carry route: its table kernel, as the
            # wrapper of that source launched it, the table made once
            table, outs, max_len = fs._table([(rows, w)], [acc], None, "f64",
                                             False, dev)
            dev_table = torch.from_numpy(table).to(dev)

            def call():
                rc = fs._launcher()(dev_table.data_ptr(), 1, CHUNK, max_len,
                                    0, build.raw_stream(dev.index))
                if rc != 0:
                    raise RuntimeError(f"fedavg_fold_launch: CUDA error {rc}")
                return outs[0]
            return call, lambda: torch.equal(bits(call()), want)
        yield ("fedavg_carry", f"{label}, {CHUNK} x {ELEMS}", make,
               {"torch.sum": lambda: torch.sum(rows, dim=0)})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, type=pathlib.Path,
                    help="directory holding the baseline's <kernel>.cu")
    ap.add_argument("--kernels", default="topk_sparsify",
                    help="comma-separated, of " + ", ".join(KERNELS))
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    unknown = set(kernels) - set(KERNELS)
    if unknown:
        sys.exit(f"kernel_ab: unknown kernels {sorted(unknown)}")
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: no CUDA device")
    from repro_torch.kernels import build
    from repro_torch.kernels import (fedavg_stream, fused_sgd, quantize,
                                     rmsnorm, topk_sparsify)
    launchers = [mod._launcher for mod in (fedavg_stream, fused_sgd, quantize,
                                           rmsnorm, topk_sparsify)]
    launchers.append(fedavg_stream._carry_launcher)
    sides = {"baseline": args.baseline.resolve(), "repo": build.CSRC}

    def use(side: str) -> None:
        build.CSRC = sides[side]
        for launcher in launchers:
            launcher.cache_clear()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    readings = {"card": card, "us": {}}
    for kernel, label, make, extras in cases(kernels):
        calls = {}
        for side in sides:
            use(side)
            calls[side], check = make(side)
            if not check():
                sys.exit(f"kernel_ab: {kernel} ({side}) differs from the "
                         f"plain version on {label}")
        times = {side: [] for side in sides}
        for side in ("baseline", "repo", "repo", "baseline"):
            use(side)
            ms, _ = counted_device_ms(
                calls[side], TAGS[kernel],
                KERNELS_A_CALL.get(kernel, 1) if side == "repo" else None)
            times[side].append(ms * 1e3)
        use("repo")
        for name, fn in extras.items():
            ms, kernels_a_call = counted_device_ms(fn, None, None)
            times[name] = [ms * 1e3]
            times[f"{name} kernels a call"] = [kernels_a_call]
        readings["us"][f"{kernel} {label}"] = times
        print(f"{kernel} {label}: {times} us", flush=True)
    print(json.dumps(readings))


if __name__ == "__main__":
    main()
