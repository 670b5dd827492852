#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card: ``nvidia-smi`` name and power limit; no CUDA device is an error;
2. build the five kernel sources of ``src/repro_torch/kernels/csrc`` with
   nvcc, one process each, all started together;
3. the fold kernel against its plain PyTorch version on the card, bit for
   bit: every dependency wave of the three topologies at the paper's
   VGG-16 width (N = 20 clients, M = 4 shards), then bf16 inputs, the
   weighted forms, N = 1, ragged and misaligned views, subnormals and a
   mixed multi-node table; then the codec kernels (quantize, dequantize,
   top-k) against theirs, bit for bit: each VGG-16 shard and the whole
   gradient (32,715 tiles), n = 0, a short and a misaligned vector, fewer
   tiles than SMs, an all-zero tile, a tile with fewer than k nonzeros,
   exact .5 quotients, subnormals, values near the f32 maximum, tiles with
   NaN and ±inf, a heavy-tailed and a tied input;
4. the reference's pinned smoke keys (``benchmarks/expected_smoke.json``,
   read as JSON) recomputed on the card: 168 keys across topology × engine
   × schedule and the ``readahead_k`` sweeps, and the 36 wire-codec keys;
   then every engine at N = 12 on the card against the CPU, under every
   codec; then the 159 keys of the faults, plugin-topology and population
   groups (``sharded_tree``, ``sharded_tree_equals_lambda_fl``, ``fault``,
   ``robust``, ``geo_tiered``, ``population``): 363 of the file's 366;
5. full width: GradsSharding, λ-FL and LIFL rounds through
   ``FederatedSession(..., engine="batched", device="cuda")`` on 20 VGG-16
   gradients made on the card from a seed; the launch counter must grow,
   each mean must equal the plain fold bit for bit, and a 1 M-element
   slice must equal a numpy fold on the host. Then the kernel's time per
   wave (CUDA events, median of 7 after a warm-up) beside its bound, the
   plain version's time and ``torch.mean`` over a pre-stacked tensor;
6. full width under the ``qsgd8`` and ``topk`` wire codecs, each topology:
   the codec kernels' launch counts must equal one encode and one decode
   per client contribution, each mean must equal the plain pipeline (plain
   encode, decode and fold) on the card bit for bit and a numpy mirror on
   a 256-tile slice, and ``codec_error`` the plain pipeline's. Then each
   codec kernel's time on one VGG-16 shard beside its bound, its plain
   version's and, for dequantize, one ``torch.mul``; by CUDA events around
   one call and by device time under ``torch.profiler``;
7. federated LM at full width (``tinyllama-1.1b``, 1.1 B parameters):
   (a) the fused-SGD kernel against its plain version bit for bit, on each
   of the 12 parameter leaves with real gradients of one local step, at a
   ragged length, on a misaligned view, with n = 0 (no launch) and with
   bf16 parameters or gradients; the rmsnorm kernel against its plain
   version at its tolerance (f32: rtol 1e-5, atol 1e-6; bf16: one ulp), on
   the real (512, 2048) bf16 activations at layer 0's first norm, at
   d = 64, 2048 and 8192 in f32 and bf16 with a row count that is not a
   multiple of 8, on an all-zero row, near the f32 maximum, on a view 4
   bytes off 16-byte alignment, on rows 2056 apart, at d = 2047 bf16 and
   8191 f32 (no 16-byte width), on one row, and on none (no launch); (b) two
   rounds of ``federated_lm.run`` (N = 4, M = 4, 2 local steps, batch 8,
   sequence 64, lr 0.05, batched engine, parameters from a seeded
   generator on the card): rmsnorm launches 45 per forward, fused-SGD 12 per local step,
   the fold at least once, every loss finite, the second round's mean
   client loss below the first's, and each round's mean equal to the plain
   fold of the four client deltas bit for bit; (c) the fused-SGD kernel
   over one step's 12 leaves and rmsnorm at (512, 2048) bf16 beside their
   bounds, plain versions and one PyTorch call each, the host walls of a
   client's local training and of an aggregation round, and the peak
   device memory; rmsnorm and ``F.rms_norm`` by events around one call
   timed in turns, by host time per call, and by device time per call
   under ``torch.profiler``, beside the device time of a ``copy_`` of the
   same activations (the card's floor for one pass of that size); then one
   local step under ``torch.profiler`` (device time by kernel, the
   device's idle share);
8. faulty, stale and hedged GradsSharding rounds on the VGG-16 gradients
   (drawn again from the seed): the reference's fault rows (partial
   participation, quorum, deadline), 3-round sessions with stale re-entry
   under polynomial staleness weights and with and without hedging (at
   the gate's factor 1.2 and at 1.05, which must fire at this width); the
   batched engine (the fold kernel) against the streaming engine (plain
   torch ops) on the card bit for bit, accounting alike, at least one
   stale weight other than 1.0 folded by the kernel, each hedged mean
   equal to its unhedged twin;
9. ``sharded_tree`` and ``geo_tiered`` at the same width, barrier and
   pipelined, batched against streaming bit for bit, and ``sharded_tree``'s
   mean equal to ``lambda_fl``'s;
10. the population engine: the CI scale job's round (``geo_tiered``, N =
   10^5, K = 4,096, its faults and upload model) and GradsSharding rounds
   at N = 10^5 and 10^6 (``benchmarks/scale_bench.py``'s upload model and
   lifted timeout), their folds in the kernel's carry form (one launch a
   512-row chunk), each mean bit for bit against the plain chunked fold of
   the same rows on the card; host wall, host RSS peak of the round and
   device peak, which must stay within four chunks and not grow with N;
   then one carry launch at the population's shape, f32 and f64, beside
   its bound, its plain version and ``torch.sum`` over the chunk;
11. one population round under ``qsgd8`` (N = 64, GradsSharding and
   ``geo_tiered``): the codec kernels run through the population's decode
   and the round equals the eager round over the materialized cohort.

The last lines are a JSON object of timings and walls, a JSON ``kernels``
line, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

N_CLIENTS = 20           # FLConfig.n_clients; the paper's RQ1-B/RQ2/RQ3 N
N_SHARDS = 4             # FLConfig.n_shards
SEED = 20260516
ROUNDS = 3               # full-width rounds per topology (fresh sessions)
REPS = 7                 # timed launches per wave, after a warm-up
PROFILED_CALLS = 50      # calls per device-time reading under the profiler
SLICE = 1_000_000        # host numpy check of the round's mean
TOPOLOGIES = ("gradssharding", "lambda_fl", "lifl")
NEW_GROUPS = ("sharded_tree", "sharded_tree_equals_lambda_fl", "fault",
              "robust", "geo_tiered", "population")
SOURCES = ("fedavg_stream", "quantize", "topk_sparsify", "fused_sgd",
           "rmsnorm")
LOSSY = ("fp16", "qsgd8", "topk")
FULL_WIDTH_CODECS = ("qsgd8", "topk")    # the codecs with kernels
CODEC_ROUNDS = 2         # full-width rounds per topology and codec
TILE = 4096              # codec tile: 32 rows x 128 lanes
TOPK_K = 128             # TopkCodec.k_per_block
CODEC_SLICE = 256 * TILE  # host numpy check of a codec round's mean
LM_ARCH = "tinyllama-1.1b"
# the reference example's settings, but lr 0.05: its lr 0.1 diverges at
# full width (PERF.md)
LM_RUN = dict(rounds=2, clients=4, shards=4, local_steps=2, batch=8, seq=64,
              lr=0.05, engine="batched")
NORMS_PER_FORWARD = 45   # 2 per layer (ln1, ln2) and the final norm
RECKONED_PEAK_GB = 46.0  # params, a client's copy, grads, velocity, bf16
                         # casts, delta tree, 4 flat deltas, the mean

# Published peaks (NVIDIA data sheets, dense, outside the tensor cores):
# device-memory bytes/s, f32 and f64 operations/s, keyed by the variant
# nvidia-smi names.
PEAKS = {
    "PCIe": (2.0e12, 51e12, 26e12),
    "NVL": (3.9e12, 60e12, 30e12),
    "H200": (4.8e12, 67e12, 34e12),
    "H100": (3.35e12, 67e12, 34e12),     # SXM (HBM3)
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def bits_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and a.dtype == b.dtype == torch.float32 \
        and torch.equal(a.view(torch.int32), b.view(torch.int32))


def peaks(name: str) -> tuple:
    for key, val in PEAKS.items():
        if key in name:
            return val
    fail(f"no published peaks for {name!r}")


# ---------------------------------------------------------------------------
# Round structure: the dependency waves of each topology's fold
# ---------------------------------------------------------------------------

def waves(grads, topology: str, fold, cm, plan_uniform):
    """The round's folds as waves of ``(inputs, weights)`` nodes, built
    with ``fold(nodes) -> outs`` (kernel, plain torch or numpy), and the
    round's mean. Mirrors the topologies' programs: GradsSharding folds M
    shards unweighted; λ-FL folds ⌈√N⌉-client leaves unweighted, then the
    root weighted by group size; every LIFL level folds weighted."""
    n = len(grads)
    if topology == "gradssharding":
        plan = plan_uniform(int(grads[0].shape[0]), N_SHARDS)
        nodes = [([g[a:b] for g in grads], None) for ((a, b),) in plan.segments]
        return [nodes], _cat(fold(nodes))
    if topology == "lambda_fl":
        groups = cm.tree_groups(n, cm.lambda_fl_branching(n))
        leaves = [([grads[i] for i in g], None) for g in groups]
        root = [(fold(leaves), [float(len(g)) for g in groups])]
        return [leaves, root], fold(root)[0]
    b = cm.lifl_branching(n)
    keys, lw, out = list(grads), [1.0] * n, []
    for level in (1, 2, 3):
        groups = cm.tree_groups(len(keys), b) if level < 3 \
            else [list(range(len(keys)))]
        nodes = [([keys[i] for i in g], [lw[i] for i in g]) for g in groups]
        out.append(nodes)
        keys = fold(nodes)
        lw = [float(sum(lw[i] for i in g)) for g in groups]
    return out, keys[0]


def _cat(outs):
    import numpy as np
    import torch
    if isinstance(outs[0], torch.Tensor):
        return torch.cat(outs)
    return np.concatenate(outs)


def numpy_fold(nodes):
    """The reference engine's fold, inline in numpy: an f32 left fold and
    one f32 divide, or an f64 fold of x·w, one f64 divide, an f32 cast."""
    import numpy as np
    outs = []
    for inputs, weights in nodes:
        if weights is None:
            acc = inputs[0].astype(np.float32).copy()
            for x in inputs[1:]:
                acc += x
            outs.append(acc / np.float32(len(inputs)))
        else:
            acc = inputs[0].astype(np.float64) * weights[0]
            for x, w in zip(inputs[1:], weights[1:]):
                acc += x.astype(np.float64) * w
            outs.append((acc / float(sum(weights))).astype(np.float32))
    return outs


def wave_cost(nodes, peak) -> tuple:
    """Bytes each input read once and each output written once, and the
    operations (an add, and a multiply when weighted, per input element;
    one divide per output element); the bound and what sets it."""
    bw, f32, f64 = peak
    nbytes = ops = 0
    weighted = nodes[0][1] is not None
    for inputs, weights in nodes:
        length = int(inputs[0].shape[0])
        nbytes += sum(x.element_size() for x in inputs) * length + 4 * length
        ops += (2 if weights is not None else 1) * len(inputs) * length \
            + length
    t_bytes = nbytes / bw
    t_ops = ops / (f64 if weighted else f32)
    return nbytes, ops, max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def device_ms(fn, tag: str | None = None):
    """Device time per call of ``fn`` under ``torch.profiler``: the CUDA
    kernels whose name holds ``tag`` (all of them when ``tag`` is None)
    over ``PROFILED_CALLS`` calls after a warm-up, summed and divided by
    the calls; and the kernels a call. A profile that records no device
    activity is taken again, twice at most; then None."""
    import torch
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(PROFILED_CALLS):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and (tag is None or tag in e.name)]
        if times:
            return sum(times) / PROFILED_CALLS / 1e3, \
                len(times) / PROFILED_CALLS
    return None


def paired_ms(fa, fb, reps: int = 21) -> tuple:
    """Median CUDA-event time around one call of ``fa`` and of ``fb``,
    timed in turns (a b, b a, ...) after a warm-up, so that a drift of the
    host's speed falls on both alike."""
    import torch
    fa()
    fb()
    torch.cuda.synchronize()
    times = ([], [])
    for i in range(reps):
        for k in ((0, 1) if i % 2 == 0 else (1, 0)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            (fa, fb)[k]()
            end.record()
            torch.cuda.synchronize()
            times[k].append(start.elapsed_time(end))
    return statistics.median(times[0]), statistics.median(times[1])


def host_us(fn, calls: int = 200) -> float:
    """Host time per call over back-to-back calls: the cost of dispatch,
    which a short kernel's event time is made of."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def time_ms(fn) -> float:
    """Median device time of ``fn`` (CUDA events), after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_card():
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    name = torch.cuda.get_device_name(0)
    print(f"[1] card: {name}, {torch.cuda.device_count()} device(s), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return card, name


def phase_build(build):
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(build.load, SOURCES))
    print(f"[2] built {len(SOURCES)} sources in parallel in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in SOURCES:
        secs, log = build.BUILD_INFO[name]
        print(f"    {name}.cu: nvcc {secs:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"    ptxas: {line.strip()}")


def phase_kernel_vs_plain(fs, grads, cm, plan_uniform):
    """Every wave of the three topologies at full width, then edge cases."""
    import torch
    plain = lambda nodes: [fs.fedavg_stream_plain(i, w) for i, w in nodes]
    kernel = lambda nodes: fs.fold_nodes(nodes)
    cases = 0
    max_err = 0.0

    def check(label, got, want):
        nonlocal cases, max_err
        for g, w in zip(got, want):
            err = float((g - w).abs().max()) if g.numel() else 0.0
            max_err = max(max_err, err)
            if not bits_equal(g, w):
                fail(f"kernel != plain in {label} (max abs err {err})")
        cases += 1

    for topology in TOPOLOGIES:
        ws, _ = waves(grads, topology, plain, cm, plan_uniform)
        for i, wave in enumerate(ws):
            check(f"{topology} wave {i}", kernel(wave), plain(wave))
            torch.cuda.synchronize()

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rnd = lambda n, L, dtype=torch.float32: [
        torch.randn(L, generator=gen, device="cuda").to(dtype)
        for _ in range(n)]
    w7 = [0.5, 2.0, 1.0, 3.25, 0.125, 1.0, 7.0]
    bf = rnd(7, 1_000_003, torch.bfloat16)
    check("bf16 unweighted", kernel([(bf, None)]), plain([(bf, None)]))
    check("bf16 weighted f64", kernel([(bf, w7)]), plain([(bf, w7)]))
    xs = rnd(7, 12_345)
    stack = torch.stack(xs)
    check("weighted f32 (fedavg_shards)", [fs.fedavg_shards(stack, w7)],
          [fs.fedavg_stream_plain(xs, w7, acc="f32")])
    stacks = [torch.stack(rnd(5, L)) for L in (1, 1023, 70_001)]
    check("fedavg_multi", fs.fedavg_multi(stacks, w7[:5]),
          [fs.fedavg_stream_plain(list(s), w7[:5], acc="f32")
           for s in stacks])
    one = rnd(1, 4097)
    check("N = 1", kernel([(one, None), (one, [3.0])]),
          plain([(one, None), (one, [3.0])]))
    base = rnd(4, 1_000_000 + 8)
    mis = [b[k:k + 999_999] for k, b in zip((1, 2, 3, 5), base)]
    if not all(m.data_ptr() % 16 for m in mis):
        fail("the misaligned case has a 16-byte aligned view")
    check("misaligned views", kernel([(mis, None), (mis, w7[:4])]),
          plain([(mis, None), (mis, w7[:4])]))
    sub = [x * 1e-39 for x in rnd(6, 50_000)]
    check("subnormals", kernel([(sub, None), (sub, w7[:6])]),
          plain([(sub, None), (sub, w7[:6])]))
    mixed = [(rnd(3, 5), None), (rnd(9, 300_000), w7 + [1.0, 2.0]),
             (rnd(2, 0), None), (rnd(1, 1), [4.0]), (rnd(20, 33_333), None)]
    check("mixed table", kernel(mixed), plain(mixed))
    torch.cuda.synchronize()
    print(f"[3] kernel == plain, bit for bit, in {cases} cases "
          f"(max abs err {max_err})")
    return max_err


def phase_codec_kernels(q, tk, grads, plan_uniform):
    """Quantize, dequantize and top-k against their plain versions on the
    card, bit for bit: the main path's shapes, then edge cases."""
    import torch
    errs = {"quantize": 0.0, "dequantize": 0.0, "topk_sparsify": 0.0}
    cases = 0

    def same(label, kernel, got, want):
        if got.dtype != want.dtype or got.shape != want.shape:
            fail(f"{kernel} in {label}: {got.dtype} {tuple(got.shape)} vs "
                 f"plain {want.dtype} {tuple(want.shape)}")
        as_bits = (lambda t: t) if got.dtype == torch.int8 else \
            (lambda t: t.view(torch.int32))
        diff = as_bits(got) != as_bits(want)
        if bool(diff.any()):
            err = float((got[diff].double() - want[diff].double()).abs()
                        .max())
            errs[kernel] = max(errs[kernel], err)
        if not torch.equal(as_bits(got), as_bits(want)):
            fail(f"{kernel} != plain in {label} (max abs err "
                 f"{errs[kernel]})")

    def check(label, x, ranges=()):
        nonlocal cases
        n = int(x.shape[0])
        codes, scales = q.quantize(x)
        plain_codes, plain_scales = q.quantize_plain(x)
        same(label, "quantize", codes, plain_codes)
        same(label, "quantize", scales, plain_scales)
        for a, b in ((0, n),) + tuple(ranges):
            same(f"{label} [{a}, {b})", "dequantize",
                 q.dequantize(codes, scales, a, b),
                 q.dequantize_plain(plain_codes, plain_scales, a, b))
        same(label, "topk_sparsify", tk.topk_sparsify(x, TOPK_K),
             tk.topk_plain(x, TOPK_K))
        torch.cuda.synchronize()
        cases += 1

    g = grads[0]
    L = int(g.shape[0])
    for j, ((a, b),) in enumerate(plan_uniform(L, N_SHARDS).segments):
        n = b - a
        check(f"VGG-16 shard {j} ({n} elements, ragged last tile of "
              f"{n % TILE})", g[a:b],
              ((1, TILE + 1), (TILE - 1, 3 * TILE + 7), (n - 5_000, n)))
    check("whole VGG-16 gradient", g, ((L - TILE - 3, L),))

    before = (q.QUANTIZE_LAUNCHES, q.DEQUANTIZE_LAUNCHES, tk.LAUNCHES)
    check("n = 0", torch.empty(0, device="cuda"))
    if (q.QUANTIZE_LAUNCHES, q.DEQUANTIZE_LAUNCHES, tk.LAUNCHES) != before:
        fail("an empty vector launched a codec kernel")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rnd = lambda n: torch.randn(n, generator=gen, device="cuda")
    check("n < 4096", rnd(1_000), ((7, 993),))
    base = rnd(100_003)
    mis = base[3:]
    if mis.data_ptr() % 16 == 0:
        fail("the misaligned case has a 16-byte aligned view")
    check("misaligned start", mis, ((5, 50_001),))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    check(f"fewer tiles ({sms // 2} + a ragged one) than SMs ({sms})",
          rnd((sms // 2) * TILE + 1_234))
    x = rnd(4 * TILE + 17)
    x[TILE:2 * TILE] = 0.0                        # an all-zero tile
    x[2 * TILE:3 * TILE] = 0.0                    # fewer than k nonzeros
    x[2 * TILE:3 * TILE:64] = rnd(TILE // 64)
    x[3 * TILE:3 * TILE + 100] = -0.0
    check("all-zero tile, fewer than k nonzeros, -0.0", x)
    ramp = torch.arange(2 * TILE, device="cuda", dtype=torch.float32)
    half = torch.empty(2 * TILE, device="cuda")
    half[:TILE] = (ramp[:TILE] % 254) - 126.5     # scale 1: x.5 quotients
    half[0] = 127.0
    half[TILE:] = 2 * ((ramp[TILE:] % 127) - 63) + 1   # scale 2: odd / 2
    half[TILE] = 254.0
    check("exact .5 quotients", half)
    check("subnormals", rnd(3 * TILE + 5) * 1e-39)
    big = (torch.rand(2 * TILE + 9, generator=gen, device="cuda") * 0.4e38
           + 3.0e38) * torch.sign(rnd(2 * TILE + 9))
    big[5] = torch.finfo(torch.float32).max
    check("near the f32 maximum", big)
    x = rnd(3 * TILE + 33)
    x[5] = x[700] = float("nan")                  # NaN, +inf and -inf
    x[9], x[100] = float("inf"), float("-inf")
    x[2 * TILE + 7], x[2 * TILE + 8] = float("inf"), float("-inf")
    x[3 * TILE + 4] = float("nan")                # a NaN in the ragged tile
    check("NaN and ±inf tiles beside a clean tile", x)
    u = torch.rand(300_007, generator=gen, device="cuda")
    check("heavy-tailed (Cauchy)", torch.tan(torch.pi * (u - 0.5)))
    check("ties (few distinct magnitudes)", torch.round(rnd(200_000) * 4))
    print(f"[3] codec kernels == plain, bit for bit, in {cases} cases "
          f"(max abs err {errs})")
    return errs


def phase_pinned(fs, smoke, FederatedSession):
    fs.LAUNCHES = 0
    t0 = time.perf_counter()
    got = smoke.main_path_invariants("cuda")
    with open(ROOT / "benchmarks" / "expected_smoke.json") as fh:
        pinned = json.load(fh)
    expected = {k: v for k, v in pinned.items()
                if k.split("/")[:2] in [["smoke", t] for t in TOPOLOGIES]}
    bad = smoke.mismatches(got, expected)
    if len(expected) != 168 or bad:
        fail(f"{len(bad)} of {len(expected)} pinned keys differ on the "
             f"card:\n" + "\n".join(bad[:20]))
    print(f"[4] pinned smoke keys on cuda: {len(expected)}/{len(expected)} "
          f"equal expected_smoke.json ({fs.LAUNCHES} kernel launches, "
          f"{time.perf_counter() - t0:.1f} s)")
    # N = 12: divisors that are not powers of two, where a reciprocal
    # multiply would show; every engine on the card against the CPU
    grads = smoke.readahead_grads("2")
    for topology in TOPOLOGIES:
        for engine in smoke.ENGINES:
            kw = dict(topology=topology, n_shards=smoke.N_SHARDS_2,
                      engine=engine, schedule="pipelined", readahead_k=2,
                      upload=smoke.UPLOAD, codec="identity")
            on_card = smoke.record(
                FederatedSession(device="cuda", **kw).round(grads))
            on_cpu = smoke.record(
                FederatedSession(device="cpu", **kw).round(grads))
            if on_card != on_cpu:
                fail(f"N=12 {topology}/{engine}: card {on_card} != cpu "
                     f"{on_cpu}")
    print(f"    N=12: {len(TOPOLOGIES) * len(smoke.ENGINES)} topology × "
          f"engine rounds on cuda equal the CPU's, hashes included")

    t0 = time.perf_counter()
    got_codec = smoke.codec_invariants(
        "cuda", raw_hashes=smoke.gradssharding_hashes(got))
    expected = smoke.expected_invariants(groups=("codec",))
    bad = smoke.mismatches(got_codec, expected)
    if len(expected) != 36 or bad:
        fail(f"{len(bad)} of {len(expected)} pinned codec keys differ on "
             f"the card:\n" + "\n".join(bad[:20]))
    print(f"    pinned codec keys on cuda: {len(expected)}/{len(expected)} "
          f"equal expected_smoke.json ({time.perf_counter() - t0:.1f} s)")
    for codec in LOSSY:
        for topology in TOPOLOGIES:
            for engine in smoke.ENGINES:
                kw = dict(topology=topology, n_shards=smoke.N_SHARDS_2,
                          engine=engine, schedule="pipelined", readahead_k=2,
                          upload=smoke.UPLOAD, codec=codec)
                card = FederatedSession(device="cuda", **kw).round(grads)
                cpu = FederatedSession(device="cpu", **kw).round(grads)
                on_card = (smoke.record(card), card.codec_error)
                on_cpu = (smoke.record(cpu), cpu.codec_error)
                if on_card != on_cpu:
                    fail(f"N=12 {codec}/{topology}/{engine}: card {on_card} "
                         f"!= cpu {on_cpu}")
    print(f"    N=12: {len(LOSSY) * len(TOPOLOGIES) * len(smoke.ENGINES)} "
          f"codec × topology × engine rounds on cuda equal the CPU's, "
          f"hashes and codec_error included")

    # the groups of the faults, plugin-topology and population slice
    t0 = time.perf_counter()
    got_new = smoke.sharded_tree_invariants(
        "cuda", lambda_fl_hashes=smoke.grid_hashes(got, "lambda_fl"))
    for invariants in (smoke.fault_invariants, smoke.robust_invariants,
                       smoke.geo_invariants, smoke.population_invariants):
        got_new.update(invariants("cuda"))
    expected = smoke.expected_invariants(groups=NEW_GROUPS)
    bad = smoke.mismatches(got_new, expected)
    if len(expected) != 159 or set(got_new) != set(expected) or bad:
        fail(f"{len(bad)} of {len(expected)} pinned fault, robust, "
             f"sharded_tree, geo_tiered and population keys differ on the "
             f"card:\n" + "\n".join(bad[:20]))
    total = len(smoke.expected_invariants(groups=smoke.GROUPS))
    print(f"    pinned sharded_tree, fault, robust, geo_tiered and "
          f"population keys on cuda: {len(expected)}/{len(expected)} "
          f"equal expected_smoke.json ({time.perf_counter() - t0:.1f} s); "
          f"{total} keys in all")


def phase_full_width(fs, grads, cm, plan_uniform, FederatedSession, peak):
    import numpy as np
    import torch
    plain = lambda nodes: [fs.fedavg_stream_plain(i, w) for i, w in nodes]
    host = [g[:SLICE].cpu().numpy() for g in grads]
    L = int(grads[0].shape[0])
    fs.LAUNCHES = 0                      # the main path starts here
    per_topo, walls = {}, {}
    for topology in TOPOLOGIES:
        _, want = waves(grads, topology, plain, cm, plan_uniform)
        _, want_host = waves(host, topology, numpy_fold, cm, plan_uniform)
        before, walls[topology] = fs.LAUNCHES, []
        for _ in range(ROUNDS):
            session = FederatedSession(topology=topology, n_shards=N_SHARDS,
                                       engine="batched", device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = session.round(grads)
            torch.cuda.synchronize()
            walls[topology].append(time.perf_counter() - t0)
            avg = result.avg_flat
            if avg.device.type != "cuda" or avg.shape != (L,) \
                    or not bool(torch.isfinite(avg).all()):
                fail(f"{topology}: avg_flat is not a finite ({L},) CUDA "
                     f"tensor")
            if not bits_equal(avg, want):
                fail(f"{topology}: avg_flat != the plain fold on the card")
            if not np.array_equal(avg[:SLICE].cpu().numpy().view(np.int32),
                                  want_host.view(np.int32)):
                fail(f"{topology}: avg_flat[:{SLICE}] != the numpy fold")
            del session, result, avg
        per_topo[topology] = fs.LAUNCHES - before
        if per_topo[topology] <= 0:
            fail(f"{topology}: the round launched no fold kernel")
        del want
        print(f"[5] {topology}: N={len(grads)} L={L} rounds "
              f"{', '.join(f'{w:.3f}' for w in walls[topology])} s host "
              f"wall, {per_topo[topology]} launches in {ROUNDS} rounds; "
              f"mean == plain fold, [:{SLICE}] == numpy fold")
    launches = fs.LAUNCHES

    rows = []
    for topology in TOPOLOGIES:
        ws, _ = waves(grads, topology, plain, cm, plan_uniform)
        for i, wave in enumerate(ws):
            nbytes, ops, bound, by = wave_cost(wave, peak)
            ms = time_ms(lambda: fs.fold_nodes(wave))
            plain_ms = time_ms(lambda: plain(wave))
            rows.append({
                "topology": topology, "wave": i, "nodes": len(wave),
                "inputs": sum(len(x) for x, _ in wave),
                "weighted": wave[0][1] is not None, "bytes": nbytes,
                "ops": ops, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by,
                "bound_share": bound / ms})
    stacked = torch.stack(grads)
    library_ms = time_ms(lambda: stacked.mean(dim=0))
    del stacked
    for row in rows:
        row["library_ms"] = library_ms if row["topology"] == "gradssharding" \
            else None
        print(f"    {row['topology']} wave {row['wave']}: {row['nodes']} "
              f"node(s), {row['inputs']} inputs, {row['ms']:.3f} ms kernel, "
              f"{row['plain_ms']:.3f} ms plain, bound {row['bound_ms']:.3f} "
              f"ms ({row['bound_by']}), {100 * row['bound_share']:.1f}% of "
              f"bound")
    print(f"    torch.mean over the stacked (N, L) gradients: "
          f"{library_ms:.3f} ms")
    return launches, per_topo, walls, rows


def codec_pieces(topology: str, L: int, plan_uniform) -> list:
    """The element ranges a client encodes: its M shards under
    GradsSharding, its whole gradient under λ-FL and LIFL."""
    if topology == "gradssharding":
        return [seg for (seg,) in plan_uniform(L, N_SHARDS).segments]
    return [(0, L)]


def plain_roundtrip(q, tk, codec: str, g, pieces):
    """A client's gradient through the plain encode and decode, piece by
    piece. Top-k's sparse payload drops zeros, -0.0 included, so its
    decode holds +0.0 wherever the dense mask is zero."""
    import torch
    outs = []
    for a, b in pieces:
        if codec == "qsgd8":
            outs.append(q.dequantize_plain(*q.quantize_plain(g[a:b])))
        else:
            dense = tk.topk_plain(g[a:b], TOPK_K)
            outs.append(torch.where(dense != 0, dense,
                                    torch.zeros((), device=dense.device)))
    return torch.cat(outs)


def numpy_roundtrip(codec: str, x):
    """The reference's codec arithmetic, inline in numpy, over whole tiles
    of ``x`` (f32, a multiple of 4096 long)."""
    import numpy as np
    tiles = x.reshape(-1, TILE)
    ax = np.abs(tiles)
    if codec == "qsgd8":
        amax = ax.max(axis=1)
        qmax = np.float32(127.0)
        scales = np.where(amax > 0, amax / qmax,
                          np.float32(1.0)).astype(np.float32)
        codes = np.clip(np.rint(tiles / scales[:, None]), -qmax,
                        qmax).astype(np.int8)
        return (codes.astype(np.float32) * scales[:, None]).reshape(-1)
    lo = np.zeros(tiles.shape[0], np.float32)
    hi = ax.max(axis=1) + np.float32(1e-12)
    for _ in range(24):
        mid = np.float32(0.5) * (lo + hi)
        keep = (ax >= mid[:, None]).sum(axis=1) >= TOPK_K
        lo = np.where(keep, mid, lo)
        hi = np.where(keep, hi, mid)
    dense = np.where(ax >= lo[:, None], tiles, np.float32(0.0))
    return np.where(dense != 0, dense, np.float32(0.0)).reshape(-1)


def codec_launches(q, tk) -> dict:
    return {"quantize": q.QUANTIZE_LAUNCHES,
            "dequantize": q.DEQUANTIZE_LAUNCHES,
            "topk_sparsify": tk.LAUNCHES}


def phase_full_width_codecs(fs, q, tk, grads, cm, plan_uniform,
                            FederatedSession):
    """Full-width rounds of each topology under qsgd8 and topk."""
    import numpy as np
    import torch
    plain = lambda nodes: [fs.fedavg_stream_plain(i, w) for i, w in nodes]
    L = int(grads[0].shape[0])
    host = [g[:CODEC_SLICE].cpu().numpy() for g in grads]
    raw_mean = fs.fedavg_stream_plain(grads)       # codec_error's reference
    walls, per_round = {}, {}
    # the main path starts here
    q.QUANTIZE_LAUNCHES = q.DEQUANTIZE_LAUNCHES = tk.LAUNCHES = 0
    for codec in FULL_WIDTH_CODECS:
        host_dec = [numpy_roundtrip(codec, h) for h in host]
        for topology in TOPOLOGIES:
            pieces = codec_pieces(topology, L, plan_uniform)
            decoded = [plain_roundtrip(q, tk, codec, g, pieces)
                       for g in grads]
            _, want = waves(decoded, topology, plain, cm, plan_uniform)
            del decoded
            want_err = float(torch.max(torch.abs(want - raw_mean)))
            _, want_host = waves(host_dec, topology, numpy_fold, cm,
                                 plan_uniform)
            n_enc = len(grads) * len(pieces)
            expect = {"quantize": n_enc, "dequantize": n_enc,
                      "topk_sparsify": 0} if codec == "qsgd8" else \
                {"quantize": 0, "dequantize": 0, "topk_sparsify": n_enc}
            key = f"{topology}/{codec}"
            walls[key] = []
            for _ in range(CODEC_ROUNDS):
                before, folds = codec_launches(q, tk), fs.LAUNCHES
                session = FederatedSession(
                    topology=topology, n_shards=N_SHARDS, engine="batched",
                    codec=codec, device="cuda")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                result = session.round(grads)
                torch.cuda.synchronize()
                walls[key].append(time.perf_counter() - t0)
                after = codec_launches(q, tk)
                grew = {k: after[k] - before[k] for k in after}
                if grew != expect or fs.LAUNCHES <= folds:
                    fail(f"{key}: launches {grew} (fold "
                         f"{fs.LAUNCHES - folds}), expected {expect} and "
                         f"at least one fold")
                avg = result.avg_flat
                if avg.device.type != "cuda" or avg.shape != (L,) \
                        or not bool(torch.isfinite(avg).all()):
                    fail(f"{key}: avg_flat is not a finite ({L},) CUDA "
                         f"tensor")
                if not bits_equal(avg, want):
                    fail(f"{key}: avg_flat != the plain pipeline on the card")
                if not np.array_equal(
                        avg[:CODEC_SLICE].cpu().numpy().view(np.int32),
                        want_host.view(np.int32)):
                    fail(f"{key}: avg_flat[:{CODEC_SLICE}] != the numpy "
                         f"mirror")
                if result.codec_error != want_err:
                    fail(f"{key}: codec_error {result.codec_error!r} != the "
                         f"plain pipeline's {want_err!r}")
                del session, result, avg
            per_round[key] = expect
            del want
            print(f"[6] {key}: rounds "
                  f"{', '.join(f'{w:.3f}' for w in walls[key])} s host wall, "
                  f"{expect} codec launches a round; mean == plain pipeline, "
                  f"[:{CODEC_SLICE}] == numpy mirror, codec_error "
                  f"{want_err!r}")
    return codec_launches(q, tk), per_round, walls


def phase_codec_timings(q, tk, grads, plan_uniform, peak):
    """Each codec kernel on one VGG-16 shard (the GradsSharding encode and
    decode): its time, its plain version's, its bound, and one PyTorch
    call where one computes the same function."""
    import torch
    bw, f32, _ = peak
    (a, b), = plan_uniform(int(grads[0].shape[0]), N_SHARDS).segments[0]
    x = grads[0][a:b]
    n = b - a
    n_tiles = math.ceil(n / TILE)
    codes, scales = q.quantize(x)
    whole = (n // TILE) * TILE
    # bytes: each input read once, each output written once; operations:
    # quantize |x|, max, divide, round, two clamps; dequantize a convert
    # and a multiply; top-k |x|, max, then 24 compare-and-count steps and
    # a select
    work = {
        "quantize": (4 * n + n + 4 * n_tiles, 6 * n,
                     lambda: q.quantize(x), lambda: q.quantize_plain(x),
                     None),
        "dequantize": (n + 4 * n_tiles + 4 * n, 2 * n,
                       lambda: q.dequantize(codes, scales),
                       lambda: q.dequantize_plain(codes, scales),
                       lambda: torch.mul(codes[:whole].view(-1, TILE),
                                         scales[:whole // TILE, None])),
        "topk_sparsify": (8 * n, (2 + 2 * 24 + 1) * n,
                          lambda: tk.topk_sparsify(x, TOPK_K),
                          lambda: tk.topk_plain(x, TOPK_K), None),
    }
    rows = {}
    for name, (nbytes, ops, kernel, plain, library) in work.items():
        t_bytes, t_ops = nbytes / bw, ops / f32
        row = {"elements": n, "bytes": nbytes, "ops": ops,
               "ms": time_ms(kernel), "plain_ms": time_ms(plain),
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": time_ms(library) if library else None}
        # the kernel alone: the event pair above also holds the wrapper's
        # host work while the device waits for it
        got = device_ms(kernel, f"::{name.split('_')[0]}_kernel")
        row["device_ms"] = got[0] if got else None
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows[name] = row
        lib = f"{row['library_ms']:.3f} ms" if library else "none"
        dev = "not measured" if got is None else \
            (f"{row['device_ms']:.4f} ms "
             f"({100 * row['bound_ms'] / row['device_ms']:.1f}% of bound)")
        print(f"    {name} on one shard ({n} elements): {row['ms']:.3f} ms "
              f"kernel, {row['plain_ms']:.3f} ms plain, library {lib}, "
              f"bound {row['bound_ms']:.3f} ms ({row['bound_by']}), "
              f"{100 * row['bound_share']:.1f}% of bound; device time {dev}")
    return rows


# ---------------------------------------------------------------------------
# Phase 7: federated LM training at full width
# ---------------------------------------------------------------------------

def bf16_ulps(a, b) -> int:
    """Largest distance in bf16 ulps between two bf16 tensors."""
    import torch

    def ordered(t):
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def phase_lm_kernels(sgd, rn, layers, models, data, cfg, params):
    """(a) fused-SGD bit for bit and rmsnorm at its tolerance, on the card,
    at the path's shapes and on edge cases. Returns the real gradients of
    one local step (reused for the timings) and the largest errors."""
    import torch
    from repro_torch.launch.federated_lm import MOMENTUM
    batch = data.batch(0, 0, LM_RUN["batch"], device="cuda")
    local = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
    loss, _ = models.loss_fn(local, cfg, batch)
    grads = dict(zip(local, torch.autograd.grad(loss, list(local.values()))))
    del local, loss
    errs = {"fused_sgd": 0.0, "rmsnorm": 0.0}
    cases = {"fused_sgd": 0, "rmsnorm": 0}

    def check_sgd(label, p, g, v, lr=LM_RUN["lr"]):
        kp, kv = p.clone(), v.clone()
        pp, pv = p.clone(), v.clone()
        sgd.fused_sgd(kp, g, kv, lr, MOMENTUM)
        sgd.fused_sgd_plain(pp, g, pv, lr, MOMENTUM)
        torch.cuda.synchronize()
        for got, want in ((kp, pp), (kv, pv)):
            if got.numel():
                errs["fused_sgd"] = max(errs["fused_sgd"], float(
                    (got.float() - want.float()).abs().max()))
            bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
            if not torch.equal(got.view(bits), want.view(bits)):
                fail(f"fused_sgd != plain in {label} (max abs err "
                     f"{errs['fused_sgd']})")
        cases["fused_sgd"] += 1

    with torch.no_grad():
        for name, p in params.items():
            g = grads[name].contiguous()
            check_sgd(f"leaf {name} {tuple(p.shape)}", p, g, g * 0.5)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
        rnd = lambda n: torch.randn(n, generator=gen, device="cuda")
        check_sgd("ragged n = 1,000,003", rnd(1_000_003), rnd(1_000_003),
                  rnd(1_000_003))
        base = [rnd(100_004) for _ in range(3)]
        mis = [b[1:] for b in base]
        if not all(m.data_ptr() % 16 for m in mis):
            fail("the misaligned case has a 16-byte aligned view")
        check_sgd("misaligned views", *mis)
        check_sgd("bf16 p", rnd(70_001).bfloat16(), rnd(70_001),
                  rnd(70_001))
        check_sgd("bf16 p and g", rnd(70_001).bfloat16(),
                  rnd(70_001).bfloat16(), rnd(70_001))
        check_sgd("f32 p, bf16 g", rnd(70_001), rnd(70_001).bfloat16(),
                  rnd(70_001))
        before = sgd.LAUNCHES
        check_sgd("n = 0", rnd(0), rnd(0), rnd(0))
        if sgd.LAUNCHES != before:
            fail("an empty leaf launched the fused_sgd kernel")

        def check_norm(label, x, gamma):
            out, rstd = rn.rmsnorm(x, gamma, cfg.norm_eps)
            want, want_rstd = rn.rmsnorm_plain(x, gamma, cfg.norm_eps)
            torch.cuda.synchronize()
            if out.dtype != x.dtype or out.shape != x.shape:
                fail(f"rmsnorm in {label}: {out.dtype} {tuple(out.shape)}")
            finite = torch.isfinite(want)
            if not torch.equal(finite, torch.isfinite(out)):
                fail(f"rmsnorm in {label}: non-finite values differ")
            diff = (out.float() - want.float()).abs()[finite]
            if diff.numel():
                errs["rmsnorm"] = max(errs["rmsnorm"], float(diff.max()))
            if x.dtype == torch.float32:
                ok = bool((diff <= 1e-6 + 1e-5 * want.float().abs()[finite])
                          .all())
            else:
                ok = bf16_ulps(out, want) <= 1
            r_ok = bool(((rstd - want_rstd).abs()
                         <= 1e-5 * want_rstd.abs()).all())
            if not (ok and r_ok):
                fail(f"rmsnorm != plain beyond the tolerance in {label} (max "
                     f"abs err {errs['rmsnorm']})")
            cases["rmsnorm"] += 1

        x0 = layers.embed_tokens(params["embed"], batch["tokens"],
                                 cfg.compute_dtype).reshape(-1, cfg.d_model)
        check_norm(f"layer 0 ln1 activations {tuple(x0.shape)} bf16", x0,
                   params["layers.ln1"][0])
        check_norm("layer 0 activations, random f32 gamma", x0,
                   rnd(cfg.d_model))
        for d in (64, 2048, 8192):
            for dt in (torch.float32, torch.bfloat16):
                for gdt in (torch.float32, torch.bfloat16):
                    check_norm(f"(1001, {d}) {dt} gamma {gdt}",
                               rnd(1001 * d).reshape(1001, d).to(dt),
                               rnd(d).to(gdt))
        x = rnd(37 * 2048).reshape(37, 2048)
        x[5] = 0.0
        check_norm("an all-zero row", x, rnd(2048))
        big = rnd(9 * 2048).reshape(9, 2048).sign() * 3.0e38
        big[1] = rnd(2048) * 1e17                # large, sum of squares finite
        big[2, 7] = torch.finfo(torch.float32).max
        check_norm("near the f32 maximum", big, rnd(2048))
        mis = rnd(513 * 2048).bfloat16()[2:2 + 512 * 2048].reshape(512, 2048)
        if mis.data_ptr() % 16 == 0:
            fail("the misaligned rmsnorm case has a 16-byte aligned view")
        check_norm("(512, 2048) bf16, 4 bytes off 16-byte alignment", mis,
                   rnd(2048))
        check_norm("(300, 2048) bf16 rows 2056 apart",
                   rnd(300 * 2056).reshape(300, 2056).bfloat16()[:, :2048],
                   rnd(2048))
        check_norm("(129, 2047) bf16", rnd(129 * 2047).reshape(129, 2047)
                   .bfloat16(), rnd(2047))
        check_norm("(33, 8191) f32, bf16 gamma", rnd(33 * 8191)
                   .reshape(33, 8191), rnd(8191).bfloat16())
        check_norm("one row", rnd(cfg.d_model).reshape(1, -1).bfloat16(),
                   params["final_norm"])
        before = rn.LAUNCHES
        out, rstd = rn.rmsnorm(rnd(0).reshape(0, 2048), rnd(2048))
        if rn.LAUNCHES != before or out.shape != (0, 2048) \
                or rstd.shape != (0,):
            fail("rmsnorm on no rows launched its kernel or gave "
                 f"{tuple(out.shape)}, {tuple(rstd.shape)}")
    print(f"[7] fused_sgd == plain, bit for bit, in {cases['fused_sgd']} "
          f"cases (12 tinyllama leaves with real gradients); rmsnorm within "
          f"f32 rtol 1e-5 atol 1e-6 / bf16 1 ulp in {cases['rmsnorm']} cases "
          f"(max abs err {errs['rmsnorm']})")
    return grads, errs


def phase_lm_path(fs, sgd, rn, federated_lm, cfg):
    """(b) two rounds of federated_lm.run at full width on the card."""
    import torch
    checked = []

    def on_round(rnd, res, flats):
        want = fs.fedavg_stream_plain(flats)
        avg = res.avg_flat
        if avg.device.type != "cuda" or avg.shape != want.shape \
                or not bool(torch.isfinite(avg).all()):
            fail(f"round {rnd}: avg_flat is not a finite "
                 f"({want.shape[0]},) CUDA tensor")
        if not bits_equal(avg, want):
            fail(f"round {rnd}: avg_flat != the plain fold of the "
                 f"{len(flats)} client deltas")
        checked.append(rnd)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fs.LAUNCHES = sgd.LAUNCHES = rn.LAUNCHES = 0   # the main path starts here
    out = federated_lm.run(cfg, device="cuda", on_round=on_round, **LM_RUN)
    torch.cuda.synchronize()
    launches = {"fedavg_stream": fs.LAUNCHES, "fused_sgd": sgd.LAUNCHES,
                "rmsnorm": rn.LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = LM_RUN["rounds"] * LM_RUN["clients"] * LM_RUN["local_steps"]
    expect = {"fused_sgd": 12 * steps, "rmsnorm": NORMS_PER_FORWARD * steps}
    if {k: launches[k] for k in expect} != expect \
            or launches["fedavg_stream"] < LM_RUN["rounds"]:
        fail(f"launches {launches}, expected {expect} and at least one fold "
             f"a round")
    if checked != list(range(LM_RUN["rounds"])):
        fail(f"the fold was checked in rounds {checked}")
    recs = out["rounds"]
    losses = [r["client_losses"] for r in recs]
    if not all(math.isfinite(x) for row in losses for x in row):
        fail(f"a client loss is not finite: {losses}")
    means = [r["mean_loss"] for r in recs]
    if not all(m < means[0] for m in means[1:]):
        fail(f"the mean client loss did not fall below the first round's: "
             f"{means}")
    if not all(bool(torch.isfinite(p).all()) for p in out["params"].values()):
        fail("the trained parameters are not finite")
    walls = {"client_s": [w for r in recs for w in r["client_walls_s"]],
             "agg_s": [r["agg_wall_s"] for r in recs]}
    print(f"[7] federated {cfg.name}: {steps} local steps, losses {losses}, "
          f"mean {means}; launches {launches}; each round's mean == plain "
          f"fold; client walls {', '.join(f'{w:.3f}' for w in walls['client_s'])} "
          f"s, aggregation walls {', '.join(f'{w:.3f}' for w in walls['agg_s'])}"
          f" s; peak device memory {peak_gb:.2f} GB (reckoned "
          f"~{RECKONED_PEAK_GB:.0f} GB)")
    return out["params"], launches, means, walls, peak_gb


def phase_lm_timings(sgd, rn, layers, cfg, params, grads, peak):
    """(c) fused-SGD over one step's 12 leaves and rmsnorm at the path's
    (512, 2048) bf16, beside their bounds, plain versions and one PyTorch
    call each."""
    import torch
    from repro_torch.launch.federated_lm import MOMENTUM
    bw, f32, _ = peak
    lr, mu = LM_RUN["lr"], MOMENTUM
    names = list(params)
    p = [params[k].detach().clone() for k in names]
    g = [grads[k].contiguous() for k in names]
    v = [x.clone() for x in g]
    n = sum(x.numel() for x in p)
    rows = {}
    nbytes, ops = 20 * n, 3 * n              # p r/w, v r/w, g read: f32
    t_bytes, t_ops = nbytes / bw, ops / f32
    opt_params = [torch.nn.Parameter(x.clone()) for x in p]
    for op, gr in zip(opt_params, g):
        op.grad = gr
    try:
        opt = torch.optim.SGD(opt_params, lr=lr, momentum=mu, fused=True)
        library = "torch.optim.SGD(fused=True).step()"
    except (RuntimeError, ValueError, TypeError) as exc:
        print(f"    fused SGD refused ({exc}); timing foreach=True")
        opt = torch.optim.SGD(opt_params, lr=lr, momentum=mu, foreach=True)
        library = "torch.optim.SGD(foreach=True).step()"
    opt.step()                               # creates the momentum buffers
    rows["fused_sgd"] = {
        "elements": n, "bytes": nbytes, "ops": ops,
        "ms": time_ms(lambda: [sgd.fused_sgd(a, b, c, lr, mu)
                               for a, b, c in zip(p, g, v)]),
        "plain_ms": time_ms(lambda: [sgd.fused_sgd_plain(a, b, c, lr, mu)
                                     for a, b, c in zip(p, g, v)]),
        "library_ms": time_ms(opt.step), "library": library,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    del opt, opt_params, p, v
    tokens = torch.randint(0, 256, (LM_RUN["batch"], LM_RUN["seq"]),
                           device="cuda")
    x = layers.embed_tokens(params["embed"], tokens, cfg.compute_dtype) \
        .reshape(-1, cfg.d_model)
    gamma = params["final_norm"]
    r, d = x.shape
    nbytes = 2 * r * d * x.element_size() + d * 4 + 4 * r   # x, out, γ, rstd
    ops = 4 * r * d                     # square, add, two multiplies
    t_bytes, t_ops = nbytes / bw, ops / f32
    g16 = gamma.to(torch.bfloat16)
    kernel = lambda: rn.rmsnorm(x, gamma, cfg.norm_eps)
    library = lambda: torch.nn.functional.rms_norm(x, (d,), weight=g16,
                                                   eps=cfg.norm_eps)
    dst = torch.empty_like(x)
    # at this size the event pair around a call mostly holds the host's
    # dispatch, so the wrapper and F.rms_norm are timed in turns
    ms, library_ms = paired_ms(kernel, library)
    rows["rmsnorm"] = {
        "shape": [r, d], "bytes": nbytes, "ops": ops,
        "ms": ms, "library_ms": library_ms,
        "plain_ms": time_ms(lambda: rn.rmsnorm_plain(x, gamma, cfg.norm_eps)),
        "library": "torch.nn.functional.rms_norm with gamma cast to bf16",
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "host_us": host_us(kernel), "library_host_us": host_us(library)}
    # device time per call: the kernel alone, F.rms_norm's kernels, and a
    # copy_ of the same activations (2 * r * d * 2 bytes moved), the card's
    # floor for one pass of that size
    for key, fn, tag in (("device", kernel, "rmsnorm_kernel"),
                         ("library_device", library, None),
                         ("copy_device", lambda: dst.copy_(x), None)):
        got = device_ms(fn, tag)
        rows["rmsnorm"][f"{key}_ms"], rows["rmsnorm"][f"{key}_kernels"] = \
            got if got else (None, None)
    rows["rmsnorm"]["copy_bytes"] = 2 * x.numel() * x.element_size()
    for name, row in rows.items():
        row["bound_share"] = row["bound_ms"] / row["ms"]
        print(f"    {name}: {row['ms']:.4f} ms kernel, {row['plain_ms']:.4f} "
              f"ms plain, {row['library_ms']:.4f} ms {row['library']}, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
              f"{100 * row['bound_share']:.1f}% of bound")
    row = rows["rmsnorm"]
    if row["device_ms"] is None:
        print("    rmsnorm device times: the profiler recorded no device "
              "activity; not measured")
    else:
        print(f"    rmsnorm by device time a call: kernel "
              f"{row['device_ms'] * 1e3:.3f} us "
              f"({100 * row['bound_ms'] / row['device_ms']:.1f}% of bound), "
              f"F.rms_norm {row['library_device_ms'] * 1e3:.3f} us in "
              f"{row['library_device_kernels']:g} kernel(s), copy_ of "
              f"{row['copy_bytes']} bytes {row['copy_device_ms'] * 1e3:.3f} us")
    print(f"    rmsnorm host time a call (dispatch): wrapper "
          f"{row['host_us']:.2f} us, F.rms_norm {row['library_host_us']:.2f} us")
    return rows


def phase_lm_profile(models, data, cfg, params):
    """One full-width local step (forward, backward, fused-SGD on every
    leaf) under ``torch.profiler``: device time by kernel name and the
    device's idle share of the step's host wall. A profiler that records
    no device activity here reads as not measured."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from repro_torch.core.fedavg import local_sgd_update
    from repro_torch.launch.federated_lm import MOMENTUM
    local = {k: v.detach().clone() for k, v in params.items()}
    batch = data.batch(1, 0, LM_RUN["batch"], device="cuda")
    step = lambda: local_sgd_update(
        lambda p, b: models.loss_fn(p, cfg, b), local, batch,
        lr=LM_RUN["lr"], momentum=MOMENTUM)
    step()                                    # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("    profile: no device activity recorded; not measured")
        return None
    by_name = collections.Counter()
    spans = []
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
        spans.append((e.time_range.start, e.time_range.end))
    spans.sort()
    busy_us, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_ms = (busy_us + cur_e - cur_s) / 1e3
    top = [[name[:90], ms] for name, ms in by_name.most_common(10)]
    # the port's kernels by their device time alone; the CUDA-event
    # timings of phase 7 (c) also hold the wrapper's host work whenever
    # the device waits for it
    ours = {}
    for tag in ("fused_sgd_kernel", "rmsnorm_kernel"):
        times = [e.time_range.elapsed_us() / 1e3 for e in kernels
                 if tag in e.name]
        ours[tag] = {"launches": len(times), "device_ms": sum(times),
                     "ms_per_launch": sum(times) / max(1, len(times))}
    out = {"step_wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": 1.0 - busy_ms / wall_ms,
           "kernel_sum_ms": sum(by_name.values()), "kernels": len(kernels),
           "top": top, "ours": ours}
    print(f"    one local step under the profiler: {wall_ms:.2f} ms host "
          f"wall, device busy {busy_ms:.2f} ms ({100 * out['idle_share']:.1f}"
          f"% idle), {len(kernels)} kernels")
    for name, ms in top:
        print(f"      {ms:8.3f} ms  {name}")
    for tag, row in ours.items():
        print(f"      {tag}: {row['launches']} launches, "
              f"{row['ms_per_launch']:.5f} ms device time each")
    return out


# ---------------------------------------------------------------------------
# Phases 8-11: faults, plugin topologies and the population engine
# ---------------------------------------------------------------------------

# the smoke gate's upload model without its 16 Mbit/s link: at 134 M
# elements every upload would take over a minute, and the 2-4 s deadlines
# of the fault rows would cut every client
FULL_UPLOAD = dict(jitter_s=3.0, rate_jitter=0.5, seed=11)
STALE_ROUNDS = 3
# the smoke gate's factor, and one a backoff chain overruns at this width:
# a VGG-16 shard's fold is expected to take ~20 s, so 1.2 waits ~4 s past
# it, longer than the 2 s retry backoff delays a failed primary
HEDGE_FACTORS = (1.2, 1.05)
POP_CI = dict(n=100_000, seed=1, participation_k=4_096,
              faults=dict(seed=7, dropout_rate=0.05, failure_rate=0.1),
              upload=dict(mbps=16.0, jitter_s=3.0, seed=11))
POP_NS = (100_000, 1_000_000)      # benchmarks/scale_bench.py's two largest
POP_GRAD_ELEMS = 4_096
# benchmarks/scale_bench.py's upload model and lifted Lambda timeout
POP_UPLOAD = dict(mbps=16.0, jitter_s=3.0, rate_jitter=0.5, compute_s=2.0,
                  compute_jitter=1.0, seed=11)
POP_TIMEOUT_S = 10_000_000
CODEC_POP_N = 64


class _KernelWeights:
    """Wraps ``fold_nodes`` for one phase: records the weights of every
    weighted node a CUDA launch folds (the engine looks the function up at
    call time), and restores the wrapper on exit."""

    def __init__(self, fs):
        self.fs, self.real, self.weights = fs, fs.fold_nodes, []

    def __enter__(self):
        def counting(nodes, acc="f64", **kw):
            nodes = list(nodes)
            if nodes and nodes[0][0][0].device.type == "cuda":
                self.weights.extend(w for _x, w in nodes if w is not None)
            return self.real(nodes, acc, **kw)
        self.fs.fold_nodes = counting
        return self

    def __exit__(self, *exc):
        self.fs.fold_nodes = self.real

    @property
    def non_unit(self) -> int:
        return sum(1 for ws in self.weights for w in ws if w != 1.0)


def _same_round(label, a, b, check_bits=True):
    """Two engines' results of one round: the mean bit for bit and every
    accounting field alike."""
    import torch
    acct = lambda r: (r.puts, r.gets, r.wall_clock_s, r.phases_s,
                      sum(x.billed_gb_s for x in r.records),
                      tuple(int(i) for i in r.arrivals), r.retries,
                      r.hedges, r.hedge_wins, r.stale_folded)
    if acct(a) != acct(b):
        fail(f"{label}: accounting differs between engines: {acct(a)} vs "
             f"{acct(b)}")
    avg = a.avg_flat
    if avg.device.type != "cuda" or not bool(torch.isfinite(avg).all()):
        fail(f"{label}: avg_flat is not a finite CUDA tensor")
    if check_bits and not bits_equal(avg, b.avg_flat):
        fail(f"{label}: batched != streaming on the card")


def phase_faults(fs, smoke, grads, FederatedSession, UploadModel):
    """(a) GradsSharding at VGG-16 width under the fault rows, stale
    re-entry and hedging: batched (the kernel) against streaming (plain
    torch ops) on the card, bit for bit."""
    import torch
    upload = UploadModel(**FULL_UPLOAD)
    base = dict(topology="gradssharding", n_shards=N_SHARDS, upload=upload,
                readahead_k=1, codec="identity", device="cuda")
    out = {"rounds": {}, "walls_s": {}}
    with _KernelWeights(fs) as kw:
        for name, knobs in smoke.FAULT_CASES:
            knobs = dict(knobs, upload=upload)
            res, walls = {}, []
            for engine in ("batched", "streaming"):
                session = FederatedSession(**{**base, **knobs},
                                           engine=engine)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res[engine] = session.round(grads)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            _same_round(name, res["batched"], res["streaming"])
            r = res["batched"]
            out["rounds"][name] = {
                "delivered_fraction": r.delivered_fraction,
                "arrivals": len(r.arrivals), "retries": r.retries,
                "wall_s": r.wall_clock_s}
            out["walls_s"][name] = walls
            print(f"[8] {name}: delivered {r.delivered_fraction:.3f} "
                  f"({len(r.arrivals)} arrivals), {r.retries} retries, "
                  f"modeled wall {r.wall_clock_s:.3f} s; batched == "
                  f"streaming; host walls {walls[0]:.3f} / {walls[1]:.3f} s")
            del res, r, session

        stale = {}
        for engine in ("batched", "streaming"):
            session = FederatedSession(
                **base, engine=engine, schedule="pipelined",
                faults=smoke.STALE_FAULTS, deadline_s=smoke.STALE_DEADLINE_S,
                staleness_policy=smoke.STALE_POLICY)
            stale[engine] = list(session.run(lambda rnd: grads,
                                             rounds=STALE_ROUNDS))
            totals = session.fault_totals
            del session
        for i, (a, b) in enumerate(zip(stale["batched"],
                                       stale["streaming"])):
            _same_round(f"stale round {i}", a, b)
        folded = kw.non_unit
        if totals["stale_folded"] == 0 or folded == 0:
            fail(f"stale re-entry folded {totals['stale_folded']} entries, "
                 f"{folded} kernel weights != 1.0")
        out["stale"] = {"fault_totals": totals,
                        "kernel_weights_not_one": folded,
                        "weights": sorted({w for ws in kw.weights
                                           for w in ws if w != 1.0})}
        print(f"    stale re-entry, {STALE_ROUNDS} rounds: {totals}; "
              f"{folded} stale weights != 1.0 folded by the kernel "
              f"{out['stale']['weights']}; batched == streaming each round")
        del stale

    chains = {}
    for hedge in (None,) + HEDGE_FACTORS:
        for engine in ("batched", "streaming"):
            session = FederatedSession(**base, engine=engine,
                                       schedule="pipelined",
                                       faults=smoke.HEDGE_FAULTS,
                                       hedge_factor=hedge)
            chains[hedge, engine] = list(session.run(
                lambda rnd: grads, rounds=smoke.ROBUST_ROUNDS))
            if engine == "batched":
                out[f"hedge_{hedge}"] = session.fault_totals
            del session
        for i, (a, b) in enumerate(zip(chains[hedge, "batched"],
                                       chains[hedge, "streaming"])):
            _same_round(f"hedge {hedge} round {i}", a, b)
    for hedge in HEDGE_FACTORS:
        for i, (a, b) in enumerate(zip(chains[hedge, "batched"],
                                       chains[None, "batched"])):
            if not bits_equal(a.avg_flat, b.avg_flat):
                fail(f"hedge {hedge} round {i}: mean != its unhedged twin")
        print(f"    hedging at {hedge}, {smoke.ROBUST_ROUNDS} rounds: "
              f"{out[f'hedge_{hedge}']}; hedged mean == unhedged twin, "
              f"batched == streaming each round")
    if out[f"hedge_{HEDGE_FACTORS[-1]}"]["hedges"] == 0:
        fail(f"no hedge fired at hedge_factor {HEDGE_FACTORS[-1]}")
    return out


def phase_plugins(fs, grads, FederatedSession, UploadModel):
    """(b) sharded_tree and geo_tiered at VGG-16 width, barrier and
    pipelined: batched against streaming bit for bit, and sharded_tree's
    mean against lambda_fl's."""
    import torch
    upload = UploadModel(**FULL_UPLOAD)
    base = dict(upload=upload, readahead_k=1, codec="identity",
                device="cuda")
    lam = FederatedSession(topology="lambda_fl", engine="batched",
                           **base).round(grads).avg_flat
    walls = {}
    for topology in ("sharded_tree", "geo_tiered"):
        for schedule in ("barrier", "pipelined"):
            res, w = {}, []
            for engine in ("batched", "streaming"):
                session = FederatedSession(topology=topology,
                                           n_shards=N_SHARDS, engine=engine,
                                           schedule=schedule, **base)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res[engine] = session.round(grads)
                torch.cuda.synchronize()
                w.append(time.perf_counter() - t0)
                del session
            _same_round(f"{topology}/{schedule}", res["batched"],
                        res["streaming"])
            if topology == "sharded_tree" and \
                    not bits_equal(res["batched"].avg_flat, lam):
                fail(f"sharded_tree/{schedule}: mean != lambda_fl's")
            walls[f"{topology}/{schedule}"] = w
            print(f"[9] {topology}/{schedule}: {len(res['batched'].records)} "
                  f"invocations, modeled wall "
                  f"{res['batched'].wall_clock_s:.3f} s; batched == "
                  f"streaming{'; == lambda_fl' if topology == 'sharded_tree' else ''}"
                  f"; host walls {w[0]:.3f} / {w[1]:.3f} s")
            del res
    return walls


class _RssPeak:
    """The process's resident set, sampled every 5 ms in a thread while a
    round runs: the host peak of that round, not of the whole script."""

    def __init__(self):
        import threading
        self.peak = self.start = self._rss()
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def _rss() -> int:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * 4096

    def _run(self):
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, self._rss())

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()
        self.peak = max(self.peak, self._rss())


def _plain_fold_nodes(fs):
    """``fold_nodes`` with the kernel swapped for its plain version on the
    card (the population's reference fold)."""
    def fold(nodes, acc="f64", *, carry=None, finalize=True, divisors=None):
        nodes = list(nodes)
        carry = [None] * len(nodes) if carry is None else list(carry)
        return [fs.fedavg_stream_plain(
            x, w, acc, carry=c, finalize=finalize,
            divisor=None if divisors is None else divisors[j])
            for j, ((x, w), c) in enumerate(zip(nodes, carry))]
    return fold


def _pop_round(make_session):
    """One population round: the result, host wall, the round's host RSS
    peak above its start and the device peak above the live tensors."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with _RssPeak() as rss:
        t0 = time.perf_counter()
        r = make_session().round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return r, {"host_wall_s": wall, "host_rss_peak_mb": rss.peak / 2**20,
               "host_rss_rise_mb": (rss.peak - rss.start) / 2**20,
               "device_peak_mb":
                   (torch.cuda.max_memory_allocated() - base) / 2**20}


def phase_population(fs, FederatedSession, ClientPopulation, UploadModel,
                     FaultModel, LambdaLimits):
    """(c) the population engine at the cohort sizes its users run: the CI
    scale job's geo_tiered round (N = 10^5, K = 4,096) and GradsSharding
    rounds at N = 10^5 and 10^6, each mean bit for bit against the plain
    chunked fold of the same rows on the card, the device peak O(one
    chunk), independent of N."""
    import torch
    from repro_torch.serverless import population as popmod
    chunk_mb = popmod.CHUNK_ROWS * POP_GRAD_ELEMS * 4 / 2**20
    bound_mb = 4 * chunk_mb          # two live chunks, accumulators, table
    out, launches = {}, {}
    ci = dict(topology="geo_tiered", schedule="pipelined",
              participation_k=POP_CI["participation_k"],
              faults=FaultModel(**POP_CI["faults"]),
              upload=UploadModel(**POP_CI["upload"]), log_ops=False,
              track_codec_error=False, device="cuda")
    make = lambda: FederatedSession(
        population=ClientPopulation(POP_CI["n"], seed=POP_CI["seed"]), **ci)
    fs.LAUNCHES = 0                  # the population path starts here
    r, stats = _pop_round(make)
    launches["geo_ci"] = fs.LAUNCHES
    real = fs.fold_nodes
    fs.fold_nodes = _plain_fold_nodes(fs)
    try:
        want = make().round().avg_flat
    finally:
        fs.fold_nodes = real
    if launches["geo_ci"] == 0 or not bits_equal(r.avg_flat, want):
        fail(f"population geo_tiered N={POP_CI['n']}: {launches['geo_ci']} "
             f"launches; mean == plain chunked fold: "
             f"{bits_equal(r.avg_flat, want)}")
    stats.update(arrivals=len(r.arrivals), aggregators=len(r.records),
                 modeled_wall_s=r.wall_clock_s, launches=launches["geo_ci"])
    out[f"geo_tiered_{POP_CI['n']}"] = stats
    print(f"[10] population geo_tiered N={POP_CI['n']} K="
          f"{POP_CI['participation_k']} (CI scale round): {len(r.arrivals)} "
          f"arrivals, {len(r.records)} aggregators, {stats['launches']} "
          f"kernel launches; mean == plain chunked fold; host wall "
          f"{stats['host_wall_s']:.2f} s, host RSS peak "
          f"{stats['host_rss_peak_mb']:.0f} MB (+{stats['host_rss_rise_mb']:.0f}"
          f"), device peak {stats['device_peak_mb']:.2f} MB")
    del r, want

    limits = LambdaLimits(max_timeout_s=POP_TIMEOUT_S)
    for n in POP_NS:
        pop = ClientPopulation(n, grad_elems=POP_GRAD_ELEMS, seed=1)
        make = lambda: FederatedSession(
            topology="gradssharding", population=pop,
            upload=UploadModel(**POP_UPLOAD), limits=limits, log_ops=False,
            keep_records=False, track_codec_error=False, device="cuda")
        before = fs.LAUNCHES
        r, stats = _pop_round(make)
        stats["launches"] = launches[f"gradssharding_{n}"] = \
            fs.LAUNCHES - before
        # the plain chunked fold of the same rows, in the same order
        acc, t0 = None, time.perf_counter()
        members = r.arrivals
        chunks = list(range(0, len(members), popmod.CHUNK_ROWS))
        for i, s in enumerate(chunks):
            rows = pop.grads(0, members[s:s + popmod.CHUNK_ROWS], "cuda")
            last = i == len(chunks) - 1
            acc = fs.fedavg_stream_plain(
                rows, carry=acc, finalize=last,
                divisor=float(len(members)) if last else None)
        torch.cuda.synchronize()
        stats["plain_check_s"] = time.perf_counter() - t0
        expect = math.ceil(len(members) / popmod.CHUNK_ROWS)
        if stats["launches"] != expect or not bits_equal(r.avg_flat, acc):
            fail(f"population gradssharding N={n}: {stats['launches']} "
                 f"launches (expected {expect}); mean == plain chunked "
                 f"fold: {bits_equal(r.avg_flat, acc)}")
        if stats["device_peak_mb"] > bound_mb:
            fail(f"population gradssharding N={n}: device peak "
                 f"{stats['device_peak_mb']:.2f} MB above the O(chunk) "
                 f"bound {bound_mb:.0f} MB")
        stats.update(arrivals=len(members), modeled_wall_s=r.wall_clock_s)
        out[f"gradssharding_{n}"] = stats
        print(f"     population gradssharding N={n}: {stats['launches']} "
              f"carry launches; mean == plain chunked fold "
              f"({stats['plain_check_s']:.1f} s); host wall "
              f"{stats['host_wall_s']:.2f} s, host RSS peak "
              f"{stats['host_rss_peak_mb']:.0f} MB (+"
              f"{stats['host_rss_rise_mb']:.0f}), device peak "
              f"{stats['device_peak_mb']:.2f} MB")
        del r, acc, pop
    small, large = (out[f"gradssharding_{n}"]["device_peak_mb"]
                    for n in POP_NS)
    if large > small + 1.0:
        fail(f"the device peak grew with N: {small:.2f} MB at N={POP_NS[0]}, "
             f"{large:.2f} MB at N={POP_NS[1]}")
    out["device_peak_bound_mb"] = bound_mb
    return out, launches


def phase_population_codec(fs, q, FederatedSession, ClientPopulation):
    """(d) one small population round under qsgd8 per population topology
    that decodes whole rows or shards: the codec kernels run through the
    population's decode, and the round equals the eager round over the
    materialized cohort on the card."""
    import torch
    pop = ClientPopulation(CODEC_POP_N, grad_elems=POP_GRAD_ELEMS, seed=3)
    rows = {}
    for topology in ("gradssharding", "geo_tiered"):
        kw = dict(topology=topology, schedule="pipelined", codec="qsgd8",
                  readahead_k=2, device="cuda")
        q.QUANTIZE_LAUNCHES = q.DEQUANTIZE_LAUNCHES = 0
        folds = fs.LAUNCHES
        lazy = FederatedSession(population=pop, **kw).round()
        launched = (q.QUANTIZE_LAUNCHES, q.DEQUANTIZE_LAUNCHES,
                    fs.LAUNCHES - folds)
        eager = FederatedSession(**kw).round(pop.materialize(0, "cuda"))
        if min(launched) == 0:
            fail(f"qsgd8 population {topology}: launches (quantize, "
                 f"dequantize, fold) {launched}")
        _same_round(f"qsgd8 population {topology}", lazy, eager,
                    check_bits=False)
        if not bits_equal(lazy.avg_flat, eager.avg_flat) \
                or lazy.codec_error != eager.codec_error:
            fail(f"qsgd8 population {topology}: != the eager round")
        rows[topology] = {"launches": launched,
                          "codec_error": lazy.codec_error}
        print(f"[11] qsgd8 population {topology} N={CODEC_POP_N}: launches "
              f"(quantize, dequantize, fold) {launched}; == eager round over "
              f"the materialized cohort, codec_error {lazy.codec_error!r}")
    torch.cuda.synchronize()
    return rows


def phase_carry_timing(fs, peak):
    """The carry form at the population's shapes: one 512-row chunk of
    4,096-element rows into an f32 accumulator (GradsSharding) and into
    an f64 one (the weighted plans), beside the bound, the plain version
    and ``torch.sum`` over the chunk (the same sum without the carry)."""
    import torch
    from repro_torch.serverless import population as popmod
    bw, f32, f64 = peak
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    n, L = popmod.CHUNK_ROWS, POP_GRAD_ELEMS
    rows = torch.randn(n, L, generator=gen, device="cuda")
    out = {}
    for name, weighted in (("carry_f32", False), ("carry_f64", True)):
        w = [1.0] * n if weighted else None
        acc = fs.fold_nodes([(rows, w)], finalize=False)[0]
        kernel = lambda: fs.fold_nodes([(rows, w)], carry=[acc],
                                       finalize=False)
        plain = lambda: fs.fedavg_stream_plain(rows, w, carry=acc,
                                               finalize=False)
        nbytes = n * L * 4 + 2 * L * acc.element_size()
        ops = n * L
        t_bytes, t_ops = nbytes / bw, ops / (f64 if weighted else f32)
        got = device_ms(kernel, "fedavg_fold_kernel")
        row = {"rows": n, "elements": L, "bytes": nbytes, "ops": ops,
               "ms": time_ms(kernel), "plain_ms": time_ms(plain),
               "library_ms": time_ms(lambda: torch.sum(rows, dim=0)),
               "device_ms": got[0] if got else None,
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        out[name] = row
        dev = "not measured" if got is None else \
            f"{row['device_ms']:.4f} ms ({100 * row['bound_ms'] / row['device_ms']:.1f}% of bound)"
        print(f"     {name}: one {n} x {L} chunk: {row['ms']:.4f} ms kernel "
              f"(events), device {dev}, plain {row['plain_ms']:.3f} ms, "
              f"torch.sum {row['library_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']})")
    return out


def main() -> None:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the port's sources are not under {SRC}")
    card, name = phase_card()
    sys.path.insert(0, str(SRC))
    import torch
    from repro_torch.api import FederatedSession
    from repro_torch.configs.paper_workloads import VGG16
    from repro_torch.core import cost_model as cm
    from repro_torch.core.sharding import plan_uniform
    from repro_torch.kernels import build
    from repro_torch.kernels import fedavg_stream as fs
    from repro_torch.kernels import quantize as q
    from repro_torch.kernels import topk_sparsify as tk
    from repro_torch.kernels import fused_sgd as sgd
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import federated_lm
    from repro_torch.models import layers
    from repro_torch.models import registry as models
    from repro_torch import smoke
    from repro_torch.config import LambdaLimits
    from repro_torch.core.cost_model import UploadModel
    from repro_torch.serverless.faults import FaultModel
    from repro_torch.serverless.population import ClientPopulation

    phase_build(build)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    grads = [torch.randn(VGG16.params, generator=gen, device="cuda")
             for _ in range(N_CLIENTS)]
    max_err = phase_kernel_vs_plain(fs, grads, cm, plan_uniform)
    codec_errs = phase_codec_kernels(q, tk, grads, plan_uniform)
    phase_pinned(fs, smoke, FederatedSession)
    launches, per_topo, walls, rows = phase_full_width(
        fs, grads, cm, plan_uniform, FederatedSession, peaks(name))
    codec_counts, codec_per_round, codec_walls = phase_full_width_codecs(
        fs, q, tk, grads, cm, plan_uniform, FederatedSession)
    codec_rows = phase_codec_timings(q, tk, grads, plan_uniform, peaks(name))
    del grads

    # f32 products in the model run in full f32 (no TF32), as stated
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lm_cfg = dataclasses.replace(get_arch(LM_ARCH).model, remat=False)
    lm_data = SyntheticLM(vocab=lm_cfg.vocab, seq_len=LM_RUN["seq"], seed=0,
                          markov_concentration=0.4)
    lm_params = models.init_params(torch.Generator(device="cuda").manual_seed(
        federated_lm.SEED), lm_cfg)
    torch.cuda.empty_cache()
    lm_grads, lm_errs = phase_lm_kernels(sgd, rn, layers, models, lm_data,
                                         lm_cfg, lm_params)
    del lm_params
    trained, lm_launches, lm_means, lm_walls, lm_peak = phase_lm_path(
        fs, sgd, rn, federated_lm, lm_cfg)
    lm_rows = phase_lm_timings(sgd, rn, layers, lm_cfg, trained, lm_grads,
                               peaks(name))
    del lm_grads
    lm_profile = phase_lm_profile(models, lm_data, lm_cfg, trained)
    del trained
    torch.cuda.empty_cache()

    # phases 8-9: the same VGG-16 gradients, drawn again from the seed
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    grads = [torch.randn(VGG16.params, generator=gen, device="cuda")
             for _ in range(N_CLIENTS)]
    fs.LAUNCHES = 0                      # the fault and plugin paths
    faults_out = phase_faults(fs, smoke, grads, FederatedSession,
                              UploadModel)
    plugin_walls = phase_plugins(fs, grads, FederatedSession, UploadModel)
    fault_launches = fs.LAUNCHES
    del grads
    torch.cuda.empty_cache()
    pop_out, pop_launches = phase_population(
        fs, FederatedSession, ClientPopulation, UploadModel, FaultModel,
        LambdaLimits)
    pop_codec = phase_population_codec(fs, q, FederatedSession,
                                       ClientPopulation)
    carry_rows = phase_carry_timing(fs, peaks(name))

    head = rows[0]                       # the GradsSharding wave
    print(json.dumps({"waves": rows, "round_walls_s": walls,
                      "launches_per_topology": per_topo,
                      "codec_kernels": codec_rows,
                      "codec_round_walls_s": codec_walls,
                      "codec_launches_per_round": codec_per_round,
                      "lm_kernels": lm_rows, "lm_launches": lm_launches,
                      "lm_mean_losses": lm_means, "lm_walls_s": lm_walls,
                      "lm_peak_memory_gb": lm_peak,
                      "lm_step_profile": lm_profile,
                      "faults": faults_out, "plugin_round_walls_s":
                          plugin_walls, "population": pop_out,
                      "population_codec": pop_codec,
                      "fold_launches": {"main_path": launches,
                                        "faults_and_plugins": fault_launches,
                                        "population": pop_launches},
                      "carry": carry_rows, "card": card}))
    kernels = [{
        "name": "fedavg_stream", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fedavg_stream.cu",
        "replaces": "src/repro/kernels/fedavg_stream.py:47",
        "launches": launches + fault_launches + sum(pop_launches.values()),
        "max_abs_err": max_err,
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "equal_plain": True,
        "carry": carry_rows}]
    for name, source, replaces in (
            ("quantize", "quantize.cu", "src/repro/kernels/quantize.py:33"),
            ("dequantize", "quantize.cu", "src/repro/kernels/quantize.py:55"),
            ("topk_sparsify", "topk_sparsify.cu",
             "src/repro/kernels/topk_sparsify.py:44")):
        row = codec_rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": codec_counts[name],
            "max_abs_err": codec_errs[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "device_ms": row["device_ms"], "equal_plain": True})
    for name, replaces, exact in (
            ("fused_sgd", "src/repro/kernels/fused_sgd.py:29", True),
            ("rmsnorm", "src/repro/kernels/rmsnorm.py:25", False)):
        row = lm_rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": lm_launches[name],
            "max_abs_err": lm_errs[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "equal_plain": exact})
    norm = lm_rows["rmsnorm"]
    kernels[-1].update({"device_ms": norm["device_ms"],
                        "library_device_ms": norm["library_device_ms"],
                        "copy_device_ms": norm["copy_device_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
