#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100 at
full width, and time its kernels for PERF.md's kernel table.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

The card tests hold every kernel and path at sizes a test can take
(``python -m pytest -q -m cuda tests/test_torch_cuda.py
tests/test_torch_tracing.py``, in the same call). This script keeps what
needs the real size, or what the kernel table reads, and holds every
kernel it times to its plain version at the timed shapes. Phases, each
fatal on failure:

1. the card: ``nvidia-smi`` name and power limit; no CUDA device, or a card
   other than the H100 SXM (HBM3) whose data sheet ``perfbench.cost``
   holds, is an error;
2. build the seven kernel sources of ``src/repro_torch/kernels/csrc`` with
   nvcc, one process each, all started together;
3. full width: 20 VGG-16 gradients made on the card from a seed (N = 20,
   M = 4); every dependency wave of the GradsSharding, λ-FL and LIFL folds
   through the fold kernel against its plain version, bit for bit; then
   each topology's rounds through ``FederatedSession(...,
   engine="batched", device="cuda")``: the fold kernel launched, each mean
   equal to the plain fold bit for bit and, on a 1 M-element slice, to a
   numpy fold on the host; then each wave's time (CUDA events, median of
   7; device time) beside its bound, the plain version's time and
   ``torch.mean`` over a pre-stacked tensor;
4. full width under the ``qsgd8`` and ``topk`` wire codecs, each topology:
   one encode and one decode launch a client contribution, each mean equal
   to the plain pipeline (plain encode, decode and fold) on the card bit
   for bit and a numpy mirror on a 256-tile slice, and ``codec_error`` the
   plain pipeline's; then each codec kernel's time on one VGG-16 shard
   beside its bound, its plain version's and, for dequantize, one
   ``torch.mul``;
5. federated LM at full width (``tinyllama-1.1b``, 1.1 B parameters): two
   rounds of ``federated_lm.run`` (N = 4, M = 4, 2 local steps, batch 8,
   sequence 64, lr 0.05, batched engine): rmsnorm launched 45 times a
   forward, fused-SGD 12 a local step, the fold at least once a round,
   every loss finite, the second round's mean client loss below the
   first's, each round's mean equal to the plain fold of the four client
   deltas bit for bit; then the fused-SGD kernel over one step's 12 leaves
   (each bit for bit its plain version) and rmsnorm at (512, 2048) bf16
   (within one bf16 ulp of its plain version) beside their bounds, plain
   versions and one PyTorch call each, and the peak device memory;
6. faulty, stale and hedged GradsSharding rounds on the VGG-16 gradients
   (the reference's fault rows; 3-round sessions with stale re-entry under
   polynomial staleness weights; hedging at the gate's 1.2 and at 1.05,
   which must fire at this width): the batched engine (the fold kernel)
   against the streaming engine (plain torch ops) bit for bit, accounting
   alike, a stale weight other than 1.0 folded by the kernel, each hedged
   mean equal to its unhedged twin; then ``sharded_tree`` and
   ``geo_tiered``, barrier and pipelined, batched against streaming, and
   ``sharded_tree``'s mean equal to ``lambda_fl``'s;
7. the population engine: the CI scale job's round (``geo_tiered``, N =
   10^5, K = 4,096) and GradsSharding rounds at N = 10^5 and 10^6, folded
   by the kernel's carry route (one launch a 512-row chunk), each mean bit
   for bit the plain chunked fold of the same rows; host wall, host RSS
   peak and device peak, which stays within four chunks and does not grow
   with N; then one carry launch at the population's shape, f32 and f64,
   by device time beside its bound, ``torch.sum`` over the chunk and the
   table kernel;
8. serving: rmsnorm at the dense archs' decode rows, within one bf16 ulp
   of its plain version, by device time;
   full-width ``tinyllama-1.1b`` at f32: 12 decode steps at batch 2
   against ``forward`` (rtol = atol = 5e-3), 45 rmsnorm launches a step;
   ``serve_loop`` at full width with the reference's defaults (batch 4,
   prompt 8, 16 new tokens, ``max_len`` 64, bf16): 45 launches a step,
   the same tokens from a second loop, tokens/s, peak device memory, the
   median host wall of a decode step, one profiled step beside its bytes
   bound;
9. the other families at full width, one model at a time
   (``falcon-mamba-7b``, ``zamba2-2.7b``, ``whisper-tiny``, and cut in
   depth ``phi3.5-moe-42b-a6.6b``, ``dbrx-132b``, ``chameleon-34b``):
   rmsnorm at their rows as in phase 8; 12 f32 decode steps at batch 2
   against ``forward`` (5e-3), ``norms_per_decode_step`` launches a step;
   a bf16 ``serve_loop`` (its launches, tokens/s, peak memory), 20 timed
   decode steps, one profiled step beside its bytes bound;
10. long context at full width, f32, batch 1, S = 8,192:
   ``tinyllama-1.1b``'s chunked attention against its dense attention and
   ``h2o-danube-1.8b``'s 2-D causal tiling against its chunked attention,
   within 1e-3 on the logits; the key blocks skipped, walls and peaks;
11. the single-program trainer (``repro_torch.launch.train``) at full
   width, ``tinyllama-1.1b``, batch 8, sequence 128, on a one-rank NCCL
   group and a (1, 1) ("data", "model") mesh: one step of each plan
   (losses within 1e-5, parameters within rtol 5e-4 / atol 1e-4 of
   ``none``, 45 rmsnorm launches a step; host wall, peak memory, busy
   share); zero1's AdamW shard update beside its bytes bound; the
   shard_map step at momentum 0 within rtol 2e-4, atol 2e-5 of a
   single-device SGD step and with qsgd8, each kernel call at 1.1 B
   elements bit for bit its plain version; ``train_loop`` for 4 steps and
   the restart test at the smoke config; a VGG-16 round on the
   ``host_mesh`` engine bit for bit the streaming round (4 launches);
   ``phi3.5-moe-42b-a6.6b`` (2 layers, f32): the local MoE dispatch within
   2e-4 of the global one;
12. tensor parallelism on one card: rmsnorm at ``qwen3-32b``'s rows as in
   phase 8, and the split route (Mamba-2's gated norm cut over ranks) at
   zamba2's rank blocks: each block's launches against their plain
   versions, the joined blocks against the whole-row kernel, one block bit
   for bit it, and the device times, the training block's over copies
   that outgrow the L2; then, on a one-rank NCCL group and a (1, 1) mesh,
   ``qwen3-32b`` at full depth (bf16, 65.6 GB) through
   ``serve_loop(mesh=)``: 257 rmsnorm launches a step, tokens/s, 20 timed
   steps, peak memory, one profiled step beside its bytes bound; and
   ``falcon-mamba-7b``, ``zamba2-2.7b`` and ``whisper-tiny`` as registered
   (bf16 for serving) through the mesh's ``make_serve_step``, 23 steps bit
   for bit the mesh-less step (logits and every cache leaf),
   ``norms_per_decode_step`` rmsnorm launches a step and none split;
13. the examples through their ``main`` with ``--device cuda``:
   ``quickstart`` (plain and pipelined qsgd8), ``faulty_round`` (plain and
   stale/hedged) and ``compression_composition`` at their defaults, each
   reaching its kernels; ``million_clients`` at N = 10^3, 10^4, 10^5 (host
   seconds, RSS and device peaks; N = 10^3's walls and costs equal to the
   CPU's); ``compression_composition --size 138357544`` (VGG-16: identity
   equal to numpy's left fold bit for bit, each codec's wire MB, billed
   GB-s, ``codec_error`` and walls); ``elastic_reshard``;
   ``serve_sharded`` for every arch (``norms_per_decode_step`` launches a
   step); ``train_federated_lm`` for two rounds of full-width
   ``tinyllama-1.1b`` (phase 5's checks); then the reference's federated
   CNN loop at ``CNNConfig()``'s default width, one round a topology:
   fused-SGD once a leaf a local step, the fold launched, the three models
   within rtol 1e-4, atol 1e-5;
14. Mamba-1's associative scan at ``falcon-mamba-7b``'s width and
   train_4k's length: one block, forward and backward at (1, 4,096,
   4,096) f32, within 1e-4 of max |want| of an f64 loop over every step,
   beside the per-step loop it replaced; one ``jit_train_step`` step cut
   to 8 of 64 layers (17 rmsnorm launches a step); the 64-layer prefill
   in bf16 (65 launches a forward);
15. the causal attention kernels at GPT-2 Large's (4, 1,024, 20, 64) and
   at (2, 1,000, 32 q / 8 kv heads, 128): the output and gradients no
   further from an f32 attention than the dense path (10 % room), two runs
   the same bits, 6 launches for two; the device time of a forward and
   backward beside its bound, the plain versions', the dense path's and
   SDPA's (``library_ms``, never called by the port), and the peak memory
   each adds;
16. the RoPE kernel at GPT-2 Large's (4, 1,024, 20, 64) bf16 and at an f32
   decode step (4, 1, 32, 128): the output and gradient bit for bit the
   plain chain's, 2 launches; the device time over copies of x and its
   gradient that outgrow the L2 against the bytes bound, the plain
   chain's, and the host's time a call for both.

Every device time comes from ``counted_device_ms``: profiles between spin
kernels that take the profiler's dropped kernels, kept only when they
record every kernel of every call. Every launch count comes from
``launches``, the growth of ``perfbench.harness.counters`` over a path.
The peaks and the kernels' least bytes are ``perfbench.cost``'s, the busy
share ``perfbench.trace``'s. Each comparison of a kernel with its plain
version that passes is recorded (``held``), and the kernels line's
``equal_plain`` reads them.

Each phase's seconds are printed before the JSON lines. The last lines
are a JSON object of timings and walls, a JSON ``kernels`` line (each
kernel's launches by path, from 0 where the path starts, whether this run
held it to its plain version bit for bit, and its timed row), and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

from perfbench import cost, trace
from perfbench.harness import counters

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
SOURCES = ("fedavg_stream", "quantize", "topk_sparsify", "fused_sgd",
           "rmsnorm", "causal_attention", "rope")
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
#: short spin kernels launched before and after each profiled window: a
#: full run's profiler left out the first or last 18 kernels of a window
PAD_KERNELS, PAD_CYCLES = 256, 2000
PROFILE_TRIES = 3
# A block of more than COLD_BYTES is timed over distinct copies that
# together hold at least COLD_POOL_BYTES (twice the H100's 50 MB L2), one
# copy a call in turn, so that each call reads its block from HBM
COLD_BYTES, COLD_POOL_BYTES = 1 << 20, 100 << 20


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def bits_equal(a, b) -> bool:
    """The same shape, type and bits, any type."""
    import torch
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(ints[a.element_size()]), b.view(ints[b.element_size()]))


#: each kernel's comparisons with its plain version that passed in this
#: run: True for one held bit for bit, False for one held within a
#: tolerance (the kernels line's ``equal_plain``)
HELD: dict = {}


def held(kernel: str, exact: bool = True) -> None:
    HELD.setdefault(kernel, set()).add(exact)


def bf16_ulps(a, b) -> int:
    """Largest distance in bf16 ulps between two bf16 tensors."""
    import torch

    def ordered(t):
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def norm_close(kernel: str, label: str, got, want, rstd=None,
               want_rstd=None) -> float:
    """An rmsnorm launch against its plain version at the rmsnorm
    tolerance (f32: rtol 1e-5, atol 1e-6; bf16: one ulp; rstd or a sum of
    squares: rtol 1e-5); fails beyond it, else records it under
    ``kernel`` and returns the largest abs error."""
    import torch
    if got.dtype != want.dtype or got.shape != want.shape:
        fail(f"{kernel} {label}: {got.dtype} {tuple(got.shape)} against "
             f"{want.dtype} {tuple(want.shape)}")
    err = float((got.float() - want.float()).abs().max()) \
        if got.numel() else 0.0
    ok = bf16_ulps(got, want) <= 1 if got.dtype == torch.bfloat16 else \
        bool(((got - want).abs() <= 1e-6 + 1e-5 * want.abs()).all())
    if rstd is not None:
        ok = ok and bool(((rstd - want_rstd).abs()
                          <= 1e-5 * want_rstd.abs()).all())
    if not ok:
        fail(f"{kernel} {label} != its plain version beyond the rmsnorm "
             f"tolerance (max abs err {err})")
    held(kernel, False)
    return err


#: the program's launch counters (``perfbench.harness.counters``'s keys)
#: and the kernel each counts
KERNEL_OF_COUNTER = {
    "repro_torch.kernels.fedavg_stream.LAUNCHES": "fedavg_stream",
    "repro_torch.kernels.quantize.QUANTIZE_LAUNCHES": "quantize",
    "repro_torch.kernels.quantize.DEQUANTIZE_LAUNCHES": "dequantize",
    "repro_torch.kernels.topk_sparsify.LAUNCHES": "topk_sparsify",
    "repro_torch.kernels.fused_sgd.LAUNCHES": "fused_sgd",
    "repro_torch.kernels.rmsnorm.LAUNCHES": "rmsnorm",
    "repro_torch.kernels.rmsnorm.SPLIT_LAUNCHES": "rmsnorm_split",
    "repro_torch.kernels.causal_attention.LAUNCHES": "causal_attention",
    "repro_torch.kernels.rope.LAUNCHES": "rope"}


def _read_counters() -> dict:
    got = counters()
    unknown = sorted(set(got) - set(KERNEL_OF_COUNTER))
    if unknown:
        fail(f"launch counters {unknown} are not in KERNEL_OF_COUNTER")
    return got


@contextlib.contextmanager
def launches(out_of: dict | None = None):
    """The kernels the block launched, by name: the growth of every
    launch counter of the program (``perfbench.harness.counters``) over
    the block. The dict it yields is filled when the block ends. Given
    ``out_of`` (the dict of an enclosing block), the block's launches are
    taken out of it: a comparison's, not the path's."""
    before = _read_counters()
    grew: dict = {}
    try:
        yield grew
    finally:
        for key, n in _read_counters().items():
            d = n - before.get(key, 0)
            if d:
                name = KERNEL_OF_COUNTER[key]
                grew[name] = grew.get(name, 0) + d
                if out_of is not None:
                    out_of[name] = out_of.get(name, 0) - d


def bound(nbytes: float, ops: float, rate: float = cost.F32_FLOPS) -> tuple:
    """The least time in ms of ``nbytes`` at the card's HBM rate and
    ``ops`` at ``rate``, and which of the two sets it."""
    t_bytes, t_ops = nbytes / cost.HBM_BPS, ops / rate
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def _pads():
    import torch
    for _ in range(PAD_KERNELS):
        torch.cuda._sleep(PAD_CYCLES)


def counted_device_ms(fn, tag: str | None, per_call: int | None):
    """Device time a call of ``fn`` under ``torch.profiler``: the kernels
    whose name holds ``tag`` (every kernel but the pads when None) over
    ``PROFILED_CALLS`` calls, between ``PAD_KERNELS`` spin kernels on
    each side, from a profile that recorded exactly ``per_call`` of them a
    call (None: as many as a profile of one call records). A profile that
    records another count is taken again; after ``PROFILE_TRIES`` the
    phase fails. Returns the time and the kernels a call."""
    import torch

    def profile(calls):
        fn()
        torch.cuda.synchronize()
        with trace.profiled(True) as tr:
            _pads()
            for _ in range(calls):
                fn()
            _pads()
        return [e - s for name, s, e in tr["kernels"]
                if "spin_kernel" not in name
                and (tag is None or tag in name)]

    counts = []
    for _ in range(PROFILE_TRIES):
        want = per_call if per_call is not None else len(profile(1))
        times = profile(PROFILED_CALLS)
        counts.append((want, len(times)))
        if want > 0 and len(times) == want * PROFILED_CALLS:
            return sum(times) / PROFILED_CALLS / 1e3, want
    fail(f"the profiler recorded (kernels a call, kernels of "
         f"{PROFILED_CALLS} calls) {counts} for {tag or 'every kernel'}")


def profiled_call(fn) -> tuple:
    """One call of ``fn`` under ``torch.profiler`` after a warm-up call,
    between spin-kernel pads: its kernels ``[(name, start_us, end_us)]``
    (``perfbench.trace.profiled``'s) and its host wall in ms."""
    import torch
    fn()
    torch.cuda.synchronize()
    with trace.profiled(True) as tr:
        _pads()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        _pads()
    return [k for k in tr["kernels"] if "spin_kernel" not in k[0]], wall_ms


def busy_row(kernels, wall_ms, bound_ms=None) -> dict | None:
    """A profiled call's reading: its host wall, the device's busy time
    (``perfbench.trace.busy_us``), idle share and kernels; the bound's
    share of busy where given."""
    if not kernels:
        return None
    busy = trace.busy_us(kernels) / 1e3
    row = {"step_wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": 1.0 - busy / wall_ms, "kernels": len(kernels),
           "rmsnorm_launches": sum(1 for k in kernels
                                   if "rmsnorm_kernel" in k[0])}
    if bound_ms is not None:
        row["bound_share_of_busy"] = bound_ms / busy
    return row


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
    if "H100" not in name or "HBM3" not in name:
        fail(f"{name!r} is not the H100 SXM (HBM3) whose published peaks "
             f"perfbench.cost holds")
    print(f"[1] card: {name}, {torch.cuda.device_count()} device(s), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return card


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


def phase_rounds(fs, grads, cm, plan_uniform, FederatedSession):
    """3: every wave of the three topologies at full width through the
    kernel against its plain version, then each topology's rounds through
    the session against the plain fold and a numpy fold of a slice; then
    each wave's times beside its bound."""
    import numpy as np
    import torch
    plain = lambda nodes: [fs.fedavg_stream_plain(i, w) for i, w in nodes]
    host = [g[:SLICE].cpu().numpy() for g in grads]
    L = int(grads[0].shape[0])
    per_topo, walls, checked = {}, {}, 0
    for topology in TOPOLOGIES:
        ws, want = waves(grads, topology, plain, cm, plan_uniform)
        for i, wave in enumerate(ws):
            if not all(bits_equal(a, b) for a, b in
                       zip(fs.fold_nodes(wave), plain(wave))):
                fail(f"{topology} wave {i}: kernel != plain")
            held("fedavg_stream")
            checked += 1
        _, want_host = waves(host, topology, numpy_fold, cm, plan_uniform)
        walls[topology] = []
        with launches() as grew:
            for _ in range(ROUNDS):
                session = FederatedSession(topology=topology,
                                           n_shards=N_SHARDS,
                                           engine="batched", device="cuda")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                result = session.round(grads)
                torch.cuda.synchronize()
                walls[topology].append(time.perf_counter() - t0)
                avg = result.avg_flat
                if avg.device.type != "cuda" or avg.shape != (L,) \
                        or not bool(torch.isfinite(avg).all()):
                    fail(f"{topology}: avg_flat is not a finite ({L},) "
                         f"CUDA tensor")
                if not bits_equal(avg, want):
                    fail(f"{topology}: avg_flat != the plain fold on the "
                         f"card")
                if not np.array_equal(
                        avg[:SLICE].cpu().numpy().view(np.int32),
                        want_host.view(np.int32)):
                    fail(f"{topology}: avg_flat[:{SLICE}] != the numpy fold")
                del session, result, avg
        per_topo[topology] = grew.get("fedavg_stream", 0)
        if per_topo[topology] <= 0:
            fail(f"{topology}: the round launched no fold kernel")
        del want
        print(f"[3] {topology}: N={len(grads)} L={L} rounds "
              f"{', '.join(f'{w:.3f}' for w in walls[topology])} s host "
              f"wall, {per_topo[topology]} launches in {ROUNDS} rounds; "
              f"mean == plain fold, [:{SLICE}] == numpy fold")
    print(f"    {checked} waves: kernel == plain, bit for bit")

    rows = []
    for topology in TOPOLOGIES:
        ws, _ = waves(grads, topology, plain, cm, plan_uniform)
        for i, wave in enumerate(ws):
            nbytes, ops, secs = cost.wave_cost(
                [(len(x), int(x[0].shape[0]), w is not None)
                 for x, w in wave])
            dev, _ = counted_device_ms(lambda: fs.fold_nodes(wave),
                                       "fedavg_fold_kernel", 1)
            rows.append({
                "topology": topology, "wave": i, "nodes": len(wave),
                "inputs": sum(len(x) for x, _ in wave),
                "weighted": wave[0][1] is not None, "bytes": nbytes,
                "ops": ops, "ms": time_ms(lambda: fs.fold_nodes(wave)),
                "device_ms": dev, "plain_ms": time_ms(lambda: plain(wave)),
                "bound_ms": secs * 1e3,
                "bound_by": "bytes" if nbytes / cost.HBM_BPS >= secs
                else "operations"})
    stacked = torch.stack(grads)
    library_ms = time_ms(lambda: stacked.mean(dim=0))
    del stacked
    for row in rows:
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        row["library_ms"] = library_ms if row["topology"] == "gradssharding" \
            else None
        print(f"    {row['topology']} wave {row['wave']}: {row['nodes']} "
              f"node(s), {row['inputs']} inputs, device {row['device_ms']:.3f}"
              f" ms, events {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} "
              f"ms, bound {row['bound_ms']:.3f} ms ({row['bound_by']}), "
              f"{100 * row['bound_share']:.1f}% of bound")
    print(f"    torch.mean over the stacked (N, L) gradients: "
          f"{library_ms:.3f} ms")
    return per_topo, walls, rows


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


def phase_codec_rounds(fs, q, tk, grads, cm, plan_uniform, FederatedSession):
    """4: full-width rounds of each topology under qsgd8 and topk."""
    import numpy as np
    import torch
    plain = lambda nodes: [fs.fedavg_stream_plain(i, w) for i, w in nodes]
    L = int(grads[0].shape[0])
    host = [g[:CODEC_SLICE].cpu().numpy() for g in grads]
    raw_mean = fs.fedavg_stream_plain(grads)       # codec_error's reference
    walls, per_round = {}, {}
    with launches() as path:
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
                    session = FederatedSession(
                        topology=topology, n_shards=N_SHARDS,
                        engine="batched", codec=codec, device="cuda")
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    with launches() as grew:
                        result = session.round(grads)
                        torch.cuda.synchronize()
                    walls[key].append(time.perf_counter() - t0)
                    got = {k: grew.get(k, 0) for k in expect}
                    if got != expect or grew.get("fedavg_stream", 0) <= 0:
                        fail(f"{key}: launches {grew}, expected {expect} "
                             f"and at least one fold")
                    avg = result.avg_flat
                    if avg.device.type != "cuda" or avg.shape != (L,) \
                            or not bool(torch.isfinite(avg).all()):
                        fail(f"{key}: avg_flat is not a finite ({L},) CUDA "
                             f"tensor")
                    if not bits_equal(avg, want):
                        fail(f"{key}: avg_flat != the plain pipeline on the "
                             f"card")
                    for k in ("fedavg_stream", *(k for k in expect
                                                 if expect[k])):
                        held(k)
                    if not np.array_equal(
                            avg[:CODEC_SLICE].cpu().numpy().view(np.int32),
                            want_host.view(np.int32)):
                        fail(f"{key}: avg_flat[:{CODEC_SLICE}] != the numpy "
                             f"mirror")
                    if result.codec_error != want_err:
                        fail(f"{key}: codec_error {result.codec_error!r} != "
                             f"the plain pipeline's {want_err!r}")
                    del session, result, avg
                per_round[key] = expect
                del want
                print(f"[4] {key}: rounds "
                      f"{', '.join(f'{w:.3f}' for w in walls[key])} s host "
                      f"wall, {expect} codec launches a round; mean == plain "
                      f"pipeline, [:{CODEC_SLICE}] == numpy mirror, "
                      f"codec_error {want_err!r}")
    return path, per_round, walls


def phase_codec_timings(q, tk, grads, plan_uniform):
    """4: each codec kernel on one VGG-16 shard (the GradsSharding encode
    and decode): its time, its plain version's, its bound, and one PyTorch
    call where one computes the same function."""
    import torch
    (a, b), = plan_uniform(int(grads[0].shape[0]), N_SHARDS).segments[0]
    x = grads[0][a:b]
    n = b - a
    codes, scales = q.quantize(x)
    whole = (n // TILE) * TILE
    # quantize and dequantize: perfbench.cost's bytes (half its
    # round trip each way); top-k reads and writes 4 bytes an element: |x|,
    # max, 24 compare-and-count steps and a select
    work = {
        "quantize": (cost.codec_bound_s(n) / 2 * 1e3, "bytes",
                     lambda: q.quantize(x), lambda: q.quantize_plain(x),
                     None),
        "dequantize": (cost.codec_bound_s(n) / 2 * 1e3, "bytes",
                       lambda: q.dequantize(codes, scales),
                       lambda: q.dequantize_plain(codes, scales),
                       lambda: torch.mul(codes[:whole].view(-1, TILE),
                                         scales[:whole // TILE, None])),
        "topk_sparsify": (*bound(8 * n, (2 + 2 * 24 + 1) * n),
                          lambda: tk.topk_sparsify(x, TOPK_K),
                          lambda: tk.topk_plain(x, TOPK_K), None),
    }
    rows = {}
    for name, (bound_ms, by, kernel, plain, library) in work.items():
        dev, _ = counted_device_ms(kernel, f"::{name.split('_')[0]}_kernel",
                                   1)
        row = {"elements": n, "ms": time_ms(kernel), "device_ms": dev,
               "plain_ms": time_ms(plain), "bound_ms": bound_ms,
               "bound_by": by, "bound_share": bound_ms / dev,
               "library_ms": time_ms(library) if library else None}
        rows[name] = row
        lib = f"{row['library_ms']:.3f} ms" if library else "none"
        print(f"    {name} on one shard ({n} elements): device {dev:.4f} ms "
              f"({100 * row['bound_share']:.1f}% of bound), events "
              f"{row['ms']:.3f} ms, {row['plain_ms']:.3f} ms plain, library "
              f"{lib}, bound {bound_ms:.4f} ms ({by})")
    return rows


# ---------------------------------------------------------------------------
# Phase 5: federated LM training at full width
# ---------------------------------------------------------------------------

def phase_lm_path(fs, federated_lm, cfg):
    """5: two rounds of federated_lm.run at full width on the card."""
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
    with launches() as path:
        out = federated_lm.run(cfg, device="cuda", on_round=on_round,
                               **LM_RUN)
        torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = LM_RUN["rounds"] * LM_RUN["clients"] * LM_RUN["local_steps"]
    if checked != list(range(LM_RUN["rounds"])):
        fail(f"the fold was checked in rounds {checked}")
    losses, means = check_lm_run(out, path)
    recs = out["rounds"]
    walls = {"client_s": [w for r in recs for w in r["client_walls_s"]],
             "agg_s": [r["agg_wall_s"] for r in recs]}
    print(f"[5] federated {cfg.name}: {steps} local steps, losses {losses}, "
          f"mean {means}; launches {path}; each round's mean == plain "
          f"fold; client walls {', '.join(f'{w:.3f}' for w in walls['client_s'])} "
          f"s, aggregation walls {', '.join(f'{w:.3f}' for w in walls['agg_s'])}"
          f" s; peak device memory {peak_gb:.2f} GB (reckoned "
          f"~{RECKONED_PEAK_GB:.0f} GB)")
    return out["params"], path, means, walls, peak_gb


def check_lm_run(out, grew) -> tuple:
    """What a federated_lm run of ``LM_RUN`` at full width must show: 12
    fused-SGD and 45 rmsnorm launches a local step, a fold a round, finite
    losses whose mean falls below the first round's, finite parameters.
    Returns the client losses and their means a round."""
    import torch
    steps = LM_RUN["rounds"] * LM_RUN["clients"] * LM_RUN["local_steps"]
    expect = {"fused_sgd": 12 * steps, "rmsnorm": NORMS_PER_FORWARD * steps}
    if {k: grew.get(k, 0) for k in expect} != expect \
            or grew.get("fedavg_stream", 0) < LM_RUN["rounds"]:
        fail(f"launches {grew}, expected {expect} and at least one fold a "
             f"round")
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
    return losses, means


def phase_lm_timings(sgd, rn, layers, cfg, params):
    """5: fused-SGD over one step's 12 leaves (seeded gradients), each
    leaf bit for bit its plain version, and rmsnorm at the path's (512,
    2048) bf16 within its tolerance of its plain version (the trained
    final norm's and layer 0's ln1 gamma, and a random f32 one); then each
    beside its bound, plain version and one PyTorch call."""
    import torch
    from repro_torch.launch.federated_lm import MOMENTUM
    lr, mu = LM_RUN["lr"], MOMENTUM
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    p = [x.detach().clone() for x in params.values()]
    g = [torch.randn(x.shape, generator=gen, device="cuda") for x in p]
    v = [x.clone() for x in g]
    n = sum(x.numel() for x in p)
    for name, a, b, c in zip(params, p, g, v):
        kp, kv, pp, pv = a.clone(), c.clone(), a.clone(), c.clone()
        sgd.fused_sgd(kp, b, kv, lr, mu)
        sgd.fused_sgd_plain(pp, b, pv, lr, mu)
        if not (bits_equal(kp, pp) and bits_equal(kv, pv)):
            fail(f"5: fused_sgd on {name} {tuple(a.shape)} != its plain "
                 f"version")
        held("fused_sgd")
        del kp, kv, pp, pv
    rows = {}
    opt_params = [torch.nn.Parameter(x.clone()) for x in p]
    for op, gr in zip(opt_params, g):
        op.grad = gr
    opt = torch.optim.SGD(opt_params, lr=lr, momentum=mu, fused=True)
    opt.step()                               # creates the momentum buffers
    step = lambda: [sgd.fused_sgd(a, b, c, lr, mu) for a, b, c in zip(p, g, v)]
    rows["fused_sgd"] = {
        "elements": n, "ms": time_ms(step),
        "plain_ms": time_ms(lambda: [sgd.fused_sgd_plain(a, b, c, lr, mu)
                                     for a, b, c in zip(p, g, v)]),
        "library_ms": time_ms(opt.step),
        "library": "torch.optim.SGD(fused=True).step()",
        "bound_ms": cost.fused_sgd_bound_s(n) * 1e3, "bound_by": "bytes"}
    # device time a step, in turns (kernel, library, library, kernel): the
    # kernel's 12 launches, and every kernel of the library's step
    turns = {"device": [], "library_device": []}
    for key in ("device", "library_device", "library_device", "device"):
        turns[key].append(counted_device_ms(step, "fused_sgd", len(p))[0]
                          if key == "device" else
                          counted_device_ms(opt.step, None, None)[0])
    for key, got in turns.items():
        rows["fused_sgd"][f"{key}_ms"] = statistics.mean(got)
    rows["fused_sgd"]["device_ms_turns"] = turns
    del opt, opt_params, p, g, v
    tokens = torch.randint(0, 256, (LM_RUN["batch"], LM_RUN["seq"]),
                           device="cuda")
    x = layers.embed_tokens(params["embed"], tokens, cfg.compute_dtype) \
        .reshape(-1, cfg.d_model)
    gamma = params["final_norm"]
    r, d = x.shape
    for label, gm in (("final norm", gamma), ("layer 0 ln1",
                                              params["layers.ln1"][0]),
                      ("random f32", torch.randn(d, generator=gen,
                                                 device="cuda"))):
        out, rstd = rn.rmsnorm(x, gm, cfg.norm_eps)
        want, want_rstd = rn.rmsnorm_plain(x, gm, cfg.norm_eps)
        norm_close("rmsnorm", f"at ({r}, {d}) bf16, {label} gamma", out,
                   want, rstd, want_rstd)
    g16 = gamma.to(torch.bfloat16)
    kernel = lambda: rn.rmsnorm(x, gamma, cfg.norm_eps)
    library = lambda: torch.nn.functional.rms_norm(x, (d,), weight=g16,
                                                   eps=cfg.norm_eps)
    dst = torch.empty_like(x)
    # at this size the event pair around a call mostly holds the host's
    # dispatch, so the wrapper and F.rms_norm are timed in turns
    ms, library_ms = paired_ms(kernel, library)
    # bytes: x, out, γ, rstd; operations: a square, an add, two multiplies
    bound_ms, by = bound(2 * r * d * x.element_size() + d * 4 + 4 * r,
                         4 * r * d)
    rows["rmsnorm"] = {
        "shape": [r, d], "ms": ms, "library_ms": library_ms,
        "plain_ms": time_ms(lambda: rn.rmsnorm_plain(x, gamma, cfg.norm_eps)),
        "library": "torch.nn.functional.rms_norm with gamma cast to bf16",
        "bound_ms": bound_ms, "bound_by": by,
        "host_us": host_us(kernel), "library_host_us": host_us(library)}
    # device time a call: the kernel alone, F.rms_norm's kernels, and a
    # copy_ of the same activations (2 * r * d * 2 bytes moved), the card's
    # floor for one pass of that size
    for key, fn, tag in (("device", kernel, "rmsnorm_kernel"),
                         ("library_device", library, None),
                         ("copy_device", lambda: dst.copy_(x), None)):
        rows["rmsnorm"][f"{key}_ms"], rows["rmsnorm"][f"{key}_kernels"] = \
            counted_device_ms(fn, tag, 1 if tag else None)
    rows["rmsnorm"]["copy_bytes"] = 2 * x.numel() * x.element_size()
    for name, row in rows.items():
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        print(f"    {name}: device {row['device_ms']:.5f} ms "
              f"({100 * row['bound_share']:.1f}% of bound), events "
              f"{row['ms']:.4f} ms, {row['plain_ms']:.4f} ms plain, "
              f"{row['library_ms']:.4f} ms {row['library']}, library device "
              f"{row['library_device_ms']:.5f} ms, bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']})")
    row = rows["rmsnorm"]
    print(f"    rmsnorm: copy_ of {row['copy_bytes']} bytes device "
          f"{row['copy_device_ms'] * 1e3:.3f} us; host time a call "
          f"(dispatch): wrapper {row['host_us']:.2f} us, F.rms_norm "
          f"{row['library_host_us']:.2f} us")
    return rows


# ---------------------------------------------------------------------------
# Phase 6: faults and plugin topologies; phase 7: the population engine
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
    """6 (a): GradsSharding at VGG-16 width under the fault rows, stale
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
            print(f"[6] {name}: delivered {r.delivered_fraction:.3f} "
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


def phase_plugins(grads, FederatedSession, UploadModel):
    """6 (b): sharded_tree and geo_tiered at VGG-16 width, barrier and
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
            print(f"[6] {topology}/{schedule}: {len(res['batched'].records)} "
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
    """One population round: the result, its fold launches, host wall, the
    round's host RSS peak above its start and the device peak above the
    live tensors."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with _RssPeak() as rss, launches() as grew:
        t0 = time.perf_counter()
        r = make_session().round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return r, {"launches": grew.get("fedavg_stream", 0), "host_wall_s": wall,
               "host_rss_peak_mb": rss.peak / 2**20,
               "host_rss_rise_mb": (rss.peak - rss.start) / 2**20,
               "device_peak_mb":
                   (torch.cuda.max_memory_allocated() - base) / 2**20}


def phase_population(fs, FederatedSession, ClientPopulation, UploadModel,
                     FaultModel, LambdaLimits):
    """7: the population engine at the cohort sizes its users run: the CI
    scale job's geo_tiered round (N = 10^5, K = 4,096) and GradsSharding
    rounds at N = 10^5 and 10^6, each mean bit for bit against the plain
    chunked fold of the same rows on the card, the device peak O(one
    chunk), independent of N."""
    import torch
    from repro_torch.serverless import population as popmod
    chunk_mb = popmod.CHUNK_ROWS * POP_GRAD_ELEMS * 4 / 2**20
    bound_mb = 4 * chunk_mb          # two live chunks, accumulators, table
    out = {}
    ci = dict(topology="geo_tiered", schedule="pipelined",
              participation_k=POP_CI["participation_k"],
              faults=FaultModel(**POP_CI["faults"]),
              upload=UploadModel(**POP_CI["upload"]), log_ops=False,
              track_codec_error=False, device="cuda")
    make = lambda: FederatedSession(
        population=ClientPopulation(POP_CI["n"], seed=POP_CI["seed"]), **ci)
    r, stats = _pop_round(make)
    real = fs.fold_nodes
    fs.fold_nodes = _plain_fold_nodes(fs)
    try:
        want = make().round().avg_flat
    finally:
        fs.fold_nodes = real
    if stats["launches"] == 0 or not bits_equal(r.avg_flat, want):
        fail(f"population geo_tiered N={POP_CI['n']}: {stats['launches']} "
             f"launches; mean == plain chunked fold: "
             f"{bits_equal(r.avg_flat, want)}")
    stats.update(arrivals=len(r.arrivals), aggregators=len(r.records),
                 modeled_wall_s=r.wall_clock_s)
    out[f"geo_tiered_{POP_CI['n']}"] = stats
    print(f"[7] population geo_tiered N={POP_CI['n']} K="
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
        r, stats = _pop_round(make)
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
        print(f"    population gradssharding N={n}: {stats['launches']} "
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
    return out, {"fedavg_stream": sum(
        s["launches"] for s in out.values() if isinstance(s, dict))}


def phase_carry_timing(fs, build):
    """7: the carry route at the population's shapes: one 512-row chunk of
    4,096-element rows into an f32 accumulator (GradsSharding) and into an
    f64 one (the weighted plans), by device time in turns beside
    ``torch.sum`` over the chunk (the same sum without the carry) and the
    same call on the table kernel (its table built and copied once, as a
    measurement); then its bound (``perfbench.cost.wave_cost``), its plain
    version, events around one call and the wrapper's host time a call."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    from repro_torch.serverless import population as popmod
    n, L = popmod.CHUNK_ROWS, POP_GRAD_ELEMS
    rows = torch.randn(n, L, generator=gen, device="cuda")
    dev = rows.device
    out = {}
    for name, weighted in (("carry_f32", False), ("carry_f64", True)):
        w = [1.0] * n if weighted else None
        acc = fs.fold_nodes([(rows, w)], finalize=False)[0]
        kernel = lambda: fs.fold_nodes([(rows, w)], carry=[acc],
                                       finalize=False)[0]
        plain = lambda: fs.fedavg_stream_plain(rows, w, carry=acc,
                                               finalize=False)
        table, table_outs, max_len = fs._table([(rows, w)], [acc], None,
                                               "f64", False, dev)
        dev_table = torch.from_numpy(table).to(dev)

        def table_route():
            rc = fs._launcher()(dev_table.data_ptr(), 1, n, max_len, 0,
                                build.raw_stream(dev.index))
            if rc != 0:
                fail(f"fedavg_fold_launch: CUDA error {rc}")
            return table_outs[0]
        want = plain()
        for label, fn in (("carry route", kernel), ("table kernel",
                                                    table_route)):
            if not bits_equal(fn(), want):
                fail(f"{name} on the {label} != plain")
            held("fedavg_stream")
        calls = {"device": (kernel, "fedavg_carry_kernel", 1),
                 "library_device": (lambda: torch.sum(rows, dim=0), None,
                                    None),
                 "table_device": (table_route, "fedavg_fold_kernel", 1)}
        turns = {key: [] for key in calls}
        for key in (*calls, *reversed(calls)):
            turns[key].append(counted_device_ms(*calls[key])[0])
        nbytes, ops, secs = cost.wave_cost([(n, L, weighted)])
        row = {"rows": n, "elements": L, "bytes": nbytes, "ops": ops,
               "ms": time_ms(kernel), "plain_ms": time_ms(plain),
               "library_ms": time_ms(lambda: torch.sum(rows, dim=0)),
               "host_us": host_us(kernel), "bound_ms": secs * 1e3,
               "bound_by": "bytes" if nbytes / cost.HBM_BPS >= secs
               else "operations", "device_ms_turns": turns}
        for key, got in turns.items():
            row[f"{key}_ms"] = statistics.mean(got)
        out[name] = row
        print(f"    {name}: one {n} x {L} chunk by device time, in turns: "
              f"carry route {row['device_ms'] * 1e3:.2f} us "
              f"({100 * row['bound_ms'] / row['device_ms']:.1f}% of bound), "
              f"torch.sum {row['library_device_ms'] * 1e3:.2f} us, table "
              f"kernel {row['table_device_ms'] * 1e3:.2f} us; bound "
              f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}); events "
              f"{row['ms']:.4f} ms, host {row['host_us']:.1f} us a call, "
              f"plain {row['plain_ms']:.3f} ms")
    return out


# ---------------------------------------------------------------------------
# Phase 8: serving (KV-cache decode)
# ---------------------------------------------------------------------------

# the reference serve_loop's defaults
SERVE = dict(batch=4, prompt_len=8, max_new_tokens=16, max_len=64)
SERVE_STEPS = SERVE["prompt_len"] + SERVE["max_new_tokens"] - 1
SERVE_TIMED_STEPS = 20           # timed decode steps, after 3 warm-up steps
DECODE_CHECK_STEPS = 12          # teacher-forced steps held against forward
# the rows each dense arch's norms get at batch 4: (batch, d_model), and
# qwen3's q-norm (batch · heads, head_dim)
DECODE_ROWS = {"tinyllama-1.1b": (4, 2048), "h2o-danube-1.8b": (4, 2560),
               "gpt2-large": (4, 1280), "qwen2.5-14b / qwen3-32b": (4, 5120),
               "qwen3-32b q-norm": (256, 128)}


def norm_rows(rn, rows_by_label, tag, library_rows=((4, 2048),)):
    """The rmsnorm kernel at each of the rows (bf16 rows, f32 gamma):
    within one bf16 ulp of its plain version, then its device time a call
    beside its bound, its events and its plain version's; at
    ``library_rows`` also F.rms_norm's, and at (4, 2048) both wrappers'
    host time a call."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + int(tag))
    rows = {}
    for label, (r, d) in rows_by_label.items():
        x = torch.randn(r, d, generator=gen, device="cuda").bfloat16()
        gamma = torch.randn(d, generator=gen, device="cuda")
        (out, rstd), (want, want_rstd) = rn.rmsnorm(x, gamma), \
            rn.rmsnorm_plain(x, gamma)
        norm_close("rmsnorm", f"at ({r}, {d}) bf16 ({label})", out, want,
                   rstd, want_rstd)
        kernel = lambda: rn.rmsnorm(x, gamma)
        bound_ms, by = bound(2 * r * d * 2 + d * 4 + 4 * r, 4 * r * d)
        row = {"shape": [r, d], "bound_ms": bound_ms, "bound_by": by,
               "device_ms": counted_device_ms(kernel, "rmsnorm_kernel", 1)[0],
               "ms": time_ms(kernel),
               "plain_ms": time_ms(lambda: rn.rmsnorm_plain(x, gamma))}
        if (r, d) in library_rows:
            g16 = gamma.bfloat16()
            library = lambda: torch.nn.functional.rms_norm(x, (d,),
                                                           weight=g16)
            row.update({"library_ms": time_ms(library),
                        "library_device_ms":
                            counted_device_ms(library, None, None)[0]})
            if (r, d) == (4, 2048):
                row.update({"host_us": host_us(kernel),
                            "library_host_us": host_us(library)})
        rows[f"{r}x{d}"] = row
        lib = "" if "library_device_ms" not in row else \
            f"; F.rms_norm device {row['library_device_ms'] * 1e3:.3f} us"
        host = "" if "host_us" not in row else \
            (f"; host a call {row['host_us']:.2f} us, F.rms_norm "
             f"{row['library_host_us']:.2f} us")
        print(f"[{tag}] rmsnorm at ({r}, {d}) bf16 ({label}): within one "
              f"bf16 ulp of plain; device "
              f"{row['device_ms'] * 1e3:.3f} us "
              f"({100 * bound_ms / row['device_ms']:.1f}% of bound), bound "
              f"{bound_ms * 1e3:.3f} us ({by}){lib}{host}")
    return rows


def _decode_against_forward(models, cfg, batch, steps, seed, tol):
    """Teacher-forced decode of ``steps`` tokens on the card against the
    full forward (f32 compute, f32 cache), at rtol = atol = ``tol``; the
    rmsnorm launches of each step and the largest error. An
    encoder-decoder decodes against seeded frames, its cache built from
    them."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = models.init_params(gen, cfg)
    toks = torch.randint(0, cfg.vocab, (batch, steps), generator=gen,
                         device="cuda")
    with torch.inference_mode():
        cache, frames = _family_cache(models, cfg, params, batch, steps,
                                      torch.float32, seed + 1)
        inputs = {"tokens": toks} if frames is None else \
            {"tokens": toks, "frames": frames}
        full = models.forward(params, cfg, inputs)
        outs, per_step = [], []
        for i in range(steps):
            with launches() as grew:
                lg, cache = models.decode_step(params, cfg, toks[:, i:i + 1],
                                               cache)
            per_step.append(grew.get("rmsnorm", 0))
            outs.append(lg[:, 0])
        stepped = torch.stack(outs, dim=1)
    torch.cuda.synchronize()
    err = (stepped - full).abs()
    if not bool(torch.isfinite(stepped).all()) or \
            not bool((err <= tol + tol * full.abs()).all()):
        fail(f"{cfg.name}: decode != forward beyond rtol = atol = {tol} "
             f"(max abs err {float(err.max())})")
    return params, cache, per_step, float(err.max())


def _family_cache(models, cfg, params, batch, max_len, dtype, seed):
    """A decode cache on the card; an encoder-decoder's holds the
    cross-attention K/V of seeded frames (the encoder's one run). Returns
    the cache and the frames (None for a decoder-only model)."""
    import torch
    from repro_torch.models import encdec
    if not models.is_encdec(cfg):
        return models.init_cache(cfg, batch, max_len, dtype=dtype,
                                 device="cuda"), None
    frames = torch.randn(
        (batch, cfg.encoder_seq, cfg.frontend_dim or cfg.d_model),
        device="cuda", generator=torch.Generator(device="cuda").manual_seed(
            seed))
    return encdec.init_cache(cfg, batch, max_len, params=params,
                             frames=frames, dtype=dtype,
                             device="cuda"), frames


def phase_serve_f32(models, cfg):
    """8: full-width decode at f32 against forward, 45 norms a step."""
    import torch
    if torch.backends.cuda.matmul.allow_tf32:
        fail("f32 matmuls would run in TF32")
    t0 = time.perf_counter()
    params, cache, per_step, err = _decode_against_forward(
        models, cfg, 2, DECODE_CHECK_STEPS, SEED + 13, 5e-3)
    norms = 2 * cfg.n_layers + 1
    if per_step != [norms] * DECODE_CHECK_STEPS or norms != NORMS_PER_FORWARD:
        fail(f"rmsnorm launches a decode step {per_step}, expected "
             f"{NORMS_PER_FORWARD}")
    if int(cache["idx"]) != DECODE_CHECK_STEPS:
        fail(f"the cache's idx is {int(cache['idx'])}")
    print(f"[8] full-width {cfg.name} at f32: {DECODE_CHECK_STEPS} decode "
          f"steps at batch 2 == forward within rtol = atol = 5e-3 (max abs "
          f"err {err:.3g}); {norms} rmsnorm launches a step; "
          f"{time.perf_counter() - t0:.1f} s")
    return {"max_abs_err": err, "rmsnorm_per_step": norms}


def _timed_steps(step, params, tok, cache, per_step=None):
    """3 warm-up and SERVE_TIMED_STEPS timed decode steps: the host walls
    in ms and the last logits and cache; each step's rmsnorm launches
    appended to ``per_step`` when given."""
    import torch
    walls = []
    for i in range(3 + SERVE_TIMED_STEPS):
        t0 = time.perf_counter()
        with launches() as grew:
            logits, cache = step(params, tok, cache)
            torch.cuda.synchronize()
        if i >= 3:
            walls.append((time.perf_counter() - t0) * 1e3)
        if per_step is not None:
            per_step.append(grew.get("rmsnorm", 0))
    return walls, logits, cache


def phase_serve_loop(serve, models, cfg):
    """8: serve_loop at full width with the reference's defaults, then
    decode steps timed by the host clock, one step under the profiler, and
    the step's bytes bound."""
    import torch
    from repro_torch.config import ShapeConfig
    from repro_torch.models import transformer
    params = models.init_params(
        torch.Generator(device="cuda").manual_seed(SEED + 14), cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with launches() as path:
        out = serve.serve_loop(cfg, params=params, seed=0, device="cuda",
                               **SERVE)
        torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gen = out["generated"]
    if path.get("rmsnorm", 0) != NORMS_PER_FORWARD * SERVE_STEPS:
        fail(f"serve_loop launched rmsnorm {path.get('rmsnorm', 0)} times, "
             f"expected {NORMS_PER_FORWARD} x {SERVE_STEPS}")
    if gen.shape != (SERVE["batch"], SERVE["max_new_tokens"]) \
            or str(gen.dtype) != "int32" \
            or not ((gen >= 0) & (gen < cfg.vocab)).all():
        fail(f"serve_loop generated {gen.dtype} {gen.shape}, values "
             f"{gen.min()}..{gen.max()}")
    again = serve.serve_loop(cfg, params=params, seed=0, device="cuda",
                             **SERVE)
    if not (again["generated"] == gen).all():
        fail("two greedy serve loops on the same weights and prompts "
             "generated different tokens")
    shape = ShapeConfig("serve", seq_len=SERVE["max_len"],
                        global_batch=SERVE["batch"], kind="decode")
    with torch.inference_mode():
        sp = serve.cast_for_serving(params, cfg)
        del params
        cache = models.init_cache(cfg, SERVE["batch"], SERVE["max_len"],
                                  device="cuda")
        step = serve.make_serve_step(cfg, shape, cache_like=cache)
        tok = torch.from_numpy(gen[:, :1].copy()).to("cuda")
        walls, logits, cache = _timed_steps(step, sp, tok, cache)
        if not bool(torch.isfinite(logits).all()):
            fail("a decode step's logits are not finite")
        unstack_us = host_us(lambda: transformer._unstack(sp, cfg.n_layers),
                             calls=50)
        kernels, prof_wall_ms = profiled_call(lambda: step(sp, tok, cache))
    idx = int(cache["idx"]) - 1          # the slots the profiled step read
    nbytes = _step_bytes(sp, cache, cfg, idx)
    bound_ms = nbytes / cost.HBM_BPS * 1e3
    step_ms = statistics.median(walls)
    prof = busy_row(kernels, prof_wall_ms, bound_ms)
    if prof is not None:
        prof["rmsnorm_device_ms"] = trace.device_us(kernels,
                                                    "rmsnorm_kernel") / 1e3
    res = {"generated_shape": list(gen.shape), "tokens_per_s":
           out["tokens_per_s"], "loop_wall_s": out["wall_s"],
           "launches": path, "peak_memory_gb": peak_gb,
           "step_walls_ms": walls, "step_median_ms": step_ms,
           "step_bytes": nbytes, "step_bound_ms": bound_ms,
           "unstack_host_us": unstack_us,
           "bound_share_of_step": bound_ms / step_ms, "profile": prof}
    print(f"[8] serve_loop {cfg.name} (batch {SERVE['batch']}, prompt "
          f"{SERVE['prompt_len']}, {SERVE['max_new_tokens']} new tokens, "
          f"max_len {SERVE['max_len']}, bf16): {out['tokens_per_s']:.1f} "
          f"tokens/s ({out['wall_s']:.3f} s for {SERVE_STEPS} steps), "
          f"launches {path} ({NORMS_PER_FORWARD} rmsnorm a step), peak "
          f"device memory {peak_gb:.2f} GB; the same tokens again")
    print(f"    a decode step: median host wall {step_ms:.3f} ms over "
          f"{SERVE_TIMED_STEPS}; bytes bound {bound_ms:.4f} ms ({nbytes} "
          f"bytes), {100 * bound_ms / step_ms:.1f}% of the step; the layer "
          f"views (_unstack) {unstack_us:.1f} us of host time a step; "
          f"{_prof_text(prof)}")
    return res


def _prof_text(prof) -> str:
    if prof is None:
        return "profile: no device activity recorded; not measured"
    return (f"one profiled step {prof['step_wall_ms']:.3f} ms host wall, "
            f"{prof['kernels']} kernels ({prof['rmsnorm_launches']} rmsnorm)"
            f", device busy {prof['device_busy_ms']:.3f} ms "
            f"({100 * prof['idle_share']:.1f}% idle), bound "
            f"{100 * prof['bound_share_of_busy']:.1f}% of busy")


# ---------------------------------------------------------------------------
# Phase 9: the MoE, VLM, SSM, hybrid and encoder-decoder families
# ---------------------------------------------------------------------------

# (arch, layers kept): None runs the registered depth; the MoE and VLM
# archs do not fit one card at full depth with f32 parameters (41.9 B,
# 131.6 B and 34.3 B parameters), so they keep their full width and are cut
# to these depths
FAMILY_RUNS = (("falcon-mamba-7b", None), ("zamba2-2.7b", None),
               ("whisper-tiny", None), ("phi3.5-moe-42b-a6.6b", 2),
               ("dbrx-132b", 1), ("chameleon-34b", 2))
# the rows these families' norms get at batch 4 (bf16 rows, f32 gamma):
# (batch, d_model), zamba2's gated norm at d_inner, chameleon's q-norm
# (batch · heads, head_dim)
FAMILY_ROWS = {"whisper-tiny": (4, 384), "zamba2-2.7b": (4, 2560),
               "zamba2-2.7b gated norm": (4, 5120),
               "falcon-mamba-7b / phi3.5-moe": (4, 4096),
               "dbrx-132b": (4, 6144), "chameleon-34b (MAX_D)": (4, 8192),
               "chameleon-34b q-norm": (256, 128)}


def _family_cfg(get_arch, arch, layers, **over):
    model = get_arch(arch).model
    return dataclasses.replace(model, remat=False,
                               n_layers=layers or model.n_layers, **over)


def _family_decode_check(models, cfg):
    """9: 12 teacher-forced f32 decode steps at batch 2 against the full
    forward (5e-3; the MoE at capacity_factor 8.0, as the reference's
    test), the rmsnorm launches of each step equal to the config's count.
    Returns the f32 parameters for the serving loop."""
    import torch
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    if cfg.moe is not None:
        f32 = dataclasses.replace(f32, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    params, _, per_step, err = _decode_against_forward(
        models, f32, 2, DECODE_CHECK_STEPS, SEED + 17, 5e-3)
    norms = models.norms_per_decode_step(cfg)
    if per_step != [norms] * DECODE_CHECK_STEPS:
        fail(f"{cfg.name}: rmsnorm launches a decode step {per_step}, "
             f"expected {norms} from the config")
    return params, err, norms


def _step_bytes(sp, cache, cfg, idx: int, experts=()) -> int:
    """Bytes one decode step must move at batch B: every weight once in its
    serving type (the embedding: B rows; an MoE layer: only the experts
    this step's tokens chose), the valid K/V slots read and this token's
    written, the SSM states and conv histories read and written, the
    cross-attention K/V read, the logits written."""
    b = SERVE["batch"]
    total = 0
    for name, t in sp.items():
        nbytes = t.numel() * t.element_size()
        if name == "embed":
            nbytes = b * cfg.d_model * t.element_size()
        elif name.split(".")[-2:-1] == ["moe"] and name[-2:] in ("w1", "w2",
                                                                 "w3"):
            per_expert = nbytes // (t.shape[0] * t.shape[1])
            nbytes = per_expert * sum(experts)
        total += nbytes
    if "k" in cache:
        blocks, _, _, kh, hd = cache["k"].shape
        total += 2 * blocks * b * kh * hd * cache["k"].element_size() \
            * (idx + 1 + 1)
    for t in cache.get("mamba", {}).values():
        total += 2 * t.numel() * t.element_size()
    for key in ("xk", "xv"):
        if key in cache:
            total += cache[key].numel() * cache[key].element_size()
    return total + b * cfg.vocab * 2


def _family_serve(serve, models, moe, cfg, params):
    """9: serve_loop in bf16 at the reference's defaults (its launches,
    tokens/s, peak device memory), then decode steps on the cast weights
    timed by the host clock, and one warmed-up step under the profiler
    beside the step's bytes bound."""
    import torch
    from repro_torch.config import ShapeConfig
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    norms = models.norms_per_decode_step(cfg)
    with launches() as path:
        out = serve.serve_loop(cfg, params=params, seed=0, device="cuda",
                               **SERVE)
        torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gen = out["generated"]
    # an encoder-decoder's cache build runs the encoder once: two norms a
    # layer and its final norm
    encoder = 2 * cfg.encoder_layers + 1 if models.is_encdec(cfg) else 0
    if path.get("rmsnorm", 0) != norms * SERVE_STEPS + encoder:
        fail(f"{cfg.name}: serve_loop launched rmsnorm "
             f"{path.get('rmsnorm', 0)} times, expected {norms} x "
             f"{SERVE_STEPS} + {encoder}")
    if gen.shape != (SERVE["batch"], SERVE["max_new_tokens"]) \
            or not ((gen >= 0) & (gen < cfg.vocab)).all():
        fail(f"{cfg.name}: serve_loop generated {gen.dtype} {gen.shape}")
    shape = ShapeConfig("serve", seq_len=SERVE["max_len"],
                        global_batch=SERVE["batch"], kind="decode")
    experts, route = [], moe.route

    def counted_route(p, x, c):
        chosen = route(p, x, c)
        experts.append(int(torch.unique(chosen[1]).numel()))
        return chosen
    with torch.inference_mode():
        sp = serve.cast_for_serving(params, cfg)
        cache, _ = _family_cache(models, cfg, sp, SERVE["batch"],
                                 SERVE["max_len"], torch.bfloat16, 1)
        step = serve.make_serve_step(cfg, shape, cache_like=cache)
        tok = torch.from_numpy(gen[:, :1].copy()).to("cuda")
        walls, logits, cache = _timed_steps(step, sp, tok, cache)
        if not bool(torch.isfinite(logits).all()):
            fail(f"{cfg.name}: a decode step's logits are not finite")
        moe.route = counted_route
        try:
            kernels, prof_wall_ms = profiled_call(
                lambda: step(sp, tok, cache))
        finally:
            moe.route = route
    # the profiled step: the second of the two, the later half of the
    # routing counts, the slots it read
    experts = experts[len(experts) // 2:]
    idx = int(cache["idx"]) - 1
    nbytes = _step_bytes(sp, cache, cfg, idx, experts)
    bound_ms = nbytes / cost.HBM_BPS * 1e3
    del sp, cache
    prof = busy_row(kernels, prof_wall_ms, bound_ms)
    step_ms = statistics.median(walls)
    if prof is not None:
        # the profiler slows the host: the busy time against the median
        # unprofiled step as well
        prof["idle_share_of_median_step"] = \
            max(0.0, 1.0 - prof["device_busy_ms"] / step_ms)
    return {"tokens_per_s": out["tokens_per_s"], "loop_wall_s": out["wall_s"],
            "launches": path, "rmsnorm_per_step": norms,
            "peak_memory_gb": peak_gb, "step_walls_ms": walls,
            "step_median_ms": step_ms, "step_bytes": nbytes,
            "step_bound_ms": bound_ms, "experts_per_moe_layer": experts,
            "bound_share_of_step": bound_ms / step_ms, "profile": prof}


def phase_families(serve, models, moe, get_arch, card):
    """9: each family at full width (the MoE and VLM archs cut in depth),
    one model at a time, freed before the next."""
    import torch
    out = {}
    for arch, layers in FAMILY_RUNS:
        t0 = time.perf_counter()
        cfg = _family_cfg(get_arch, arch, layers)
        params, err, norms = _family_decode_check(models, cfg)
        torch.cuda.empty_cache()
        row = _family_serve(serve, models, moe, cfg, params)
        del params
        torch.cuda.empty_cache()
        row.update({"n_layers": cfg.n_layers,
                    "registered_layers": get_arch(arch).model.n_layers,
                    "params": models.param_count(cfg),
                    "decode_max_abs_err": err,
                    "seconds": time.perf_counter() - t0})
        out[arch] = row
        cut = "" if layers is None else \
            f", cut to {cfg.n_layers} of {row['registered_layers']} layers"
        prof = row["profile"]
        median = "" if prof is None else \
            (f" ({100 * prof['idle_share_of_median_step']:.1f}% idle of the "
             f"median step)")
        print(f"[9] {arch} ({row['params']:,} parameters{cut}; {card}): "
              f"f32 decode == forward within 5e-3 (max abs err {err:.3g}); "
              f"{norms} rmsnorm launches a step; bf16 serve_loop "
              f"{row['tokens_per_s']:.1f} tokens/s, median step "
              f"{row['step_median_ms']:.3f} ms, peak device memory "
              f"{row['peak_memory_gb']:.2f} GB; step bytes bound "
              f"{row['step_bound_ms']:.4f} ms ({row['step_bytes']} bytes); "
              f"{_prof_text(prof)}{median}; {row['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 10: long context at full width
# ---------------------------------------------------------------------------

LONG_SEQ = 8192


def _long_forward(models, cfg, params, toks):
    """One f32 forward at batch 1 on the card: logits, host wall, peak
    device memory."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits = models.forward(params, cfg, {"tokens": toks})
    torch.cuda.synchronize()
    return logits, time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated() / 1e9


def phase_long_context(models, layers, get_arch, card):
    """10: tinyllama-1.1b's chunked attention against its dense attention,
    and h2o-danube-1.8b's 2-D causal tiling against its chunked attention,
    at S = 8,192, f32, batch 1, within 1e-3 on the logits."""
    import torch
    out = {}
    runs = (("tinyllama-1.1b", ("dense", dict(attn_chunk=0)),
             ("chunked", dict(attn_chunk=2048))),
            ("h2o-danube-1.8b", ("chunked", dict(attn_chunk=2048)),
             ("causal_2d", dict(attn_chunk=2048, attn_causal_skip=True))))
    for arch, (ref_name, ref_over), (name, over) in runs:
        t0 = time.perf_counter()
        base = _family_cfg(get_arch, arch, None, compute_dtype=torch.float32)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
        params = models.init_params(gen, base)
        toks = torch.randint(0, base.vocab, (1, LONG_SEQ), generator=gen,
                             device="cuda")
        want, ref_wall, ref_peak = _long_forward(
            models, dataclasses.replace(base, **ref_over), params, toks)
        # the 2-D tiling's calls: (S, window, chunk) of each layer's
        tiled, tile = [], layers.attention_causal_2d

        def counted_tile(q, k, v, **kw):
            tiled.append((q.shape[1], kw["window"], kw["chunk"]))
            return tile(q, k, v, **kw)
        layers.attention_causal_2d = counted_tile
        try:
            got, wall, peak_gb = _long_forward(
                models, dataclasses.replace(base, **over), params, toks)
        finally:
            layers.attention_causal_2d = tile
        err = (got - want).abs()
        if not bool(torch.isfinite(got).all()) or \
                not bool((err <= 1e-3 + 1e-3 * want.abs()).all()):
            fail(f"{arch}: {name} attention != {ref_name} beyond 1e-3 at "
                 f"S = {LONG_SEQ} (max abs err {float(err.max())})")
        chunk = over["attn_chunk"]
        nq = LONG_SEQ // chunk
        want_calls = [(LONG_SEQ, base.sliding_window, chunk)] * \
            base.n_layers if name == "causal_2d" else []
        if tiled != want_calls:
            fail(f"{arch}: attention_causal_2d ran {len(tiled)} times "
                 f"({tiled[:1]}), expected {len(want_calls)}")
        # each query block i reads the key blocks from the first one its
        # window reaches (0 without a window) to the diagonal
        skipped = sum(nq - (i + 1 - (max(0, (i * chunk - w + 1) // chunk)
                                     if w else 0))
                      for _, w, _ in tiled for i in range(nq))
        row = {"paths": [ref_name, name], "max_abs_err": float(err.max()),
               "walls_s": [ref_wall, wall], "peak_memory_gb":
                   [ref_peak, peak_gb], "skipped_key_blocks": skipped,
               "key_blocks": base.n_layers * nq * nq}
        del params, want, got, err
        torch.cuda.empty_cache()
        row["seconds"] = time.perf_counter() - t0
        out[arch] = row
        skip_txt = "" if name != "causal_2d" else \
            f"; skipped {skipped} of {row['key_blocks']} key blocks"
        print(f"[10] {arch} at S = {LONG_SEQ}, f32, batch 1 ({card}): "
              f"{name} == {ref_name} within 1e-3 (max abs err "
              f"{row['max_abs_err']:.3g}); host wall {ref_name} "
              f"{ref_wall:.3f} s, {name} {wall:.3f} s; peak device memory "
              f"{ref_name} {ref_peak:.2f} GB, {name} {peak_gb:.2f} GB"
              f"{skip_txt}; {row['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 11: the single-program trainer, the host_mesh engine, MoE local
# ---------------------------------------------------------------------------

TRAIN = dict(batch=8, seq=128)   # the reference trainer's main() defaults
TRAIN_LOOP_STEPS = 4
PLAN_TIMED_STEPS = 3             # timed steps a plan, after the checked one
SHARDMAP_LR = 0.1                # the reference's shard_map test step
# zero1's AdamW shard update reads g, μ, ν, p and writes μ, ν, p: 7 f32
ADAMW_BYTES_PER_ELEM = 7 * 4
MOE_ARCH, MOE_LAYERS = "phi3.5-moe-42b-a6.6b", 2
# the reference's tolerances: across plans (loss, then parameters), and
# the shard_map step against a single-device step
PLAN_LOSS_ATOL, PLAN_RTOL, PLAN_ATOL = 1e-5, 5e-4, 1e-4
SINGLE_RTOL, SINGLE_ATOL = 2e-4, 2e-5

# The helpers below hold the trainer to its checks here and in
# tools/multi_card.py (several cards), which imports them.


class HeldAgainstPlain:
    """Wraps the kernel wrappers that the shard_map step calls, for one
    step: each call goes to the kernel as before (its launch is the main
    path's), and what the plain version needs to redo it is kept: clones
    of the in-place fused-SGD's p and v, references to every other input
    and output. ``check()`` runs the plain versions after the step, when
    its memory is free, and holds the kernels' results bit for bit."""

    def __init__(self, sgd, q, where: str = "11"):
        self.sgd, self.q, self.where = sgd, q, where
        self.calls = {"fused_sgd": [], "quantize": [], "dequantize": []}
        self.saved = (sgd.fused_sgd, q.quantize, q.dequantize)

    def __enter__(self):
        kernel_sgd, kernel_q, kernel_dq = self.saved

        def fused_sgd(p, g, v, lr, momentum=0.9):
            before = (p.clone(), v.clone())
            kernel_sgd(p, g, v, lr, momentum)
            self.calls["fused_sgd"].append((before, g, lr, momentum, p, v))
            return p, v

        def quantize(x):
            codes, scales = kernel_q(x)
            self.calls["quantize"].append((x, codes, scales))
            return codes, scales

        def dequantize(codes, scales, start=0, stop=None):
            out = kernel_dq(codes, scales, start, stop)
            self.calls["dequantize"].append((codes, scales, start, stop, out))
            return out

        self.sgd.fused_sgd, self.q.quantize, self.q.dequantize = \
            fused_sgd, quantize, dequantize
        return self

    def __exit__(self, *exc):
        self.sgd.fused_sgd, self.q.quantize, self.q.dequantize = self.saved

    def check(self) -> dict:
        """Max abs err of each kernel against its plain version (0.0: the
        bits agree; anything else fails)."""
        import torch
        errs = {}
        for (p0, v0), g, lr, mu, p, v in self.calls.pop("fused_sgd"):
            self.sgd.fused_sgd_plain(p0, g, v0, lr, mu)
            if not (bits_equal(p0, p) and bits_equal(v0, v)):
                fail(f"{self.where}: fused_sgd at {p.numel():,} elements != "
                     f"its plain version (max abs err "
                     f"{float((p0 - p).abs().max())})")
            errs["fused_sgd"] = 0.0
            held("fused_sgd")
            del p0, v0
        for x, codes, scales in self.calls.pop("quantize"):
            pc, ps = self.q.quantize_plain(x)
            if not (torch.equal(pc, codes) and bits_equal(ps, scales)):
                fail(f"{self.where}: quantize at {x.numel():,} elements != "
                     f"its plain version")
            errs["quantize"] = 0.0
            held("quantize")
            del pc, ps
        for codes, scales, start, stop, out in self.calls.pop("dequantize"):
            plain = self.q.dequantize_plain(codes, scales, start, stop)
            if not bits_equal(plain, out):
                fail(f"{self.where}: dequantize at {out.numel():,} elements "
                     f"!= its plain version")
            errs["dequantize"] = 0.0
            held("dequantize")
            del plain
        torch.cuda.empty_cache()
        return errs


def max_rel(a, b, rtol: float, atol: float) -> tuple:
    """(max abs err, within ``|a - b| <= atol + rtol·|b|`` everywhere),
    over flat f32 vectors, in chunks."""
    err, ok = 0.0, True
    for lo in range(0, a.numel(), 1 << 27):
        da, db = a[lo:lo + (1 << 27)], b[lo:lo + (1 << 27)]
        diff = (da - db).abs()
        err = max(err, float(diff.max()))
        ok = ok and bool((diff <= atol + rtol * db.abs()).all())
    return err, ok


def flat_params(params):
    from repro_torch.core.sharding import flatten
    return flatten(params)[0]


def plan_step(T, mesh, cfg, shape, opt, gs, params, batch, base,
              where: str = "11", with_mu: bool = False):
    """One checked step of plan ``gs`` from ``params`` on ``batch``:
    ``(step, p_in, state, row, flat)``, the step and its placed inputs
    kept for timing, ``flat`` the new parameters gathered whole; with
    ``with_mu``, AdamW's first moment gathered whole and flat as a sixth
    item (after one step from zero, ``(1 - b1)`` times the clipped
    gradient the plan's optimizer took). On a card, ``row`` holds the
    memory held before the step and the step's peak, both read before
    the check gathers anything whole. Fails on a non-finite loss or
    parameters and, given ``base`` (the ``none`` plan's ``(flat,
    loss)``), beyond the tolerances across plans."""
    import torch
    from repro_torch.config import ShardingPlan
    plan = ShardingPlan(grad_sharding=gs)
    step = T.jit_train_step(cfg, shape, mesh, plan, opt, None, donate=False)
    p_in, state = T.place_state(cfg, mesh, plan, params, opt.init(params))
    cuda = batch["tokens"].device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 1e9
    new, new_state, m = step(p_in, state, batch)
    if cuda:
        step_peak = torch.cuda.max_memory_allocated() / 1e9
    whole, whole_state = T.gather_state(cfg, mesh, plan, new, new_state)
    del new, new_state
    flat = flat_params(whole)
    del whole
    mu = flat_params(whole_state.mu) if with_mu else None
    del whole_state
    loss = float(m["loss"])
    if not math.isfinite(loss) or not bool(torch.isfinite(flat).all()):
        fail(f"{where}: the {gs} step gave a non-finite loss or parameters")
    row = {"loss": loss, "grad_norm": float(m["grad_norm"])}
    if cuda:
        row.update(held_before_step_gb=held, step_peak_memory_gb=step_peak)
    if base is not None:
        err, ok = max_rel(flat, base[0], PLAN_RTOL, PLAN_ATOL)
        row["max_abs_err_vs_none"] = err
        if abs(loss - base[1]) > PLAN_LOSS_ATOL or not ok:
            fail(f"{where}: the {gs} plan != none (loss {loss} vs "
                 f"{base[1]}; params max abs err {err}) beyond "
                 f"{PLAN_LOSS_ATOL} / rtol {PLAN_RTOL}, atol {PLAN_ATOL}")
    if with_mu:
        return step, p_in, state, row, flat, mu
    return step, p_in, state, row, flat


def held_to_single_step(T, cfg, params, batch, new_flat, loss, lr,
                        where: str = "11") -> float:
    """The shard_map step's new parameters (``new_flat``) and ``loss``
    against a single-device SGD step at ``lr`` from ``params`` on the
    whole ``batch``: its max abs err; fails beyond rtol 2e-4 / atol 2e-5
    (the loss: 1e-5 of it)."""
    from repro_torch import optim
    ref, _, ref_m = T.make_train_step(cfg, optim.sgd(lr))(params, (),
                                                          batch)
    ref, ref_loss = flat_params(ref), float(ref_m["loss"])
    err, ok = max_rel(new_flat, ref, SINGLE_RTOL, SINGLE_ATOL)
    if not ok or abs(float(loss) - ref_loss) > 1e-5 * abs(ref_loss):
        fail(f"{where}: the shard_map step != a single-device SGD step "
             f"beyond rtol {SINGLE_RTOL}, atol {SINGLE_ATOL} (max abs err "
             f"{err}; loss {float(loss)} vs {ref_loss})")
    return err


def host_mesh_vs_streaming(FederatedSession, grads, host_mesh: int,
                           device: str, rounds: int = 1,
                           warm_up: bool = False, where: str = "11"):
    """GradsSharding rounds (M = N_SHARDS) over ``grads``, on the
    streaming engine and on ``host_mesh`` fold devices: each engine's
    host walls (ms) of ``rounds`` rounds, after an untimed one with
    ``warm_up``, and the fold launches of its last round. Fails unless
    the host_mesh mean is the streaming one bit for bit."""
    import torch
    from repro_torch.api import SessionConfig
    out, res = {}, {}
    for engine, hm in (("streaming", None), ("host_mesh", host_mesh)):
        session = FederatedSession(SessionConfig(
            topology="gradssharding", n_shards=N_SHARDS, engine=engine,
            host_mesh=hm, device=device))
        if warm_up:
            session.round(grads)
        walls = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            with launches() as grew:
                res[engine] = session.round(grads)
                if device == "cuda":
                    for i in range(torch.cuda.device_count()):
                        torch.cuda.synchronize(i)
            walls.append((time.perf_counter() - t0) * 1e3)
        out[f"{engine}_wall_ms"] = walls
        out[f"{engine}_fold_launches"] = grew.get("fedavg_stream", 0)
    if not bits_equal(res["host_mesh"].avg_flat, res["streaming"].avg_flat):
        fail(f"{where}: the host_mesh round != the streaming round")
    return out


def _plan_steps(T, mesh, cfg, params, batch, card):
    """11 (a): one step of each plan from the same parameters and batch,
    held against ``none`` (losses within 1e-5, parameters within rtol 5e-4
    / atol 1e-4), each with 45 rmsnorm launches; then timed steps (the
    median host wall, peak device memory) and a profiled one (device busy
    share)."""
    import torch
    from repro_torch.config import ShapeConfig
    from repro_torch.optim import adamw
    shape = ShapeConfig("train", seq_len=TRAIN["seq"],
                        global_batch=TRAIN["batch"], kind="train")
    opt = adamw(3e-4, grad_clip_norm=1.0)
    rows, base = {}, None
    for gs in T.PLANS:
        with launches() as grew:
            step, p_in, state, row, flat = plan_step(T, mesh, cfg, shape,
                                                     opt, gs, params, batch,
                                                     base)
        norms = grew.get("rmsnorm", 0)
        if norms != NORMS_PER_FORWARD:
            fail(f"11: a {gs} step launched rmsnorm {norms} times, "
                 f"expected {NORMS_PER_FORWARD}")
        row["rmsnorm_launches"] = norms
        loss = row["loss"]
        if base is None:
            base = (flat, loss)
        del flat
        # the cache stays warm: a timed step allocates no new blocks
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(PLAN_TIMED_STEPS):
            t0 = time.perf_counter()
            out = step(p_in, state, batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            del out
        row["step_walls_ms"] = walls
        row["step_wall_ms"] = statistics.median(walls)
        row["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        prof = busy_row(*profiled_call(lambda: step(p_in, state, batch)))
        row["busy_share"] = None if prof is None else 1 - prof["idle_share"]
        row["profile"] = prof
        del p_in, state
        torch.cuda.empty_cache()
        rows[gs] = row
        busy_txt = "profile: no device activity; not measured" \
            if prof is None else (
                f"profiled step {prof['step_wall_ms']:.1f} ms, device "
                f"busy {prof['device_busy_ms']:.1f} ms "
                f"({100 * row['busy_share']:.1f}%)")
        print(f"[11] {gs}: loss {loss:.6f}, grad norm {row['grad_norm']:.4f}"
              f", step host wall {row['step_wall_ms']:.1f} ms (median of "
              f"{PLAN_TIMED_STEPS}), peak device "
              f"memory {row['peak_memory_gb']:.2f} GB, {busy_txt} ({card})")
    del base
    return rows


def _adamw_shard_update(T, mesh, cfg, params, card):
    """11 (b): zero1's AdamW update of the shard alone (M = 1: all |θ|),
    by CUDA events, beside its bytes bound: 7 f32 of |θ| over the
    memory rate."""
    import torch
    from repro_torch.config import ShardingPlan
    from repro_torch.optim import adamw
    opt = adamw(3e-4, grad_clip_norm=1.0)
    # zero3's layout: the parameters' flat shard and AdamW's over it
    p, state = T.place_state(cfg, mesh, ShardingPlan(grad_sharding="zero3"),
                             params, opt.init(params))
    g = torch.randn(p.numel(), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(5))
    norm = torch.linalg.vector_norm(g)

    def update():
        u, _ = opt.update(g, state, p, norm=norm)
        p.add_(u)
    ms = time_ms(update)
    nbytes = ADAMW_BYTES_PER_ELEM * p.numel()
    bound_ms = nbytes / cost.HBM_BPS * 1e3
    elems = p.numel()
    del p, state
    torch.cuda.empty_cache()
    print(f"[11] zero1 AdamW shard update over {g.numel():,} elements: "
          f"{ms:.3f} ms (CUDA events, median of {REPS}); bytes bound "
          f"{bound_ms:.3f} ms ({nbytes:,} bytes at "
          f"{cost.HBM_BPS / 1e12:.2f} TB/s), {100 * bound_ms / ms:.1f}% of "
          f"it ({card})")
    del g
    return {"ms": ms, "bound_ms": bound_ms, "bytes": nbytes, "elems": elems}


def _shardmap_steps(T, mesh, cfg, params, batch, sgd, q, path, card):
    """11 (c): the shard_map step at momentum 0 against a plain
    single-device SGD step (rtol 2e-4, atol 2e-5), then its qsgd8 variant;
    every kernel call of both held bit for bit against its plain version
    at |θ| elements. The single-device step's launches are taken out of
    ``path``."""
    import torch
    out = {}
    step, init_v = T.make_shardmap_train_step(cfg, mesh, lr=SHARDMAP_LR,
                                              momentum=0.0)
    with HeldAgainstPlain(sgd, q) as held, launches() as grew:
        t0 = time.perf_counter()
        new, v, loss = step(params, init_v(params), batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    counts = (grew.get("fused_sgd", 0), grew.get("rmsnorm", 0))
    new_flat = flat_params(new)
    del new, v
    errs = held.check()
    if counts != (1, NORMS_PER_FORWARD) or "fused_sgd" not in errs:
        fail(f"11: the shard_map step launched fused_sgd and rmsnorm "
             f"{counts} times, expected (1, {NORMS_PER_FORWARD})")
    with launches(out_of=path):          # the reference step's forward
        err = held_to_single_step(T, cfg, params, batch, new_flat, loss,
                                  SHARDMAP_LR)
    del new_flat
    torch.cuda.empty_cache()
    out["sgd"] = {"loss": float(loss), "max_abs_err_vs_single": err,
                  "step_wall_ms": wall, "fused_sgd_launches": counts[0],
                  "rmsnorm_launches": counts[1]}
    print(f"[11] shard_map step (momentum 0, lr {SHARDMAP_LR}): == a "
          f"single-device SGD step within rtol 2e-4, atol 2e-5 (max abs err "
          f"{err:.3g}); fused_sgd 1 launch over {T.flat_spec(cfg).total:,} "
          f"elements == fused_sgd_plain bit for bit; {counts[1]} rmsnorm "
          f"launches; step host wall {wall:.1f} ms (with the kept clones; "
          f"{card})")

    step, init_v = T.make_shardmap_train_step(cfg, mesh, lr=0.05,
                                              momentum=0.9, compress="qsgd8")
    with HeldAgainstPlain(sgd, q) as held, launches() as grew:
        new, v, loss = step(params, init_v(params), batch)
        torch.cuda.synchronize()
    counts = tuple(grew.get(k, 0) for k in ("quantize", "dequantize",
                                            "fused_sgd"))
    finite = bool(torch.isfinite(flat_params(new)).all()) and math.isfinite(
        float(loss))
    del new, v
    errs.update(held.check())
    if counts != (1, 1, 1) or set(errs) != {"fused_sgd", "quantize",
                                            "dequantize"} or not finite:
        fail(f"11: the qsgd8 step launched quantize, dequantize, fused_sgd "
             f"{counts} times (expected once each) or was not finite")
    out["qsgd8"] = {"loss": float(loss), "launches": counts,
                    "max_abs_err": errs}
    print(f"[11] shard_map step with qsgd8: quantize, dequantize and "
          f"fused_sgd once each over {T.flat_spec(cfg).total:,} elements, "
          f"each == its plain version bit for bit; loss {float(loss):.6f}")
    return out, errs


def _train_loop_runs(T, get_arch, cfg, mesh, card):
    """11 (d): train_loop at full width (4 steps, zero1, no checkpoint:
    one is ~13 GB of disk) and the restart test at the smoke config."""
    import tempfile
    import torch
    t0 = time.perf_counter()
    full = T.train_loop(cfg, steps=TRAIN_LOOP_STEPS,
                        batch_size=TRAIN["batch"], seq_len=TRAIN["seq"],
                        mesh=mesh, log_every=0, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = full["losses"]
    del full
    torch.cuda.empty_cache()
    if not all(math.isfinite(x) for x in losses) or not any(
            b < a for a, b in zip(losses, losses[1:])):
        fail(f"11: train_loop losses {losses} are not finite or never fall")
    smoke = dataclasses.replace(get_arch(LM_ARCH).smoke, n_layers=2,
                                remat=False)
    kw = dict(batch_size=2, seq_len=16, ckpt_every=3, log_every=0,
              mesh=mesh, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        whole = T.train_loop(smoke, steps=6, ckpt_dir=f"{tmp}/a", **kw)
        T.train_loop(smoke, steps=3, ckpt_dir=f"{tmp}/b", **kw)
        part2 = T.train_loop(smoke, steps=6, ckpt_dir=f"{tmp}/b", **kw)
    a, b = whole["losses"][3:], part2["losses"]
    restart_err = max(abs(x - y) for x, y in zip(a, b))
    if len(b) != 3 or any(abs(x - y) > 1e-5 + 1e-4 * abs(x)
                          for x, y in zip(a, b)):
        fail(f"11: the restarted train_loop {b} != the uninterrupted "
             f"{a} beyond rtol 1e-4, atol 1e-5")
    print(f"[11] train_loop at full width, {TRAIN_LOOP_STEPS} steps (zero1, "
          f"batch {TRAIN['batch']}, seq {TRAIN['seq']}): losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}, {wall:.1f} s with "
          f"parameter init; restart at the smoke config == uninterrupted "
          f"(max abs err {restart_err:.3g}; {card})")
    return {"losses": losses, "wall_s": wall,
            "restart_max_abs_err": restart_err}


def _host_mesh_round(FederatedSession, card):
    """11 (e): a GradsSharding VGG-16 round on the host_mesh engine (one
    card: the fold kernel's no-divide form over each shard, then one
    divide), bit for bit the streaming engine's."""
    import torch
    from repro_torch.configs.paper_workloads import VGG16
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    grads = [torch.randn(VGG16.params, generator=gen, device="cuda")
             for _ in range(N_CLIENTS)]
    out = host_mesh_vs_streaming(FederatedSession, grads, 1, "cuda")
    del grads
    folds = out["host_mesh_fold_launches"]
    walls = {e: out[f"{e}_wall_ms"][0] / 1e3
             for e in ("streaming", "host_mesh")}
    if folds != N_SHARDS:
        fail(f"11: the host_mesh round launched the fold {folds} times, "
             f"expected {N_SHARDS} (one a shard node)")
    print(f"[11] host_mesh VGG-16 GradsSharding round (N = {N_CLIENTS}, "
          f"M = {N_SHARDS}, 1 card): == streaming bit for bit; fold "
          f"{folds} launches; round host wall "
          f"{walls['host_mesh'] * 1e3:.1f} ms vs streaming "
          f"{walls['streaming'] * 1e3:.1f} ms ({card})")
    torch.cuda.empty_cache()
    return {"fold_launches": folds, "round_wall_s": walls["host_mesh"],
            "streaming_round_wall_s": walls["streaming"]}


def _moe_local(models, meshctx, get_arch, mesh, path, card):
    """11 (f): phi3.5-moe at full width, 2 layers, f32: the local
    dispatch under the mesh within 2e-4 of the global dispatch (whose
    launches are taken out of ``path``)."""
    import torch
    cfg = _family_cfg(get_arch, MOE_ARCH, MOE_LAYERS,
                      compute_dtype=torch.float32)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    params = models.init_params(
        torch.Generator(device="cuda").manual_seed(SEED), cfg)
    toks = torch.randint(0, cfg.vocab, (2, 64), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(1))
    with torch.no_grad():
        with launches(out_of=path):      # the comparison's forward
            glob = models.forward(params, cfg, {"tokens": toks})
        with meshctx.use_mesh(mesh):
            loc = models.forward(params, dataclasses.replace(
                cfg, moe_dispatch="local"), {"tokens": toks})
    err = float((loc - glob).abs().max())
    ok = bool(((loc - glob).abs() <= 2e-4 + 2e-4 * glob.abs()).all())
    del params, glob, loc
    torch.cuda.empty_cache()
    if not ok:
        fail(f"11: the local MoE dispatch != the global one beyond 2e-4 "
             f"(max abs err {err})")
    print(f"[11] {MOE_ARCH} ({MOE_LAYERS} layers, full width, f32): local "
          f"dispatch under the (1, 1) mesh == global within 2e-4 (max abs "
          f"err {err:.3g}; {card})")
    return {"max_abs_err": err}


def _one_rank_mesh(where: str):
    """A (1, 1) ("data", "model") mesh on a one-rank NCCL group."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        fail(f"{where}: expected a one-rank NCCL group, got "
             f"{dist.get_backend()} x {dist.get_world_size()}")
    return mesh


def phase_trainer(sgd, q, models, get_arch, FederatedSession, card):
    """11: the single-program trainer at full width on a one-rank NCCL
    group, the host_mesh engine and the MoE local dispatch. The forwards
    that the path is compared with (a single-device step's, the global MoE
    dispatch's) are left out of the phase's launches."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import train as T
    from repro_torch.models import meshctx
    t0 = time.perf_counter()
    mesh = _one_rank_mesh("11")
    cfg = dataclasses.replace(get_arch(LM_ARCH).model, remat=False)
    params = models.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab, (TRAIN["batch"], TRAIN["seq"] + 1),
                         device="cuda", generator=torch.Generator(
                             device="cuda").manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with launches() as path:
        out = {"plans": _plan_steps(T, mesh, cfg, params, batch, card)}
        out["adamw_shard"] = _adamw_shard_update(T, mesh, cfg, params, card)
        out["shardmap"], errs = _shardmap_steps(T, mesh, cfg, params, batch,
                                                sgd, q, path, card)
        del params, batch, toks
        torch.cuda.empty_cache()
        out["train_loop"] = _train_loop_runs(T, get_arch, cfg, mesh, card)
        out["host_mesh"] = _host_mesh_round(FederatedSession, card)
        out["moe_local"] = _moe_local(models, meshctx, get_arch, mesh, path,
                                      card)
        torch.cuda.synchronize()
    missing = [k for k in ("rmsnorm", "fused_sgd", "quantize", "dequantize",
                           "fedavg_stream") if path.get(k, 0) <= 0]
    if missing:
        fail(f"11: the trainer path never launched {missing}")
    dist.destroy_process_group()
    out.update({"launches": path, "max_abs_err": errs,
                "params": models.param_count(cfg),
                "seconds": time.perf_counter() - t0})
    print(f"[11] launches on the phase's path: {path}; "
          f"{out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 12: tensor parallelism on one card
# ---------------------------------------------------------------------------

TP_ARCH = "qwen3-32b"
TP_NORMS_PER_STEP = 257          # 64 layers x (ln1, ln2, q-norm, k-norm) + 1
# qwen3-32b's norm rows at batch 4: the residual, q- and k-norm over all
# heads, and one rank's heads at TP = 4; chameleon's (4, 8192) beside it
# for F.rms_norm's device time, which phase 9 did not take
TP_ROWS = {"qwen3-32b": (4, 5120), "chameleon-34b": (4, 8192),
           "qwen3-32b q-norm": (256, 128), "qwen3-32b k-norm": (32, 128),
           "qwen3-32b q-norm, one of 4 ranks": (64, 128),
           "qwen3-32b k-norm, one of 4 ranks": (8, 128)}
TP_LIBRARY_ROWS = ((4, 5120), (4, 8192))
# zamba2's gated-norm rows a rank holds (d_inner 5,120): serving's batch 4
# over 4 and 2 ranks, the trainer's 8 x 128 rows over 4; (rows, block
# width, blocks)
SPLIT_ROWS = {"decode, one of 4 ranks": (4, 1280, 4),
              "decode, one of 2 ranks": (4, 2560, 2),
              "training, one of 4 ranks": (1024, 1280, 4)}


def tp_serve_cfg(get_arch):
    """qwen3-32b as registered, served at bf16 parameters (the reference's
    serving configuration: ``dryrun._build_target`` sets ``param_dtype``
    to bf16)."""
    import torch
    return dataclasses.replace(get_arch(TP_ARCH).model,
                               param_dtype=torch.bfloat16, remat=False)


def tp_prompt(cfg):
    """serve_loop's prompts (seed 0): (batch, prompt_len) int32."""
    import numpy as np
    return np.random.default_rng(0).integers(
        0, cfg.vocab, (SERVE["batch"], SERVE["prompt_len"])).astype(np.int32)


def tp_first_logits(serve, models, cfg, params, mesh, cache_dtype=None):
    """The first decode step's logits (B, 1, V) on the serving run's first
    prompt token, through make_serve_step on ``mesh`` (the cache in
    ``cache_dtype``, by default the serving bf16); what the four-card run
    holds against one card."""
    import torch
    from repro_torch.config import ShapeConfig
    from repro_torch.models import meshctx
    b, max_len = SERVE["batch"], SERVE["max_len"]
    shape = ShapeConfig("serve", seq_len=max_len, global_batch=b,
                        kind="decode")
    dtype = cache_dtype or torch.bfloat16
    step = serve.make_serve_step(cfg, shape, mesh,
                                 models.cache_specs(cfg, b, max_len, dtype))
    dev = params["embed"].device
    with meshctx.use_mesh(mesh):
        cache = models.init_cache(cfg, b, max_len, dtype, dev)
    logits, _ = step(params, torch.from_numpy(tp_prompt(cfg)[:, :1]).to(dev),
                     cache)
    return logits


def family_first_logits(serve, models, cfg, params, mesh, cache_dtype=None):
    """The first decode step's logits (B, 1, V) on the serving run's first
    prompt token through make_serve_step on ``mesh``, any family (an
    encoder-decoder's cross-attention cache from seeded frames, built
    under the mesh); what tools/multi_card.py holds against one card."""
    import torch
    from repro_torch.config import ShapeConfig
    from repro_torch.models import encdec, meshctx
    if not models.is_encdec(cfg):
        return tp_first_logits(serve, models, cfg, params, mesh, cache_dtype)
    b, max_len = SERVE["batch"], SERVE["max_len"]
    shape = ShapeConfig("serve", seq_len=max_len, global_batch=b,
                        kind="decode")
    dtype = cache_dtype or torch.bfloat16
    dev = params["embed"].device
    step = serve.make_serve_step(cfg, shape, mesh,
                                 encdec.cache_specs(cfg, b, max_len, dtype))
    frames = torch.randn((b, cfg.encoder_seq, cfg.frontend_dim or cfg.d_model),
                         device=dev, generator=torch.Generator(device=dev)
                         .manual_seed(SEED + 181))
    with meshctx.use_mesh(mesh):
        cache = encdec.init_cache(cfg, b, max_len, params=params,
                                  frames=frames, dtype=dtype, device=dev)
    logits, _ = step(params, torch.from_numpy(tp_prompt(cfg)[:, :1]).to(dev),
                     cache)
    return logits


TP_FAMILY_ARCHS = ("falcon-mamba-7b", "zamba2-2.7b", "whisper-tiny")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _family_model1_bits(serve, models, get_arch, mesh, arch, path, card):
    """12: ``arch`` as registered (full width, full depth), its weights
    cast for serving (bf16), through make_serve_step on the (1, 1) mesh
    under the none plan, bit for bit the mesh-less step over the serving
    run's 23 steps (logits and the whole cache, the encoder's
    cross-attention K/V built under the mesh included); the rmsnorm
    launches of each step equal to ``norms_per_decode_step``, none split.
    The mesh's steps count in ``path``, the mesh-less ones do not."""
    import torch
    from repro_torch.config import ShapeConfig, ShardingPlan
    from repro_torch.models import encdec, meshctx
    cfg = dataclasses.replace(get_arch(arch).model, remat=False)
    b, max_len = SERVE["batch"], SERVE["max_len"]
    shape = ShapeConfig("serve", seq_len=max_len, global_batch=b,
                        kind="decode")
    t0 = time.perf_counter()
    params = serve.cast_for_serving(models.init_params(
        torch.Generator(device="cuda").manual_seed(SEED + 18), cfg), cfg)
    torch.cuda.empty_cache()
    family = encdec if models.is_encdec(cfg) else models
    like = family.cache_specs(cfg, b, max_len)
    on_mesh = serve.make_serve_step(cfg, shape, mesh, like,
                                    ShardingPlan(grad_sharding="none"))
    alone = serve.make_serve_step(cfg, shape, cache_like=like)
    with torch.inference_mode(), launches(out_of=path):
        want_cache, frames = _family_cache(models, cfg, params, b, max_len,
                                           torch.bfloat16, SEED + 181)
    with torch.inference_mode():
        with meshctx.use_mesh(mesh):
            got_cache = encdec.init_cache(
                cfg, b, max_len, params=params, frames=frames,
                device="cuda") if frames is not None else models.init_cache(
                    cfg, b, max_len, device="cuda")
    toks = torch.randint(0, cfg.vocab, (b, SERVE_STEPS), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(SEED + 182))
    norms = models.norms_per_decode_step(cfg)
    per_step = []
    for i in range(SERVE_STEPS):
        with launches() as grew:
            got, got_cache = on_mesh(params, toks[:, i:i + 1], got_cache)
        per_step.append((grew.get("rmsnorm", 0),
                         grew.get("rmsnorm_split", 0)))
        with launches(out_of=path):      # the comparison's step
            want, want_cache = alone(params, toks[:, i:i + 1], want_cache)
        if not bits_equal(got, want):
            fail(f"12: {arch} step {i} on the (1, 1) mesh != the mesh-less "
                 f"step (max abs err {float((got - want).abs().max())})")
    flat = lambda c: [t for _, t in sorted(_leaves(c))]
    if not all(bits_equal(a, w) for a, w in zip(flat(got_cache),
                                                flat(want_cache))) \
            or int(got_cache["idx"]) != SERVE_STEPS:
        fail(f"12: {arch}'s cache on the (1, 1) mesh != the mesh-less "
             f"step's")
    if per_step != [(norms, 0)] * SERVE_STEPS:
        fail(f"12: {arch}'s (rmsnorm, split) launches a step on the (1, 1) "
             f"mesh {per_step}, expected ({norms}, 0)")
    n = models.param_count(cfg)
    del params, got_cache, want_cache, got, want
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"[12] {arch} as registered ({n:,} parameters, bf16 for serving) "
          f"through make_serve_step on the (1, 1) mesh, none plan: "
          f"{SERVE_STEPS} steps == the mesh-less step bit for bit (logits "
          f"and cache); {norms} rmsnorm launches a step, none split; "
          f"{secs:.1f} s ({card})")
    return {"params": n, "steps": SERVE_STEPS, "rmsnorm_per_step": norms,
            "seconds": secs}


def split_rows(rn):
    """12: the rmsnorm kernel's split route (Mamba-2's gated norm under
    TP) at zamba2's rank rows, bf16 and f32 (f32 gamma): a row cut into 4
    (or 2) blocks, each block's sum of squares by the first launch within
    rtol 1e-5 of its plain version, the sums added on the device (the
    ranks' all-reduce), each block's scale launch against its plain
    version on the same sum and the joined blocks against the whole-row
    kernel (both at the rmsnorm tolerance), one block with its own sum bit
    for bit the whole-row kernel; then each launch's device time beside
    its bytes bound, over copies of the block that outgrow the L2
    (COLD_POOL_BYTES) where it exceeds COLD_BYTES, and a pair's events and
    its plain version's."""
    import itertools

    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 180)
    rows = {}
    for label, (r, d, blocks) in SPLIT_ROWS.items():
        for dtype in (torch.bfloat16, torch.float32):
            width = blocks * d
            tag = f"at ({r}, {d}) of {width} {dtype}"
            x = (torch.randn(r, width, generator=gen, device="cuda")
                 * 3).to(dtype)
            gamma = torch.randn(width, generator=gen, device="cuda")
            cuts = [slice(i * d, (i + 1) * d) for i in range(blocks)]
            ssq = [rn.rmsnorm_sumsq(x[:, c]) for c in cuts]
            for c, got in zip(cuts, ssq):
                want = rn.rmsnorm_sumsq_plain(x[:, c])
                if not bool(((got - want).abs() <= 1e-5 * want.abs()).all()):
                    fail(f"12: rmsnorm_sumsq {tag} != its plain version "
                         f"beyond rtol 1e-5")
            total = ssq[0]
            for more in ssq[1:]:
                total = total + more
            outs = [rn.rmsnorm_scale(x[:, c], total, gamma[c], 1e-5, width)
                    for c in cuts]
            for c, (out, rstd) in zip(cuts, outs):
                want, want_rstd = rn.rmsnorm_scale_plain(
                    x[:, c], total, gamma[c], 1e-5, width)
                norm_close("rmsnorm_split", f"{tag} against its plain version",
                           out, want, rstd, want_rstd)
            norm_close("rmsnorm_split", f"{tag} against the whole-row kernel",
                       torch.cat([o for o, _ in outs], dim=1),
                       rn.rmsnorm(x, gamma)[0])
            alone, _ = rn.rmsnorm_scale(x[:, cuts[0]],
                                        rn.rmsnorm_sumsq(x[:, cuts[0]]),
                                        gamma[cuts[0]], 1e-5, d)
            if not bits_equal(alone, rn.rmsnorm(x[:, cuts[0]],
                                                gamma[cuts[0]])[0]):
                fail(f"12: one block's split route {tag} != the whole-row "
                     f"kernel on it bit for bit")
            xs = x.element_size()
            sum_ms, sum_by = bound(r * d * xs + 4 * r, 2 * r * d)
            scale_ms, scale_by = bound(2 * r * d * xs + 4 * d + 8 * r,
                                       3 * r * d)
            # a rank's block is its own contiguous (rows, d); one copy a
            # call in turn where a block outgrows COLD_BYTES
            copies = 1 if r * d * xs <= COLD_BYTES else \
                -(-COLD_POOL_BYTES // (r * d * xs))
            pool = itertools.cycle([x[:, cuts[0]].contiguous()
                                    for _ in range(copies)])
            g_blk = gamma[cuts[0]]
            dev_sum, _ = counted_device_ms(
                lambda: rn.rmsnorm_sumsq(next(pool)), "rmsnorm_sumsq_kernel",
                1)
            dev_scale, _ = counted_device_ms(
                lambda: rn.rmsnorm_scale(next(pool), total, g_blk, 1e-5,
                                         width), "rmsnorm_scale_kernel", 1)

            def pair():
                blk = next(pool)
                return rn.rmsnorm_scale(blk, rn.rmsnorm_sumsq(blk), g_blk,
                                        1e-5, width)

            def plain():
                blk = next(pool)
                return rn.rmsnorm_scale_plain(
                    blk, rn.rmsnorm_sumsq_plain(blk), g_blk, 1e-5, width)
            bound_ms = sum_ms + scale_ms
            row = {"shape": [r, d], "d_total": width, "dtype": str(dtype),
                   "timed_copies": copies, "bound_ms": bound_ms,
                   "bound_by": "bytes" if sum_by == scale_by == "bytes"
                   else "operations",
                   "sumsq_device_ms": dev_sum, "scale_device_ms": dev_scale,
                   "device_ms": dev_sum + dev_scale, "ms": time_ms(pair),
                   "plain_ms": time_ms(plain), "library_ms": None}
            rows[f"{r}x{d} {str(dtype)[6:]}"] = row
            where = f"{copies} copies of the block in turn, from HBM" \
                if copies > 1 else "one block"
            print(f"[12] rmsnorm split route {tag} ({label}): {blocks} "
                  f"blocks == plain and == the whole-row kernel within the "
                  f"rmsnorm tolerance, one block == it bit for bit; device "
                  f"{dev_sum * 1e3:.3f} + {dev_scale * 1e3:.3f} us "
                  f"({100 * bound_ms / row['device_ms']:.1f}% of bound) over "
                  f"{where}, bound {bound_ms * 1e3:.3f} us "
                  f"({row['bound_by']})")
            del x, pool
    return rows


def _tp_qwen3(serve, models, get_arch, mesh, card):
    """12: qwen3-32b at full depth, bf16 parameters, served on the (1, 1)
    mesh: serve_loop at the reference's defaults (257 rmsnorm launches a
    step), then timed steps, one profiled step and the step's bytes
    bound."""
    import torch
    from repro_torch.config import ShapeConfig
    cfg = tp_serve_cfg(get_arch)
    b, max_len = SERVE["batch"], SERVE["max_len"]
    if models.norms_per_decode_step(cfg) != TP_NORMS_PER_STEP:
        fail(f"12: {TP_ARCH} counts {models.norms_per_decode_step(cfg)} "
             f"norms a step, expected {TP_NORMS_PER_STEP}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = models.init_params(
        torch.Generator(device="cuda").manual_seed(SEED + 19), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = models.param_count(cfg)
    nbytes = sum(t.numel() * t.element_size() for t in params.values())
    with launches() as path:
        out = serve.serve_loop(cfg, params=params, seed=0, device="cuda",
                               mesh=mesh, **SERVE)
    gen = out["generated"]
    if path.get("rmsnorm", 0) != TP_NORMS_PER_STEP * SERVE_STEPS:
        fail(f"12: serve_loop launched rmsnorm {path.get('rmsnorm', 0)} "
             f"times, expected {TP_NORMS_PER_STEP} x {SERVE_STEPS}")
    if gen.shape != (b, SERVE["max_new_tokens"]) or str(gen.dtype) != \
            "int32" or not ((gen >= 0) & (gen < cfg.vocab)).all():
        fail(f"12: serve_loop generated {gen.dtype} {gen.shape}")
    shape = ShapeConfig("serve", seq_len=max_len, global_batch=b,
                        kind="decode")
    with torch.inference_mode():
        first = tp_first_logits(serve, models, cfg, params, mesh)
        if first.shape != (b, 1, cfg.vocab) or not bool(
                torch.isfinite(first).all()):
            fail(f"12: the first step's logits {tuple(first.shape)} are not "
                 f"finite (B, 1, V)")
        step = serve.make_serve_step(cfg, shape, mesh,
                                     models.cache_specs(cfg, b, max_len))
        cache = models.init_cache(cfg, b, max_len, device="cuda")
        tok = torch.from_numpy(gen[:, :1].copy()).to("cuda")
        per_step = []
        walls, logits, cache = _timed_steps(step, params, tok, cache,
                                            per_step)
        if set(per_step) != {TP_NORMS_PER_STEP} or not bool(
                torch.isfinite(logits).all()):
            fail(f"12: rmsnorm launches a step {sorted(set(per_step))}, or "
                 f"non-finite logits")
        kernels, prof_wall_ms = profiled_call(
            lambda: step(params, tok, cache))
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    idx = int(cache["idx"]) - 1
    step_bytes = _step_bytes(params, cache, cfg, idx)
    bound_ms = step_bytes / cost.HBM_BPS * 1e3
    step_ms = statistics.median(walls)
    prof = busy_row(kernels, prof_wall_ms, bound_ms)
    res = {"params": n, "param_bytes": nbytes, "init_s": init_s,
           "tokens_per_s": out["tokens_per_s"], "loop_wall_s": out["wall_s"],
           "launches": path, "rmsnorm_per_step": TP_NORMS_PER_STEP,
           "step_walls_ms": walls, "step_median_ms": step_ms,
           "step_bytes": step_bytes, "step_bound_ms": bound_ms,
           "peak_memory_gb": peak_gb, "profile": prof,
           "first_logits_max_abs": float(first.float().abs().max()),
           "first_logits_sum": float(first.float().sum())}
    del params, cache, first, logits
    torch.cuda.empty_cache()
    print(f"[12] {TP_ARCH} at full depth ({n:,} parameters, "
          f"{nbytes / 1e9:.2f} GB of bf16, drawn in {init_s:.1f} s) through "
          f"serve_loop on the (1, 1) mesh (batch {b}, prompt "
          f"{SERVE['prompt_len']}, {SERVE['max_new_tokens']} new tokens): "
          f"{out['tokens_per_s']:.1f} tokens/s, {TP_NORMS_PER_STEP} rmsnorm "
          f"launches a step, peak device memory {peak_gb:.2f} GB ({card})")
    print(f"    a decode step: median host wall {step_ms:.3f} ms over "
          f"{SERVE_TIMED_STEPS}; bytes bound {bound_ms:.3f} ms "
          f"({step_bytes} bytes); {_prof_text(prof)}")
    return res


def phase_tp(serve, models, rn, get_arch, card):
    """12: rmsnorm at qwen3-32b's rows (a TP = 4 rank's q/k-norm blocks
    included) and the split route at zamba2's rank blocks, each held to
    its plain version and timed; then, on a one-rank NCCL group and a (1,
    1) ("data", "model") mesh, qwen3-32b at full depth in bf16, and the
    SSM, hybrid and encoder-decoder families as registered bit for bit
    the mesh-less step. tools/multi_card.py serves them split over four
    cards."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    out = {"rmsnorm_rows": norm_rows(rn, TP_ROWS, "12", TP_LIBRARY_ROWS),
           "split_rows": split_rows(rn)}
    mesh = _one_rank_mesh("12")
    out["qwen3"] = _tp_qwen3(serve, models, get_arch, mesh, card)
    with launches() as families:
        out["families"] = {arch: _family_model1_bits(
            serve, models, get_arch, mesh, arch, families, card)
            for arch in TP_FAMILY_ARCHS}
    dist.destroy_process_group()
    out.update(launches=out["qwen3"]["launches"],
               family_launches=families, seconds=time.perf_counter() - t0)
    print(f"[12] launches on the phase's paths: qwen3-32b {out['launches']}, "
          f"the families {families}; {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 13: the examples at full width, through their own entry points
# ---------------------------------------------------------------------------

EX_QUICKSTART_FAST = ["--schedule", "pipelined", "--readahead-k", "4",
                      "--codec", "qsgd8"]
EX_FAULTY_ROBUST = ["--staleness-policy", "polynomial", "--hedge", "2"]
EX_VGG16_SIZE = "138357544"      # VGG-16's parameters: 553 MB a client
EX_SERVE_STEPS = 8 + 24 - 1      # serve_sharded's prompt_len + new_tokens - 1
# the reference's federated CNN loop (tests/test_fl_e2e.py) at
# CNNConfig()'s default width
CNN_RUN = dict(clients=4, shards=4, local_steps=4, lr=0.05, momentum=0.9,
               batch=32)
#: the kernels the phase's examples must reach
EX_KERNELS = ("fedavg_stream", "quantize", "dequantize", "topk_sparsify",
              "fused_sgd", "rmsnorm")


@contextlib.contextmanager
def timed_sessions(module, FederatedSession, walls: list, seen: list):
    """``module.FederatedSession`` swapped for a subclass whose rounds take
    the host clock around work that ends in a device synchronisation (in
    ``walls``), the client gradients of the first kept in ``seen``."""
    import torch

    class Timed(FederatedSession):
        def round(self, client_grads=None, **kw):
            if client_grads is not None and not seen:
                seen.extend(client_grads)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = super().round(client_grads, **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            return r

    module.FederatedSession = Timed
    try:
        yield
    finally:
        module.FederatedSession = FederatedSession


def cnn_rounds(card):
    """13: the reference's federated CNN loop at ``CNNConfig()``'s default
    width on the card, one round of each topology from the same seeded
    weights (batched engine, cuDNN's deterministic algorithms): fused-SGD
    once a leaf a local step, the fold launched, the three models within
    rtol 1e-4, atol 1e-5 of GradsSharding's; client and aggregation walls.
    The card tests hold the loop to the CPU at the reference's test
    width."""
    import torch
    from repro_torch.core import aggregation as agg
    from repro_torch.core import fedavg
    from repro_torch.core.sharding import flatten, unflatten
    from repro_torch.data import SyntheticVision
    from repro_torch.models import cnn
    from repro_torch.serverless import LambdaRuntime
    from repro_torch.store import ObjectStore
    cfg = cnn.CNNConfig()
    data = SyntheticVision(n_classes=cfg.n_classes, img_size=cfg.img_size,
                           seed=0, noise=0.4)
    start = cnn.init_params(torch.Generator().manual_seed(0), cfg)
    loss = lambda p, b: cnn.loss_fn(p, cfg, b)
    torch.backends.cudnn.deterministic = True
    out, finals = {}, {}
    for topology in TOPOLOGIES:
        params = {k: v.to("cuda") for k, v in start.items()}
        client_walls, flats, spec = [], [], None
        with launches() as grew:
            for c in range(CNN_RUN["clients"]):
                t0 = time.perf_counter()
                local, vel = {k: v.clone() for k, v in params.items()}, None
                for step in range(CNN_RUN["local_steps"]):
                    local, vel, _ = fedavg.local_sgd_update(
                        loss, local, data.batch(c, step, CNN_RUN["batch"],
                                                device="cuda"),
                        lr=CNN_RUN["lr"], momentum=CNN_RUN["momentum"],
                        velocity=vel)
                flat, spec = flatten(fedavg.model_delta(params, local))
                flats.append(flat)
                torch.cuda.synchronize()
                client_walls.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            r = agg.aggregate_round(topology, flats, rnd=0,
                                    store=ObjectStore(),
                                    runtime=LambdaRuntime(),
                                    n_shards=CNN_RUN["shards"],
                                    codec="identity", engine="batched")
            torch.cuda.synchronize()
            agg_wall = time.perf_counter() - t0
        params = fedavg.apply_delta(params, unflatten(r.avg_flat, spec))
        finals[topology] = flatten(params)[0]
        want = len(cnn.param_shapes(cfg)) * CNN_RUN["local_steps"] \
            * CNN_RUN["clients"]
        if grew.get("fused_sgd", 0) != want \
                or grew.get("fedavg_stream", 0) == 0:
            fail(f"13: the CNN round under {topology} launched {grew}, "
                 f"expected {want} fused_sgd and a fold")
        out[topology] = {"launches": grew, "client_walls_s": client_walls,
                         "agg_wall_s": agg_wall}
    head = finals["gradssharding"]
    for topology in TOPOLOGIES[1:]:
        diff = (finals[topology] - head).abs()
        out[topology]["max_abs_diff_vs_gradssharding"] = float(diff.max())
        if not bool((diff <= 1e-5 + 1e-4 * head.abs()).all()):
            fail(f"13: the default-width CNN after a {topology} round != "
                 f"gradssharding's beyond rtol 1e-4, atol 1e-5")
    torch.backends.cudnn.deterministic = False
    n = int(head.numel())
    client_ms = 1e3 * statistics.median(
        out["gradssharding"]["client_walls_s"])
    print(f"[13] federated CNN at CNNConfig()'s width ({n:,} parameters), "
          f"one round each: lambda_fl and lifl == gradssharding within rtol "
          f"1e-4, atol 1e-5; median client wall {client_ms:.1f} ms, "
          f"aggregation walls " + ", ".join(
              f"{t} {1e3 * out[t]['agg_wall_s']:.1f} ms" for t in TOPOLOGIES)
          + f"; launches {out['gradssharding']['launches']} a round ({card})")
    return out


def phase_examples(examples, models, get_arch, FederatedSession, card):
    """13: the reference's examples through the port's entry points on the
    card, their self-checks live: quickstart (plain and pipelined qsgd8),
    faulty_round (plain and stale/hedged) and compression_composition at
    their defaults, each reaching its kernels (the card tests hold their
    values to the CPU's); million_clients at N = 10^3, 10^4, 10^5 (N =
    10^3 equal to the CPU's); compression_composition at VGG-16 width,
    identity equal to numpy's left fold; elastic_reshard; serve_sharded
    for every registered arch (the rmsnorm launches of each step equal to
    ``norms_per_decode_step``); train_federated_lm for 2 rounds of
    full-width tinyllama-1.1b. Each example's launches are read over its
    run, and each kernel of EX_KERNELS must be reached."""
    import numpy as np
    import torch
    from repro_torch.configs import arch_ids
    (quickstart, faulty_round, million_clients, compression_composition,
     elastic_reshard, serve_sharded, train_federated_lm) = examples
    out, per_example = {}, {}

    def run(label, fn):
        t0 = time.perf_counter()
        with launches() as grew:
            got = fn()
            torch.cuda.synchronize()
        per_example[label] = dict(grew, seconds=time.perf_counter() - t0)
        return got

    for label, module, extra in (
            ("quickstart", quickstart, []),
            ("quickstart qsgd8", quickstart, EX_QUICKSTART_FAST),
            ("faulty_round", faulty_round, []),
            ("faulty_round stale+hedge", faulty_round, EX_FAULTY_ROBUST),
            ("compression_composition", compression_composition, [])):
        run(label, lambda: module.main(extra + ["--device", "cuda"]))
        print(f"[13] {label}: launches {per_example[label]}")
    if per_example["quickstart"].get("fedavg_stream", 0) == 0 \
            or per_example["quickstart qsgd8"].get("quantize", 0) == 0 \
            or per_example["compression_composition"].get(
                "topk_sparsify", 0) == 0:
        fail(f"an example did not reach its kernels: {per_example}")

    # million_clients: each cell's host RSS and device peaks, then N = 10^3
    # on the CPU
    peak, real_round = {}, million_clients.one_round

    def measured_round(topology, n, device):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with _RssPeak() as rss:
            got = real_round(topology, n, device)
        peak[n, topology] = (
            rss.peak / 2**20, (rss.peak - rss.start) / 2**20,
            (torch.cuda.max_memory_allocated() - base) / 2**20)
        return got

    million_clients.one_round = measured_round
    try:
        mc = run("million_clients",
                 lambda: million_clients.main(["--device", "cuda"]))
    finally:
        million_clients.one_round = real_round
    small, cohorts = million_clients.COHORTS[0], million_clients.COHORTS
    million_clients.COHORTS = (small,)
    try:
        mc_cpu = million_clients.main(["--device", "cpu"])
    finally:
        million_clients.COHORTS = cohorts
    for topology in million_clients.TOPOLOGIES:
        a, b = mc["cells"][small, topology], mc_cpu["cells"][small, topology]
        if (a["wall_clock_s"], a["cost"]) != (b["wall_clock_s"], b["cost"]):
            fail(f"million_clients N={small} {topology}: the card's wall and "
                 f"cost {a['wall_clock_s']!r}, {a['cost']!r} != the CPU's "
                 f"{b['wall_clock_s']!r}, {b['cost']!r}")
    if per_example["million_clients"].get("fedavg_stream", 0) == 0:
        fail("million_clients launched no fold")
    out["million_clients"] = {
        f"{n}/{t}": {"host_s": c["host_s"], "host_rss_peak_mb": peak[n, t][0],
                     "host_rss_rise_mb": peak[n, t][1],
                     "device_peak_mb": peak[n, t][2],
                     "modeled_wall_s": c["wall_clock_s"], "cost": c["cost"]}
        for (n, t), c in mc["cells"].items()}
    for key, c in out["million_clients"].items():
        print(f"[13] million_clients {key}: host {c['host_s']:.3f} s, host "
              f"RSS peak {c['host_rss_peak_mb']:.0f} MB (+"
              f"{c['host_rss_rise_mb']:.0f}), device peak "
              f"{c['device_peak_mb']:.2f} MB")
    print(f"    million_clients N={small}: walls and costs == the CPU's")

    # compression_composition at VGG-16 width
    walls, seen = [], []
    with timed_sessions(compression_composition, FederatedSession, walls,
                        seen):
        cc = run("compression_composition VGG-16", lambda:
                 compression_composition.main(
                     ["--size", EX_VGG16_SIZE, "--device", "cuda"]))
    acc = seen[0].copy()
    for g in seen[1:]:
        acc += g
    acc /= len(seen)
    if not np.array_equal(cc["codecs"]["identity"]["avg_flat"], acc):
        fail("compression_composition at VGG-16 width: identity != numpy's "
             "left fold")
    out["compression_vgg16"] = {
        codec: {"wire_mb": row["wire_mb"], "billed_gb_s": row["billed_gb_s"],
                "codec_error": row["codec_error"],
                "modeled_wall_s": row["wall_clock_s"], "host_wall_s": wall}
        for (codec, row), wall in zip(cc["codecs"].items(), walls)}
    del seen, acc, cc
    for codec, row in out["compression_vgg16"].items():
        print(f"    VGG-16 {codec}: wire {row['wire_mb']:.2f} MB, billed "
              f"{row['billed_gb_s']:.3f} GB-s, codec_error "
              f"{row['codec_error']:.3e}, modeled wall "
              f"{row['modeled_wall_s']:.3f} s, host wall "
              f"{row['host_wall_s']:.3f} s")
    print("    VGG-16 identity == numpy's left fold, bit for bit")
    torch.cuda.empty_cache()

    er = run("elastic_reshard",
             lambda: elastic_reshard.main(["--device", "cuda"]))
    print(f"[13] elastic_reshard: restored bit for bit, shards "
          f"{er['resumed_shard_sizes']}")
    out["serve_sharded"] = {}
    for arch in arch_ids():
        cfg = get_arch(arch).smoke
        got = run(f"serve_sharded {arch}", lambda: serve_sharded.main(
            ["--arch", arch, "--device", "cuda"]))
        norms = models.norms_per_decode_step(cfg)
        encoder = 2 * cfg.encoder_layers + 1 if models.is_encdec(cfg) else 0
        grew = per_example[f"serve_sharded {arch}"]
        if grew.get("rmsnorm", 0) != norms * EX_SERVE_STEPS + encoder \
                or got["generated"].shape != (4, 24):
            fail(f"serve_sharded {arch}: launches {grew} (expected "
                 f"{norms} x {EX_SERVE_STEPS} + {encoder} rmsnorm), "
                 f"generated {got['generated'].shape}")
        out["serve_sharded"][arch] = {"tokens_per_s": got["tokens_per_s"],
                                      "rmsnorm_per_step": norms}
        print(f"    serve_sharded {arch}: {got['tokens_per_s']:.1f} tok/s, "
              f"{norms} rmsnorm launches a step")
    torch.cuda.empty_cache()

    lm_args = [f"--{k}={v}" for k, v in LM_RUN.items()]
    lm = run("train_federated_lm",
             lambda: train_federated_lm.main(lm_args + ["--device", "cuda"]))
    losses, means = check_lm_run(lm, per_example["train_federated_lm"])
    del lm
    torch.cuda.empty_cache()
    print(f"[13] train_federated_lm {LM_ARCH}: losses {losses}, mean "
          f"{means}; launches {per_example['train_federated_lm']}")
    launched = {}
    for grew in per_example.values():
        for k, n in grew.items():
            if k != "seconds":
                launched[k] = launched.get(k, 0) + n
    if any(launched.get(k, 0) == 0 for k in EX_KERNELS):
        fail(f"a kernel was not launched on the examples' path: {launched}")
    out.update(launches=launched, per_example=per_example, card=card)
    print(f"[13] examples: launches {launched}")
    return out


# ---------------------------------------------------------------------------
# Phase 14: Mamba-1's associative scan at training length
# ---------------------------------------------------------------------------

SCAN_ARCH = "falcon-mamba-7b"
SCAN_SEQ = 4096                  # train_4k's sequence length
# 14 (b) cuts the depth: at 64 layers the f32 parameters, gradients and
# AdamW's two moments alone hold ~116 GB
SCAN_TRAIN_LAYERS = 8
SCAN_TIMED_STEPS = 3
# 14 (a): the f32 block against the f64 loop, max |got - want| within
# these shares of max |want| (f32 rounding through products of 4,096 and
# 8,192 terms, `exp` and 256-step scans; every weight's gradient sums over
# 4,096 tokens)
SCAN_OUT_TOL, SCAN_GRAD_TOL = 1e-4, 1e-4


def loop_mamba1_ssm(dt, bmat, cmat, xc, a, h0, chunk: int):
    """Mamba-1's chunked recurrence as a loop over each chunk's steps, with
    ``ssm.mamba1_ssm``'s signature: the form the associative scan
    replaced, kept here only as 14 (a)'s reading before it."""
    import torch
    s = dt.shape[1]
    chunk = min(chunk, s)
    dt, bmat, cmat, xc = (t.float() for t in (dt, bmat, cmat, xc))
    h, ys = h0, []
    for lo in range(0, s, chunk):
        sl = slice(lo, lo + chunk)
        da = torch.exp(dt[:, sl, :, None] * a)
        db = (dt[:, sl] * xc[:, sl])[..., None] * bmat[:, sl, None, :]
        hs = []
        for i in range(da.shape[1]):
            h = da[:, i] * h + db[:, i]
            hs.append(h)
        ys.append(torch.einsum("bcdn,bcn->bcd", torch.stack(hs, dim=1),
                               cmat[:, sl]))
    return torch.cat(ys, dim=1), h


def mamba1_block_f64(p, x, cfg):
    """14 (a)'s reference: the Mamba-1 block in f64 from the same weights,
    its recurrence a loop over every step of the sequence (no chunks)."""
    import torch
    import torch.nn.functional as F
    r, ds = math.ceil(cfg.d_model / 16), cfg.ssm.d_state
    k, c = p["conv_w"].shape
    x_in, z = x @ p["in_x"], x @ p["in_z"]
    conv = F.conv1d(F.pad(x_in.transpose(1, 2), (k - 1, 0)),
                    p["conv_w"].T.reshape(c, 1, k), groups=c)
    xc = F.silu(conv.transpose(1, 2) + p["conv_b"])
    dt_raw, bm, cm = torch.split(xc @ p["x_proj"], [r, ds, ds], dim=-1)
    dt = F.softplus(dt_raw @ p["dt_proj"] + p["dt_bias"])
    da = torch.exp(dt[..., None] * -torch.exp(p["a_log"]))
    db = (dt * xc)[..., None] * bm[:, :, None, :]
    h, hs = torch.zeros_like(da[:, 0]), []
    for da_t, db_t in zip(da.unbind(1), db.unbind(1)):
        h = da_t * h + db_t
        hs.append(h)
    y = torch.einsum("bsdn,bsn->bsd", torch.stack(hs, dim=1), cm)
    return ((y + xc * p["d_skip"]) * F.silu(z)) @ p["out_proj"]


def _block_grads(block, p, x, w):
    """``block(p, x)`` and the gradients of sum(out · w) by x and by each
    leaf of ``p``, in that order."""
    import torch
    out = block(p, x)
    grads = torch.autograd.grad((out * w).sum(), [x, *p.values()])
    return out.detach(), grads


def _scan_reading(fn) -> dict:
    """One call of ``fn`` (its result dropped): host wall and peak device
    memory; then one profiled call: device busy time and kernels."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    del res
    prof = busy_row(*profiled_call(fn))
    return {"host_wall_ms": wall_ms, "peak_memory_gb": peak / 1e9,
            "peak_above_held_gb": (peak - held) / 1e9,
            "device_busy_ms": None if prof is None
            else prof["device_busy_ms"],
            "kernels": 0 if prof is None else prof["kernels"],
            "profiled_wall_ms": None if prof is None
            else prof["step_wall_ms"]}


def _scan_block(ssm, get_arch, card) -> dict:
    """14 (a): one falcon-mamba-7b block, forward and backward, at (1,
    4,096, 4,096), f32 compute: its output and every gradient against the
    f64 step loop, then the scan's and the per-step loop's readings."""
    import torch
    cfg = dataclasses.replace(get_arch(SCAN_ARCH).model,
                              compute_dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    p = ssm.mamba1_init(gen, cfg, torch.float32)
    x = torch.randn((1, SCAN_SEQ, cfg.d_model), generator=gen,
                    device="cuda")
    w = torch.randn((1, SCAN_SEQ, cfg.d_model), generator=gen,
                    device="cuda")
    p64 = {k: v.double().requires_grad_() for k, v in p.items()}
    want, want_g = _block_grads(lambda q, v: mamba1_block_f64(q, v, cfg),
                                p64, x.double().requires_grad_(), w.double())
    del p64
    torch.cuda.empty_cache()
    p = {k: v.requires_grad_() for k, v in p.items()}
    x.requires_grad_()
    block = lambda q, v: ssm.mamba1_block(q, v, cfg)[0]
    got, got_g = _block_grads(block, p, x, w)
    scale = lambda t: float(t.abs().max())
    errs = {"out": float((got.double() - want).abs().max()) / scale(want)}
    for name, g, wg in zip(["x", *p], got_g, want_g):
        errs[f"d{name}"] = float((g.double() - wg).abs().max()) / scale(wg)
    del got, got_g, want, want_g
    print(f"[14] falcon-mamba-7b block at (1, {SCAN_SEQ}, {cfg.d_model}), "
          f"f32, against the f64 step loop: max |err| / max |want| "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    bad = {k: v for k, v in errs.items()
           if not v <= (SCAN_OUT_TOL if k == "out" else SCAN_GRAD_TOL)}
    if bad:
        fail(f"14: the block beyond {SCAN_OUT_TOL} (output) / "
             f"{SCAN_GRAD_TOL} (gradients) of max |want|: {bad}")
    run = lambda: _block_grads(block, p, x, w)
    out = {"errors": errs, "scan": _scan_reading(run)}
    scan_fn = ssm.mamba1_ssm
    ssm.mamba1_ssm = loop_mamba1_ssm
    try:
        out["loop"] = _scan_reading(run)
    finally:
        ssm.mamba1_ssm = scan_fn
    del p, x, w
    torch.cuda.empty_cache()
    for name in ("scan", "loop"):
        r = out[name]
        busy = "not measured" if r["device_busy_ms"] is None else \
            f"{r['device_busy_ms']:.1f} ms"
        print(f"[14] block forward + backward, {name}: host wall "
              f"{r['host_wall_ms']:.1f} ms, device busy {busy}, "
              f"{r['kernels']} kernels, peak device memory "
              f"{r['peak_memory_gb']:.2f} GB ({card})")
    return out


def _scan_train_step(T, models, get_arch, mesh, card) -> dict:
    """14 (b): falcon-mamba-7b at full width cut to SCAN_TRAIN_LAYERS
    layers, one ``none`` step of ``jit_train_step`` at batch 1 x 4,096,
    bf16 compute, remat as registered: finite loss, rmsnorm launches
    (each layer's pre-norm, again in its recompute, and the final norm),
    the step's host wall (median of 3), peak device memory and a profiled
    step's busy share."""
    import torch
    from repro_torch.config import ShapeConfig, ShardingPlan
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(get_arch(SCAN_ARCH).model,
                              n_layers=SCAN_TRAIN_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    params = models.init_params(gen, cfg)
    toks = torch.randint(0, cfg.vocab, (1, SCAN_SEQ + 1), generator=gen,
                         device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    shape = ShapeConfig("train_4k", seq_len=SCAN_SEQ, global_batch=1,
                        kind="train")
    opt = adamw(3e-4, grad_clip_norm=1.0)
    plan = ShardingPlan(grad_sharding="none")
    step = T.jit_train_step(cfg, shape, mesh, plan, opt)
    p_in, state = T.place_state(cfg, mesh, plan, params, opt.init(params))
    del params
    norms = cfg.n_layers * (2 if cfg.remat else 1) + 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    with launches() as path:             # the steps and the two profiled
        for _ in range(1 + SCAN_TIMED_STEPS):
            t0 = time.perf_counter()
            p_in, state, m = step(p_in, state, batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        peak = torch.cuda.max_memory_allocated() / 1e9
        if not all(map(math.isfinite, losses)):
            fail(f"14: a falcon-mamba-7b step gave a non-finite loss "
                 f"{losses}")
        prof = busy_row(*profiled_call(lambda: step(p_in, state, batch)))
    launched = path.get("rmsnorm", 0)
    if launched != norms * (len(losses) + 2):
        fail(f"14: {len(losses) + 2} steps launched rmsnorm {launched} "
             f"times, expected {norms} a step")
    del p_in, state, batch, toks
    torch.cuda.empty_cache()
    median = statistics.median(walls[1:])
    busy = None if prof is None else prof["device_busy_ms"]
    out = {"n_layers": cfg.n_layers, "registered_layers":
           get_arch(SCAN_ARCH).model.n_layers, "params":
           models.param_count(cfg), "losses": losses,
           "step_walls_ms": walls[1:], "first_step_wall_ms": walls[0],
           "step_wall_ms": median, "peak_memory_gb": peak,
           "rmsnorm_per_step": norms, "launches": path, "profile": prof,
           "busy_share": None if prof is None else 1 - prof["idle_share"],
           # the profiler slows the host: busy against the median step too
           "busy_share_of_median_step": None if busy is None else
           min(1.0, busy / median)}
    busy_txt = "profile: no device activity; not measured" if prof is None \
        else (f"profiled step {prof['step_wall_ms']:.1f} ms, device busy "
              f"{busy:.1f} ms ({100 * out['busy_share']:.1f}%; "
              f"{100 * out['busy_share_of_median_step']:.1f}% of the median "
              f"step), {prof['kernels']} kernels")
    print(f"[14] falcon-mamba-7b train step ({out['params']:,} parameters, "
          f"cut to {cfg.n_layers} of {out['registered_layers']} layers), "
          f"batch 1 x {SCAN_SEQ}, bf16: losses {losses}; {norms} rmsnorm "
          f"launches a step; step host wall {median:.1f} ms "
          f"(median of {SCAN_TIMED_STEPS}; the first "
          f"{walls[0]:.1f}), peak device memory {peak:.2f} GB; {busy_txt} "
          f"({card})")
    return out


def _scan_prefill(models, get_arch, card) -> dict:
    """14 (c): falcon-mamba-7b's forward at full depth (64 layers, bf16
    weights) at batch 1 x 4,096: host wall of two forwards after a
    warm-up, peak device memory, rmsnorm launches."""
    import torch
    cfg = dataclasses.replace(get_arch(SCAN_ARCH).model, remat=False,
                              param_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    params = models.init_params(gen, cfg)
    toks = torch.randint(0, cfg.vocab, (1, SCAN_SEQ), generator=gen,
                         device="cuda")
    walls = []
    with launches() as path:
        for _ in range(3):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with torch.inference_mode():
                logits = models.forward(params, cfg, {"tokens": toks})
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated() / 1e9
            if logits.shape != (1, SCAN_SEQ, cfg.vocab) \
                    or not bool(torch.isfinite(logits).all()):
                fail(f"14: the prefill's logits {tuple(logits.shape)} are "
                     f"not finite or not (1, {SCAN_SEQ}, {cfg.vocab})")
            del logits
    norms = cfg.n_layers + 1
    if path.get("rmsnorm", 0) != 3 * norms:
        fail(f"14: three prefills launched rmsnorm {path.get('rmsnorm', 0)} "
             f"times, expected {norms} a forward")
    del params
    torch.cuda.empty_cache()
    out = {"n_layers": cfg.n_layers, "params": models.param_count(cfg),
           "walls_ms": walls[1:], "first_wall_ms": walls[0],
           "peak_memory_gb": peak, "launches": path}
    print(f"[14] falcon-mamba-7b prefill, 64 layers, bf16 weights, batch 1 "
          f"x {SCAN_SEQ}: host wall {walls[1]:.1f}, {walls[2]:.1f} ms (the "
          f"first {walls[0]:.1f}), peak device memory {peak:.2f} GB; "
          f"{norms} rmsnorm launches a forward ({card})")
    return out


def phase_scan(ssm, models, get_arch, card) -> dict:
    """14: Mamba-1's associative scan at falcon-mamba-7b's width and
    train_4k's length: (a) one block's forward and backward against an f64
    step loop, beside the per-step loop's readings; (b) the trainer's step
    on a one-rank NCCL group and a (1, 1) mesh, cut in depth; (c) the full
    64-layer prefill."""
    import torch.distributed as dist
    from repro_torch.launch import train as T
    t0 = time.perf_counter()
    out = {"block": _scan_block(ssm, get_arch, card)}
    part_s = {"block": time.perf_counter() - t0}
    mesh = _one_rank_mesh("14")
    out["train"] = _scan_train_step(T, models, get_arch, mesh, card)
    dist.destroy_process_group()
    part_s["train"] = time.perf_counter() - t0 - sum(part_s.values())
    out["prefill"] = _scan_prefill(models, get_arch, card)
    part_s["prefill"] = time.perf_counter() - t0 - sum(part_s.values())
    out["part_seconds"] = part_s
    out["launches"] = {k: out["train"]["launches"].get(k, 0)
                       + out["prefill"]["launches"].get(k, 0)
                       for k in {*out["train"]["launches"],
                                 *out["prefill"]["launches"]}}
    out["seconds"] = time.perf_counter() - t0
    print(f"[14] launches on the phase's path: {out['launches']}; "
          f"{out['seconds']:.1f} s (" + ", ".join(
              f"{k} {v:.1f}" for k, v in part_s.items()) + ")")
    return out


# ---------------------------------------------------------------------------
# Phase 15: the causal attention kernel
# ---------------------------------------------------------------------------

#: (label, (B, S, H, KH, D)): GPT-2 Large's training step, and grouped-query
#: attention at head dim 128 with a ragged last tile
ATTN_SHAPES = (("gpt2-large", (4, 1024, 20, 20, 64)),
               ("gqa128", (2, 1000, 32, 8, 128)))


def attn_cost(b, s, h, kh, d) -> tuple:
    """One forward and backward: the train count of operations (3 × QKᵀ
    and PV over the causal half, recomputation not counted) and the bytes
    (each input read once, each output written once: q, k, v in and o, m,
    l out; q, k, v, do, m, l in and dq, dk, dv out)."""
    qb, kvb, st = b * s * h * d * 2, b * s * kh * d * 2, b * h * s * 4
    flops = 3.0 * 4.0 * s * s * h * d * 0.5 * b
    nbytes = (qb + 2 * kvb + qb + 2 * st) + (2 * qb + 2 * kvb + 2 * st
                                             + qb + 2 * kvb)
    return flops, nbytes


def phase_attention(ca, layers, card) -> dict:
    """15: the causal attention kernels against ``attention_dense``: the
    output and the three gradients no further (relative norm) from an f32
    attention on the same bf16 values than the dense path at bf16 is,
    with 10 % room; two runs the same bits; 1 + 2 launches a forward and
    backward. Then the device time of one forward and backward (three
    kernels a call), its bound, the plain versions' time, the dense
    path's and SDPA's (``library_ms``, a yardstick the port never calls),
    and the peak memory a forward and backward adds, kernel against
    dense."""
    import torch
    import torch.nn.functional as F
    t0 = time.perf_counter()
    gap = lambda a, b: float((a - b).norm() / b.norm()) if float(
        b.norm()) > 0 else float((a - b).norm())
    out = {}
    for label, (b, s, h, kh, d) in ATTN_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(SEED + d)
        mk = lambda *sh: torch.randn(*sh, generator=gen, device="cuda").to(
            torch.bfloat16)
        q, k, v, do = mk(b, s, h, d), mk(b, s, kh, d), mk(b, s, kh, d), \
            mk(b, s, h, d)
        pos = torch.arange(s, device="cuda")
        dense = lambda q_, k_, v_: layers.attention_dense(
            q_, k_, v_, q_pos=pos, k_pos=pos, causal=True)

        def grads(fn, dtype=torch.bfloat16):
            leaves = [t.detach().clone().to(dtype).requires_grad_()
                      for t in (q, k, v)]
            o = fn(*leaves)
            o.backward(do.to(dtype))
            return [o.detach()] + [t.grad for t in leaves]

        exact = [t.float() for t in grads(dense, torch.float32)]
        ref = [t.float() for t in grads(dense)]
        with launches() as grew:
            got = grads(ca.causal_attention)
            again = grads(ca.causal_attention)
            torch.cuda.synchronize()
        if grew.get("causal_attention", 0) != 6:
            fail(f"15 {label}: {grew} launched for two forwards and "
                 f"backwards, not 6 causal_attention")
        row = {"shape": [b, s, h, kh, d]}
        for name, g_, r_, e_ in zip(("o", "dq", "dk", "dv"), got, ref,
                                    exact):
            row[f"{name}_gap"] = gap(g_.float(), e_)
            row[f"{name}_dense_gap"] = gap(r_, e_)
            if row[f"{name}_gap"] > 1.1 * row[f"{name}_dense_gap"] + 1e-7:
                fail(f"15 {label}: {name} is {row[f'{name}_gap']:.3e} from "
                     f"f32, the dense path {row[f'{name}_dense_gap']:.3e}")
        if not all(bits_equal(x, y) for x, y in zip(got, again)):
            fail(f"15 {label}: two runs differ")
        held("causal_attention", False)
        del exact, ref, got, again
        o, m, l = ca.forward(q, k, v)
        kernel = lambda: (ca.forward(q, k, v), ca.backward(q, k, v, do, m, l))
        plain = lambda: (ca.forward_plain(q, k, v),
                         ca.backward_plain(q, k, v, do, m, l))
        lib = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]

        def library():
            F.scaled_dot_product_attention(
                *lib, is_causal=True, enable_gqa=kh != h).backward(
                    do.transpose(1, 2))

        def peak_gb(fn):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fn()
            torch.cuda.synchronize()
            return (torch.cuda.max_memory_allocated() - base) / 1e9

        flops, nbytes = attn_cost(b, s, h, kh, d)
        bound_ms, by = bound(nbytes, flops, cost.BF16_FLOPS)
        dev, kernels = counted_device_ms(kernel, "causal_attention", 3)
        row.update({
            "device_ms": dev, "kernels_a_call": kernels,
            "ms": time_ms(kernel), "bound_ms": bound_ms, "bound_by": by,
            "share": bound_ms / dev, "plain_ms": time_ms(plain),
            "dense_ms": time_ms(lambda: grads(dense)),
            "library_ms": time_ms(library),
            "peak_gb": peak_gb(lambda: grads(ca.causal_attention)),
            "dense_peak_gb": peak_gb(lambda: grads(dense))})
        print(f"[15] {label} {tuple(row['shape'])}: gaps to f32 (kernel / "
              f"dense) " + ", ".join(
                  f"{n} {row[n + '_gap']:.3e} / {row[n + '_dense_gap']:.3e}"
                  for n in ("o", "dq", "dk", "dv"))
              + f"; device {dev:.4f} ms "
              f"({kernels} kernels a call, all recorded), events "
              f"{row['ms']:.3f}, bound {bound_ms:.4f} ({by}), share "
              f"{100 * row['share']:.1f}%, plain {row['plain_ms']:.2f}, "
              f"dense {row['dense_ms']:.2f}, SDPA {row['library_ms']:.3f}; "
              f"peak {row['peak_gb']:.2f} GB against "
              f"{row['dense_peak_gb']:.2f} ({card})")
        out[label] = row
        del q, k, v, do, o, m, l, lib
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Phase 16: the RoPE kernel
# ---------------------------------------------------------------------------

#: (label, (B, S, H, hd), type, positions): GPT-2 Large's training step's q
#: (k alike), and a tinyllama-wide f32 decode step at one position
ROPE_SHAPES = (("gpt2-large", (4, 1024, 20, 64), "bfloat16", "arange"),
               ("decode128", (4, 1, 32, 128), "float32", "one"))


def phase_rope(rp, layers, card) -> dict:
    """16: the RoPE kernel through ``layers.apply_rope`` against the plain
    chain (``apply_rope_plain``) and autograd through it: the output and
    x's gradient bit for bit, two launches a forward and backward. Then a
    forward and backward over copies of x and of its gradient, one pair a
    call in turn, that together outgrow the L2 (COLD_POOL_BYTES) where x
    exceeds COLD_BYTES: the kernels' device time (2 a call), against
    their bound (one read and one write of x each way); the plain chain's
    (its table built each call, as the port did before the kernel), as
    many kernels a call as one call records; both by CUDA events, and the
    host's time a call for both."""
    import itertools

    import torch
    t0 = time.perf_counter()
    out = {}
    for label, shape, dtype, kind in ROPE_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(SEED + shape[-1])
        mk = lambda: torch.randn(*shape, generator=gen, device="cuda").to(
            getattr(torch, dtype))
        x, do = mk().requires_grad_(), mk()
        pos = (torch.arange(shape[1], device="cuda") if kind == "arange"
               else torch.tensor([4097], device="cuda"))
        nbytes = x.numel() * x.element_size()
        copies = 1 if nbytes <= COLD_BYTES else -(-COLD_POOL_BYTES // nbytes)
        pool = itertools.cycle(
            [(x, do)] + [(x.detach().clone().requires_grad_(), do.clone())
                         for _ in range(copies - 1)])

        def fwd_bwd(rotate, pair=None):
            x_, do_ = next(pool) if pair is None else pair
            o = rotate(x_, pos, 10000.0)
            return o, torch.autograd.grad(o, x_, do_)[0]

        routed = lambda: fwd_bwd(layers.apply_rope)
        plain = lambda: fwd_bwd(rp.apply_rope_plain)
        with launches() as grew:
            got = fwd_bwd(layers.apply_rope, (x, do))
            torch.cuda.synchronize()
        if grew != {"rope": 2}:
            fail(f"16 {label}: {grew} launched for a forward and backward, "
                 f"not 2 rope")
        if not all(bits_equal(a.detach(), b.detach()) for a, b in
                   zip(got, fwd_bwd(rp.apply_rope_plain, (x, do)))):
            fail(f"16 {label}: the kernel's output or gradient differs from "
                 f"the plain chain's")
        held("rope")
        bound_ms, by = bound(2 * 2 * nbytes, 0)
        dev, kernels = counted_device_ms(routed, "rope_rotate", 2)
        plain_dev, plain_kernels = counted_device_ms(plain, None, None)
        row = {"shape": list(shape), "dtype": dtype, "positions": kind,
               "timed_copies": copies, "device_ms": dev,
               "kernels_a_call": kernels, "ms": time_ms(routed),
               "bound_ms": bound_ms, "bound_by": by,
               "share": bound_ms / dev, "plain_device_ms": plain_dev,
               "plain_kernels_a_call": plain_kernels,
               "plain_ms": time_ms(plain), "host_us": host_us(routed),
               "plain_host_us": host_us(plain)}
        where = f"{copies} copies of x and its gradient in turn, from HBM" \
            if copies > 1 else "one x"
        print(f"[16] {label} {tuple(shape)} {dtype}: bits equal the plain "
              f"chain's; device {dev:.5f} ms "
              f"({kernels} kernels a call, all recorded) over {where}, "
              f"events {row['ms']:.4f}, bound {bound_ms:.4f} ({by}), share "
              f"{100 * row['share']:.1f}%; plain device {plain_dev:.4f} ms "
              f"({plain_kernels} kernels), events {row['plain_ms']:.4f}; "
              f"host {row['host_us']:.1f} us a call against "
              f"{row['plain_host_us']:.1f} ({card})")
        out[label] = row
        del x, do, got, pool
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# The kernels line
# ---------------------------------------------------------------------------

#: each hand-written kernel: its source and the TPU kernel it replaces
#: (None: added for the benchmark's trace)
KERNELS = (("fedavg_stream", "fedavg_stream.cu",
            "src/repro/kernels/fedavg_stream.py:47"),
           ("quantize", "quantize.cu", "src/repro/kernels/quantize.py:33"),
           ("dequantize", "quantize.cu", "src/repro/kernels/quantize.py:55"),
           ("topk_sparsify", "topk_sparsify.cu",
            "src/repro/kernels/topk_sparsify.py:44"),
           ("fused_sgd", "fused_sgd.cu", "src/repro/kernels/fused_sgd.py:29"),
           ("rmsnorm", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:25"),
           ("causal_attention", "causal_attention.cu", None),
           ("rope", "rope.cu", None))


def equal_plain(name: str):
    """From this run's comparisons (``HELD``): True where every one held
    the kernel to its plain version bit for bit, False where one held it
    within a tolerance, None where none ran."""
    got = HELD.get(name)
    return None if not got else all(got)


def kernels_line(paths: dict, timed: dict) -> list:
    """One entry a kernel: its launches on each full-width path (each
    counted from 0 where the path starts) and in all, whether this run
    held it to its plain version bit for bit, and its timed row
    (``timed[name]``). Under rmsnorm, its split route's launches: none on
    one card, where no row splits; tools/multi_card.py section 5
    (zamba2-2.7b over (1, 4)) runs it."""
    def by_path(name):
        return {p: n for p, grew in paths.items() if (n := grew.get(name))}
    out = []
    for name, source, replaces in KERNELS:
        counts = by_path(name)
        out.append({"name": name, "route": "cuda",
                    "source": f"src/repro_torch/kernels/csrc/{source}",
                    "replaces": replaces, "launches": sum(counts.values()),
                    "paths": counts, "equal_plain": equal_plain(name),
                    **timed.get(name, {})})
        if name == "rmsnorm":
            split = by_path("rmsnorm_split")
            out[-1]["split"] = {"launches": sum(split.values()),
                                "paths": split,
                                "equal_plain": equal_plain("rmsnorm_split")}
    return out


def main() -> None:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the port's sources are not under {SRC}")
    card = phase_card()
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
    from repro_torch.kernels import causal_attention as ca
    from repro_torch.kernels import rope as rp
    from repro_torch.configs import get_arch
    from repro_torch.launch import federated_lm, serve
    from repro_torch.models import layers
    from repro_torch.models import moe
    from repro_torch.models import ssm
    from repro_torch.models import registry as models
    from repro_torch import smoke
    from repro_torch.config import LambdaLimits
    from repro_torch.core.cost_model import UploadModel
    from repro_torch.serverless.faults import FaultModel
    from repro_torch.serverless.population import ClientPopulation
    from repro_torch.examples import (compression_composition,
                                      elastic_reshard, faulty_round,
                                      million_clients, quickstart,
                                      serve_sharded, train_federated_lm)

    clock = [("start", time.perf_counter())]
    phase_build(build)
    clock.append(("2 build", time.perf_counter()))
    paths = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    grads = [torch.randn(VGG16.params, generator=gen, device="cuda")
             for _ in range(N_CLIENTS)]
    per_topo, walls, rows = phase_rounds(fs, grads, cm, plan_uniform,
                                         FederatedSession)
    paths["vgg16_rounds"] = {"fedavg_stream": sum(per_topo.values())}
    paths["codec_rounds"], codec_per_round, codec_walls = \
        phase_codec_rounds(fs, q, tk, grads, cm, plan_uniform,
                           FederatedSession)
    codec_rows = phase_codec_timings(q, tk, grads, plan_uniform)
    del grads
    clock.append(("3-4 VGG-16 rounds, codecs", time.perf_counter()))

    # f32 products in the model run in full f32 (no TF32), as stated
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lm_cfg = dataclasses.replace(get_arch(LM_ARCH).model, remat=False)
    trained, paths["federated_lm"], lm_means, lm_walls, lm_peak = \
        phase_lm_path(fs, federated_lm, lm_cfg)
    lm_rows = phase_lm_timings(sgd, rn, layers, lm_cfg, trained)
    del trained
    torch.cuda.empty_cache()
    clock.append(("5 federated LM", time.perf_counter()))

    # phase 6: the same VGG-16 gradients, drawn again from the seed
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    grads = [torch.randn(VGG16.params, generator=gen, device="cuda")
             for _ in range(N_CLIENTS)]
    with launches() as paths["faults_and_plugins"]:
        faults_out = phase_faults(fs, smoke, grads, FederatedSession,
                                  UploadModel)
        plugin_walls = phase_plugins(grads, FederatedSession, UploadModel)
    del grads
    torch.cuda.empty_cache()
    pop_out, paths["population"] = phase_population(
        fs, FederatedSession, ClientPopulation, UploadModel, FaultModel,
        LambdaLimits)
    carry_rows = phase_carry_timing(fs, build)
    torch.cuda.empty_cache()
    clock.append(("6-7 faults, plugins, population, carry",
                  time.perf_counter()))

    serve_norms = norm_rows(rn, DECODE_ROWS, "8")
    serve_f32 = phase_serve_f32(models, dataclasses.replace(
        get_arch(LM_ARCH).model, compute_dtype=torch.float32, remat=False))
    torch.cuda.empty_cache()
    serve_out = phase_serve_loop(serve, models, dataclasses.replace(
        get_arch(LM_ARCH).model, remat=False))
    paths["serve"] = serve_out["launches"]
    torch.cuda.empty_cache()
    clock.append(("8 serving", time.perf_counter()))
    family_norms = norm_rows(rn, FAMILY_ROWS, "9")
    families = phase_families(serve, models, moe, get_arch, card)
    paths["families"] = {}
    for row in families.values():
        for k, n in row["launches"].items():
            paths["families"][k] = paths["families"].get(k, 0) + n
    clock.append(("9 families", time.perf_counter()))
    long_ctx = phase_long_context(models, layers, get_arch, card)
    clock.append(("10 long context", time.perf_counter()))
    torch.cuda.empty_cache()
    trainer = phase_trainer(sgd, q, models, get_arch, FederatedSession, card)
    paths["trainer"] = trainer["launches"]
    clock.append(("11 trainer", time.perf_counter()))
    torch.cuda.empty_cache()
    tp = phase_tp(serve, models, rn, get_arch, card)
    paths["tp"] = tp["launches"]
    paths["tp_families"] = tp["family_launches"]
    clock.append(("12 TP", time.perf_counter()))
    torch.cuda.empty_cache()
    ex = phase_examples((quickstart, faulty_round, million_clients,
                         compression_composition, elastic_reshard,
                         serve_sharded, train_federated_lm), models,
                        get_arch, FederatedSession, card)
    paths["examples"] = ex["launches"]
    cnn_out = cnn_rounds(card)
    paths["federated_cnn"] = {}
    for row in cnn_out.values():
        for k, n in row["launches"].items():
            paths["federated_cnn"][k] = paths["federated_cnn"].get(k, 0) + n
    clock.append(("13 examples, federated CNN", time.perf_counter()))
    torch.cuda.empty_cache()
    scan = phase_scan(ssm, models, get_arch, card)
    paths["mamba1_scan"] = scan["launches"]
    clock.append(("14 Mamba-1 scan", time.perf_counter()))
    torch.cuda.empty_cache()
    attn = phase_attention(ca, layers, card)
    clock.append(("15 causal attention", time.perf_counter()))
    torch.cuda.empty_cache()
    rope_out = phase_rope(rp, layers, card)
    clock.append(("16 rope", time.perf_counter()))
    phase_s = {label: t - clock[i][1]
               for i, (label, t) in enumerate(clock[1:])}
    print(f"phase seconds ({card}): " + ", ".join(
        f"{label} {secs:.1f}" for label, secs in phase_s.items())
        + f"; total {clock[-1][1] - clock[0][1]:.1f}")

    print(json.dumps({"waves": rows, "round_walls_s": walls,
                      "launches_per_topology": per_topo,
                      "codec_kernels": codec_rows,
                      "codec_round_walls_s": codec_walls,
                      "codec_launches_per_round": codec_per_round,
                      "lm_kernels": lm_rows, "lm_mean_losses": lm_means,
                      "lm_walls_s": lm_walls, "lm_peak_memory_gb": lm_peak,
                      "faults": faults_out, "plugin_round_walls_s":
                          plugin_walls, "population": pop_out,
                      "carry": carry_rows,
                      "serve": {"rmsnorm_decode_rows": serve_norms,
                                "f32_decode": serve_f32, "loop": serve_out},
                      "families": {"rmsnorm_rows": family_norms,
                                   "models": families},
                      "long_context": long_ctx, "trainer": trainer,
                      "tp": tp, "examples": ex, "federated_cnn": cnn_out,
                      "mamba1_scan": scan,
                      "causal_attention": attn, "rope": rope_out,
                      "phase_seconds": phase_s, "card": card}))
    timed = {"fedavg_stream": {**rows[0], "carry": carry_rows},
             **codec_rows, "fused_sgd": lm_rows["fused_sgd"],
             "rmsnorm": {**lm_rows["rmsnorm"],
                         "rows": {**serve_norms, **family_norms,
                                  **tp["rmsnorm_rows"]},
                         "split_rows": tp["split_rows"]},
             "causal_attention": {**attn["gpt2-large"],
                                  "rows": {k: attn[k] for k, _ in
                                           ATTN_SHAPES}},
             "rope": {**rope_out["gpt2-large"],
                      "rows": {k: rope_out[k] for k, *_ in ROPE_SHAPES}}}
    print(json.dumps({"kernels": kernels_line(paths, timed)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
