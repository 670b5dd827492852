#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card: ``nvidia-smi`` name and power limit; no CUDA device is an error;
2. build the six kernel sources of ``src/repro_torch/kernels/csrc`` with
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
   ``robust``, ``geo_tiered``, ``population``) and the 3 of the host
   fold's worker sweep (``roofline/host_fold``): all 366 of the file's
   keys; the sweep's six inputs also fold on the card, by the table kernel
   (a list) and by the carry route (one 2-D stack), to its pinned hash;
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
   bf16 parameters or gradients, with p, g and v at different offsets
   modulo 16 bytes, and at lengths 1, 3 and 5; the rmsnorm kernel against
   its plain
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
   bounds, plain versions and one PyTorch call each (fused-SGD and
   ``torch.optim.SGD(fused=True)`` also by device time), the host walls of a
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
   lifted timeout), their folds in the kernel's carry route (one launch a
   512-row chunk), each mean bit for bit against the plain chunked fold of
   the same rows on the card; host wall, host RSS peak of the round and
   device peak, which must stay within four chunks and not grow with N;
   then one carry launch at the population's shape, f32 and f64, by
   device time beside its bound, its plain version, ``torch.sum`` over the
   chunk and the same call on the table kernel (its table built once), and
   the wrapper's host time a call;
11. one population round under ``qsgd8`` (N = 64, GradsSharding and
   ``geo_tiered``): the codec kernels run through the population's decode
   and the round equals the eager round over the materialized cohort;
12. serving: (1) the rmsnorm kernel against its plain version (one bf16
   ulp) at every dense arch's decode rows, (4, 2048), (4, 2560), (4, 1280)
   and (4, 5120) bf16 with f32 gamma and qwen3's q-norm rows (256, 128),
   each by device time beside its bound, and the wrapper's host time a
   call at (4, 2048) beside ``F.rms_norm``'s; (2) full-width
   ``tinyllama-1.1b`` at f32 compute and f32 cache: 12 teacher-forced
   decode steps at batch 2 against ``forward`` (rtol = atol = 5e-3), 45
   rmsnorm launches a step; (3) ``serve_loop`` at full width with the
   reference's defaults (batch 4, prompt 8, 16 new tokens, ``max_len``
   64, bf16): 45 rmsnorm launches a step, tokens/s, peak device memory,
   the same tokens from a second loop, the median host wall of a decode
   step, one step under ``torch.profiler`` (device busy, idle share,
   kernels, the rmsnorm kernels' share) and the step's bytes bound; (4)
   the five dense archs at smoke width: decode against ``forward``
   (5e-3; h2o-danube's ring of 8 slots wraps over 14 steps), grouped
   against expanded decode (2e-5), qk-norm's launches. qwen2.5-14b and
   qwen3-32b do not fit this card at full width with f32 parameters (59
   and 131 GB) beside the earlier phases;
13. the other families at full width, one model at a time, each freed
   before the next: ``falcon-mamba-7b`` (Mamba-1, 64 layers),
   ``zamba2-2.7b`` (Mamba-2 with the shared attention block, 54 layers),
   ``whisper-tiny`` (encoder-decoder, its encoder run once over 1,500
   frames at cache build), and at full width cut in depth
   ``phi3.5-moe-42b-a6.6b`` (2 of 32 layers), ``dbrx-132b`` (1 of 40) and
   ``chameleon-34b`` (2 of 48), which do not fit one card at full depth
   with f32 parameters. First the rmsnorm kernel against its plain version
   at these families' decode rows, (4, 384) to (4, 8192) = ``MAX_D`` and
   chameleon's q-norm rows (256, 128), by device time beside its bound.
   Then for each model: 12 f32 decode steps at batch 2 against
   ``forward`` (5e-3; the MoE at capacity_factor 8.0), the rmsnorm
   launches of each step equal to ``norms_per_decode_step(cfg)``; a bf16
   ``serve_loop`` at the reference's defaults (its launches, tokens/s,
   peak device memory); the median host wall of 20 decode steps; one
   warmed-up step under the profiler (kernels, device busy, idle share of
   the profiled step and of the median step) beside the step's bytes
   bound (an MoE layer counts only the experts its tokens chose);
14. long context at full width, f32, batch 1, S = 8,192:
   ``tinyllama-1.1b``'s chunked attention (``attn_chunk`` 2,048) against
   its dense attention, and ``h2o-danube-1.8b``'s 2-D causal tiling
   (window 4,096) against its chunked attention, within 1e-3 on the
   logits; the key blocks skipped, each path's host wall and peak device
   memory;
15. the federated CNN: the reference's e2e test loop
   (``tests/test_fl_e2e.py``: 4 clients, 4 shards, 4 local steps at lr
   0.05, momentum 0.9) on the card, batched engine, from the CPU tests'
   seeded weights: the three topologies' models after 2 rounds agree
   (rtol 1e-4, atol 1e-5) and equal the same rounds on the CPU, 6
   GradsSharding rounds end above 0.5 accuracy, fused-SGD launches once a
   leaf a local step and the fold kernel folds; then one round at the
   default ``CNNConfig()`` width, its client and aggregation walls;
16. the single-program trainer (``repro_torch.launch.train``) at full
   width, ``tinyllama-1.1b`` with f32 parameters, batch 8, sequence 128
   (the reference trainer's defaults), on a one-rank NCCL group and a
   (1, 1) ("data", "model") mesh: the rmsnorm kernel at the trainer's
   rows (1,024 × 2,048 bf16, f32 γ) against its plain version; one step
   of each plan (``none``,
   ``zero1``, ``zero3``) from the same parameters and batch, losses within
   1e-5 and parameters within rtol 5e-4, atol 1e-4 of ``none``, 45 rmsnorm
   launches a step, each plan's step host wall (median of 3), peak device
   memory and profiled device-busy share; zero1's AdamW shard update by
   CUDA events beside its bytes bound (7 f32 of |θ|); the shard_map step at momentum 0
   within rtol 2e-4, atol 2e-5 of a single-device SGD step, and with
   qsgd8, its fused-SGD, quantize and dequantize calls at 1.1 B elements
   each held bit for bit against the plain versions; ``train_loop`` for 4
   steps at full width (finite losses that fall at least once) and the
   reference's restart test at the smoke config (a full-width checkpoint
   is ~13 GB of disk); a VGG-16 GradsSharding round on the ``host_mesh``
   engine (one card: the fold kernel's no-divide form) bit for bit the
   streaming round; ``phi3.5-moe-42b-a6.6b`` at full width, 2 layers, f32,
   its local MoE dispatch under the mesh within 2e-4 of the global one.
   The phase's launch counts are set to 0 at its start and must all grow;
   the forwards the path is compared with do not count;
17. tensor parallelism's serving path on one card: the rmsnorm kernel
   against its plain version (one bf16 ulp) at ``qwen3-32b``'s rows, (4,
   5120) and the q/k-norm rows (256, 128) and (32, 128), a TP = 4 rank's
   blocks (64, 128) and (8, 128), and chameleon's (4, 8192), beside
   ``F.rms_norm``'s device time at (4, 5120) and (4, 8192); then on a
   one-rank NCCL group and a (1, 1) ("data", "model") mesh: full-width
   ``tinyllama-1.1b`` at f32 through ``make_serve_step(mesh, plan=none)``
   bit for bit the mesh-less step over 23 steps (logits and cache), and
   ``qwen3-32b`` at full depth (64 layers, 32.8 B parameters, bf16
   parameters, 65.6 GB) through ``serve_loop(mesh=)`` at the reference's
   defaults: 257 rmsnorm launches a step, tokens/s, the median host wall
   of 20 steps, peak device memory, one profiled step's kernels and busy
   share beside the step's bytes bound. ``tools/multi_card.py`` serves the
   same model split over four cards;
18. tensor parallelism for the SSM, hybrid and encoder-decoder families on
   one card: the rmsnorm kernel's split route (Mamba-2's gated norm over a
   ``d_inner`` cut over the ranks: each block's sum of squares, an
   all-reduce, the scale launch) at zamba2's rank rows, (4, 1280), (4,
   2560) and a training block (1024, 1280), bf16 and f32: a row of 5,120
   in 4 (or 2) blocks, each launch against its plain version, the sums
   added on the card (the ranks' all-reduce) and the joined blocks
   against the whole-row kernel (rmsnorm's tolerance), one block bit for bit the whole-row
   kernel, each launch's device time beside its bytes bound (the training
   block's read from HBM, over copies that outgrow the L2); then on a
   one-rank NCCL group and a (1, 1) ("data", "model") mesh
   ``falcon-mamba-7b``, ``zamba2-2.7b`` and ``whisper-tiny`` as registered
   (full width, full depth, bf16 for serving) through the mesh's
   ``make_serve_step`` bit for bit the mesh-less step over 23 steps
   (logits and cache; at ``model`` = 1 every TP wrapper takes no op),
   ``norms_per_decode_step`` rmsnorm launches a step.
   ``tools/multi_card.py`` runs the three families split over four cards,
   where the gated norm takes the split route;
19. the examples (``repro_torch.examples``) through their ``main`` with
   ``--device cuda``, their self-checks live: ``quickstart`` at the
   reference's constants (20 × 100,000, M = 4, four topologies), plain and
   ``--schedule pipelined --readahead-k 4 --codec qsgd8``; ``faulty_round``
   at its defaults and ``--staleness-policy polynomial --hedge 2``;
   ``compression_composition`` at its defaults: every value these print
   (means, puts, gets, billed GB-s, peak memory, walls, costs, arrivals,
   drops, retries, ``codec_error``) equal to a CPU session's, bit for bit;
   ``million_clients`` at N = 10^3, 10^4, 10^5 (each cell's host seconds,
   host RSS peak and device peak; N = 10^3's walls and costs equal to the
   CPU's); ``compression_composition --size 138357544`` (VGG-16, 8
   clients, 4.4 GB of gradients: identity equal to numpy's left fold bit
   for bit, each codec's wire MB, billed GB-s, ``codec_error``, modeled and
   host wall); ``elastic_reshard``; ``serve_sharded`` for every registered
   arch (``norms_per_decode_step`` rmsnorm launches a step); and
   ``train_federated_lm`` for two rounds of full-width ``tinyllama-1.1b``
   (phase 7's settings and checks). Every kernel's launches are counted
   from 0 over the phase (the kernels line's ``examples``) and must grow;
20. Mamba-1's associative scan (``models.ssm._assoc_scan_chunk``) at
   ``falcon-mamba-7b``'s width (d_model 4,096, d_inner 8,192, d_state 16,
   chunk 256) and train_4k's length: (a) one block, forward and backward,
   at (1, 4,096, 4,096), f32 compute, its output and every gradient
   within 1e-4 of max |want| of an f64 loop over every step on the card;
   host wall, device busy time, kernels and peak device memory of the
   block on the scan and on the per-step loop it replaced (here only);
   the scan's bits on the card equal to the CPU's at C = 7 and 256; (b)
   one ``none`` step of ``jit_train_step`` on a one-rank NCCL group and a
   (1, 1) mesh at batch 1 x 4,096, bf16 compute, cut to 8 of 64 layers
   (at full depth the f32 parameters, gradients and AdamW moments alone
   hold ~116 GB): the rmsnorm kernel at the step's rows against its plain
   version, finite losses, 2 x 8 + 1 rmsnorm launches a step (remat
   recomputes each pre-norm), the step's host wall (median of 3), peak
   device memory, a profiled step's busy share; (c) the full 64-layer
   forward at batch 1 x 4,096 with bf16 weights: host walls, peak device
   memory, 65 rmsnorm launches a forward;
21. the causal attention kernel (``kernels.causal_attention``; every phase
   above that trains or prefills at bf16 with head dim 64 or 128 already
   ran through it, and its launches there are counted) at GPT-2 Large's
   (4, 1,024, 20, 64) and at (2, 1,000, 32 q / 8 kv heads, 128): the
   output and the three gradients no further from an f32 attention than
   ``attention_dense`` at bf16 is (relative norm, 10 % room), two runs
   the same bits, three launches a forward and backward; the device time
   of a forward and backward beside its bound, the plain versions', the
   dense path's and SDPA's (``library_ms``, never called by the port),
   and the peak memory each adds;
22. the RoPE kernel (``kernels.rope``; every phase above rotates q and k
   through it where x is a contiguous CUDA tensor, and its launches there
   are counted per path beside the attention kernel's) at GPT-2 Large's
   (4, 1,024, 20, 64) bf16 and at an f32 decode step (4, 1, 32, 128): the
   output and gradient bit for bit the plain chain's (``apply_rope_plain``
   and autograd through it), two launches a forward and backward; the
   device time, over copies of x and its gradient that outgrow the L2,
   against the bytes bound, from profiles that recorded every kernel (2
   a call; the plain chain's as many as one call records), and the
   plain chain's; the host's time a call for both.

Each phase's seconds are printed before the JSON lines.

The last lines are a JSON object of timings and walls, a JSON ``kernels``
line, and ``{"ok": true, "device": {...}}``.
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
           "rmsnorm", "causal_attention", "rope")
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
    """The same shape, type and bits, any type."""
    import torch
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(ints[a.element_size()]), b.view(ints[b.element_size()]))


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
        # a user annotation (an optimizer's step range) is listed as a
        # device activity spanning its kernels: not a kernel of its own
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)
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
    import torch
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
    print(f"    pinned sharded_tree, fault, robust, geo_tiered and "
          f"population keys on cuda: {len(expected)}/{len(expected)} "
          f"equal expected_smoke.json ({time.perf_counter() - t0:.1f} s)")

    # the host fold's worker sweep, and its inputs folded on the card
    got_roof = smoke.roofline_invariants()
    expected = smoke.expected_invariants(groups=("roofline",))
    bad = smoke.mismatches(got_roof, expected)
    if len(expected) != 3 or set(got_roof) != set(expected) or bad:
        fail(f"{len(bad)} of {len(expected)} pinned roofline/host_fold keys "
             f"differ:\n" + "\n".join(bad))
    xs = [torch.from_numpy(x).cuda() for x in smoke.roofline_inputs()]
    want = expected["roofline/host_fold/avg_hash"]
    for label, node in (("table kernel", (xs, None)),
                        ("carry route", (torch.stack(xs), None))):
        got_hash = smoke.avg_hash(fs.fold_nodes([node])[0])
        if got_hash != want:
            fail(f"the roofline inputs on the card's {label} hash to "
                 f"{got_hash}, pinned {want}")
    total = len(smoke.expected_invariants(groups=smoke.GROUPS))
    n_got = len(got) + len(got_codec) + len(got_new) + len(got_roof)
    if total != 366 or n_got != total:
        fail(f"{n_got} keys checked on the card of {total} pinned")
    print(f"    pinned roofline/host_fold keys: 3/3 (host fold pool of "
          f"{smoke.FOLD_WORKER_GRID} workers); its six inputs on the card "
          f"hash to {want} by the table kernel and the carry route; "
          f"{n_got} keys in all")


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
        # p, g and v 4, 8 and 12 bytes off alignment: no index aligns them
        # all, the whole leaf takes the scalar loop
        check_sgd("mixed offsets", *(rnd(100_004)[k:k + 100_001]
                                     for k in (1, 2, 3)))
        check_sgd("bf16 p 4 bytes in, g and v 8 (a 2-element head)",
                  rnd(100_004).bfloat16()[2:], rnd(100_004)[2:],
                  rnd(100_004)[2:])
        for n in (1, 3, 5):
            check_sgd(f"n = {n}", rnd(n), rnd(n), rnd(n))
            check_sgd(f"n = {n}, 4 bytes in", rnd(n + 1)[1:], rnd(n + 1)[1:],
                      rnd(n + 1)[1:])
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


def phase_lm_path(fs, sgd, rn, ca, federated_lm, cfg):
    """(b) two rounds of federated_lm.run at full width on the card."""
    import torch
    from repro_torch.kernels import rope as rp
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
    # the main path starts here
    fs.LAUNCHES = sgd.LAUNCHES = rn.LAUNCHES = ca.LAUNCHES = rp.LAUNCHES = 0
    out = federated_lm.run(cfg, device="cuda", on_round=on_round, **LM_RUN)
    torch.cuda.synchronize()
    launches = {"fedavg_stream": fs.LAUNCHES, "fused_sgd": sgd.LAUNCHES,
                "rmsnorm": rn.LAUNCHES, "causal_attention": ca.LAUNCHES,
                "rope": rp.LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = LM_RUN["rounds"] * LM_RUN["clients"] * LM_RUN["local_steps"]
    if checked != list(range(LM_RUN["rounds"])):
        fail(f"the fold was checked in rounds {checked}")
    losses, means = check_lm_run(out, launches)
    recs = out["rounds"]
    walls = {"client_s": [w for r in recs for w in r["client_walls_s"]],
             "agg_s": [r["agg_wall_s"] for r in recs]}
    print(f"[7] federated {cfg.name}: {steps} local steps, losses {losses}, "
          f"mean {means}; launches {launches}; each round's mean == plain "
          f"fold; client walls {', '.join(f'{w:.3f}' for w in walls['client_s'])} "
          f"s, aggregation walls {', '.join(f'{w:.3f}' for w in walls['agg_s'])}"
          f" s; peak device memory {peak_gb:.2f} GB (reckoned "
          f"~{RECKONED_PEAK_GB:.0f} GB)")
    return out["params"], launches, means, walls, peak_gb


def check_lm_run(out, launches) -> tuple:
    """What a federated_lm run of ``LM_RUN`` at full width must show: 12
    fused-SGD and 45 rmsnorm launches a local step, a fold a round, finite
    losses whose mean falls below the first round's, finite parameters.
    Returns the client losses and their means a round."""
    import torch
    steps = LM_RUN["rounds"] * LM_RUN["clients"] * LM_RUN["local_steps"]
    expect = {"fused_sgd": 12 * steps, "rmsnorm": NORMS_PER_FORWARD * steps}
    if {k: launches[k] for k in expect} != expect \
            or launches["fedavg_stream"] < LM_RUN["rounds"]:
        fail(f"launches {launches}, expected {expect} and at least one fold "
             f"a round")
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
    step = lambda: [sgd.fused_sgd(a, b, c, lr, mu) for a, b, c in zip(p, g, v)]
    rows["fused_sgd"] = {
        "elements": n, "bytes": nbytes, "ops": ops,
        "ms": time_ms(step),
        "plain_ms": time_ms(lambda: [sgd.fused_sgd_plain(a, b, c, lr, mu)
                                     for a, b, c in zip(p, g, v)]),
        "library_ms": time_ms(opt.step), "library": library,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    # device time a step, in turns (kernel, library, library, kernel): the
    # kernel's 12 launches, and every kernel of the library's step
    turns = {"device": [], "library_device": []}
    for key in ("device", "library_device", "library_device", "device"):
        got = device_ms(step, "fused_sgd") if key == "device" \
            else device_ms(opt.step)
        turns[key].append(got[0] if got else None)
    for key, got in turns.items():
        rows["fused_sgd"][f"{key}_ms"] = None if None in got \
            else statistics.mean(got)
    rows["fused_sgd"]["device_ms_turns"] = turns
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
    row = rows["fused_sgd"]
    if row["device_ms"] is None or row["library_device_ms"] is None:
        print("    fused_sgd device times: the profiler recorded no device "
              "activity; not measured")
    else:
        print(f"    fused_sgd by device time a step, in turns: kernel "
              f"{row['device_ms']:.4f} ms "
              f"({100 * row['bound_ms'] / row['device_ms']:.1f}% of bound), "
              f"{row['library']} {row['library_device_ms']:.4f} ms")
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


def device_busy_ms(kernels) -> float:
    """The union of the kernels' device spans, in ms: the time the device
    was busy (kernels that overlap count once)."""
    return busy_ms_of_spans([(e.time_range.start, e.time_range.end)
                             for e in kernels])


def busy_ms_of_spans(spans) -> float:
    """The union of (start, end) spans in µs, in ms."""
    spans = sorted(spans)
    busy_us, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return (busy_us + cur_e - cur_s) / 1e3


def profiled_step(step):
    """One call of ``step`` under ``torch.profiler`` after a warm-up cycle
    (a step first in the profiler's window loses kernels): its device
    kernels (user annotations left out), the operator table and the
    call's host wall in ms."""
    import torch
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    kept = {}

    def ready(p):
        kept["events"], kept["ops"] = list(p.events()), p.key_averages()
    with torch.profiler.profile(
            activities=acts, on_trace_ready=ready,
            schedule=torch.profiler.schedule(wait=0, warmup=1,
                                             active=1)) as prof:
        step()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    kernels = [e for e in kept.get("events", ())
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    return kernels, kept.get("ops", ()), wall_ms


def kernel_spans(step):
    """One call of ``step`` under ``torch.profiler`` (CUDA activity only)
    after a warm-up cycle: its device kernels' (start, end) spans in µs,
    read from the raw kineto events (user annotations left out; no
    operator tree is built, so a call of ~65,000 kernels is read in
    seconds), and the call's host wall in ms."""
    import torch
    from torch.autograd import DeviceType
    kept = {}

    def ready(p):
        kept["spans"] = [(e.start_ns() / 1e3,
                          (e.start_ns() + e.duration_ns()) / 1e3)
                         for e in p.profiler.kineto_results.events()
                         if e.device_type() == DeviceType.CUDA
                         and not e.is_user_annotation()]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            on_trace_ready=ready,
            schedule=torch.profiler.schedule(wait=0, warmup=1,
                                             active=1)) as prof:
        step()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    return kept.get("spans", []), wall_ms


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
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
    busy_ms = device_busy_ms(kernels)
    top = [[name[:90], ms] for name, ms in by_name.most_common(10)]
    # the port's kernels by their device time alone; the CUDA-event
    # timings of phase 7 (c) also hold the wrapper's host work whenever
    # the device waits for it
    ours = {}
    for tag in ("fused_sgd", "rmsnorm_kernel"):      # both fused_sgd kernels
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


def phase_carry_timing(fs, build, peak):
    """The carry route at the population's shapes: one 512-row chunk of
    4,096-element rows into an f32 accumulator (GradsSharding) and into
    an f64 one (the weighted plans), by device time in turns beside
    ``torch.sum`` over the chunk (the same sum without the carry) and the
    same call on the table kernel (its table built and copied once, as a
    measurement); then its bound, its plain version, events around one
    call and the wrapper's host time a call."""
    import torch
    from repro_torch.serverless import population as popmod
    bw, f32, f64 = peak
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
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
            got = fn()
            ints = torch.int64 if got.dtype == torch.float64 else torch.int32
            if got.dtype != acc.dtype or not torch.equal(
                    got.view(ints), want.view(ints)):
                fail(f"{name} on the {label} != plain")
        calls = {"device": (kernel, "fedavg_carry_kernel"),
                 "library_device": (lambda: torch.sum(rows, dim=0), None),
                 "table_device": (table_route, "fedavg_fold_kernel")}
        turns = {key: [] for key in calls}
        for key in (*calls, *reversed(calls)):
            got = device_ms(*calls[key])
            turns[key].append(got[0] if got else None)
        nbytes = n * L * 4 + 2 * L * acc.element_size()
        ops = n * L
        t_bytes, t_ops = nbytes / bw, ops / (f64 if weighted else f32)
        row = {"rows": n, "elements": L, "bytes": nbytes, "ops": ops,
               "ms": time_ms(kernel), "plain_ms": time_ms(plain),
               "library_ms": time_ms(lambda: torch.sum(rows, dim=0)),
               "host_us": host_us(kernel),
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "device_ms_turns": turns}
        for key, got in turns.items():
            row[f"{key}_ms"] = None if None in got else statistics.mean(got)
        out[name] = row
        dev_ms = {key: "not measured" if row[f"{key}_ms"] is None else
                  f"{row[f'{key}_ms'] * 1e3:.2f} us" for key in turns}
        share = "" if row["device_ms"] is None else \
            f" ({100 * row['bound_ms'] / row['device_ms']:.1f}% of bound)"
        print(f"     {name}: one {n} x {L} chunk by device time, in turns: "
              f"carry route {dev_ms['device']}{share}, torch.sum "
              f"{dev_ms['library_device']}, table kernel "
              f"{dev_ms['table_device']}; bound {row['bound_ms'] * 1e3:.3f} "
              f"us ({row['bound_by']}); events {row['ms']:.4f} ms, host "
              f"{row['host_us']:.1f} us a call, plain {row['plain_ms']:.3f} "
              f"ms")
    return out


# ---------------------------------------------------------------------------
# Phase 12: serving (KV-cache decode)
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


def phase_serve_kernels(rn, peak, decode_rows=DECODE_ROWS, tag="12",
                        library_rows=((4, 2048),)):
    """12 (1): the rmsnorm kernel against its plain version at every dense
    arch's decode rows (bf16 rows, f32 gamma; one bf16 ulp), by device time
    a call beside its bound; at ``library_rows`` also F.rms_norm's time
    and device time, and at (4, 2048) both wrappers' host time a call.
    Phases 13 and 17 run it at other rows."""
    import torch
    bw, f32, _ = peak
    gen = torch.Generator(device="cuda").manual_seed(SEED + int(tag))
    rows, max_err = {}, 0.0
    for label, (r, d) in decode_rows.items():
        x = torch.randn(r, d, generator=gen, device="cuda").bfloat16()
        gamma = torch.randn(d, generator=gen, device="cuda")
        out, rstd = rn.rmsnorm(x, gamma)
        want, want_rstd = rn.rmsnorm_plain(x, gamma)
        torch.cuda.synchronize()
        max_err = max(max_err, float((out.float() - want.float()).abs().max()))
        if out.dtype != x.dtype or out.shape != x.shape \
                or bf16_ulps(out, want) > 1 or not bool(
                    ((rstd - want_rstd).abs() <= 1e-5 * want_rstd.abs()).all()):
            fail(f"rmsnorm != plain beyond one bf16 ulp at the decode rows "
                 f"({r}, {d}) of {label} (max abs err {max_err})")
        nbytes = 2 * r * d * 2 + d * 4 + 4 * r      # x, out, gamma, rstd
        t_bytes, t_ops = nbytes / bw, 4 * r * d / f32
        kernel = lambda: rn.rmsnorm(x, gamma)
        got = device_ms(kernel, "rmsnorm_kernel")
        row = {"shape": [r, d], "bytes": nbytes,
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "device_ms": got[0] if got else None,
               "ms": time_ms(kernel),
               "plain_ms": time_ms(lambda: rn.rmsnorm_plain(x, gamma))}
        if (r, d) in library_rows:
            g16 = gamma.bfloat16()
            library = lambda: torch.nn.functional.rms_norm(x, (d,),
                                                           weight=g16)
            lib = device_ms(library)
            row.update({"library_ms": time_ms(library),
                        "library_device_ms": lib[0] if lib else None})
            if (r, d) == DECODE_ROWS["tinyllama-1.1b"]:
                row.update({"host_us": host_us(kernel),
                            "library_host_us": host_us(library)})
        rows[f"{r}x{d}"] = row
        dev = "not measured" if row["device_ms"] is None else \
            f"{row['device_ms'] * 1e3:.3f} us " \
            f"({100 * row['bound_ms'] / row['device_ms']:.1f}% of bound)"
        lib = "" if row.get("library_device_ms") is None else \
            f"; F.rms_norm device {row['library_device_ms'] * 1e3:.3f} us"
        print(f"[{tag}] rmsnorm at ({r}, {d}) bf16 ({label}): within one "
              f"bf16 ulp of plain; device {dev}, bound "
              f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}){lib}")
    if "4x2048" not in rows:
        return rows, max_err
    row = rows["4x2048"]
    lib_dev = "not measured" if row["library_device_ms"] is None else \
        f"{row['library_device_ms'] * 1e3:.3f} us"
    print(f"     at (4, 2048): host time a call, wrapper {row['host_us']:.2f} "
          f"us, F.rms_norm {row['library_host_us']:.2f} us; F.rms_norm "
          f"device {lib_dev}")
    return rows, max_err


def _decode_against_forward(models, rn, cfg, batch, steps, seed, tol):
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
            before = rn.LAUNCHES
            lg, cache = models.decode_step(params, cfg, toks[:, i:i + 1],
                                           cache)
            per_step.append(rn.LAUNCHES - before)
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


def phase_serve_f32(models, rn, cfg):
    """12 (2): full-width decode at f32 against forward, 45 norms a step."""
    import torch
    if torch.backends.cuda.matmul.allow_tf32:
        fail("f32 matmuls would run in TF32")
    t0 = time.perf_counter()
    params, cache, per_step, err = _decode_against_forward(
        models, rn, cfg, 2, DECODE_CHECK_STEPS, SEED + 13, 5e-3)
    norms = 2 * cfg.n_layers + 1
    if per_step != [norms] * DECODE_CHECK_STEPS or norms != NORMS_PER_FORWARD:
        fail(f"rmsnorm launches a decode step {per_step}, expected "
             f"{NORMS_PER_FORWARD}")
    if int(cache["idx"]) != DECODE_CHECK_STEPS:
        fail(f"the cache's idx is {int(cache['idx'])}")
    print(f"[12] full-width {cfg.name} at f32: {DECODE_CHECK_STEPS} decode "
          f"steps at batch 2 == forward within rtol = atol = 5e-3 (max abs "
          f"err {err:.3g}); {norms} rmsnorm launches a step; "
          f"{time.perf_counter() - t0:.1f} s")
    return {"max_abs_err": err, "rmsnorm_per_step": norms}


def phase_serve_loop(serve, models, rn, ca, cfg, peak):
    """12 (3): serve_loop at full width with the reference's defaults, then
    decode steps timed by the host clock, one step under the profiler, and
    the step's bytes bound."""
    import torch
    from repro_torch.config import ShapeConfig
    from repro_torch.kernels import rope as rp
    from repro_torch.models import transformer
    bw = peak[0]
    params = models.init_params(
        torch.Generator(device="cuda").manual_seed(SEED + 14), cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rn.LAUNCHES = ca.LAUNCHES = rp.LAUNCHES = 0   # the serving path starts
    out = serve.serve_loop(cfg, params=params, seed=0, device="cuda", **SERVE)
    torch.cuda.synchronize()
    launches, attn_launches = rn.LAUNCHES, ca.LAUNCHES
    rope_launches = rp.LAUNCHES
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gen = out["generated"]
    if launches != NORMS_PER_FORWARD * SERVE_STEPS:
        fail(f"serve_loop launched rmsnorm {launches} times, expected "
             f"{NORMS_PER_FORWARD} x {SERVE_STEPS}")
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
        walls = []
        for i in range(3 + SERVE_TIMED_STEPS):
            t0 = time.perf_counter()
            logits, cache = step(sp, tok, cache)
            torch.cuda.synchronize()
            if i >= 3:
                walls.append((time.perf_counter() - t0) * 1e3)
        if not bool(torch.isfinite(logits).all()):
            fail("a decode step's logits are not finite")
        unstack_us = host_us(lambda: transformer._unstack(sp, cfg.n_layers),
                             calls=50)
        kernels, ops, prof_wall_ms = profiled_step(
            lambda: step(sp, tok, cache))
    idx = int(cache["idx"]) - 1          # the slots the profiled step read
    nbytes = _step_bytes(sp, cache, cfg, idx)
    bound_ms = nbytes / bw * 1e3
    step_ms = statistics.median(walls)
    prof_out = None
    if kernels:
        busy = device_busy_ms(kernels)
        norm_ms = sum(e.time_range.elapsed_us() for e in kernels
                      if "rmsnorm_kernel" in e.name) / 1e3
        kernel_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        prof_out = {"step_wall_ms": prof_wall_ms, "device_busy_ms": busy,
                    "idle_share": 1.0 - busy / prof_wall_ms,
                    "kernels": len(kernels), "kernel_sum_ms": kernel_ms,
                    "rmsnorm_launches": sum(1 for e in kernels
                                            if "rmsnorm_kernel" in e.name),
                    "rmsnorm_device_ms": norm_ms,
                    "rmsnorm_share_of_kernel_time": norm_ms / kernel_ms,
                    "bound_share_of_busy": bound_ms / busy,
                    # where the host's time goes: operators by self time
                    "host_top": [[e.key[:60], e.self_cpu_time_total / 1e3,
                                  e.count] for e in sorted(
                        ops, key=lambda e: -e.self_cpu_time_total)[:12]]}
    res = {"generated_shape": list(gen.shape), "tokens_per_s":
           out["tokens_per_s"], "loop_wall_s": out["wall_s"],
           "launches": launches, "attention_launches": attn_launches,
           "rope_launches": rope_launches, "peak_memory_gb": peak_gb,
           "step_walls_ms": walls, "step_median_ms": step_ms,
           "step_bytes": nbytes, "step_bound_ms": bound_ms,
           "unstack_host_us": unstack_us,
           "bound_share_of_step": bound_ms / step_ms, "profile": prof_out}
    print(f"[12] serve_loop {cfg.name} (batch {SERVE['batch']}, prompt "
          f"{SERVE['prompt_len']}, {SERVE['max_new_tokens']} new tokens, "
          f"max_len {SERVE['max_len']}, bf16): {out['tokens_per_s']:.1f} "
          f"tokens/s ({out['wall_s']:.3f} s for {SERVE_STEPS} steps), "
          f"{launches} rmsnorm launches ({NORMS_PER_FORWARD} a step), peak "
          f"device memory {peak_gb:.2f} GB; the same tokens again")
    print(f"     a decode step: median host wall {step_ms:.3f} ms over "
          f"{SERVE_TIMED_STEPS}; bytes bound {bound_ms:.4f} ms ({nbytes} "
          f"bytes), {100 * bound_ms / step_ms:.1f}% of the step; the layer "
          f"views (_unstack) {unstack_us:.1f} us of host time a step")
    if prof_out is None:
        print("     profile: no device activity recorded; not measured")
    else:
        print(f"     one step under the profiler: {prof_wall_ms:.3f} ms host "
              f"wall, device busy {prof_out['device_busy_ms']:.3f} ms "
              f"({100 * prof_out['idle_share']:.1f}% idle), "
              f"{prof_out['kernels']} kernels, rmsnorm "
              f"{prof_out['rmsnorm_launches']} launches "
              f"{prof_out['rmsnorm_device_ms'] * 1e3:.1f} us "
              f"({100 * prof_out['rmsnorm_share_of_kernel_time']:.1f}% of "
              f"kernel time); bound {100 * prof_out['bound_share_of_busy']:.1f}"
              f"% of device busy")
        for name, ms, count in prof_out["host_top"]:
            print(f"       host {ms:8.3f} ms  {count:5d} x {name}")
    return res


def phase_serve_archs(models, rn, get_arch):
    """12 (4): every dense arch at smoke width on the card: decode against
    forward (5e-3, the SWA ring wrapping for h2o-danube), grouped against
    expanded decode (2e-5), qk-norm's launches."""
    import torch
    out = {}
    for arch in ("tinyllama-1.1b", "h2o-danube-1.8b", "gpt2-large",
                 "qwen2.5-14b", "qwen3-32b"):
        cfg = dataclasses.replace(get_arch(arch).smoke,
                                  compute_dtype=torch.float32)
        steps = 14 if cfg.sliding_window else 12
        params, cache, per_step, err = _decode_against_forward(
            models, rn, cfg, 2, steps, SEED + 15, 5e-3)
        norms = 2 * cfg.n_layers + 1 + (2 * cfg.n_layers if cfg.qk_norm
                                        else 0)
        if per_step != [norms] * steps:
            fail(f"{arch}: rmsnorm launches a step {per_step}, expected "
                 f"{norms}")
        width = cfg.sliding_window or steps
        if cache["k"].shape[2] != width:
            fail(f"{arch}: the cache holds {cache['k'].shape[2]} slots, "
                 f"expected {width}")
        row = {"steps": steps, "max_abs_err": err, "norms_per_step": norms}
        if cfg.n_kv_heads < cfg.n_heads:
            grouped = dataclasses.replace(cfg, decode_grouped_attn=True)
            gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
            toks = torch.randint(0, cfg.vocab, (2, 10), generator=gen,
                                 device="cuda")
            c1 = models.init_cache(cfg, 2, 10, torch.float32, "cuda")
            c2 = models.init_cache(grouped, 2, 10, torch.float32, "cuda")
            g_err = 0.0
            with torch.inference_mode():
                for i in range(10):
                    l1, c1 = models.decode_step(params, cfg,
                                                toks[:, i:i + 1], c1)
                    l2, c2 = models.decode_step(params, grouped,
                                                toks[:, i:i + 1], c2)
                    diff = (l1 - l2).abs()
                    g_err = max(g_err, float(diff.max()))
                    if not bool((diff <= 2e-5 + 2e-5 * l1.abs()).all()):
                        fail(f"{arch}: grouped decode != expanded decode "
                             f"beyond 2e-5 (max abs err {g_err})")
            row["grouped_max_abs_err"] = g_err
        out[arch] = row
    print("[12] smoke width on the card, decode == forward within 5e-3 "
          "(max abs err " + ", ".join(f"{a} {r['max_abs_err']:.2g}"
                                      for a, r in out.items())
          + "); grouped == expanded decode within 2e-5 ("
          + ", ".join(f"{a} {r['grouped_max_abs_err']:.2g}"
                      for a, r in out.items() if "grouped_max_abs_err" in r)
          + "); h2o-danube's ring of 8 slots wrapped over 14 steps")
    return out


# ---------------------------------------------------------------------------
# Phase 13: the MoE, VLM, SSM, hybrid and encoder-decoder families
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


def _family_decode_check(models, rn, cfg):
    """13 (1): 12 teacher-forced f32 decode steps at batch 2 against the
    full forward (5e-3; the MoE at capacity_factor 8.0, as the reference's
    test), the rmsnorm launches of each step equal to the config's count.
    Returns the f32 parameters for the serving loop."""
    import torch
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    if cfg.moe is not None:
        f32 = dataclasses.replace(f32, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    params, _, per_step, err = _decode_against_forward(
        models, rn, f32, 2, DECODE_CHECK_STEPS, SEED + 17, 5e-3)
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


def _family_serve(serve, models, moe, rn, ca, cfg, params, peak):
    """13 (2): serve_loop in bf16 at the reference's defaults (its rmsnorm
    launches, tokens/s, peak device memory), then decode steps on the cast
    weights timed by the host clock, and one warmed-up step under the
    profiler beside the step's bytes bound."""
    import torch
    from repro_torch.config import ShapeConfig
    from repro_torch.kernels import rope as rp
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    norms = models.norms_per_decode_step(cfg)
    rn.LAUNCHES = ca.LAUNCHES = rp.LAUNCHES = 0   # the serving path starts
    out = serve.serve_loop(cfg, params=params, seed=0, device="cuda", **SERVE)
    torch.cuda.synchronize()
    launches, attn_launches = rn.LAUNCHES, ca.LAUNCHES
    rope_launches = rp.LAUNCHES
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gen = out["generated"]
    # an encoder-decoder's cache build runs the encoder once: two norms a
    # layer and its final norm
    encoder = 2 * cfg.encoder_layers + 1 if models.is_encdec(cfg) else 0
    if launches != norms * SERVE_STEPS + encoder:
        fail(f"{cfg.name}: serve_loop launched rmsnorm {launches} times, "
             f"expected {norms} x {SERVE_STEPS} + {encoder}")
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
        walls = []
        for i in range(3 + SERVE_TIMED_STEPS):
            t0 = time.perf_counter()
            logits, cache = step(sp, tok, cache)
            torch.cuda.synchronize()
            if i >= 3:
                walls.append((time.perf_counter() - t0) * 1e3)
        if not bool(torch.isfinite(logits).all()):
            fail(f"{cfg.name}: a decode step's logits are not finite")
        moe.route = counted_route
        try:
            kernels, _, prof_wall_ms = profiled_step(
                lambda: step(sp, tok, cache))
        finally:
            moe.route = route
    # the profiled step: the second of the two, the later half of the
    # routing counts, the slots it read
    experts = experts[len(experts) // 2:]
    idx = int(cache["idx"]) - 1
    nbytes = _step_bytes(sp, cache, cfg, idx, experts)
    bound_ms = nbytes / peak[0] * 1e3
    del sp, cache
    prof_out = None
    if kernels:
        busy = device_busy_ms(kernels)
        prof_out = {"step_wall_ms": prof_wall_ms, "device_busy_ms": busy,
                    "idle_share": 1.0 - busy / prof_wall_ms,
                    "kernels": len(kernels),
                    "rmsnorm_launches": sum(1 for e in kernels
                                            if "rmsnorm_kernel" in e.name),
                    "bound_share_of_busy": bound_ms / busy}
    step_ms = statistics.median(walls)
    if prof_out is not None:
        # the profiler slows the host: the busy time against the median
        # unprofiled step as well
        prof_out["idle_share_of_median_step"] = \
            max(0.0, 1.0 - prof_out["device_busy_ms"] / step_ms)
    return {"tokens_per_s": out["tokens_per_s"], "loop_wall_s": out["wall_s"],
            "launches": launches, "attention_launches": attn_launches,
            "rope_launches": rope_launches, "rmsnorm_per_step": norms,
            "peak_memory_gb": peak_gb, "step_walls_ms": walls,
            "step_median_ms": step_ms, "step_bytes": nbytes,
            "step_bound_ms": bound_ms, "experts_per_moe_layer": experts,
            "bound_share_of_step": bound_ms / step_ms, "profile": prof_out}


def phase_families(serve, models, moe, rn, ca, get_arch, peak, card):
    """13: each family at full width (the MoE and VLM archs cut in depth),
    one model at a time, freed before the next."""
    import torch
    out = {}
    for arch, layers in FAMILY_RUNS:
        t0 = time.perf_counter()
        cfg = _family_cfg(get_arch, arch, layers)
        params, err, norms = _family_decode_check(models, rn, cfg)
        torch.cuda.empty_cache()
        row = _family_serve(serve, models, moe, rn, ca, cfg, params,
                            peak)
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
        prof_txt = "profile: no device activity recorded; not measured" \
            if prof is None else (
                f"one profiled step {prof['step_wall_ms']:.3f} ms host wall, "
                f"{prof['kernels']} kernels, device busy "
                f"{prof['device_busy_ms']:.3f} ms "
                f"({100 * prof['idle_share']:.1f}% idle; "
                f"{100 * prof['idle_share_of_median_step']:.1f}% of the "
                f"median step), bound "
                f"{100 * prof['bound_share_of_busy']:.1f}% of busy")
        print(f"[13] {arch} ({row['params']:,} parameters{cut}; {card}): "
              f"f32 decode == forward within 5e-3 (max abs err {err:.3g}); "
              f"{norms} rmsnorm launches a step; bf16 serve_loop "
              f"{row['tokens_per_s']:.1f} tokens/s, median step "
              f"{row['step_median_ms']:.3f} ms, peak device memory "
              f"{row['peak_memory_gb']:.2f} GB; step bytes bound "
              f"{row['step_bound_ms']:.4f} ms ({row['step_bytes']} bytes); "
              f"{prof_txt}; {row['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 14: long context at full width
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
    """14: tinyllama-1.1b's chunked attention against its dense attention,
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
        print(f"[14] {arch} at S = {LONG_SEQ}, f32, batch 1 ({card}): "
              f"{name} == {ref_name} within 1e-3 (max abs err "
              f"{row['max_abs_err']:.3g}); host wall {ref_name} "
              f"{ref_wall:.3f} s, {name} {wall:.3f} s; peak device memory "
              f"{ref_name} {ref_peak:.2f} GB, {name} {peak_gb:.2f} GB"
              f"{skip_txt}; {row['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 15: the federated CNN
# ---------------------------------------------------------------------------

CNN_RUN = dict(clients=4, shards=4, local_steps=4, lr=0.05, momentum=0.9,
               batch=32)


def _cnn_rounds(cnn, agg, fedavg, flatten, unflatten, LambdaRuntime,
                ObjectStore, cfg, data, topology: str, rounds: int,
                device: str = "cuda"):
    """The reference's e2e loop (``tests/test_fl_e2e.py``) on ``device``,
    batched engine, from the CPU generator's seeded weights (the CPU
    tests' start): parameters, test accuracies, client and aggregation
    walls."""
    import torch
    params = {k: v.to(device) for k, v in cnn.init_params(
        torch.Generator().manual_seed(0), cfg).items()}
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    store, rt = ObjectStore(), LambdaRuntime()
    loss = lambda p, b: cnn.loss_fn(p, cfg, b)
    accs, client_walls, agg_walls = [], [], []
    for rnd in range(rounds):
        flats, spec = [], None
        for c in range(CNN_RUN["clients"]):
            t0 = time.perf_counter()
            local = {k: v.clone() for k, v in params.items()}
            vel = None
            for step in range(CNN_RUN["local_steps"]):
                batch = data.batch(c, rnd * 10 + step, CNN_RUN["batch"],
                                   device=device)
                local, vel, _ = fedavg.local_sgd_update(
                    loss, local, batch, lr=CNN_RUN["lr"],
                    momentum=CNN_RUN["momentum"], velocity=vel)
            flat, spec = flatten(fedavg.model_delta(params, local))
            flats.append(flat)
            sync()
            client_walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        r = agg.aggregate_round(topology, flats, rnd=rnd, store=store,
                                runtime=rt, n_shards=CNN_RUN["shards"],
                                codec="identity", engine="batched")
        sync()
        agg_walls.append(time.perf_counter() - t0)
        params = fedavg.apply_delta(params, unflatten(r.avg_flat, spec))
        with torch.no_grad():
            _, m = cnn.loss_fn(params, cfg, data.batch(99, 999, 128,
                                                       device=device))
        accs.append(float(m["acc"]))
    return params, accs, client_walls, agg_walls


def phase_federated_cnn(fs, sgd, card):
    """15: the reference's federated CNN test loop on the card: the three
    topologies' models after 2 rounds agree (1e-4 / 1e-5), 6 GradsSharding
    rounds end above 0.5 accuracy, fused-SGD launches once a leaf a local
    step and the fold kernel folds; then one round at the default
    ``CNNConfig()`` width."""
    import torch
    from repro_torch.core import aggregation as agg
    from repro_torch.core import fedavg
    from repro_torch.core.sharding import flatten, unflatten
    from repro_torch.data import SyntheticVision
    from repro_torch.models import cnn
    from repro_torch.serverless import LambdaRuntime
    from repro_torch.store import ObjectStore
    t0 = time.perf_counter()
    cfg = cnn.CNNConfig(n_classes=4, channels=(8, 16), blocks_per_stage=1,
                        img_size=8)
    data = SyntheticVision(n_classes=4, img_size=8, seed=0, noise=0.4)
    run = lambda c, d, topo, n, device="cuda": _cnn_rounds(
        cnn, agg, fedavg, flatten, unflatten, LambdaRuntime, ObjectStore, c,
        d, topo, n, device)
    leaves = len(cnn.param_shapes(cfg))
    # cuDNN's deterministic algorithms: the three topologies' runs train
    # the same client deltas, so only the aggregation can differ
    torch.backends.cudnn.deterministic = True
    sgd.LAUNCHES = fs.LAUNCHES = 0       # the federated CNN path starts here
    finals = {topo: flatten(run(cfg, data, topo, 2)[0])[0]
              for topo in TOPOLOGIES}
    _, accs, client_walls, agg_walls = run(cfg, data, "gradssharding", 6)
    torch.cuda.synchronize()
    sgd_launches, fold_launches = sgd.LAUNCHES, fs.LAUNCHES
    want_sgd = leaves * CNN_RUN["local_steps"] * CNN_RUN["clients"] * (
        2 * len(TOPOLOGIES) + 6)
    if sgd_launches != want_sgd:
        fail(f"fused_sgd launched {sgd_launches} times on the CNN path, "
             f"expected {want_sgd} (one a leaf a local step)")
    if fold_launches == 0:
        fail("the CNN rounds never launched the fold kernel")
    head = finals["gradssharding"]
    agree = {}
    for topo in TOPOLOGIES[1:]:
        diff = (finals[topo] - head).abs()
        agree[topo] = float(diff.max())
        if not bool((diff <= 1e-5 + 1e-4 * head.abs()).all()):
            fail(f"the CNN after 2 {topo} rounds != gradssharding beyond "
                 f"rtol 1e-4, atol 1e-5 (max abs err {agree[topo]})")
    if not accs[-1] > 0.5 or accs[-1] < accs[0] - 0.05:
        fail(f"6 GradsSharding CNN rounds did not learn: accuracies {accs}")
    # the same 2 GradsSharding rounds on the CPU (where the tests hold the
    # port against the reference)
    on_cpu = flatten(run(cfg, data, "gradssharding", 2, "cpu")[0])[0]
    cpu_err = float((head.cpu() - on_cpu).abs().max())
    if not bool(((head.cpu() - on_cpu).abs()
                 <= 1e-5 + 1e-4 * on_cpu.abs()).all()):
        fail(f"the CNN after 2 GradsSharding rounds on the card != on the "
             f"CPU beyond rtol 1e-4, atol 1e-5 (max abs err {cpu_err})")
    # one round at the default width (16/32/64 channels, 32x32 images)
    wide = cnn.CNNConfig()
    wide_data = SyntheticVision(n_classes=wide.n_classes, img_size=32,
                                seed=0, noise=0.4)
    _, wide_accs, wide_client, wide_agg = run(wide, wide_data,
                                              "gradssharding", 1)
    out = {"fused_sgd_launches": sgd_launches,
           "fold_launches": fold_launches, "leaves": leaves,
           "max_abs_diff_vs_gradssharding": agree,
           "max_abs_diff_card_vs_cpu": cpu_err, "accuracies": accs,
           "client_walls_s": client_walls, "agg_walls_s": agg_walls,
           "default_width": {"params": sum(math.prod(s) for s in
                                           cnn.param_shapes(wide).values()),
                             "accuracy": wide_accs[0],
                             "client_walls_s": wide_client,
                             "agg_wall_s": wide_agg[0]},
           "seconds": time.perf_counter() - t0}
    print(f"[15] federated CNN on the card ({card}): lambda_fl and lifl == "
          f"gradssharding after 2 rounds within rtol 1e-4, atol 1e-5 (max "
          f"abs diff {', '.join(f'{k} {v:.3g}' for k, v in agree.items())}"
          f"), and == the same rounds on the CPU (max abs diff "
          f"{cpu_err:.3g}); 6 GradsSharding rounds, accuracy "
          f"{' '.join(f'{a:.3f}' for a in accs)}; fused_sgd {sgd_launches} "
          f"launches ({leaves} leaves x {CNN_RUN['local_steps']} steps x "
          f"{CNN_RUN['clients']} clients x 12 rounds), fold {fold_launches} "
          f"launches; median client wall "
          f"{statistics.median(client_walls) * 1e3:.1f} ms, median "
          f"aggregation wall {statistics.median(agg_walls) * 1e3:.1f} ms")
    print(f"     default CNNConfig() ({out['default_width']['params']:,} "
          f"parameters): one round, median client wall "
          f"{statistics.median(wide_client) * 1e3:.1f} ms, aggregation "
          f"wall {wide_agg[0] * 1e3:.1f} ms; {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 16: the single-program trainer, the host_mesh engine, MoE local
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


@contextlib.contextmanager
def uncounted(*modules):
    """Launches inside are a comparison's, not the path's: each module's
    ``LAUNCHES`` is put back as it was."""
    before = [m.LAUNCHES for m in modules]
    try:
        yield
    finally:
        for m, n in zip(modules, before):
            m.LAUNCHES = n


class HeldAgainstPlain:
    """Wraps the kernel wrappers that the shard_map step calls, for one
    step: each call goes to the kernel as before (its launch is the main
    path's), and what the plain version needs to redo it is kept: clones
    of the in-place fused-SGD's p and v, references to every other input
    and output. ``check()`` runs the plain versions after the step, when
    its memory is free, and holds the kernels' results bit for bit."""

    def __init__(self, sgd, q, where: str = "16"):
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
            del p0, v0
        for x, codes, scales in self.calls.pop("quantize"):
            pc, ps = self.q.quantize_plain(x)
            if not (torch.equal(pc, codes) and bits_equal(ps, scales)):
                fail(f"{self.where}: quantize at {x.numel():,} elements != "
                     f"its plain version")
            errs["quantize"] = 0.0
            del pc, ps
        for codes, scales, start, stop, out in self.calls.pop("dequantize"):
            plain = self.q.dequantize_plain(codes, scales, start, stop)
            if not bits_equal(plain, out):
                fail(f"{self.where}: dequantize at {out.numel():,} elements "
                     f"!= its plain version")
            errs["dequantize"] = 0.0
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
              where: str = "16", with_mu: bool = False):
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
                        where: str = "16") -> float:
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


def host_mesh_vs_streaming(fs, FederatedSession, grads, host_mesh: int,
                           device: str, rounds: int = 1,
                           warm_up: bool = False, where: str = "16"):
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
            before = fs.LAUNCHES
            t0 = time.perf_counter()
            res[engine] = session.round(grads)
            if device == "cuda":
                for i in range(torch.cuda.device_count()):
                    torch.cuda.synchronize(i)
            walls.append((time.perf_counter() - t0) * 1e3)
        out[f"{engine}_wall_ms"] = walls
        out[f"{engine}_fold_launches"] = fs.LAUNCHES - before
    if not bits_equal(res["host_mesh"].avg_flat, res["streaming"].avg_flat):
        fail(f"{where}: the host_mesh round != the streaming round")
    return out


def check_trainer_norm(rn, layers, cfg, params, batch, gamma_key="layers.ln1",
                       where: str = "16") -> float:
    """The rmsnorm kernel at the trainer's rows (layer 0's first norm input,
    batch × seq rows in the compute dtype, γ as stored) against its plain
    version: within one bf16 ulp (f32: rtol 1e-5, atol 1e-6), rstd within
    1e-5; its max abs err. ``gamma_key`` names the stacked γ of that norm,
    ``where`` the phase."""
    import torch
    x = layers.embed_tokens(params["embed"], batch["tokens"],
                            cfg.compute_dtype).reshape(-1, cfg.d_model)
    gamma = params[gamma_key][0]
    out, rstd = rn.rmsnorm(x, gamma, cfg.norm_eps)
    want, want_rstd = rn.rmsnorm_plain(x, gamma, cfg.norm_eps)
    torch.cuda.synchronize()
    label = f"{tuple(x.shape)} {x.dtype}, gamma {gamma.dtype}"
    if out.dtype != x.dtype or out.shape != x.shape or not bool(
            torch.isfinite(want).all() and torch.isfinite(out).all()):
        fail(f"{where}: rmsnorm at the trainer's rows {label}: a non-finite "
             f"value or {out.dtype} {tuple(out.shape)}")
    diff = (out.float() - want.float()).abs()
    if x.dtype == torch.float32:
        ok = bool((diff <= 1e-6 + 1e-5 * want.float().abs()).all())
    else:
        ok = bf16_ulps(out, want) <= 1
    ok = ok and bool(((rstd - want_rstd).abs()
                      <= 1e-5 * want_rstd.abs()).all())
    err = float(diff.max())
    if not ok:
        fail(f"{where}: rmsnorm at the trainer's rows {label} != plain beyond "
             f"the tolerance (max abs err {err})")
    print(f"[{where}] rmsnorm at the trainer's rows {label}: == plain within "
          f"the tolerance (max abs err {err:.3g})")
    return err


def _plan_steps(T, mesh, cfg, params, batch, rn, card):
    """16 (a): one step of each plan from the same parameters and batch,
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
        norms = rn.LAUNCHES
        step, p_in, state, row, flat = plan_step(T, mesh, cfg, shape, opt,
                                                 gs, params, batch, base)
        norms = rn.LAUNCHES - norms
        if norms != NORMS_PER_FORWARD:
            fail(f"16: a {gs} step launched rmsnorm {norms} times, "
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
        kernels, _, wall_ms = profiled_step(lambda: step(p_in, state, batch))
        if kernels:
            busy = device_busy_ms(kernels)
            row.update({"profiled_wall_ms": wall_ms, "device_busy_ms": busy,
                        "busy_share": busy / wall_ms,
                        "kernels": len(kernels)})
        else:
            row["busy_share"] = None
        del p_in, state
        torch.cuda.empty_cache()
        rows[gs] = row
        busy_txt = "profile: no device activity; not measured" \
            if row["busy_share"] is None else (
                f"profiled step {row['profiled_wall_ms']:.1f} ms, device "
                f"busy {row['device_busy_ms']:.1f} ms "
                f"({100 * row['busy_share']:.1f}%)")
        print(f"[16] {gs}: loss {loss:.6f}, grad norm {row['grad_norm']:.4f}"
              f", step host wall {row['step_wall_ms']:.1f} ms (median of "
              f"{PLAN_TIMED_STEPS}), peak device "
              f"memory {row['peak_memory_gb']:.2f} GB, {busy_txt} ({card})")
    del base
    return rows


def _adamw_shard_update(T, mesh, cfg, params, peak, card):
    """16 (b): zero1's AdamW update of the shard alone (M = 1: all |θ|),
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
    bound = nbytes / peak[0] * 1e3
    elems = p.numel()
    del p, state
    torch.cuda.empty_cache()
    print(f"[16] zero1 AdamW shard update over {g.numel():,} elements: "
          f"{ms:.3f} ms (CUDA events, median of {REPS}); bytes bound "
          f"{bound:.3f} ms ({nbytes:,} bytes at {peak[0] / 1e12:.2f} TB/s), "
          f"{100 * bound / ms:.1f}% of it ({card})")
    del g
    return {"ms": ms, "bound_ms": bound, "bytes": nbytes, "elems": elems}


def _shardmap_steps(T, mesh, cfg, params, batch, sgd, q, rn, ca, card):
    """16 (c): the shard_map step at momentum 0 against a plain
    single-device SGD step (rtol 2e-4, atol 2e-5), then its qsgd8 variant;
    every kernel call of both held bit for bit against its plain version
    at |θ| elements."""
    import torch
    from repro_torch.kernels import rope as rp
    out = {}
    step, init_v = T.make_shardmap_train_step(cfg, mesh, lr=SHARDMAP_LR,
                                              momentum=0.0)
    before = (sgd.LAUNCHES, rn.LAUNCHES)
    with HeldAgainstPlain(sgd, q) as held:
        t0 = time.perf_counter()
        new, v, loss = step(params, init_v(params), batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    launches = (sgd.LAUNCHES - before[0], rn.LAUNCHES - before[1])
    new_flat = flat_params(new)
    del new, v
    errs = held.check()
    if launches != (1, NORMS_PER_FORWARD) or "fused_sgd" not in errs:
        fail(f"16: the shard_map step launched fused_sgd and rmsnorm "
             f"{launches} times, expected (1, {NORMS_PER_FORWARD})")
    with uncounted(rn, ca, rp):     # the reference step's forward
        err = held_to_single_step(T, cfg, params, batch, new_flat, loss,
                                  SHARDMAP_LR)
    del new_flat
    torch.cuda.empty_cache()
    out["sgd"] = {"loss": float(loss), "max_abs_err_vs_single": err,
                  "step_wall_ms": wall, "fused_sgd_launches": launches[0],
                  "rmsnorm_launches": launches[1]}
    print(f"[16] shard_map step (momentum 0, lr {SHARDMAP_LR}): == a "
          f"single-device SGD step within rtol 2e-4, atol 2e-5 (max abs err "
          f"{err:.3g}); fused_sgd 1 launch over {T.flat_spec(cfg).total:,} "
          f"elements == fused_sgd_plain bit for bit; {launches[1]} rmsnorm "
          f"launches; step host wall {wall:.1f} ms (with the kept clones; "
          f"{card})")

    step, init_v = T.make_shardmap_train_step(cfg, mesh, lr=0.05,
                                              momentum=0.9, compress="qsgd8")
    before = (q.QUANTIZE_LAUNCHES, q.DEQUANTIZE_LAUNCHES, sgd.LAUNCHES)
    with HeldAgainstPlain(sgd, q) as held:
        new, v, loss = step(params, init_v(params), batch)
        torch.cuda.synchronize()
    launches = (q.QUANTIZE_LAUNCHES - before[0],
                q.DEQUANTIZE_LAUNCHES - before[1], sgd.LAUNCHES - before[2])
    finite = bool(torch.isfinite(flat_params(new)).all()) and math.isfinite(
        float(loss))
    del new, v
    errs.update(held.check())
    if launches != (1, 1, 1) or set(errs) != {"fused_sgd", "quantize",
                                              "dequantize"} or not finite:
        fail(f"16: the qsgd8 step launched quantize, dequantize, fused_sgd "
             f"{launches} times (expected once each) or was not finite")
    out["qsgd8"] = {"loss": float(loss), "launches": launches,
                    "max_abs_err": errs}
    print(f"[16] shard_map step with qsgd8: quantize, dequantize and "
          f"fused_sgd once each over {T.flat_spec(cfg).total:,} elements, "
          f"each == its plain version bit for bit; loss {float(loss):.6f}")
    return out, errs


def _train_loop_runs(T, get_arch, cfg, mesh, card):
    """16 (d): train_loop at full width (4 steps, zero1, no checkpoint:
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
        fail(f"16: train_loop losses {losses} are not finite or never fall")
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
        fail(f"16: the restarted train_loop {b} != the uninterrupted "
             f"{a} beyond rtol 1e-4, atol 1e-5")
    print(f"[16] train_loop at full width, {TRAIN_LOOP_STEPS} steps (zero1, "
          f"batch {TRAIN['batch']}, seq {TRAIN['seq']}): losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}, {wall:.1f} s with "
          f"parameter init; restart at the smoke config == uninterrupted "
          f"(max abs err {restart_err:.3g}; {card})")
    return {"losses": losses, "wall_s": wall,
            "restart_max_abs_err": restart_err}


def _host_mesh_round(fs, FederatedSession, card):
    """16 (e): a GradsSharding VGG-16 round on the host_mesh engine (one
    card: the fold kernel's no-divide form over each shard, then one
    divide), bit for bit the streaming engine's."""
    import torch
    from repro_torch.configs.paper_workloads import VGG16
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    grads = [torch.randn(VGG16.params, generator=gen, device="cuda")
             for _ in range(N_CLIENTS)]
    out = host_mesh_vs_streaming(fs, FederatedSession, grads, 1, "cuda")
    del grads
    launches = out["host_mesh_fold_launches"]
    walls = {e: out[f"{e}_wall_ms"][0] / 1e3
             for e in ("streaming", "host_mesh")}
    if launches != N_SHARDS:
        fail(f"16: the host_mesh round launched the fold {launches} times, "
             f"expected {N_SHARDS} (one a shard node)")
    print(f"[16] host_mesh VGG-16 GradsSharding round (N = {N_CLIENTS}, "
          f"M = {N_SHARDS}, 1 card): == streaming bit for bit; fold "
          f"{launches} launches; round host wall "
          f"{walls['host_mesh'] * 1e3:.1f} ms vs streaming "
          f"{walls['streaming'] * 1e3:.1f} ms ({card})")
    torch.cuda.empty_cache()
    return {"fold_launches": launches,
            "round_wall_s": walls["host_mesh"],
            "streaming_round_wall_s": walls["streaming"]}


def _moe_local(models, meshctx, rn, ca, get_arch, mesh, card):
    """16 (f): phi3.5-moe at full width, 2 layers, f32: the local
    dispatch under the mesh within 2e-4 of the global dispatch."""
    import torch
    from repro_torch.kernels import rope as rp
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
        with uncounted(rn, ca, rp):  # the comparison's forward
            glob = models.forward(params, cfg, {"tokens": toks})
        with meshctx.use_mesh(mesh):
            loc = models.forward(params, dataclasses.replace(
                cfg, moe_dispatch="local"), {"tokens": toks})
    err = float((loc - glob).abs().max())
    ok = bool(((loc - glob).abs() <= 2e-4 + 2e-4 * glob.abs()).all())
    del params, glob, loc
    torch.cuda.empty_cache()
    if not ok:
        fail(f"16: the local MoE dispatch != the global one beyond 2e-4 "
             f"(max abs err {err})")
    print(f"[16] {MOE_ARCH} ({MOE_LAYERS} layers, full width, f32): local "
          f"dispatch under the (1, 1) mesh == global within 2e-4 (max abs "
          f"err {err:.3g}; {card})")
    return {"max_abs_err": err}


def phase_trainer(fs, sgd, q, rn, ca, models, get_arch, FederatedSession,
                  peak, card):
    """16: the single-program trainer at full width on a one-rank NCCL
    group, the host_mesh engine and the MoE local dispatch. Every launch
    count of the phase is read at its end. The forwards that the path is
    compared with (a single-device step's, the global MoE dispatch's) are
    left out of the counts, as is the rmsnorm check at the trainer's rows
    made before the counts start."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import rope as rp
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers, meshctx
    t0 = time.perf_counter()
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        fail(f"16: expected a one-rank NCCL group, got "
             f"{dist.get_backend()} x {dist.get_world_size()}")
    cfg = dataclasses.replace(get_arch(LM_ARCH).model, remat=False)
    params = models.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab, (TRAIN["batch"], TRAIN["seq"] + 1),
                         device="cuda", generator=torch.Generator(
                             device="cuda").manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    norm_err = check_trainer_norm(rn, layers, cfg, params, batch)
    fs.LAUNCHES = sgd.LAUNCHES = rn.LAUNCHES = ca.LAUNCHES = 0  # main path
    rp.LAUNCHES = 0
    q.QUANTIZE_LAUNCHES = q.DEQUANTIZE_LAUNCHES = 0
    out = {"plans": _plan_steps(T, mesh, cfg, params, batch, rn, card)}
    out["adamw_shard"] = _adamw_shard_update(T, mesh, cfg, params, peak,
                                             card)
    out["shardmap"], errs = _shardmap_steps(T, mesh, cfg, params, batch, sgd,
                                            q, rn, ca, card)
    del params, batch, toks
    torch.cuda.empty_cache()
    out["train_loop"] = _train_loop_runs(T, get_arch, cfg, mesh, card)
    out["host_mesh"] = _host_mesh_round(fs, FederatedSession, card)
    out["moe_local"] = _moe_local(models, meshctx, rn, ca, get_arch, mesh,
                                  card)
    torch.cuda.synchronize()
    launches = {"rmsnorm": rn.LAUNCHES, "fused_sgd": sgd.LAUNCHES,
                "quantize": q.QUANTIZE_LAUNCHES,
                "dequantize": q.DEQUANTIZE_LAUNCHES, "fold": fs.LAUNCHES}
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"16: the trainer path never launched {missing}")
    launches["causal_attention"] = ca.LAUNCHES
    launches["rope"] = rp.LAUNCHES
    dist.destroy_process_group()
    out.update({"launches": launches, "max_abs_err": errs,
                "rmsnorm_max_abs_err": norm_err,
                "params": models.param_count(cfg),
                "seconds": time.perf_counter() - t0})
    print(f"[16] launches on the phase's path: "
          + ", ".join(f"{k} {n}" for k, n in launches.items())
          + f"; {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# 17: tensor parallelism's serving path on one card
# ---------------------------------------------------------------------------

TP_ARCH = "qwen3-32b"
TP_NORMS_PER_STEP = 257          # 64 layers x (ln1, ln2, q-norm, k-norm) + 1
# qwen3-32b's norm rows at batch 4: the residual, q- and k-norm over all
# heads, and one rank's heads at TP = 4; chameleon's (4, 8192) beside it
# for F.rms_norm's device time, which phase 13 did not take
TP_ROWS = {"qwen3-32b": (4, 5120), "chameleon-34b": (4, 8192),
           "qwen3-32b q-norm": (256, 128), "qwen3-32b k-norm": (32, 128),
           "qwen3-32b q-norm, one of 4 ranks": (64, 128),
           "qwen3-32b k-norm, one of 4 ranks": (8, 128)}
TP_LIBRARY_ROWS = ((4, 5120), (4, 8192))


def tp_serve_cfg(get_arch):
    """qwen3-32b as registered, served at bf16 parameters (the reference's
    serving configuration: ``dryrun._build_target`` sets ``param_dtype``
    to bf16)."""
    import torch
    return dataclasses.replace(get_arch(TP_ARCH).model,
                               param_dtype=torch.bfloat16, remat=False)


def _tp_model1_bits(serve, models, rn, ca, get_arch, mesh, card):
    """17 (a): full-width tinyllama at f32 (f32 cache) through
    make_serve_step on the (1, 1) mesh under the none plan, bit for bit the
    mesh-less step over the serving run's 23 steps, logits and cache."""
    import torch
    from repro_torch.config import ShapeConfig, ShardingPlan
    from repro_torch.kernels import rope as rp
    cfg = dataclasses.replace(get_arch(LM_ARCH).model,
                              compute_dtype=torch.float32, remat=False)
    b, max_len = SERVE["batch"], SERVE["max_len"]
    shape = ShapeConfig("serve", seq_len=max_len, global_batch=b,
                        kind="decode")
    params = models.init_params(
        torch.Generator(device="cuda").manual_seed(SEED + 17), cfg)
    like = models.cache_specs(cfg, b, max_len, torch.float32)
    on_mesh = serve.make_serve_step(cfg, shape, mesh, like,
                                    ShardingPlan(grad_sharding="none"))
    alone = serve.make_serve_step(cfg, shape, cache_like=like)
    toks = torch.randint(0, cfg.vocab, (b, SERVE_STEPS), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(SEED + 18))
    caches = [models.init_cache(cfg, b, max_len, torch.float32, "cuda")
              for _ in range(2)]
    per_step = []
    for i in range(SERVE_STEPS):
        before = rn.LAUNCHES
        got, caches[0] = on_mesh(params, toks[:, i:i + 1], caches[0])
        per_step.append(rn.LAUNCHES - before)
        with uncounted(rn, ca, rp):          # the comparison's step
            want, caches[1] = alone(params, toks[:, i:i + 1], caches[1])
        if not bits_equal(got, want):
            fail(f"17: step {i} on the (1, 1) mesh != the mesh-less step "
                 f"(max abs err {float((got - want).abs().max())})")
    if not all(bits_equal(caches[0][k], caches[1][k]) for k in ("k", "v")) \
            or int(caches[0]["idx"]) != SERVE_STEPS:
        fail("17: the (1, 1) mesh's cache != the mesh-less step's")
    if per_step != [NORMS_PER_FORWARD] * SERVE_STEPS:
        fail(f"17: rmsnorm launches a step on the (1, 1) mesh {per_step}")
    del params, caches
    torch.cuda.empty_cache()
    print(f"[17] full-width {LM_ARCH} at f32 through make_serve_step on the "
          f"(1, 1) mesh, none plan: {SERVE_STEPS} steps == the mesh-less "
          f"step bit for bit (logits and cache); {NORMS_PER_FORWARD} rmsnorm "
          f"launches a step ({card})")
    return {"steps": SERVE_STEPS, "max_abs_err": 0.0,
            "rmsnorm_per_step": NORMS_PER_FORWARD}


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


def _tp_qwen3(serve, models, rn, get_arch, mesh, peak, card):
    """17 (b): qwen3-32b at full depth, bf16 parameters, served on the
    (1, 1) mesh: serve_loop at the reference's defaults (257 rmsnorm
    launches a step), then timed steps, one profiled step and the step's
    bytes bound."""
    import torch
    from repro_torch.config import ShapeConfig
    cfg = tp_serve_cfg(get_arch)
    b, max_len = SERVE["batch"], SERVE["max_len"]
    if models.norms_per_decode_step(cfg) != TP_NORMS_PER_STEP:
        fail(f"17: {TP_ARCH} counts {models.norms_per_decode_step(cfg)} "
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
    before = rn.LAUNCHES
    out = serve.serve_loop(cfg, params=params, seed=0, device="cuda",
                           mesh=mesh, **SERVE)
    launches = rn.LAUNCHES - before
    gen = out["generated"]
    if launches != TP_NORMS_PER_STEP * SERVE_STEPS:
        fail(f"17: serve_loop launched rmsnorm {launches} times, expected "
             f"{TP_NORMS_PER_STEP} x {SERVE_STEPS}")
    if gen.shape != (b, SERVE["max_new_tokens"]) or str(gen.dtype) != \
            "int32" or not ((gen >= 0) & (gen < cfg.vocab)).all():
        fail(f"17: serve_loop generated {gen.dtype} {gen.shape}")
    shape = ShapeConfig("serve", seq_len=max_len, global_batch=b,
                        kind="decode")
    with torch.inference_mode():
        first = tp_first_logits(serve, models, cfg, params, mesh)
        if first.shape != (b, 1, cfg.vocab) or not bool(
                torch.isfinite(first).all()):
            fail(f"17: the first step's logits {tuple(first.shape)} are not "
                 f"finite (B, 1, V)")
        step = serve.make_serve_step(cfg, shape, mesh,
                                     models.cache_specs(cfg, b, max_len))
        cache = models.init_cache(cfg, b, max_len, device="cuda")
        tok = torch.from_numpy(gen[:, :1].copy()).to("cuda")
        walls, per_step = [], []
        for i in range(3 + SERVE_TIMED_STEPS):
            before = rn.LAUNCHES
            t1 = time.perf_counter()
            logits, cache = step(params, tok, cache)
            torch.cuda.synchronize()
            per_step.append(rn.LAUNCHES - before)
            if i >= 3:
                walls.append((time.perf_counter() - t1) * 1e3)
        if set(per_step) != {TP_NORMS_PER_STEP} or not bool(
                torch.isfinite(logits).all()):
            fail(f"17: rmsnorm launches a step {sorted(set(per_step))}, or "
                 f"non-finite logits")
        kernels, _, prof_wall_ms = profiled_step(
            lambda: step(params, tok, cache))
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    idx = int(cache["idx"]) - 1
    step_bytes = _step_bytes(params, cache, cfg, idx)
    bound_ms = step_bytes / peak[0] * 1e3
    step_ms = statistics.median(walls)
    prof = None
    if kernels:
        busy = device_busy_ms(kernels)
        prof = {"step_wall_ms": prof_wall_ms, "device_busy_ms": busy,
                "idle_share": 1.0 - busy / prof_wall_ms,
                "kernels": len(kernels),
                "rmsnorm_launches": sum(1 for e in kernels
                                        if "rmsnorm_kernel" in e.name),
                "bound_share_of_busy": bound_ms / busy}
    res = {"params": n, "param_bytes": nbytes, "init_s": init_s,
           "tokens_per_s": out["tokens_per_s"], "loop_wall_s": out["wall_s"],
           "launches": launches, "rmsnorm_per_step": TP_NORMS_PER_STEP,
           "step_walls_ms": walls, "step_median_ms": step_ms,
           "step_bytes": step_bytes, "step_bound_ms": bound_ms,
           "peak_memory_gb": peak_gb, "profile": prof,
           "first_logits_max_abs": float(first.float().abs().max()),
           "first_logits_sum": float(first.float().sum())}
    del params, cache, first, logits
    torch.cuda.empty_cache()
    print(f"[17] {TP_ARCH} at full depth ({n:,} parameters, "
          f"{nbytes / 1e9:.2f} GB of bf16, drawn in {init_s:.1f} s) through "
          f"serve_loop on the (1, 1) mesh (batch {b}, prompt "
          f"{SERVE['prompt_len']}, {SERVE['max_new_tokens']} new tokens): "
          f"{out['tokens_per_s']:.1f} tokens/s, {TP_NORMS_PER_STEP} rmsnorm "
          f"launches a step, peak device memory {peak_gb:.2f} GB ({card})")
    prof_txt = "no device activity recorded; not measured" if prof is None \
        else (f"{prof['kernels']} kernels, device busy "
              f"{prof['device_busy_ms']:.3f} ms of {prof_wall_ms:.3f} "
              f"({100 * prof['idle_share']:.1f}% idle)")
    print(f"     a decode step: median host wall {step_ms:.3f} ms over "
          f"{SERVE_TIMED_STEPS}; bytes bound {bound_ms:.3f} ms "
          f"({step_bytes} bytes); one profiled step: {prof_txt}")
    return res


def phase_tp(serve, models, rn, ca, get_arch, peak, card):
    """17: the tensor-parallel serving path on one card: rmsnorm at
    qwen3-32b's rows (a TP = 4 rank's q/k-norm blocks included) against its
    plain version; then, on a one-rank NCCL group and a (1, 1) ("data",
    "model") mesh, tinyllama through the mesh's make_serve_step bit for
    bit the mesh-less step, and qwen3-32b at full depth in bf16. The
    rmsnorm count is set to 0 after the row checks and read at the end;
    the mesh-less steps compared with do not count."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import rope as rp
    from repro_torch.launch.mesh import make_mesh
    t0 = time.perf_counter()
    rows, norm_err = phase_serve_kernels(rn, peak, TP_ROWS, tag="17",
                                         library_rows=TP_LIBRARY_ROWS)
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    rn.LAUNCHES = ca.LAUNCHES = rp.LAUNCHES = 0  # the phase's main path
    out = {"rmsnorm_rows": rows,
           "model1": _tp_model1_bits(serve, models, rn, ca, get_arch, mesh,
                                     card),
           "qwen3": _tp_qwen3(serve, models, rn, get_arch, mesh, peak, card)}
    launches = rn.LAUNCHES
    if launches == 0:
        fail("17: the TP serving path never launched rmsnorm")
    dist.destroy_process_group()
    out.update({"launches": {"rmsnorm": launches,
                             "causal_attention": ca.LAUNCHES,
                             "rope": rp.LAUNCHES},
                "rmsnorm_max_abs_err": norm_err,
                "seconds": time.perf_counter() - t0})
    print(f"[17] launches on the phase's path: rmsnorm {launches}; "
          f"{out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 18: tensor parallelism for the SSM, hybrid and encoder-decoder
# families (the rmsnorm kernel's split route, the (1, 1) mesh's bits)
# ---------------------------------------------------------------------------

TP_FAMILY_ARCHS = ("falcon-mamba-7b", "zamba2-2.7b", "whisper-tiny")
# zamba2's gated-norm rows a rank holds (d_inner 5,120): serving's batch 4
# over 4 and 2 ranks, the trainer's 8 x 128 rows over 4; (rows, block
# width, blocks)
# A block of more than COLD_BYTES is timed over distinct copies that
# together hold at least COLD_POOL_BYTES (twice the H100's 50 MB L2), one
# copy a call in turn, so that each call reads its block from HBM
COLD_BYTES, COLD_POOL_BYTES = 1 << 20, 100 << 20
SPLIT_ROWS = {"decode, one of 4 ranks": (4, 1280, 4),
              "decode, one of 2 ranks": (4, 2560, 2),
              "training, one of 4 ranks": (1024, 1280, 4)}


def _split_close(label, got, want, dtype) -> float:
    """Max abs err of the split route's output against ``want``; fails
    beyond the rmsnorm tolerance (f32: rtol 1e-5, atol 1e-6; bf16: one
    ulp)."""
    import torch
    err = float((got.float() - want.float()).abs().max())
    ok = bf16_ulps(got, want) <= 1 if dtype == torch.bfloat16 else bool(
        ((got - want).abs() <= 1e-6 + 1e-5 * want.abs()).all())
    if not ok:
        fail(f"18: the rmsnorm split route {label} beyond the rmsnorm "
             f"tolerance (max abs err {err})")
    return err


def phase_split_norm(rn, peak):
    """18 (a): the rmsnorm kernel's split route at zamba2's rank rows, bf16
    and f32 (f32 gamma): a row of 5,120 cut into 4 (or 2) blocks, each
    block's sum of squares by the first launch against its plain version
    (rtol 1e-5), the sums added on the device (the all-reduce of the
    ranks), each block's scale
    launch against its plain version on the same sum and the joined blocks
    against the whole-row kernel on the whole row (both at the rmsnorm
    tolerance), one block with its own sum bit for bit the whole-row
    kernel; each launch's device time beside its bytes bound, the training
    block's over copies that outgrow the L2 (COLD_POOL_BYTES). The
    comparisons' whole-row launches do not count."""
    import itertools

    import torch
    bw, f32, _ = peak
    gen = torch.Generator(device="cuda").manual_seed(SEED + 180)
    rows, max_err = {}, 0.0
    for label, (r, d, blocks) in SPLIT_ROWS.items():
        for dtype in (torch.bfloat16, torch.float32):
            width = blocks * d
            x = (torch.randn(r, width, generator=gen, device="cuda")
                 * 3).to(dtype)
            gamma = torch.randn(width, generator=gen, device="cuda")
            cuts = [slice(i * d, (i + 1) * d) for i in range(blocks)]
            ssq = [rn.rmsnorm_sumsq(x[:, c]) for c in cuts]
            for c, got in zip(cuts, ssq):
                want = rn.rmsnorm_sumsq_plain(x[:, c])
                if not bool(((got - want).abs() <= 1e-5 * want.abs()).all()):
                    fail(f"18: rmsnorm_sumsq at ({r}, {d}) {dtype} != its "
                         f"plain version beyond rtol 1e-5")
            total = ssq[0]
            for more in ssq[1:]:         # the all-reduce of the ranks
                total = total + more
            outs = [rn.rmsnorm_scale(x[:, c], total, gamma[c], 1e-5, width)
                    for c in cuts]
            tag = f"at ({r}, {d}) of {width} {dtype}"
            for c, (out, rstd) in zip(cuts, outs):
                want, want_rstd = rn.rmsnorm_scale_plain(
                    x[:, c], total, gamma[c], 1e-5, width)
                max_err = max(max_err, _split_close(
                    f"{tag} against its plain version", out, want, dtype))
                if not bool(((rstd - want_rstd).abs()
                             <= 1e-5 * want_rstd.abs()).all()):
                    fail(f"18: rmsnorm_scale's rstd {tag} != plain")
            with uncounted(rn):
                whole, whole_rstd = rn.rmsnorm(x, gamma)
                one, _ = rn.rmsnorm(x[:, cuts[0]], gamma[cuts[0]])
            joined = torch.cat([o for o, _ in outs], dim=1)
            max_err = max(max_err, _split_close(
                f"{tag} against the whole-row kernel", joined, whole, dtype))
            alone, _ = rn.rmsnorm_scale(x[:, cuts[0]],
                                        rn.rmsnorm_sumsq(x[:, cuts[0]]),
                                        gamma[cuts[0]], 1e-5, d)
            if not bits_equal(alone, one):
                fail(f"18: one block's split route {tag} != the whole-row "
                     f"kernel on it bit for bit")
            xs = x.element_size()
            sum_bytes, scale_bytes = r * d * xs + 4 * r, \
                2 * r * d * xs + 4 * d + 8 * r
            t_sum, t_scale = sum_bytes / bw, scale_bytes / bw
            o_sum, o_scale = 2 * r * d / f32, 3 * r * d / f32
            # a rank's block is its own contiguous (rows, d); one copy a
            # call in turn where a block outgrows COLD_BYTES
            copies = 1 if r * d * xs <= COLD_BYTES else \
                -(-COLD_POOL_BYTES // (r * d * xs))
            pool = itertools.cycle([x[:, cuts[0]].contiguous()
                                    for _ in range(copies)])
            g_blk = gamma[cuts[0]]
            dev_sum = device_ms(lambda: rn.rmsnorm_sumsq(next(pool)),
                                "rmsnorm_sumsq_kernel")
            dev_scale = device_ms(
                lambda: rn.rmsnorm_scale(next(pool), total, g_blk, 1e-5,
                                         width), "rmsnorm_scale_kernel")

            def pair():
                blk = next(pool)
                return rn.rmsnorm_scale(blk, rn.rmsnorm_sumsq(blk), g_blk,
                                        1e-5, width)

            def plain():
                blk = next(pool)
                return rn.rmsnorm_scale_plain(
                    blk, rn.rmsnorm_sumsq_plain(blk), g_blk, 1e-5, width)
            bound = (max(t_sum, o_sum) + max(t_scale, o_scale)) * 1e3
            row = {"shape": [r, d], "d_total": width, "dtype": str(dtype),
                   "timed_copies": copies,
                   "bytes": sum_bytes + scale_bytes, "bound_ms": bound,
                   "bound_by": "bytes" if t_sum >= o_sum and t_scale
                   >= o_scale else "operations",
                   "sumsq_device_ms": dev_sum[0] if dev_sum else None,
                   "scale_device_ms": dev_scale[0] if dev_scale else None,
                   "ms": time_ms(pair), "plain_ms": time_ms(plain),
                   "library_ms": None}
            row["device_ms"] = None if not (dev_sum and dev_scale) else \
                dev_sum[0] + dev_scale[0]
            rows[f"{r}x{d} {str(dtype)[6:]}"] = row
            dev = "not measured" if row["device_ms"] is None else \
                (f"{row['sumsq_device_ms'] * 1e3:.3f} + "
                 f"{row['scale_device_ms'] * 1e3:.3f} us "
                 f"({100 * bound / row['device_ms']:.1f}% of bound)")
            where = f"{copies} copies of the block in turn, from HBM" \
                if copies > 1 else "one block"
            print(f"[18] rmsnorm split route {tag} ({label}): {blocks} "
                  f"blocks == "
                  f"plain and == the whole-row kernel within the rmsnorm "
                  f"tolerance, one block == it bit for bit; device {dev} "
                  f"over {where}, bound {bound * 1e3:.3f} us "
                  f"({row['bound_by']})")
    return rows, max_err


def _family_model1_bits(serve, models, rn, ca, get_arch, mesh, arch,
                         card):
    """18 (b): ``arch`` as registered (full width, full depth), its
    weights cast for serving (bf16), through make_serve_step on the (1, 1)
    mesh under the none plan, bit for bit the mesh-less step over the
    serving run's 23 steps (logits and the whole cache, the encoder's
    cross-attention K/V built under the mesh included); the rmsnorm
    launches of each step equal to ``norms_per_decode_step``."""
    import torch
    from repro_torch.config import ShapeConfig, ShardingPlan
    from repro_torch.kernels import rope as rp
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
    with torch.inference_mode():
        want_cache, frames = _family_cache(models, cfg, params, b, max_len,
                                           torch.bfloat16, SEED + 181)
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
        before = rn.LAUNCHES
        got, got_cache = on_mesh(params, toks[:, i:i + 1], got_cache)
        per_step.append(rn.LAUNCHES - before)
        with uncounted(rn, ca, rp):          # the comparison's step
            want, want_cache = alone(params, toks[:, i:i + 1], want_cache)
        if not bits_equal(got, want):
            fail(f"18: {arch} step {i} on the (1, 1) mesh != the mesh-less "
                 f"step (max abs err {float((got - want).abs().max())})")
    flat = lambda c: [t for _, t in sorted(_leaves(c))]
    if not all(bits_equal(a, w) for a, w in zip(flat(got_cache),
                                                flat(want_cache))) \
            or int(got_cache["idx"]) != SERVE_STEPS:
        fail(f"18: {arch}'s cache on the (1, 1) mesh != the mesh-less "
             f"step's")
    if per_step != [norms] * SERVE_STEPS:
        fail(f"18: {arch}'s rmsnorm launches a step on the (1, 1) mesh "
             f"{per_step}, expected {norms}")
    n = models.param_count(cfg)
    del params, got_cache, want_cache, got, want
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"[18] {arch} as registered ({n:,} parameters, bf16 for serving) "
          f"through make_serve_step on the (1, 1) mesh, none plan: "
          f"{SERVE_STEPS} steps == the mesh-less step bit for bit (logits "
          f"and cache); {norms} rmsnorm launches a step; {secs:.1f} s "
          f"({card})")
    return {"params": n, "steps": SERVE_STEPS, "max_abs_err": 0.0,
            "rmsnorm_per_step": norms, "seconds": secs}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


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


def phase_tp_families(serve, models, rn, ca, get_arch, peak, card):
    """18: the rmsnorm kernel's split route (Mamba-2's gated norm under
    tensor parallelism) against its plain version and the whole-row kernel;
    then, on a one-rank NCCL group and a (1, 1) ("data", "model") mesh, the
    three families as registered through the mesh's make_serve_step bit
    for bit the mesh-less step. The rmsnorm counts are set to 0 before
    the families' run and read after it; the comparisons' launches do not
    count. tools/multi_card.py runs the families split over four cards."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import rope as rp
    from repro_torch.launch.mesh import make_mesh
    t0 = time.perf_counter()
    rn.SPLIT_LAUNCHES = 0
    split_rows, split_err = phase_split_norm(rn, peak)
    split_launches = rn.SPLIT_LAUNCHES
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    rn.LAUNCHES, rn.SPLIT_LAUNCHES, ca.LAUNCHES = 0, 0, 0  # the main path
    rp.LAUNCHES = 0
    models_out = {arch: _family_model1_bits(serve, models, rn, ca, get_arch,
                                            mesh, arch, card)
                  for arch in TP_FAMILY_ARCHS}
    launches = rn.LAUNCHES
    if launches == 0:
        fail("18: the families' path never launched rmsnorm")
    if rn.SPLIT_LAUNCHES:
        fail(f"18: the (1, 1) mesh took the split route "
             f"{rn.SPLIT_LAUNCHES} times (model = 1 splits nothing)")
    dist.destroy_process_group()
    out = {"split_rows": split_rows, "split_max_abs_err": split_err,
           "split_launches_checked": split_launches,
           "split_launches": rn.SPLIT_LAUNCHES, "models": models_out,
           "launches": {"rmsnorm": launches,
                        "causal_attention": ca.LAUNCHES,
                        "rope": rp.LAUNCHES},
           "seconds": time.perf_counter() - t0}
    print(f"[18] launches on the phase's path: rmsnorm {launches}, its "
          f"split route {rn.SPLIT_LAUNCHES}; the split route's checks apart "
          f"{split_launches}; {out['seconds']:.1f} s")
    return out


def _split_line(tpf) -> dict:
    """The split route's entry under rmsnorm in the kernels line: its two
    launchers; ``launches`` from the main path's run, 0 here (at model = 1
    no row is split; the path that runs it is tensor parallelism over
    several cards, whose count tools/multi_card.py section 5 prints); the
    comparisons' launches apart under ``check_launches``; the largest
    error against the plain version and the whole-row kernel, and each
    row's times beside its bound (the decode block of 4 ranks first,
    bf16)."""
    rows = tpf["split_rows"]
    head = rows["4x1280 bfloat16"]
    return {"route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "entry_points": ["rmsnorm_sumsq_launch", "rmsnorm_scale_launch"],
            "replaces": "src/repro/kernels/rmsnorm.py:25",
            "launches": tpf["split_launches"],
            "check_launches": tpf["split_launches_checked"],
            "main_path_launches_at": "tools/multi_card.py section 5 "
                                     "(zamba2-2.7b over (1, 4))",
            "max_abs_err": tpf["split_max_abs_err"],
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "device_ms": head["device_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None,
            "rows": {k: {key: r[key] for key in
                         ("device_ms", "sumsq_device_ms", "scale_device_ms",
                          "ms", "plain_ms", "bound_ms", "bound_by",
                          "timed_copies")}
                     for k, r in rows.items()}}


# ---------------------------------------------------------------------------
# Phase 19: the examples, through their own entry points
# ---------------------------------------------------------------------------

EX_QUICKSTART_FAST = ["--schedule", "pipelined", "--readahead-k", "4",
                      "--codec", "qsgd8"]
EX_FAULTY_ROBUST = ["--staleness-policy", "polynomial", "--hedge", "2"]
EX_VGG16_SIZE = "138357544"      # VGG-16's parameters: 553 MB a client
EX_SERVE_STEPS = 8 + 24 - 1      # serve_sharded's prompt_len + new_tokens - 1
EX_KERNELS = ("fedavg_stream", "quantize", "dequantize", "topk_sparsify",
              "fused_sgd", "rmsnorm")


def same_output(label, got, want, path="") -> None:
    """Two examples' returned dicts alike in every key: arrays of the same
    dtype, shape and bits, numbers exactly."""
    import numpy as np
    where = f"{label}{path}"
    if isinstance(want, dict):
        if set(got) != set(want):
            fail(f"{where}: keys {sorted(got)} != {sorted(want)}")
        for k in want:
            same_output(label, got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        if got.dtype != want.dtype or got.shape != want.shape \
                or got.tobytes() != want.tobytes():
            fail(f"{where}: the arrays differ (card against the CPU)")
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            fail(f"{where}: {len(got)} items != {len(want)}")
        for i, (a, b) in enumerate(zip(got, want)):
            same_output(label, a, b, f"{path}[{i}]")
    elif got != want and not (isinstance(want, float) and math.isnan(want)
                              and math.isnan(got)):
        fail(f"{where}: {got!r} != {want!r}")


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


def kernel_counts(fs, q, tk, sgd, rn, ca) -> dict:
    from repro_torch.kernels import rope as rp
    return {"fedavg_stream": fs.LAUNCHES, **codec_launches(q, tk),
            "fused_sgd": sgd.LAUNCHES, "rmsnorm": rn.LAUNCHES,
            "causal_attention": ca.LAUNCHES, "rope": rp.LAUNCHES}


def phase_examples(examples, fs, q, tk, sgd, rn, ca, models, get_arch,
                   FederatedSession, card):
    """The reference's seven examples through the port's entry points on
    the card, their self-checks live: quickstart (plain and pipelined
    qsgd8), faulty_round (plain and stale/hedged) and
    compression_composition at its defaults equal to a CPU session's in
    every printed value, bit for bit; million_clients at N = 10^3, 10^4,
    10^5 (N = 10^3 equal to the CPU's); compression_composition at VGG-16
    width, identity equal to numpy's left fold; elastic_reshard;
    serve_sharded for every registered arch (the rmsnorm launches of each
    step equal to ``norms_per_decode_step``); train_federated_lm for 2
    rounds of full-width tinyllama-1.1b. Every kernel's launches are
    counted from 0 over the phase and each must grow."""
    import numpy as np
    import torch
    from repro_torch.configs import arch_ids
    from repro_torch.kernels import rope as rp
    (quickstart, faulty_round, million_clients, compression_composition,
     elastic_reshard, serve_sharded, train_federated_lm) = examples
    out, per_example = {}, {}
    fs.LAUNCHES = sgd.LAUNCHES = rn.LAUNCHES = tk.LAUNCHES = ca.LAUNCHES = 0
    rp.LAUNCHES = 0
    q.QUANTIZE_LAUNCHES = q.DEQUANTIZE_LAUNCHES = 0   # the path starts here

    def run(label, fn):
        before = kernel_counts(fs, q, tk, sgd, rn, ca)
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        after = kernel_counts(fs, q, tk, sgd, rn, ca)
        per_example[label] = {k: after[k] - before[k] for k in after
                              if after[k] != before[k]}
        per_example[label]["seconds"] = time.perf_counter() - t0
        return got

    for label, module, extra in (
            ("quickstart", quickstart, []),
            ("quickstart qsgd8", quickstart, EX_QUICKSTART_FAST),
            ("faulty_round", faulty_round, []),
            ("faulty_round stale+hedge", faulty_round, EX_FAULTY_ROBUST),
            ("compression_composition", compression_composition, [])):
        got = run(label, lambda: module.main(extra + ["--device", "cuda"]))
        same_output(label, got, module.main(extra + ["--device", "cpu"]))
        print(f"[19] {label}: the card's printed values == the CPU's, "
              f"bit for bit; launches {per_example[label]}")
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
        same_output(f"million_clients N={small} {topology}",
                    (a["wall_clock_s"], a["cost"]),
                    (b["wall_clock_s"], b["cost"]))
    if per_example["million_clients"].get("fedavg_stream", 0) == 0:
        fail("million_clients launched no fold")
    out["million_clients"] = {
        f"{n}/{t}": {"host_s": c["host_s"], "host_rss_peak_mb": peak[n, t][0],
                     "host_rss_rise_mb": peak[n, t][1],
                     "device_peak_mb": peak[n, t][2],
                     "modeled_wall_s": c["wall_clock_s"], "cost": c["cost"]}
        for (n, t), c in mc["cells"].items()}
    for key, c in out["million_clients"].items():
        print(f"     million_clients {key}: host {c['host_s']:.3f} s, host "
              f"RSS peak {c['host_rss_peak_mb']:.0f} MB (+"
              f"{c['host_rss_rise_mb']:.0f}), device peak "
              f"{c['device_peak_mb']:.2f} MB")
    print(f"     million_clients N={small}: walls and costs == the CPU's")

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
        print(f"     VGG-16 {codec}: wire {row['wire_mb']:.2f} MB, billed "
              f"{row['billed_gb_s']:.3f} GB-s, codec_error "
              f"{row['codec_error']:.3e}, modeled wall "
              f"{row['modeled_wall_s']:.3f} s, host wall "
              f"{row['host_wall_s']:.3f} s")
    print("     VGG-16 identity == numpy's left fold, bit for bit")
    torch.cuda.empty_cache()

    er = run("elastic_reshard",
             lambda: elastic_reshard.main(["--device", "cuda"]))
    print(f"[19] elastic_reshard: restored bit for bit, shards "
          f"{er['resumed_shard_sizes']}")

    out["serve_sharded"] = {}
    for arch in arch_ids():
        cfg = get_arch(arch).smoke
        got = run(f"serve_sharded {arch}", lambda: serve_sharded.main(
            ["--arch", arch, "--device", "cuda"]))
        launches = per_example[f"serve_sharded {arch}"].get("rmsnorm", 0)
        encoder = 2 * cfg.encoder_layers + 1 if models.is_encdec(cfg) else 0
        norms = models.norms_per_decode_step(cfg)
        if launches != norms * EX_SERVE_STEPS + encoder \
                or got["generated"].shape != (4, 24):
            fail(f"serve_sharded {arch}: {launches} rmsnorm launches "
                 f"(expected {norms} x {EX_SERVE_STEPS} + {encoder}), "
                 f"generated {got['generated'].shape}")
        out["serve_sharded"][arch] = {
            "tokens_per_s": got["tokens_per_s"],
            "generated": list(got["generated"].shape),
            "rmsnorm_per_step": norms}
        print(f"     serve_sharded {arch}: {got['tokens_per_s']:.1f} tok/s, "
              f"generated {got['generated'].shape}, {norms} rmsnorm "
              f"launches a step")
    torch.cuda.empty_cache()

    lm_args = [f"--{k}={v}" for k, v in LM_RUN.items()]
    lm = run("train_federated_lm",
             lambda: train_federated_lm.main(lm_args + ["--device", "cuda"]))
    losses, means = check_lm_run(lm, {
        k: per_example["train_federated_lm"].get(k, 0) for k in EX_KERNELS})
    del lm
    torch.cuda.empty_cache()
    print(f"[19] train_federated_lm {LM_ARCH}: losses {losses}, mean "
          f"{means}; launches {per_example['train_federated_lm']}")

    launches = kernel_counts(fs, q, tk, sgd, rn, ca)
    if any(launches[k] == 0 for k in EX_KERNELS):
        fail(f"a kernel was not launched on the examples' path: {launches}")
    out.update(launches=launches, per_example=per_example, card=card)
    print(f"[19] examples: launches {launches}")
    return out


# ---------------------------------------------------------------------------
# Phase 20: Mamba-1's associative scan at training length
# ---------------------------------------------------------------------------

SCAN_ARCH = "falcon-mamba-7b"
SCAN_SEQ = 4096                  # train_4k's sequence length
# 20 (b) cuts the depth: at 64 layers the f32 parameters, gradients and
# AdamW's two moments alone hold ~116 GB
SCAN_TRAIN_LAYERS = 8
SCAN_TIMED_STEPS = 3
# 20 (a): the f32 block against the f64 loop, max |got - want| within
# these shares of max |want| (f32 rounding through products of 4,096 and
# 8,192 terms, `exp` and 256-step scans; every weight's gradient sums over
# 4,096 tokens)
SCAN_OUT_TOL, SCAN_GRAD_TOL = 1e-4, 1e-4
# the card's _assoc_scan_chunk against the CPU's, bit for bit: (B, C, di,
# ds) at a 7-token prompt's chunk and the registered chunk
SCAN_BITS_SHAPES = ((1, 7, 64, 16), (1, 256, 64, 16))


def loop_mamba1_ssm(dt, bmat, cmat, xc, a, h0, chunk: int):
    """Mamba-1's chunked recurrence as a loop over each chunk's steps, with
    ``ssm.mamba1_ssm``'s signature: the form the associative scan
    replaced, kept here only as 20 (a)'s reading before it."""
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
    """20 (a)'s reference: the Mamba-1 block in f64 from the same weights,
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
    memory; then one call under the profiler after a warm-up cycle:
    device busy time and kernels."""
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
    kernels, prof_wall_ms = kernel_spans(fn)
    busy = busy_ms_of_spans(kernels) if kernels else None
    return {"host_wall_ms": wall_ms, "peak_memory_gb": peak / 1e9,
            "peak_above_held_gb": (peak - held) / 1e9,
            "device_busy_ms": busy, "kernels": len(kernels),
            "profiled_wall_ms": prof_wall_ms}


def _scan_bits(ssm) -> list:
    """The card's ``_assoc_scan_chunk`` against the CPU's on the same
    inputs, bit for bit (``*`` and ``+`` are separate kernels on both)."""
    import torch
    gen = torch.Generator().manual_seed(SEED + 20)
    shapes = []
    for shape in SCAN_BITS_SHAPES:
        da = torch.exp(-0.2 * torch.rand(shape, generator=gen))
        db = torch.randn(shape, generator=gen)
        h0 = torch.randn(shape[:1] + shape[2:], generator=gen)
        want = ssm._assoc_scan_chunk(da, db, h0)
        got = ssm._assoc_scan_chunk(da.cuda(), db.cuda(), h0.cuda())
        if not all(bits_equal(g.cpu(), w) for g, w in zip(got, want)):
            fail(f"20: _assoc_scan_chunk at {shape} on the card != the "
                 f"CPU's bits")
        shapes.append(list(shape))
    return shapes


def _scan_block(ssm, get_arch, card) -> dict:
    """20 (a): one falcon-mamba-7b block, forward and backward, at (1,
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
    print(f"[20] falcon-mamba-7b block at (1, {SCAN_SEQ}, {cfg.d_model}), "
          f"f32, against the f64 step loop: max |err| / max |want| "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    bad = {k: v for k, v in errs.items()
           if not v <= (SCAN_OUT_TOL if k == "out" else SCAN_GRAD_TOL)}
    if bad:
        fail(f"20: the block beyond {SCAN_OUT_TOL} (output) / "
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
    out["bits_on_card"] = _scan_bits(ssm)
    for name in ("scan", "loop"):
        r = out[name]
        busy = "not measured" if r["device_busy_ms"] is None else \
            f"{r['device_busy_ms']:.1f} ms"
        print(f"[20] block forward + backward, {name}: host wall "
              f"{r['host_wall_ms']:.1f} ms, device busy {busy}, "
              f"{r['kernels']} kernels, peak device memory "
              f"{r['peak_memory_gb']:.2f} GB ({card})")
    print(f"[20] _assoc_scan_chunk on the card == the CPU's bit for bit at "
          f"{out['bits_on_card']}")
    return out


def _scan_train_step(T, models, rn, layers, get_arch, mesh, card) -> dict:
    """20 (b): falcon-mamba-7b at full width cut to SCAN_TRAIN_LAYERS
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
    norm_err = check_trainer_norm(rn, layers, cfg, params, batch,
                                  gamma_key="layers.ln", where="20")
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
    rn.LAUNCHES = 0                      # the training path starts here
    losses, walls = [], []
    for _ in range(1 + SCAN_TIMED_STEPS):
        t0 = time.perf_counter()
        p_in, state, m = step(p_in, state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(map(math.isfinite, losses)):
        fail(f"20: a falcon-mamba-7b step gave a non-finite loss {losses}")
    kernels, prof_wall = kernel_spans(lambda: step(p_in, state, batch))
    launches = rn.LAUNCHES               # the steps above and two profiled
    if launches != norms * (len(losses) + 2):
        fail(f"20: {len(losses) + 2} steps launched rmsnorm {launches} "
             f"times, expected {norms} a step")
    busy = busy_ms_of_spans(kernels) if kernels else None
    del p_in, state, batch, toks
    torch.cuda.empty_cache()
    out = {"n_layers": cfg.n_layers, "registered_layers":
           get_arch(SCAN_ARCH).model.n_layers, "params":
           models.param_count(cfg), "losses": losses,
           "step_walls_ms": walls[1:], "first_step_wall_ms": walls[0],
           "step_wall_ms": statistics.median(walls[1:]),
           "peak_memory_gb": peak, "rmsnorm_per_step": norms,
           "rmsnorm_launches": launches, "rmsnorm_max_abs_err": norm_err,
           "profiled_wall_ms": prof_wall, "device_busy_ms": busy,
           "kernels": len(kernels),
           "busy_share": None if busy is None else busy / prof_wall,
           # the profiler slows the host: busy against the median step too
           "busy_share_of_median_step": None if busy is None else
           min(1.0, busy / statistics.median(walls[1:]))}
    busy_txt = "profile: no device activity; not measured" if busy is None \
        else (f"profiled step {prof_wall:.1f} ms, device busy {busy:.1f} ms"
              f" ({100 * out['busy_share']:.1f}%; "
              f"{100 * out['busy_share_of_median_step']:.1f}% of the median "
              f"step), {len(kernels)} kernels")
    print(f"[20] falcon-mamba-7b train step ({out['params']:,} parameters, "
          f"cut to {cfg.n_layers} of {out['registered_layers']} layers), "
          f"batch 1 x {SCAN_SEQ}, bf16: losses {losses}; {norms} rmsnorm "
          f"launches a step; step host wall {out['step_wall_ms']:.1f} ms "
          f"(median of {SCAN_TIMED_STEPS}; the first "
          f"{walls[0]:.1f}), peak device memory {peak:.2f} GB; {busy_txt} "
          f"({card})")
    return out


def _scan_prefill(models, rn, get_arch, card) -> dict:
    """20 (c): falcon-mamba-7b's forward at full depth (64 layers, bf16
    weights) at batch 1 x 4,096: host wall of two forwards after a
    warm-up, peak device memory, rmsnorm launches."""
    import torch
    cfg = dataclasses.replace(get_arch(SCAN_ARCH).model, remat=False,
                              param_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    params = models.init_params(gen, cfg)
    toks = torch.randint(0, cfg.vocab, (1, SCAN_SEQ), generator=gen,
                         device="cuda")
    before, walls = rn.LAUNCHES, []
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
            fail(f"20: the prefill's logits {tuple(logits.shape)} are not "
                 f"finite or not (1, {SCAN_SEQ}, {cfg.vocab})")
        del logits
    launches = rn.LAUNCHES - before
    norms = cfg.n_layers + 1
    if launches != 3 * norms:
        fail(f"20: three prefills launched rmsnorm {launches} times, "
             f"expected {norms} a forward")
    del params
    torch.cuda.empty_cache()
    out = {"n_layers": cfg.n_layers, "params": models.param_count(cfg),
           "walls_ms": walls[1:], "first_wall_ms": walls[0],
           "peak_memory_gb": peak, "rmsnorm_launches": launches}
    print(f"[20] falcon-mamba-7b prefill, 64 layers, bf16 weights, batch 1 "
          f"x {SCAN_SEQ}: host wall {walls[1]:.1f}, {walls[2]:.1f} ms (the "
          f"first {walls[0]:.1f}), peak device memory {peak:.2f} GB; "
          f"{norms} rmsnorm launches a forward ({card})")
    return out


def phase_scan(ssm, models, rn, layers, get_arch, card) -> dict:
    """20: Mamba-1's associative scan at falcon-mamba-7b's width and
    train_4k's length: (a) one block's forward and backward against an f64
    step loop, beside the per-step loop's readings; (b) the trainer's step
    on a one-rank NCCL group and a (1, 1) mesh, cut in depth; (c) the full
    64-layer prefill. The rmsnorm count is set to 0 before (b) and read
    after (c); the norm check at (b)'s rows comes before it."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    t0 = time.perf_counter()
    out = {"block": _scan_block(ssm, get_arch, card)}
    part_s = {"block": time.perf_counter() - t0}
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        fail(f"20: expected a one-rank NCCL group, got "
             f"{dist.get_backend()} x {dist.get_world_size()}")
    out["train"] = _scan_train_step(T, models, rn, layers, get_arch, mesh,
                                    card)
    dist.destroy_process_group()
    part_s["train"] = time.perf_counter() - t0 - sum(part_s.values())
    out["prefill"] = _scan_prefill(models, rn, get_arch, card)
    part_s["prefill"] = time.perf_counter() - t0 - sum(part_s.values())
    out["part_seconds"] = part_s
    out["launches"] = {"rmsnorm": rn.LAUNCHES}
    out["seconds"] = time.perf_counter() - t0
    print(f"[20] launches on the phase's path: rmsnorm {rn.LAUNCHES}; "
          f"{out['seconds']:.1f} s (" + ", ".join(
              f"{k} {v:.1f}" for k, v in part_s.items()) + ")")
    return out


# ---------------------------------------------------------------------------
# Phase 21: the causal attention kernel
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
    """21: the causal attention kernels against ``attention_dense`` at two
    shapes: the output and the three gradients no further (relative norm)
    from an f32 attention on the same bf16 values than the dense path at
    bf16 is, with 10 % room; two runs the same bits; 1 + 2 launches a
    forward and backward. Then the device time of one forward and
    backward, its bound, the plain versions' time, the dense path's and
    SDPA's (``library_ms``, a yardstick the port never calls), and the
    peak memory a forward and backward adds, kernel against dense."""
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

        def grads(fn, dtype):
            leaves = [t.detach().clone().to(dtype).requires_grad_()
                      for t in (q, k, v)]
            o = fn(*leaves)
            o.backward(do.to(dtype))
            return [o.detach().float()] + [t.grad.float() for t in leaves]

        exact = grads(dense, torch.float32)
        ref = grads(dense, torch.bfloat16)
        before = ca.LAUNCHES
        got = grads(ca.causal_attention, torch.bfloat16)
        again = grads(ca.causal_attention, torch.bfloat16)
        torch.cuda.synchronize()
        if ca.LAUNCHES - before != 6:
            fail(f"21 {label}: {ca.LAUNCHES - before} launches for two "
                 f"forwards and backwards, not 6")
        row = {"shape": [b, s, h, kh, d]}
        for name, g_, r_, e_ in zip(("o", "dq", "dk", "dv"), got, ref,
                                    exact):
            row[f"{name}_gap"], row[f"{name}_dense_gap"] = gap(g_, e_), \
                gap(r_, e_)
            if row[f"{name}_gap"] > 1.1 * row[f"{name}_dense_gap"] + 1e-7:
                fail(f"21 {label}: {name} is {row[f'{name}_gap']:.3e} from "
                     f"f32, the dense path {row[f'{name}_dense_gap']:.3e}")
        if not all(bits_equal(x, y) for x, y in zip(got, again)):
            fail(f"21 {label}: two runs differ")
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
        bound = max(flops / 989e12, nbytes / 3.35e12) * 1e3
        dev = device_ms(kernel, "causal_attention")
        row.update({
            "device_ms": dev[0] if dev else None,
            "kernels_a_call": dev[1] if dev else None,
            "ms": time_ms(kernel), "bound_ms": bound,
            "bound_by": "operations" if flops / 989e12 > nbytes / 3.35e12
            else "bytes",
            "plain_ms": time_ms(plain),
            "dense_ms": time_ms(lambda: grads(dense, torch.bfloat16)),
            "library_ms": time_ms(library),
            "peak_gb": peak_gb(lambda: grads(ca.causal_attention,
                                             torch.bfloat16)),
            "dense_peak_gb": peak_gb(lambda: grads(dense, torch.bfloat16))})
        row["share"] = bound / row["device_ms"] if dev else None
        print(f"[21] {label} {tuple(row['shape'])}: gaps to f32 (kernel / "
              f"dense) " + ", ".join(
                  f"{n} {row[n + '_gap']:.3e} / {row[n + '_dense_gap']:.3e}"
                  for n in ("o", "dq", "dk", "dv"))
              + f"; device {row['device_ms']} ms, events {row['ms']:.3f}, "
              f"bound {bound:.4f} ({row['bound_by']}), plain "
              f"{row['plain_ms']:.2f}, dense {row['dense_ms']:.2f}, SDPA "
              f"{row['library_ms']:.3f}; peak {row['peak_gb']:.2f} GB "
              f"against {row['dense_peak_gb']:.2f} ({card})")
        out[label] = row
        del q, k, v, do, o, m, l, lib
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Phase 22: the RoPE kernel
# ---------------------------------------------------------------------------

#: (label, (B, S, H, hd), type, positions): GPT-2 Large's training step's q
#: (k alike), and a tinyllama-wide f32 decode step at one position
ROPE_SHAPES = (("gpt2-large", (4, 1024, 20, 64), "bfloat16", "arange"),
               ("decode128", (4, 1, 32, 128), "float32", "one"))
#: short spin kernels launched before and after each profiled window: a
#: full run's profiler left out the first or last 18 kernels of a window
PAD_LAUNCHES, PAD_CYCLES = 256, 2000
PROFILE_TRIES = 3


def counted_device_ms(fn, tag: str | None, per_call: int | None):
    """Device time a call of ``fn`` under ``torch.profiler``: the kernels
    whose name holds ``tag`` (every kernel but the pads when None) over
    ``PROFILED_CALLS`` calls, between ``PAD_LAUNCHES`` spin kernels on
    each side, from a profile that recorded exactly ``per_call`` of them a
    call (None: as many as a profile of one call records). A profile that
    records another count is taken again; after ``PROFILE_TRIES`` the
    phase fails. Returns the time and the kernels a call."""
    import torch
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def profile(calls):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(PAD_LAUNCHES):
                torch.cuda._sleep(PAD_CYCLES)
            for _ in range(calls):
                fn()
            for _ in range(PAD_LAUNCHES):
                torch.cuda._sleep(PAD_CYCLES)
            torch.cuda.synchronize()
        return [e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and "spin_kernel" not in e.name
                and (tag is None or tag in e.name)]

    counts = []
    for _ in range(PROFILE_TRIES):
        want = per_call if per_call is not None else len(profile(1))
        times = profile(PROFILED_CALLS)
        counts.append((want, len(times)))
        if want > 0 and len(times) == want * PROFILED_CALLS:
            return sum(times) / PROFILED_CALLS / 1e3, want
    fail(f"22: the profiler recorded (kernels a call, kernels of "
         f"{PROFILED_CALLS} calls) {counts} for {tag or 'the plain chain'}")


def phase_rope(rp, layers, card) -> dict:
    """22: the RoPE kernel through ``layers.apply_rope`` against the plain
    chain (``apply_rope_plain``) and autograd through it: the output and
    x's gradient bit for bit, two launches a forward and backward. Then,
    a forward and backward over copies of x and of its gradient, one pair
    a call in turn, that together outgrow the L2 (COLD_POOL_BYTES) where
    x exceeds COLD_BYTES: the kernels' device time from profiles that
    recorded both kernels of every call, against their bound (one read
    and one write of x each way); the plain chain's (its table built each
    call, as the port did before the kernel) from profiles that recorded
    as many kernels a call as one call does; both by CUDA events, and the
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
        before = rp.LAUNCHES
        got = fwd_bwd(layers.apply_rope, (x, do))
        torch.cuda.synchronize()
        if rp.LAUNCHES - before != 2:
            fail(f"22 {label}: {rp.LAUNCHES - before} launches for a "
                 f"forward and backward, not 2")
        if not all(bits_equal(a.detach(), b.detach()) for a, b in
                   zip(got, fwd_bwd(rp.apply_rope_plain, (x, do)))):
            fail(f"22 {label}: the kernel's output or gradient differs from "
                 f"the plain chain's")
        bound = 2 * 2 * nbytes / 3.35e12 * 1e3
        dev, kernels = counted_device_ms(routed, "rope_rotate", 2)
        plain_dev, plain_kernels = counted_device_ms(plain, None, None)
        row = {"shape": list(shape), "dtype": dtype, "positions": kind,
               "timed_copies": copies, "device_ms": dev,
               "kernels_a_call": kernels, "ms": time_ms(routed),
               "bound_ms": bound, "bound_by": "bytes",
               "share": bound / dev, "plain_device_ms": plain_dev,
               "plain_kernels_a_call": plain_kernels,
               "plain_ms": time_ms(plain), "host_us": host_us(routed),
               "plain_host_us": host_us(plain)}
        where = f"{copies} copies of x and its gradient in turn, from HBM" \
            if copies > 1 else "one x"
        print(f"[22] {label} {tuple(shape)} {dtype}: bits equal the plain "
              f"chain's; device {dev} ms ({kernels} kernels a call, all "
              f"recorded) over {where}, events {row['ms']:.4f}, bound "
              f"{bound:.4f} (bytes), share {row['share']}; plain device "
              f"{plain_dev} ms ({plain_kernels} kernels), events "
              f"{row['plain_ms']:.4f}; host {row['host_us']:.1f} us a call "
              f"against {row['plain_host_us']:.1f} ({card})")
        out[label] = row
        del x, do, got, pool
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
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
    from repro_torch.kernels import causal_attention as ca
    from repro_torch.kernels import rope as rp
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLM
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
    clock.append(("3-6 kernels, pinned keys, VGG-16 rounds",
                  time.perf_counter()))

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
        fs, sgd, rn, ca, federated_lm, lm_cfg)
    lm_rows = phase_lm_timings(sgd, rn, layers, lm_cfg, trained, lm_grads,
                               peaks(name))
    del lm_grads
    lm_profile = phase_lm_profile(models, lm_data, lm_cfg, trained)
    del trained
    torch.cuda.empty_cache()
    clock.append(("7 federated LM", time.perf_counter()))

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
    carry_rows = phase_carry_timing(fs, build, peaks(name))
    torch.cuda.empty_cache()
    clock.append(("8-11 faults, plugins, population, carry",
                  time.perf_counter()))

    # phase 12: serving
    serve_norms, serve_norm_err = phase_serve_kernels(rn, peaks(name))
    serve_f32 = phase_serve_f32(models, rn, dataclasses.replace(
        get_arch(LM_ARCH).model, compute_dtype=torch.float32, remat=False))
    torch.cuda.empty_cache()
    serve_out = phase_serve_loop(serve, models, rn, ca, dataclasses.replace(
        get_arch(LM_ARCH).model, remat=False), peaks(name))
    torch.cuda.empty_cache()
    serve_archs = phase_serve_archs(models, rn, get_arch)
    torch.cuda.empty_cache()
    clock.append(("12 serving", time.perf_counter()))

    # phase 13: the other families at full width
    family_norms, family_norm_err = phase_serve_kernels(
        rn, peaks(name), FAMILY_ROWS, tag="13")
    families = phase_families(serve, models, moe, rn, ca, get_arch,
                              peaks(name), card)
    clock.append(("13 families", time.perf_counter()))
    # phase 14: long context
    long_ctx = phase_long_context(models, layers, get_arch, card)
    clock.append(("14 long context", time.perf_counter()))
    # phase 15: the federated CNN
    fl_cnn = phase_federated_cnn(fs, sgd, card)
    clock.append(("15 federated CNN", time.perf_counter()))
    # phase 16: the single-program trainer
    torch.cuda.empty_cache()
    trainer = phase_trainer(fs, sgd, q, rn, ca, models, get_arch,
                            FederatedSession, peaks(name), card)
    clock.append(("16 trainer", time.perf_counter()))
    # phase 17: tensor parallelism's serving path
    torch.cuda.empty_cache()
    tp = phase_tp(serve, models, rn, ca, get_arch, peaks(name), card)
    clock.append(("17 TP serving", time.perf_counter()))
    # phase 18: TP for the SSM, hybrid and encoder-decoder families
    torch.cuda.empty_cache()
    tpf = phase_tp_families(serve, models, rn, ca, get_arch, peaks(name),
                            card)
    clock.append(("18 TP families", time.perf_counter()))
    # phase 19: the examples
    torch.cuda.empty_cache()
    ex = phase_examples(
        (quickstart, faulty_round, million_clients, compression_composition,
         elastic_reshard, serve_sharded, train_federated_lm),
        fs, q, tk, sgd, rn, ca, models, get_arch, FederatedSession, card)
    clock.append(("19 examples", time.perf_counter()))
    # phase 20: Mamba-1's associative scan at training length
    torch.cuda.empty_cache()
    scan = phase_scan(ssm, models, rn, layers, get_arch, card)
    clock.append(("20 Mamba-1 scan", time.perf_counter()))
    # phase 21: the causal attention kernel, its launches counted apart
    # from the paths'
    torch.cuda.empty_cache()
    ca.LAUNCHES = 0
    attn = phase_attention(ca, layers, card)
    clock.append(("21 causal attention", time.perf_counter()))
    # phase 22: the RoPE kernel, its launches counted apart from the paths'
    torch.cuda.empty_cache()
    rp.LAUNCHES = 0
    rope_out = phase_rope(rp, layers, card)
    clock.append(("22 rope", time.perf_counter()))
    phase_s = {label: t - clock[i][1]
               for i, (label, t) in enumerate(clock[1:])}
    print(f"phase seconds ({card}): " + ", ".join(
        f"{label} {secs:.1f}" for label, secs in phase_s.items())
        + f"; total {clock[-1][1] - clock[0][1]:.1f}")

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
                      "carry": carry_rows,
                      "serve": {"rmsnorm_decode_rows": serve_norms,
                                "f32_decode": serve_f32, "loop": serve_out,
                                "smoke_archs": serve_archs},
                      "families": {"rmsnorm_rows": family_norms,
                                   "models": families},
                      "long_context": long_ctx, "federated_cnn": fl_cnn,
                      "trainer": trainer, "tp": tp, "tp_families": tpf,
                      "examples": ex, "mamba1_scan": scan,
                      "causal_attention": attn, "rope": rope_out,
                      "phase_seconds": phase_s,
                      "card": card}))
    kernels = [{
        "name": "fedavg_stream", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fedavg_stream.cu",
        "replaces": "src/repro/kernels/fedavg_stream.py:47",
        "launches": launches + fault_launches + sum(pop_launches.values())
        + fl_cnn["fold_launches"] + trainer["launches"]["fold"],
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
            "replaces": replaces,
            "launches": codec_counts[name] + trainer["launches"].get(name, 0),
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
    step = lm_rows["fused_sgd"]
    kernels[-2].update({"launches": lm_launches["fused_sgd"]
                        + fl_cnn["fused_sgd_launches"]
                        + trainer["launches"]["fused_sgd"],
                        "device_ms": step["device_ms"],
                        "library_device_ms": step["library_device_ms"]})
    norm = lm_rows["rmsnorm"]
    decode_norm = serve_norms["4x2048"]
    family_launches = sum(r["launches"] for r in families.values())
    kernels[-1].update({
        "launches": lm_launches["rmsnorm"] + serve_out["launches"]
        + family_launches + trainer["launches"]["rmsnorm"]
        + tp["launches"]["rmsnorm"] + tpf["launches"]["rmsnorm"]
        + scan["launches"]["rmsnorm"],
        "max_abs_err": max(lm_errs["rmsnorm"], serve_norm_err,
                           family_norm_err, trainer["rmsnorm_max_abs_err"],
                           tp["rmsnorm_max_abs_err"],
                           tpf["split_max_abs_err"],
                           scan["train"]["rmsnorm_max_abs_err"]),
        "device_ms": norm["device_ms"],
        "library_device_ms": norm["library_device_ms"],
        "copy_device_ms": norm["copy_device_ms"],
        "serve": {"launches": serve_out["launches"], "shape": [4, 2048],
                  "device_ms": decode_norm["device_ms"],
                  "ms": decode_norm["ms"],
                  "plain_ms": decode_norm["plain_ms"],
                  "bound_ms": decode_norm["bound_ms"],
                  "bound_by": decode_norm["bound_by"],
                  "library_ms": decode_norm["library_ms"],
                  "library_device_ms": decode_norm["library_device_ms"],
                  "host_us": decode_norm["host_us"],
                  "library_host_us": decode_norm["library_host_us"]},
        "families": {"launches": family_launches,
                     "per_step": {a: r["rmsnorm_per_step"]
                                  for a, r in families.items()},
                     "rows": {k: {key: r[key] for key in
                                  ("device_ms", "ms", "plain_ms",
                                   "bound_ms", "bound_by")}
                              for k, r in family_norms.items()}},
        "tp": {"launches": tp["launches"]["rmsnorm"],
               "per_step": tp["qwen3"]["rmsnorm_per_step"],
               "rows": {k: {key: r.get(key) for key in
                            ("device_ms", "ms", "plain_ms", "bound_ms",
                             "bound_by", "library_ms", "library_device_ms")}
                        for k, r in tp["rmsnorm_rows"].items()}},
        "tp_families": {"launches": tpf["launches"]["rmsnorm"],
                        "per_step": {a: r["rmsnorm_per_step"] for a, r in
                                     tpf["models"].items()}},
        "mamba1_scan": {"launches": scan["launches"]["rmsnorm"],
                        "train_per_step": scan["train"]["rmsnorm_per_step"],
                        "prefill": scan["prefill"]["rmsnorm_launches"]},
        "split": _split_line(tpf)})
    for row in kernels:                  # phase 19's launches
        row["examples"] = ex["launches"][row["name"]]
        row["launches"] += row["examples"]
    head = attn["gpt2-large"]
    # the route takes every bf16 causal self-attention at head dim 64 or
    # 128: each path's launches, counted from 0 where the path starts
    attn_paths = {
        "federated_lm": lm_launches["causal_attention"],
        "serve": serve_out["attention_launches"],
        "families": sum(r["attention_launches"] for r in families.values()),
        "trainer": trainer["launches"]["causal_attention"],
        "tp": tp["launches"]["causal_attention"],
        "tp_families": tpf["launches"]["causal_attention"],
        "examples": ex["launches"]["causal_attention"]}
    kernels.append({
        "name": "causal_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/causal_attention.cu",
        "replaces": None, "launches": sum(attn_paths.values()),
        "paths": attn_paths, "check_launches": ca.LAUNCHES,
        "max_gap_over_dense": max(
            r[f"{n}_gap"] / r[f"{n}_dense_gap"] for r in (
                attn[label] for label, _ in ATTN_SHAPES)
            for n in ("o", "dq", "dk", "dv")),
        **{key: head[key] for key in (
            "device_ms", "ms", "plain_ms", "bound_ms", "bound_by", "share",
            "library_ms", "dense_ms")},
        "equal_plain": False})
    # the route takes every rotation of a contiguous CUDA tensor at
    # positions (S,) or (1,): each path's launches, counted from 0 where
    # the path starts
    rope_paths = {
        "federated_lm": lm_launches["rope"],
        "serve": serve_out["rope_launches"],
        "families": sum(r["rope_launches"] for r in families.values()),
        "trainer": trainer["launches"]["rope"],
        "tp": tp["launches"]["rope"],
        "tp_families": tpf["launches"]["rope"],
        "examples": ex["launches"]["rope"]}
    head = rope_out["gpt2-large"]
    kernels.append({
        "name": "rope", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rope.cu",
        "replaces": None, "launches": sum(rope_paths.values()),
        "paths": rope_paths, "check_launches": rp.LAUNCHES,
        **{key: head[key] for key in (
            "device_ms", "timed_copies", "ms", "plain_ms", "plain_device_ms",
            "bound_ms", "bound_by", "share", "host_us", "plain_host_us")},
        "equal_plain": True})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
