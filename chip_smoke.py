#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card: ``nvidia-smi`` name and power limit; no CUDA device is an error;
2. build the fold kernel from ``src/repro_torch/kernels/csrc`` with nvcc;
3. the kernel against its plain PyTorch version on the card, bit for bit:
   every dependency wave of the three topologies at the paper's VGG-16
   width (N = 20 clients, M = 4 shards), then bf16 inputs, the weighted
   forms, N = 1, ragged and misaligned views, subnormals and a mixed
   multi-node table;
4. the reference's pinned smoke keys (``benchmarks/expected_smoke.json``,
   read as JSON) recomputed on the card: 168 keys across topology × engine
   × schedule and the ``readahead_k`` sweeps; then every engine at N = 12
   on the card against the CPU;
5. full width: GradsSharding, λ-FL and LIFL rounds through
   ``FederatedSession(..., engine="batched", device="cuda")`` on 20 VGG-16
   gradients made on the card from a seed; the launch counter must grow,
   each mean must equal the plain fold bit for bit, and a 1 M-element
   slice must equal a numpy fold on the host. Then the kernel's time per
   wave (CUDA events, median of 7 after a warm-up) beside its bound, the
   plain version's time and ``torch.mean`` over a pre-stacked tensor.

The last lines are a JSON object of per-wave timings, a JSON ``kernels``
line, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
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
SLICE = 1_000_000        # host numpy check of the round's mean
TOPOLOGIES = ("gradssharding", "lambda_fl", "lifl")

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
    build.load("fedavg_stream")
    secs, log = build.BUILD_INFO["fedavg_stream"]
    print(f"[2] built fedavg_stream.cu in {secs:.1f} s "
          f"(load {time.perf_counter() - t0:.1f} s)")
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
    from repro_torch import smoke

    phase_build(build)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    grads = [torch.randn(VGG16.params, generator=gen, device="cuda")
             for _ in range(N_CLIENTS)]
    max_err = phase_kernel_vs_plain(fs, grads, cm, plan_uniform)
    phase_pinned(fs, smoke, FederatedSession)
    launches, per_topo, walls, rows = phase_full_width(
        fs, grads, cm, plan_uniform, FederatedSession, peaks(name))

    head = rows[0]                       # the GradsSharding wave
    print(json.dumps({"waves": rows, "round_walls_s": walls,
                      "launches_per_topology": per_topo, "card": card}))
    print(json.dumps({"kernels": [{
        "name": "fedavg_stream", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fedavg_stream.cu",
        "replaces": "src/repro/kernels/fedavg_stream.py:47",
        "launches": launches, "max_abs_err": max_err,
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "equal_plain": True}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
