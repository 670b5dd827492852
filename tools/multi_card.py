#!/usr/bin/env python3
"""The port's multi-card paths on several cards of one host: the
``host_mesh`` fold engine, and the single-program trainer on an NCCL group
of one rank a card.

Run from the repository root on a machine with several NVIDIA cards::

    python3 tools/multi_card.py                    # every visible card

Rehearse on the CPU (gloo ranks, smoke widths)::

    PYTHONPATH=src python3 tools/multi_card.py --device cpu --ranks 4 --smoke

What it checks and measures (each check fatal):

1. a GradsSharding VGG-16 round (N = 20 clients, M = 4 shards) on the
   ``host_mesh`` engine over every card (each card folds its column slice
   of every shard node with the fold kernel's no-divide form, then one
   divide), bit for bit the streaming round; its fold launches and the
   host walls of 3 rounds after a warm-up, beside streaming's;
2. the trainer (``repro_torch.launch.train``) on M ranks, a mesh (M, 1)
   ("data", "model"), full-width ``tinyllama-1.1b`` with f32 parameters
   (broadcast from rank 0) and f32 compute, a global batch of 8 × 128:
   one step of each plan from the same parameters, losses within 1e-5 and
   parameters within rtol 5e-4 / atol 1e-4 of ``none``; each plan's step
   host wall (median of 3 after a warm-up, every rank synchronised) and
   each rank's peak device memory; the shard_map step at momentum 0
   within rtol 2e-4 / atol 2e-5 of a single-device SGD step on the whole
   batch, its fused-SGD launch over the rank's |θ|/M shard held bit for
   bit against the plain version.

3. tensor parallelism over ``model`` (each rank holds its block of every
   weight, the forward runs with explicit collectives): the same
   tinyllama at f32 compute on meshes (1, M) and (2, M/2) ("data",
   "model"): the logits (each rank's vocabulary block and rows, joined)
   within rtol = atol = 2e-4 of the whole model's forward on one card on
   the same weights; one step of each plan, losses within 1e-5 and
   parameters within rtol 5e-4 / atol 1e-4 of the (M, 1) ``none`` step
   of 2, each rank's peak device memory and the step's host wall;
4. ``qwen3-32b`` at full depth served split over a (1, M) mesh at bf16
   parameters (each rank draws every leaf whole and keeps its block:
   ``init_local_params``): ``serve_loop`` at the reference's defaults
   (tokens/s), the median host wall of 20 decode steps, each rank's peak
   device memory; the first step's logits at f32 compute (the same bf16
   weights, an f32 cache) within rtol = atol = 2e-4 of the whole model's on
   one card
   (rank 0's, after the split one is freed), and in bf16 their distance
   from one card's bf16 logits (``chip_smoke.py``'s phase 17 computation)
   beside one card's own bf16-to-f32 distance: a bf16 step rounds every
   product, so two bf16 orders of the same sums differ by that much.

The checks and their tolerances are ``chip_smoke.py``'s own (its phase 16
and 17 helpers, imported), so one card and several hold the trainer and
the server alike.

The last line is a JSON object of the results; the same object goes to
``chiprun_out/multi_card.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import pathlib
import statistics
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402  (the shared checks)

BATCH, SEQ = cs.TRAIN["batch"], cs.TRAIN["seq"]
T_PLANS = ("none", "zero1", "zero3")
TIMED_STEPS = cs.PLAN_TIMED_STEPS


def fail(msg: str) -> None:
    print(f"multi_card: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_mesh_round(args) -> dict:
    """1: the host_mesh engine over every fold device against streaming."""
    import torch
    from repro_torch.api import FederatedSession
    from repro_torch.configs.paper_workloads import VGG16
    from repro_torch.kernels import fedavg_stream as fs

    length = 40_003 if args.smoke else VGG16.params
    gen = torch.Generator(device=args.device).manual_seed(cs.SEED)
    grads = [torch.randn(length, generator=gen, device=args.device)
             for _ in range(cs.N_CLIENTS)]
    out = cs.host_mesh_vs_streaming(fs, FederatedSession, grads, args.ranks,
                                    args.device, rounds=TIMED_STEPS,
                                    warm_up=True, where="multi_card [1]")
    want = cs.N_SHARDS * args.ranks if args.device == "cuda" else 0
    if out["host_mesh_fold_launches"] != want:
        fail(f"host_mesh launched the fold {out['host_mesh_fold_launches']} "
             f"times, expected {want} (a shard node a card)")
    print(f"[1] host_mesh GradsSharding round over {args.ranks} fold "
          f"devices ({length:,} elements, N = {cs.N_CLIENTS}, "
          f"M = {cs.N_SHARDS}): "
          f"== streaming bit for bit; fold "
          f"{out['host_mesh_fold_launches']} launches a round; host walls "
          f"{' '.join(f'{w:.1f}' for w in out['host_mesh_wall_ms'])} ms vs "
          f"streaming "
          f"{' '.join(f'{w:.1f}' for w in out['streaming_wall_ms'])} ms")
    return out


def _rank(rank: int, args, store: str, result: str) -> None:
    """2: one rank of the trainer's group."""
    import torch
    import torch.distributed as dist
    from repro_torch import optim
    from repro_torch.config import ShapeConfig
    from repro_torch.configs import get_arch
    from repro_torch.kernels import fused_sgd as sgd
    from repro_torch.kernels import quantize as q
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry as models

    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{store}", rank=rank,
                            world_size=args.ranks)
    mesh = make_mesh((args.ranks, 1), ("data", "model"), args.device)
    spec = get_arch("tinyllama-1.1b")
    # f32 compute, as the reference's trainer tests: in bf16 a rank's
    # gradient of its 2 rows rounds otherwise than the whole batch's
    cfg = dataclasses.replace(spec.smoke if args.smoke else spec.model,
                              remat=False, compute_dtype=torch.float32)
    params = models.init_params(torch.Generator(device=dev).manual_seed(0),
                                cfg)
    for p in params.values():
        dist.broadcast(p, 0)
    toks = torch.randint(0, cfg.vocab, (BATCH, SEQ + 1),
                         generator=torch.Generator().manual_seed(1)).to(dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    shape = ShapeConfig("train", seq_len=SEQ, global_batch=BATCH,
                        kind="train")
    opt = optim.adamw(3e-4, grad_clip_norm=1.0)

    def barrier_sync():
        _sync(dev)
        dist.barrier()

    rows, base = {}, None
    for gs in T.PLANS:
        step, p_in, state, row, flat = cs.plan_step(
            T, mesh, cfg, shape, opt, gs, params, batch, base,
            where=f"multi_card rank {rank}")
        if base is None:
            base = (flat, row["loss"])
        del flat
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        walls = []
        for _ in range(TIMED_STEPS):
            barrier_sync()
            t0 = time.perf_counter()
            out = step(p_in, state, batch)
            barrier_sync()
            walls.append((time.perf_counter() - t0) * 1e3)
            del out
        row["step_wall_ms"] = statistics.median(walls)
        row["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 \
            if cuda else None
        del p_in, state
        rows[gs] = row

    # the shard_map step against a single-device SGD step on the whole
    # batch, its fused-SGD call held against the plain version
    step, init_v = T.make_shardmap_train_step(cfg, mesh, lr=cs.SHARDMAP_LR,
                                              momentum=0.0)
    launches = sgd.LAUNCHES
    with cs.HeldAgainstPlain(sgd, q, where=f"multi_card rank {rank}") \
            as held:
        new, v, loss = step(params, init_v(params), batch)
    launches = sgd.LAUNCHES - launches
    shard = v.numel()
    del v
    held.check()
    if launches != (1 if cuda else 0):
        fail(f"rank {rank}: the shard_map step launched fused_sgd "
             f"{launches} times")
    new_flat = cs.flat_params(new)
    del new
    err = cs.held_to_single_step(T, cfg, params, batch, new_flat, loss,
                                 cs.SHARDMAP_LR,
                                 where=f"multi_card rank {rank}")
    del new_flat
    rows["shardmap"] = {"loss": float(loss), "max_abs_err_vs_single": err,
                        "fused_sgd_shard_elems": shard}
    barrier_sync()
    rows["tp"] = tp_trainer(rank, args, dev, cfg, params, batch, shape, opt,
                            base, barrier_sync)
    del params, base
    if cuda:
        torch.cuda.empty_cache()
    rows["tp_serve"] = tp_serve(rank, args, dev, barrier_sync)
    barrier_sync()
    out = [None] * args.ranks
    dist.all_gather_object(out, rows)
    if rank == 0:
        pathlib.Path(result).write_text(json.dumps(out))
    dist.destroy_process_group()


def _peak_reset(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def _peak_gb(dev):
    import torch
    return torch.cuda.max_memory_allocated(dev) / 1e9 \
        if dev.type == "cuda" else None


def _held_gb(dev):
    """What the rank holds before the timed steps (the placed state, and
    the whole weights and the (M, 1) step's flat parameters that the
    checks keep): part of its peak."""
    import torch
    return torch.cuda.memory_allocated(dev) / 1e9 \
        if dev.type == "cuda" else None


def tp_trainer(rank, args, dev, cfg, params, batch, shape, opt, base,
               barrier_sync) -> dict:
    """3: the TP forward and the plans on (1, M) and (2, M/2)."""
    import torch
    from repro_torch.core import device_agg as da
    from repro_torch.launch import partitioning as parts
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import meshctx
    from repro_torch.models import registry as models

    with torch.no_grad():
        whole = models.forward(params, cfg, batch)
    out = {}
    for shape_m in ((1, args.ranks), (2, args.ranks // 2)):
        mesh = make_mesh(shape_m, ("data", "model"), args.device)
        name = f"{shape_m[0]}x{shape_m[1]}"
        where = f"multi_card [3] {name} rank {rank}"
        blocks = parts.shard_params(params, cfg, mesh)
        local = T._local_batch(batch, parts.batch_pspecs(cfg, shape, mesh),
                               mesh)
        with torch.no_grad(), meshctx.use_mesh(mesh):
            logits = models.forward(blocks, cfg, local)
        if logits.shape[-1] != cfg.vocab:   # a vocabulary block
            logits = da.all_gather_model(mesh, logits, -1)
        if da.replica_size(mesh) > 1:
            logits = da.GatherRows.apply(logits, mesh, da.replica_index(mesh))
        err, ok = cs.max_rel(logits.reshape(-1), whole.reshape(-1), 2e-4,
                             2e-4)
        if not ok:
            fail(f"{where}: TP logits != one card's beyond rtol = atol = "
                 f"2e-4 (max abs err {err})")
        del blocks, logits
        row = {"logits_max_abs_err": err}
        for gs in T.PLANS:
            step, p_in, state, r, flat = cs.plan_step(
                T, mesh, cfg, shape, opt, gs, params, batch, base,
                where=where)
            del flat
            _peak_reset(dev)             # the timed steps' peak, as in 2
            held = _held_gb(dev)
            walls = []
            for _ in range(TIMED_STEPS):
                barrier_sync()
                t0 = time.perf_counter()
                res = step(p_in, state, batch)
                barrier_sync()
                walls.append((time.perf_counter() - t0) * 1e3)
                del res
            r["step_wall_ms"] = statistics.median(walls)
            r["peak_memory_gb"] = _peak_gb(dev)
            r["held_gb"] = held
            del step, p_in, state
            row[gs] = r
        out[name] = row
    del whole
    return out


def tp_serve(rank, args, dev, barrier_sync) -> dict:
    """4: qwen3-32b served split over (1, M); then rank 0 alone serves the
    whole model's first step on its card and holds the split one to it."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import partitioning as parts
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import meshctx
    from repro_torch.models import registry as models
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.config import ShapeConfig

    cfg = cs.tp_serve_cfg(get_arch)
    if args.smoke:
        cfg = dataclasses.replace(get_arch("qwen3-32b").smoke,
                                  param_dtype=torch.bfloat16)
    b, max_len = cs.SERVE["batch"], cs.SERVE["max_len"]
    mesh = make_mesh((1, args.ranks), ("data", "model"), args.device)
    where = f"multi_card [4] rank {rank}"
    _peak_reset(dev)
    seed = cs.SEED + 19                  # phase 17's weights
    t0 = time.perf_counter()
    params = parts.init_local_params(
        torch.Generator(device=dev).manual_seed(seed), cfg, mesh)
    _sync(dev)
    init_s = time.perf_counter() - t0
    held = sum(t.numel() * t.element_size() for t in params.values())
    before = rn.LAUNCHES
    loop = serve.serve_loop(cfg, params=params, seed=0, device=dev.type,
                            mesh=mesh, **cs.SERVE)
    launches = rn.LAUNCHES - before
    norms = models.norms_per_decode_step(cfg) * cs.SERVE_STEPS
    if launches != (norms if dev.type == "cuda" else 0):
        fail(f"{where}: serve_loop launched rmsnorm {launches} times, "
             f"expected {norms}")
    shape = ShapeConfig("serve", seq_len=max_len, global_batch=b,
                        kind="decode")
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    with torch.inference_mode():
        split = cs.tp_first_logits(serve, models, cfg, params, mesh)
        split32 = cs.tp_first_logits(serve, models, cfg32, params, mesh,
                                     torch.float32)
        step = serve.make_serve_step(cfg, shape, mesh,
                                     models.cache_specs(cfg, b, max_len))
        with meshctx.use_mesh(mesh):
            cache = models.init_cache(cfg, b, max_len, device=dev)
        tok = torch.from_numpy(loop["generated"][:, :1].copy()).to(dev)
        walls = []
        for i in range(3 + cs.SERVE_TIMED_STEPS):
            barrier_sync()
            t1 = time.perf_counter()
            logits, cache = step(params, tok, cache)
            _sync(dev)
            if i >= 3:
                walls.append((time.perf_counter() - t1) * 1e3)
    row = {"init_s": init_s, "held_gb": held / 1e9,
           "tokens_per_s": loop["tokens_per_s"],
           "loop_wall_s": loop["wall_s"], "rmsnorm_launches": launches,
           "step_median_ms": statistics.median(walls),
           "peak_memory_gb": _peak_gb(dev)}
    del params, cache, logits, step
    _peak_reset(dev)
    barrier_sync()
    if rank == 0:
        # the whole model on one card, the same weights and first step, in
        # bf16 and at f32 compute (the same bf16 weights, an f32 cache: a
        # bf16 cache rounds the first step's one value vector)
        whole = models.init_params(
            torch.Generator(device=dev).manual_seed(seed), cfg)
        want = {}
        with torch.inference_mode():
            for label, c, dtype in (("bf16", cfg, torch.bfloat16),
                                    ("f32", cfg32, torch.float32)):
                one = serve.make_serve_step(c, shape, cache_like=models
                                            .cache_specs(c, b, max_len, dtype))
                prompt = cs.tp_prompt(c)[:, :1]
                want[label], _ = one(
                    whole, torch.from_numpy(prompt).to(dev),
                    models.init_cache(c, b, max_len, dtype, dev))
        del whole
        gap = lambda a, b: float((a.float() - b.float()).abs().max())
        scale = float(want["bf16"].float().abs().max())
        err32, ok32 = cs.max_rel(split32.reshape(-1),
                                 want["f32"].reshape(-1), 2e-4, 2e-4)
        row.update({"first_logits_ok": bool(torch.isfinite(split).all())
                    and ok32,
                    "first_logits_f32_max_abs_err": err32,
                    "first_logits_max_abs_err": gap(split, want["bf16"]),
                    "one_card_bf16_vs_f32": gap(want["bf16"], want["f32"]),
                    "split_bf16_vs_one_card_f32": gap(split, want["f32"]),
                    "first_logits_max_abs": scale,
                    "first_logits_sum_one_card": float(
                        want["bf16"].float().sum()),
                    "whole_peak_memory_gb": _peak_gb(dev)})
        del want
    barrier_sync()
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks and fold devices (default: every card)")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config and a short VGG-16 stand-in")
    args = ap.parse_args(argv)
    import torch
    import torch.multiprocessing as mp

    if args.device == "cuda":
        if not torch.cuda.is_available():
            fail("no CUDA device; pass --device cpu to rehearse")
        args.ranks = args.ranks or torch.cuda.device_count()
        if args.ranks < 2 or args.ranks > torch.cuda.device_count():
            fail(f"needs 2 to {torch.cuda.device_count()} cards, got "
                 f"--ranks {args.ranks}")
        cards = os.popen("nvidia-smi --query-gpu=name,power.limit "
                         "--format=csv,noheader").read().strip().splitlines()
        card = f"{cards[0]} (card 0 of {len(cards)})"
    else:
        args.ranks = args.ranks or 4
        card = "CPU rehearsal"
    print(card)
    t0 = time.perf_counter()
    out = {"card": card, "ranks": args.ranks, "smoke": args.smoke,
           "host_mesh": host_mesh_round(args)}
    if args.device == "cuda":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(args, f"{tmp}/store", f"{tmp}/result.json"),
                 nprocs=args.ranks, join=True)
        ranks = json.loads(pathlib.Path(f"{tmp}/result.json").read_text())
    out["trainer"] = ranks[0]
    out["peak_memory_gb_by_rank"] = {
        gs: [r[gs]["peak_memory_gb"] for r in ranks]
        for gs in ("none", "zero1", "zero3")}
    for gs in ("none", "zero1", "zero3"):
        r = ranks[0][gs]
        mem = out["peak_memory_gb_by_rank"][gs]
        mem_txt = "not measured" if mem[0] is None else \
            f"{max(mem):.2f} GB peak on the fullest rank"
        print(f"[2] {gs} on {args.ranks} ranks: loss {r['loss']:.6f}, step "
              f"host wall {r['step_wall_ms']:.1f} ms (median of "
              f"{TIMED_STEPS}), {mem_txt} ({card})")
    for name, row in ranks[0]["tp"].items():
        for gs in ("none", "zero1", "zero3"):
            mem = [r["tp"][name][gs]["peak_memory_gb"] for r in ranks]
            mem_txt = "not measured" if mem[0] is None else \
                f"peaks {', '.join(f'{m:.2f}' for m in mem)} GB by rank " \
                f"({row[gs]['held_gb']:.2f} GB held before the step)"
            print(f"[3] TP {name} {gs}: loss {row[gs]['loss']:.6f} (== (M, "
                  f"1) none within 1e-5, params max abs err "
                  f"{row[gs]['max_abs_err_vs_none']:.3g}); step host wall "
                  f"{row[gs]['step_wall_ms']:.1f} ms; {mem_txt} ({card})")
        print(f"[3] TP {name}: logits == one card within 2e-4 (max abs err "
              f"{row['logits_max_abs_err']:.3g})")
    srv = [r["tp_serve"] for r in ranks]
    mem = [r["peak_memory_gb"] for r in srv]
    mem_txt = "not measured" if mem[0] is None else \
        f"peaks {', '.join(f'{m:.2f}' for m in mem)} GB by rank"
    print(f"[4] qwen3-32b split over (1, {args.ranks}): "
          f"{srv[0]['held_gb']:.2f} GB of blocks a rank, "
          f"{srv[0]['tokens_per_s']:.1f} tokens/s, step median "
          f"{srv[0]['step_median_ms']:.3f} ms; {mem_txt} ({card})")
    print(f"[4] first logits at f32 compute (the same bf16 weights): "
          f"{srv[0]['first_logits_f32_max_abs_err']:.4g} off one card's, "
          f"within rtol = atol = 2e-4; in bf16 "
          f"{srv[0]['first_logits_max_abs_err']:.4g} off one card's bf16 "
          f"(max |logit| {srv[0]['first_logits_max_abs']:.4g}), where one "
          f"card's bf16 is {srv[0]['one_card_bf16_vs_f32']:.4g} off its own "
          f"f32 compute and the split bf16 "
          f"{srv[0]['split_bf16_vs_one_card_f32']:.4g}")
    out["tp"] = {"trainer": ranks[0]["tp"], "serve": srv,
                 "trainer_peak_memory_gb_by_rank": {
                     name: {gs: [r["tp"][name][gs]["peak_memory_gb"]
                                 for r in ranks] for gs in T_PLANS}
                     for name in ranks[0]["tp"]}}
    sm = ranks[0]["shardmap"]
    print(f"[2] shard_map step: == a single-device SGD step within rtol "
          f"2e-4, atol 2e-5 (max abs err {sm['max_abs_err_vs_single']:.3g})"
          f"; fused_sgd over each rank's {sm['fused_sgd_shard_elems']:,} "
          f"elements == its plain version bit for bit")
    out["seconds"] = time.perf_counter() - t0
    if not all(math.isfinite(ranks[0][gs]["loss"]) for gs in T_PLANS):
        fail("a non-finite loss")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "multi_card.json").write_text(
        json.dumps(out, indent=1))
    print(json.dumps(out))
    if not srv[0]["first_logits_ok"]:
        fail(f"[4] the split model's first logits at f32 compute are "
             f"{srv[0]['first_logits_f32_max_abs_err']} off the whole "
             f"model's, beyond rtol = atol = 2e-4 (or not finite)")


if __name__ == "__main__":
    main()
