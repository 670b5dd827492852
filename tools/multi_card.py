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

The checks and their tolerances are ``chip_smoke.py``'s own (its phase 16
helpers, imported), so one card and several hold the trainer alike.

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
    del base

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
    rows["shardmap"] = {"loss": float(loss), "max_abs_err_vs_single": err,
                        "fused_sgd_shard_elems": shard}
    barrier_sync()
    out = [None] * args.ranks
    dist.all_gather_object(out, rows)
    if rank == 0:
        pathlib.Path(result).write_text(json.dumps(out))
    dist.destroy_process_group()


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
    sm = ranks[0]["shardmap"]
    print(f"[2] shard_map step: == a single-device SGD step within rtol "
          f"2e-4, atol 2e-5 (max abs err {sm['max_abs_err_vs_single']:.3g})"
          f"; fused_sgd over each rank's {sm['fused_sgd_shard_elems']:,} "
          f"elements == its plain version bit for bit")
    out["seconds"] = time.perf_counter() - t0
    if not all(math.isfinite(ranks[0][gs]["loss"]) for gs in ranks[0]):
        fail("a non-finite loss")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "multi_card.json").write_text(
        json.dumps(out, indent=1))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
