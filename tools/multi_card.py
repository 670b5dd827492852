#!/usr/bin/env python3
"""The port's multi-card paths on several cards of one host: the
``host_mesh`` fold engine, and the single-program trainer on an NCCL group
of one rank a card.

Run from the repository root on a machine with several NVIDIA cards::

    python3 tools/multi_card.py                    # every visible card
    python3 tools/multi_card.py --sections 5       # only section 5

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
   from one card's bf16 logits (``chip_smoke.py``'s phase 12 computation)
   beside one card's own bf16-to-f32 distance: a bf16 step rounds every
   product, so two bf16 orders of the same sums differ by that much;
5. the SSM, hybrid and encoder-decoder families split over ``model``:
   ``falcon-mamba-7b`` and ``zamba2-2.7b`` at full depth served over (1,
   M) and ``whisper-tiny`` over (1, M) and (2, M/2), bf16 parameters
   (``init_local_params``): ``serve_loop`` at the reference's defaults
   (tokens/s; rmsnorm launches a step, Mamba-2's gated norm through the
   kernel's split route, two launches a layer), the median host wall of
   20 decode steps, each rank's peak device memory; the first step's
   logits at f32 compute within rtol = atol = 2e-4 of the whole model's on
   rank 0 alone, and the bf16 gap beside one card's own bf16-to-f32 gap;
   then ``zamba2-2.7b``'s training plans at full width, 36 of its 54
   layers (f32 parameters and compute, 1,704,681,920 parameters: the (M,
   1) step does not fit a card's 80 GB at full depth; a global batch of 8
   × 128) over (1, M) and (2, M/2) against the (M, 1) ``none`` step:
   losses within 1e-5, parameters within rtol 5e-4 / atol 1e-4, each
   rank's peak device memory and the step's host wall.

The checks and their tolerances are ``chip_smoke.py``'s own (its phase 11
and 12 helpers, imported), and so is the reading of launch counts
(``chip_smoke.launches``), so one card and several hold the trainer and
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

    length = 40_003 if args.smoke else VGG16.params
    gen = torch.Generator(device=args.device).manual_seed(cs.SEED)
    grads = [torch.randn(length, generator=gen, device=args.device)
             for _ in range(cs.N_CLIENTS)]
    out = cs.host_mesh_vs_streaming(FederatedSession, grads, args.ranks,
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
    """One rank of the group: sections 2-5, those ``args.sections``
    names."""
    import torch
    import torch.distributed as dist

    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{store}", rank=rank,
                            world_size=args.ranks)

    def barrier_sync():
        _sync(dev)
        dist.barrier()

    rows = {}
    if 2 in args.sections:
        rows.update(trainer(rank, args, dev, barrier_sync))
        if cuda:
            torch.cuda.empty_cache()
    if 4 in args.sections:
        rows["tp_serve"] = tp_serve(rank, args, dev, barrier_sync)
        barrier_sync()
    if 5 in args.sections:
        rows["families"] = {"serve": tp_family_serve(rank, args, dev,
                                                     barrier_sync),
                            "train": tp_family_train(rank, args, dev,
                                                     barrier_sync)}
        barrier_sync()
    out = [None] * args.ranks
    dist.all_gather_object(out, rows)
    if rank == 0:
        pathlib.Path(result).write_text(json.dumps(out))
    dist.destroy_process_group()


def trainer(rank, args, dev, barrier_sync) -> dict:
    """2: the trainer's plans on (M, 1) and the shard_map step; then 3, TP
    on the same model and batch."""
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

    cuda = dev.type == "cuda"
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
    with cs.HeldAgainstPlain(sgd, q, where=f"multi_card rank {rank}") \
            as held, cs.launches() as grew:
        new, v, loss = step(params, init_v(params), batch)
    launches = grew.get("fused_sgd", 0)
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
    return rows


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
    from repro_torch.config import ShapeConfig

    cfg = cs.tp_serve_cfg(get_arch)
    if args.smoke:
        cfg = dataclasses.replace(get_arch("qwen3-32b").smoke,
                                  param_dtype=torch.bfloat16)
    b, max_len = cs.SERVE["batch"], cs.SERVE["max_len"]
    mesh = make_mesh((1, args.ranks), ("data", "model"), args.device)
    where = f"multi_card [4] rank {rank}"
    _peak_reset(dev)
    seed = cs.SEED + 19                  # phase 12's weights
    t0 = time.perf_counter()
    params = parts.init_local_params(
        torch.Generator(device=dev).manual_seed(seed), cfg, mesh)
    _sync(dev)
    init_s = time.perf_counter() - t0
    held = sum(t.numel() * t.element_size() for t in params.values())
    with cs.launches() as grew:
        loop = serve.serve_loop(cfg, params=params, seed=0, device=dev.type,
                                mesh=mesh, **cs.SERVE)
    launches = grew.get("rmsnorm", 0)
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


FAMILY_ARCHS = ("falcon-mamba-7b", "zamba2-2.7b", "whisper-tiny")
#: zamba2's depth for the training plans: the (M, 1) `none` step holds ~9.4
#: f32 copies of the parameters a rank (section 2's tinyllama: 41.44 GB for
#: 4.40 GB on an H100 80GB), 91 GB at the full 54 layers, 64 GB at 36 (a
#: multiple of attn_every = 6); full width
FAMILY_TRAIN_LAYERS = 36
#: AdamW's b1 in section 5: its first moment after one step from zero is
#: (1 - b1) times the clipped gradient
ADAM_B1 = 0.9
#: the smoke rehearsal's widths: whisper at 6 heads (whole over 4 ranks,
#: split over 2) and an odd vocabulary, as tests/test_torch_tp_families.py
SMOKE_OVERRIDES = {"whisper-tiny": {"n_heads": 6, "n_kv_heads": 6,
                                    "vocab": 255}}


def _family_cfg(arch: str, args, **over):
    import torch
    from repro_torch.configs import get_arch
    spec = get_arch(arch)
    base = spec.smoke if args.smoke else spec.model
    extra = SMOKE_OVERRIDES.get(arch, {}) if args.smoke else {}
    return dataclasses.replace(base, remat=False, **{**extra, **over})


def _gated_norms(cfg, mesh) -> int:
    """Mamba-2 gated norms a decode step runs on the split route (its
    ``d_inner`` split over ``model``), 0 otherwise."""
    from repro_torch.launch import partitioning as parts
    if cfg.ssm is None or cfg.ssm.version != 2:
        return 0
    split = parts.model_sharded(cfg, mesh)
    return cfg.n_layers if split["layers.mamba.norm_g"] else 0


def tp_family_serve(rank, args, dev, barrier_sync) -> dict:
    """5 (serving): the three families split over (1, M), whisper also over
    (2, M/2); then rank 0 alone serves the whole model's first step."""
    import torch
    from repro_torch.config import ShapeConfig
    from repro_torch.launch import partitioning as parts
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import encdec, meshctx
    from repro_torch.models import registry as models

    b, max_len = cs.SERVE["batch"], cs.SERVE["max_len"]
    shape = ShapeConfig("serve", seq_len=max_len, global_batch=b,
                        kind="decode")
    meshes = {"falcon-mamba-7b": [(1, args.ranks)],
              "zamba2-2.7b": [(1, args.ranks)],
              "whisper-tiny": [(1, args.ranks), (2, args.ranks // 2)]}
    out = {}
    for i, arch in enumerate(FAMILY_ARCHS):
        cfg = _family_cfg(arch, args, param_dtype=torch.bfloat16)
        cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
        seed = cs.SEED + 50 + i
        enc_norms = 2 * cfg.encoder_layers + 1 if models.is_encdec(cfg) \
            else 0
        for shape_m in meshes[arch]:
            name = f"{arch} {shape_m[0]}x{shape_m[1]}"
            where = f"multi_card [5] {name} rank {rank}"
            mesh = make_mesh(shape_m, ("data", "model"), args.device)
            _peak_reset(dev)
            params = parts.init_local_params(
                torch.Generator(device=dev).manual_seed(seed), cfg, mesh)
            held = sum(t.numel() * t.element_size() for t in params.values())
            gated = _gated_norms(cfg, mesh)
            with cs.launches() as grew:
                loop = serve.serve_loop(cfg, params=params, seed=0,
                                        device=dev.type, mesh=mesh,
                                        **cs.SERVE)
            launches = grew.get("rmsnorm", 0)
            split = grew.get("rmsnorm_split", 0)
            norms = (models.norms_per_decode_step(cfg) - gated) \
                * cs.SERVE_STEPS + enc_norms
            want_split = 2 * gated * cs.SERVE_STEPS
            if dev.type == "cuda" and (launches, split) != (norms,
                                                            want_split):
                fail(f"{where}: serve_loop launched rmsnorm {launches} "
                     f"times and its split route {split}, expected {norms} "
                     f"and {want_split}")
            family = encdec if models.is_encdec(cfg) else models
            with torch.inference_mode():
                first = cs.family_first_logits(serve, models, cfg, params,
                                               mesh)
                first32 = cs.family_first_logits(serve, models, cfg32,
                                                 params, mesh, torch.float32)
                step = serve.make_serve_step(cfg, shape, mesh,
                                             family.cache_specs(cfg, b,
                                                                max_len))
                with meshctx.use_mesh(mesh):
                    cache = family.init_cache(cfg, b, max_len, device=dev)
                tok = torch.from_numpy(loop["generated"][:, :1].copy()).to(dev)
                walls = []
                for k in range(3 + cs.SERVE_TIMED_STEPS):
                    barrier_sync()
                    t1 = time.perf_counter()
                    logits, cache = step(params, tok, cache)
                    _sync(dev)
                    if k >= 3:
                        walls.append((time.perf_counter() - t1) * 1e3)
            row = {"held_gb": held / 1e9, "tokens_per_s": loop["tokens_per_s"],
                   "rmsnorm_launches": launches, "split_launches": split,
                   "step_median_ms": statistics.median(walls),
                   "peak_memory_gb": _peak_gb(dev)}
            del params, cache, logits, step
            _peak_reset(dev)
            barrier_sync()
            if rank == 0:
                row.update(_one_card_first(serve, models, cfg, cfg32, seed,
                                           dev, first, first32, where))
            del first, first32
            barrier_sync()
            out[name] = row
    return out


def _one_card_first(serve, models, cfg, cfg32, seed, dev, split, split32,
                    where) -> dict:
    """The whole model on one card, the same weights: its first step's
    logits in bf16 and at f32 compute (f32 cache) against the split
    model's; fails beyond rtol = atol = 2e-4 at f32."""
    import torch
    whole = models.init_params(torch.Generator(device=dev).manual_seed(seed),
                               cfg)
    want = {}
    with torch.inference_mode():
        for label, c, dtype in (("bf16", cfg, torch.bfloat16),
                                ("f32", cfg32, torch.float32)):
            want[label] = cs.family_first_logits(serve, models, c, whole,
                                                 None, dtype)
    del whole
    gap = lambda a, b: float((a.float() - b.float()).abs().max())
    err32, ok32 = cs.max_rel(split32.reshape(-1).float(),
                             want["f32"].reshape(-1).float(), 2e-4, 2e-4)
    if not ok32 or not bool(torch.isfinite(split).all()):
        fail(f"{where}: the split model's first logits at f32 compute are "
             f"{err32} off the whole model's, beyond rtol = atol = 2e-4 (or "
             f"not finite)")
    return {"first_logits_f32_max_abs_err": err32,
            "first_logits_max_abs_err": gap(split, want["bf16"]),
            "one_card_bf16_vs_f32": gap(want["bf16"], want["f32"]),
            "first_logits_max_abs": float(want["bf16"].float().abs().max()),
            "whole_peak_memory_gb": _peak_gb(dev)}


def tp_family_train(rank, args, dev, barrier_sync) -> dict:
    """5 (training): zamba2-2.7b's plans at f32 over (1, M) and (2, M/2)
    against the (M, 1) none step."""
    import torch
    import torch.distributed as dist
    from repro_torch import optim
    from repro_torch.config import ShapeConfig
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry as models

    cfg = _family_cfg("zamba2-2.7b", args, compute_dtype=torch.float32)
    if not args.smoke:
        cfg = dataclasses.replace(cfg, n_layers=FAMILY_TRAIN_LAYERS)
    params = models.init_params(torch.Generator(device=dev).manual_seed(1),
                                cfg)
    for p in params.values():
        dist.broadcast(p, 0)
    toks = torch.randint(0, cfg.vocab, (BATCH, SEQ + 1),
                         generator=torch.Generator().manual_seed(2)).to(dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    shape = ShapeConfig("train", seq_len=SEQ, global_batch=BATCH,
                        kind="train")
    opt = optim.adamw(3e-4, b1=ADAM_B1, grad_clip_norm=1.0)
    mesh = make_mesh((args.ranks, 1), ("data", "model"), args.device)
    _peak_reset(dev)
    step, p_in, state, base_row, flat, mu = cs.plan_step(
        T, mesh, cfg, shape, opt, "none", params, batch, None,
        where=f"multi_card [5] zamba2 ({args.ranks}, 1) rank {rank}",
        with_mu=True)
    base_row["peak_memory_gb"] = _peak_gb(dev)
    del step, p_in, state
    # the base's first moment: (1 - b1) times its clipped gradient, element
    # for element, held against each plan's
    base = (flat, base_row["loss"], mu)
    out = {"params": models.param_count(cfg),
           f"{args.ranks}x1 none": base_row, "failures": []}
    for shape_m in ((1, args.ranks), (2, args.ranks // 2)):
        mesh = make_mesh(shape_m, ("data", "model"), args.device)
        name = f"{shape_m[0]}x{shape_m[1]}"
        for gs in T.PLANS:
            _peak_reset(dev)
            where = f"multi_card [5] zamba2 {name} {gs} rank {rank}"
            barrier_sync()
            t0 = time.perf_counter()
            step, p_in, state, row, flat, mu = cs.plan_step(
                T, mesh, cfg, shape, opt, gs, params, batch, None,
                where=where, with_mu=True)
            barrier_sync()
            row["checked_step_wall_ms"] = (time.perf_counter() - t0) * 1e3
            row["peak_memory_gb"] = _peak_gb(dev)
            del step, p_in, state
            # plan_step's check against the base, every comparison run
            # before a failure is reported
            err, ok = cs.max_rel(flat, base[0], cs.PLAN_RTOL, cs.PLAN_ATOL)
            row.update(max_abs_err_vs_none=err,
                       **_beyond(params, flat, base[0], mu, base[2]),
                       **_moment_gap(params, mu, base[2]))
            if abs(row["loss"] - base[1]) > cs.PLAN_LOSS_ATOL or not ok:
                out["failures"].append(
                    f"{where}: the {gs} plan != none (loss {row['loss']} vs "
                    f"{base[1]}; params max abs err {err}) beyond "
                    f"{cs.PLAN_LOSS_ATOL} / rtol {cs.PLAN_RTOL}, atol "
                    f"{cs.PLAN_ATOL}")
            del flat, mu
            out[f"{name} {gs}"] = row
    del params, base
    _peak_reset(dev)
    return out


def _leaf_spans(params):
    """``(name, start, shape)`` of each leaf in the flat vector's order."""
    from repro_torch.core.sharding import leaf_order
    spans, start = [], 0
    for name in leaf_order(params):
        spans.append((name, start, tuple(params[name].shape)))
        start += params[name].numel()
    return spans


def _beyond(params, flat, base, mu, base_mu, listed: int = 16) -> dict:
    """The elements of ``flat`` beyond rtol 5e-4 / atol 1e-4 of ``base``:
    their count and, for the first ``listed``, the leaf, the index in it,
    the two new values and the two clipped gradients (each plan's first
    moment over ``1 - b1``), so that a gradient that differs shows apart
    from one that agrees where AdamW's first step divides it by its own
    size plus eps."""
    import torch
    n, found = 0, []
    for lo in range(0, flat.numel(), 1 << 27):
        sl = slice(lo, lo + (1 << 27))
        diff = (flat[sl] - base[sl]).abs()
        mask = diff > cs.PLAN_ATOL + cs.PLAN_RTOL * base[sl].abs()
        n += int(mask.sum())
        for i in torch.nonzero(mask).flatten().tolist():
            if len(found) < listed:
                found.append(lo + i)
    spans = _leaf_spans(params)
    rows = []
    for i in found:
        name, start, shape = max((s for s in spans if s[1] <= i),
                                 key=lambda s: s[1])
        idx = list(torch.unravel_index(torch.tensor(i - start), shape)) \
            if shape else []
        rows.append({"leaf": name, "index": [int(j) for j in idx],
                     "new": float(flat[i]), "base_new": float(base[i]),
                     "clipped_grad": float(mu[i]) / (1 - ADAM_B1),
                     "base_clipped_grad":
                     float(base_mu[i]) / (1 - ADAM_B1)})
    return {"beyond_tolerance": n, "beyond": rows,
            "elements": int(flat.numel())}


def _moment_gap(params, mu, base_mu) -> dict:
    """The whole clipped gradient against the base's, leaf by leaf: each
    leaf's largest ``|g - g_base|`` and largest ``|g_base|`` (each plan's
    first moment over ``1 - b1``), and the leaf where the first is the
    largest share of the second. A tensor-parallel gradient that misses a
    sum over ``model`` is off there by a share near 1; one that sums in
    another order, by f32 rounding."""
    by_leaf, worst, name = {}, 0.0, None
    for leaf, start, shape in _leaf_spans(params):
        sl = slice(start, start + math.prod(shape))
        scale = float(base_mu[sl].abs().max()) / (1 - ADAM_B1)
        gap = float((mu[sl] - base_mu[sl]).abs().max()) / (1 - ADAM_B1)
        by_leaf[leaf] = {"max_gap": gap, "max_abs_grad": scale}
        share = gap / scale if scale else (math.inf if gap else 0.0)
        if share >= worst:
            worst, name = share, leaf
    return {"grad_max_rel_gap": worst, "grad_max_rel_gap_leaf": name,
            "grad_gap_by_leaf": by_leaf}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks and fold devices (default: every card)")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config and a short VGG-16 stand-in")
    ap.add_argument("--sections", default="1,2,4,5",
                    help="the sections to run, of 1, 2 (with 3), 4, 5")
    args = ap.parse_args(argv)
    args.sections = {int(x) for x in args.sections.split(",")}
    if not args.sections <= {1, 2, 4, 5}:
        fail(f"--sections takes 1, 2 (which runs 3 too), 4 and 5, got "
             f"{sorted(args.sections)}")
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
           "sections": sorted(args.sections)}
    if 1 in args.sections:
        out["host_mesh"] = host_mesh_round(args)
    if args.device == "cuda":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(args, f"{tmp}/store", f"{tmp}/result.json"),
                 nprocs=args.ranks, join=True)
        ranks = json.loads(pathlib.Path(f"{tmp}/result.json").read_text())
    if 2 in args.sections:
        _report_trainer(out, ranks, args, card)
    if 4 in args.sections:
        _report_tp_serve(out, ranks, args, card)
    if 5 in args.sections:
        _report_families(out, ranks, card)
    out["seconds"] = time.perf_counter() - t0
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "multi_card.json").write_text(
        json.dumps(out, indent=1))
    print(json.dumps(out))
    failures = out.get("families", {}).get("train", {}).get("failures")
    if failures:
        fail("[5] " + "; ".join(failures))
    if 4 in args.sections and not out["tp"]["serve"][0]["first_logits_ok"]:
        srv = out["tp"]["serve"]
        fail(f"[4] the split model's first logits at f32 compute are "
             f"{srv[0]['first_logits_f32_max_abs_err']} off the whole "
             f"model's, beyond rtol = atol = 2e-4 (or not finite)")


def _report_trainer(out, ranks, args, card) -> None:
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
    out["tp"] = {"trainer": ranks[0]["tp"],
                 "trainer_peak_memory_gb_by_rank": {
                     name: {gs: [r["tp"][name][gs]["peak_memory_gb"]
                                 for r in ranks] for gs in T_PLANS}
                     for name in ranks[0]["tp"]}}
    sm = ranks[0]["shardmap"]
    print(f"[2] shard_map step: == a single-device SGD step within rtol "
          f"2e-4, atol 2e-5 (max abs err {sm['max_abs_err_vs_single']:.3g})"
          f"; fused_sgd over each rank's {sm['fused_sgd_shard_elems']:,} "
          f"elements == its plain version bit for bit")
    if not all(math.isfinite(ranks[0][gs]["loss"]) for gs in T_PLANS):
        fail("a non-finite loss")


def _report_tp_serve(out, ranks, args, card) -> None:
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
    out.setdefault("tp", {})["serve"] = srv


def _report_families(out, ranks, card) -> None:
    fam = [r["families"] for r in ranks]
    for name, row in fam[0]["serve"].items():
        mem = [f["serve"][name]["peak_memory_gb"] for f in fam]
        mem_txt = "not measured" if mem[0] is None else \
            f"peaks {', '.join(f'{m:.2f}' for m in mem)} GB by rank"
        print(f"[5] {name}: {row['held_gb']:.2f} GB of blocks a rank, "
              f"{row['tokens_per_s']:.1f} tokens/s, step median "
              f"{row['step_median_ms']:.3f} ms, rmsnorm "
              f"{row['rmsnorm_launches']} launches and its split route "
              f"{row['split_launches']}; {mem_txt}; first logits at f32 "
              f"{row['first_logits_f32_max_abs_err']:.4g} off one card's "
              f"(rtol = atol = 2e-4), bf16 "
              f"{row['first_logits_max_abs_err']:.4g} (max |logit| "
              f"{row['first_logits_max_abs']:.4g}) beside one card's own "
              f"bf16-to-f32 {row['one_card_bf16_vs_f32']:.4g} ({card})")
    for name, row in fam[0]["train"].items():
        if name in ("params", "failures"):
            continue
        mem = [f["train"][name]["peak_memory_gb"] for f in fam]
        mem_txt = "not measured" if mem[0] is None else (
            f"step peak {row['step_peak_memory_gb']:.2f} GB over "
            f"{row['held_before_step_gb']:.2f} GB held before it (the "
            f"whole weights and the check's base copies among them); "
            f"peaks with the check's whole copies "
            f"{', '.join(f'{m:.2f}' for m in mem)} GB by rank")
        err = row.get("max_abs_err_vs_none")
        err_txt = "the base" if err is None else (
            f"params max abs err {err:.3g} against the base; "
            f"{row['beyond_tolerance']:,} of {row['elements']:,} elements "
            f"beyond rtol 5e-4 / atol 1e-4; clipped gradient against the "
            f"base's: largest gap {row['grad_max_rel_gap']:.3g} of the "
            f"leaf's largest |g| ({row['grad_max_rel_gap_leaf']})")
        print(f"[5] zamba2-2.7b ({fam[0]['train']['params']:,} parameters) "
              f"{name}: loss {row['loss']:.6f} ({err_txt}); {mem_txt} "
              f"({card})")
        for e in row.get("beyond", []):
            leaf = row["grad_gap_by_leaf"][e["leaf"]]
            print(f"[5]   {name} beyond: {e['leaf']}{e['index']}: new "
                  f"{e['new']:.9g} against the base's {e['base_new']:.9g}; "
                  f"clipped g {e['clipped_grad']:.6g} against the base's "
                  f"{e['base_clipped_grad']:.6g}; the leaf's largest |g| "
                  f"{leaf['max_abs_grad']:.6g}, its largest gap "
                  f"{leaf['max_gap']:.6g}")
    out["families"] = {
        "serve": fam[0]["serve"], "train": fam[0]["train"],
        "serve_peak_memory_gb_by_rank": {
            name: [f["serve"][name]["peak_memory_gb"] for f in fam]
            for name in fam[0]["serve"]},
        "train_peak_memory_gb_by_rank": {
            name: [f["train"][name]["peak_memory_gb"] for f in fam]
            for name in fam[0]["train"] if name not in ("params",
                                                        "failures")}}


if __name__ == "__main__":
    main()
