"""Single-program trainer: data parallelism + the paper's gradient sharding.

Every rank of a ``DeviceMesh`` (:mod:`repro_torch.launch.mesh`) runs the
same program on its own device; the batch is split over the replica axes
(every axis but ``model``). Two execution paths give the same aggregation
semantics:

  * ``jit_train_step`` (the reference's GSPMD path, here eager): the
    ShardingPlan picks the aggregation strategy exactly as the paper's
    topologies map to devices: ``none`` = replicated optimizer,
    full-gradient all-reduce (λ-FL/LIFL analogue); ``zero1`` = optimizer
    state sharded over the replica axes — reduce-scatter, AdamW on this
    rank's flat shard, all-gather (GradsSharding); ``zero3`` = parameters
    held as flat shards too, all-gathered before use. Over ``model`` the
    forward is tensor-parallel: each rank holds its block of every weight
    (``partitioning.shard_params``), and the flat vectors the plans shard
    are those of its blocks. The collectives are
    :mod:`repro_torch.core.device_agg`'s, on flat vectors from
    :func:`repro_torch.core.sharding.flatten`, so the op order can be read
    here; no FSDP wrapper hides it.

  * ``make_shardmap_train_step`` (paper-faithful demonstration): explicit
    flatten → reduce-scatter(mean) → per-rank |θ|/M shard SGD-momentum
    step through the fused-SGD kernel (optionally QSGD-compressed through
    the quantize/dequantize kernels) → all-gather → unflatten. Its
    parameters are whole on every rank, as in the reference; ranks along
    ``model`` repeat the computation.

The training loop adds the production substrate: checkpoint/restart
(atomic, manifested), deterministic data restart, metric logging.

A third path runs the paper's own setting end to end:
:func:`federated_train_loop` drives multi-round federated training through
a :class:`repro_torch.api.FederatedSession`.

Run (the smoke configuration, on the CPU)::

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 3
"""
from __future__ import annotations

import argparse
import contextlib
import math
from dataclasses import replace
from typing import Any, Mapping

import torch

from repro_torch.config import ModelConfig, ShapeConfig, ShardingPlan
from repro_torch.core import device_agg
from repro_torch.core.sharding import FlatSpec, flatten, resolve_device, \
    unflatten
from repro_torch.kernels import fused_sgd as _sgd
from repro_torch.kernels import ops
from repro_torch.launch import partitioning as parts
from repro_torch.launch.hostenv import host_timer, maybe_preload_tcmalloc
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import meshctx
from repro_torch.models import registry as models
from repro_torch.optim import Optimizer, adamw, apply_updates
from repro_torch.optim.optimizers import global_norm

Tree = Any
PLANS = ("none", "zero1", "zero3")


# ---------------------------------------------------------------------------
# Plain step
# ---------------------------------------------------------------------------

def _value_and_grad(cfg: ModelConfig, params: Mapping, batch):
    """(loss, metrics, grads) of ``models.loss_fn`` at ``params``."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss, metrics = models.loss_fn(leaves, cfg, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, dict(zip(leaves, grads))


_gnorm = global_norm        # the reference's name for the metric


def make_train_step(cfg: ModelConfig, optimizer: Optimizer):
    """(params, opt_state, batch) -> (params, opt_state, metrics) on one
    device."""

    def train_step(params, opt_state, batch):
        _, metrics, grads = _value_and_grad(cfg, params, batch)
        with torch.no_grad():
            updates, new_state = optimizer.update(grads, opt_state, params)
            new_params = apply_updates(params, updates)
            metrics = dict(metrics, grad_norm=_gnorm(grads))
        return new_params, new_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# Flat-shard layout of the sharded plans
# ---------------------------------------------------------------------------

def flat_spec(cfg: ModelConfig, mesh=None) -> FlatSpec:
    """The flat layout of ``cfg``'s parameters (from their specs on the
    meta device: nothing is allocated); with a ``mesh``, of a rank's
    ``model``-axis blocks of them."""
    specs = models.param_specs(cfg)
    if mesh is not None:
        shapes = parts.local_param_shapes(cfg, mesh)
        specs = {k: torch.empty(shapes[k], dtype=t.dtype, device="meta")
                 for k, t in specs.items()}
    return flatten(specs)[1]


class _Shards:
    """|θ| padded with zeros to a multiple of M; rank d owns elements
    [d·k, (d+1)·k) with k = ⌈|θ|/M⌉."""

    def __init__(self, mesh, spec: FlatSpec):
        self.mesh, self.spec = mesh, spec
        self.m = device_agg.replica_size(mesh)
        self.k = -(-spec.total // self.m)
        self.lo = device_agg.replica_index(mesh) * self.k

    def pack(self, tree: Mapping, lo: int, hi: int) -> torch.Tensor:
        """Elements [lo, hi) of the padded flat f32 vector of ``tree``,
        built without the whole vector."""
        leaf = next(iter(tree.values()))
        out = torch.zeros(hi - lo, dtype=torch.float32, device=leaf.device)
        off = 0
        for name, size in zip(self.spec.names, self.spec.sizes):
            a, b = max(off, lo), min(off + size, hi)
            if a < b:
                out[a - lo:b - lo].copy_(tree[name].reshape(-1)[a - off:b - off])
            off += size
        return out

    def flat(self, tree: Mapping) -> torch.Tensor:
        return self.pack(tree, 0, self.k * self.m)

    def shard(self, tree: Mapping) -> torch.Tensor:
        return self.pack(tree, self.lo, self.lo + self.k)

    def square_sums(self, shard: torch.Tensor, split: Mapping
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The sums of squares of this rank's shard over the leaves that
        ``split`` marks (split over ``model``) and over the others."""
        sums = [shard.new_zeros(()), shard.new_zeros(())]
        lo, hi, off = self.lo, self.lo + self.k, 0
        for name, size in zip(self.spec.names, self.spec.sizes):
            a, b = max(off, lo), min(off + size, hi)
            if a < b:
                sums[0 if split[name] else 1] += torch.sum(
                    torch.square(shard[a - lo:b - lo]))
            off += size
        return sums[0], sums[1]

    def gather(self, shard: torch.Tensor, dtypes: bool = True) -> dict:
        """The whole tree from every rank's shard (leaves in the spec's
        types, or f32 with ``dtypes=False``)."""
        full = device_agg.all_gather_shards(self.mesh, shard)
        spec = self.spec if dtypes else replace(
            self.spec, dtypes=(torch.float32,) * len(self.spec.names))
        return unflatten(full[:self.spec.total], spec)


def _map_state(fn, state: Tree) -> Tree:
    """``fn`` on every param-shaped part of an optimizer state (a dict of
    tensors in the full form, a 1-D shard in the sharded one); other
    tensors (AdamW's step count) pass through."""
    if isinstance(state, Mapping) or (isinstance(state, torch.Tensor)
                                      and state.ndim == 1):
        return fn(state)
    if isinstance(state, tuple):
        vals = [_map_state(fn, v) for v in state]
        return type(state)(*vals) if hasattr(state, "_fields") \
            else tuple(vals)
    return state


def _tp(mesh) -> int:
    return parts.axis_sizes(mesh).get("model", 1)


def place_state(cfg: ModelConfig, mesh, plan: ShardingPlan, params: Tree,
                opt_state: Tree) -> tuple[Tree, Tree]:
    """``(params, opt_state)`` in the plan's layout: every whole leaf cut to
    this rank's ``model``-axis block (``partitioning.shard_params``), then
    ``zero1`` shards the optimizer state, ``zero3`` the parameters too,
    each part to this rank's flat f32 shard of its blocks; a part already
    in that layout stays as it is."""
    if _tp(mesh) > 1:
        to_blocks = lambda t: parts.shard_params(t, cfg, mesh) \
            if isinstance(t, Mapping) else t
        params = to_blocks(params)
        opt_state = _map_state(to_blocks, opt_state)
    if plan.grad_sharding == "none":
        return params, opt_state
    sh = _Shards(mesh, flat_spec(cfg, mesh))
    to_shard = lambda t: sh.shard(t) if isinstance(t, Mapping) else t
    if plan.grad_sharding == "zero3":
        params = to_shard(params)
    return params, _map_state(to_shard, opt_state)


def gather_state(cfg: ModelConfig, mesh, plan: ShardingPlan, params: Tree,
                 opt_state: Tree) -> tuple[Tree, Tree]:
    """The inverse of :func:`place_state`: whole trees on every rank."""
    if plan.grad_sharding != "none":
        sh = _Shards(mesh, flat_spec(cfg, mesh))
        to_tree = lambda t, dtypes=False: t if isinstance(t, Mapping) \
            else sh.gather(t, dtypes)
        params, opt_state = to_tree(params, True), _map_state(to_tree,
                                                              opt_state)
    if _tp(mesh) > 1:
        whole = lambda t: parts.gather_params(t, cfg, mesh) \
            if isinstance(t, Mapping) else t
        params, opt_state = whole(params), _map_state(whole, opt_state)
    return params, opt_state


def _local_batch(batch: Mapping, specs: Mapping, mesh) -> dict:
    """This rank's rows of the global batch: its block over the replica
    axes where the spec splits the batch, the whole batch where it does
    not."""
    m, d = device_agg.replica_size(mesh), device_agg.replica_index(mesh)
    out = {}
    for k, x in batch.items():
        if specs.get(k, (None,))[0] is None:
            out[k] = x
        elif x.shape[0] % m:
            raise ValueError(f"{k}: {x.shape[0]} rows do not split over "
                             f"{m} replicas")
        else:
            rows = x.shape[0] // m
            out[k] = x[d * rows:(d + 1) * rows]
    return out


# ---------------------------------------------------------------------------
# Plan path (the reference's jit_train_step)
# ---------------------------------------------------------------------------

def jit_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
                   plan: ShardingPlan, optimizer: Optimizer,
                   opt_state_like: Tree = None, donate: bool = True):
    """The train step under ``plan``: ``step(params, opt_state, batch) ->
    (params, opt_state, metrics)``, called in every rank with the same
    global batch. Eager (the reference's name is kept): inputs are first
    placed on the plan's layout (:func:`place_state`, a no-op when they
    already are), and the outputs stay in it. ``metrics`` holds the loss
    averaged over the replicas and the whole gradient's norm.

    ``none`` takes one mean of the gradient tree over the replica axes
    (a sum, then one divide, as the reference's flat mean) and updates
    every leaf. ``zero1`` and ``zero3``
    reduce-scatter the flat gradient (padded to M with zeros, which stay
    zero in the moments and the parameters), clip with the norm of the
    whole gradient (the sum of the shards' squared norms, all-reduced),
    update this rank's shard and all-gather. With ``donate`` the new
    parameters are written into the old ones (``none``, ``zero3``).
    ``opt_state_like`` is accepted for the reference's signature; the
    layout follows from the plan alone.

    With ``model`` > 1 the parameters and the optimizer state are this
    rank's ``model``-axis blocks (the plans shard the flat vector of its
    blocks over the replica axes, as the reference's ``opt_state_pspecs``
    composes them), the forward runs tensor-parallel, and the clipping
    norm counts each logical element once: the squares of the split
    leaves summed over ``model``, those of the replicated leaves (norms,
    router, unsplit biases) taken once.
    """
    gs = plan.grad_sharding
    if gs not in PLANS:
        raise ValueError(f"grad_sharding must be one of {PLANS}, got {gs!r}")
    rep = device_agg.replica_axes(mesh)
    b_specs = parts.batch_pspecs(cfg, shape, mesh)
    tp = _tp(mesh)
    split = parts.model_sharded(cfg, mesh)
    sh = _Shards(mesh, flat_spec(cfg, mesh)) if gs != "none" else None
    ctx = (lambda: meshctx.use_mesh(mesh)) if tp > 1 else \
        contextlib.nullcontext

    def norm_of(sq_split, sq_rest, axes):
        """The whole gradient's norm from this rank's sums of squares of
        the split leaves and of the others, its data over ``axes``."""
        return torch.sqrt(device_agg.psum(mesh, sq_split, axes + ("model",))
                          + device_agg.psum(mesh, sq_rest, axes))

    def step(params, opt_state, batch):
        params, opt_state = place_state(cfg, mesh, plan, params, opt_state)
        full = sh.gather(params) if gs == "zero3" else params
        with ctx():
            _, metrics, grads = _value_and_grad(
                cfg, full, _local_batch(batch, b_specs, mesh))
        with torch.no_grad():
            metrics = device_agg.pmean(mesh, metrics, rep)
            if gs == "none":
                grads = device_agg.pmean(mesh, grads, rep)
                norm = None
                if tp > 1:
                    zero = torch.zeros((), device=params["embed"].device)
                    norm = norm_of(*(sum(
                        (torch.sum(torch.square(g.to(torch.float32)))
                         for k, g in grads.items() if split[k] == s), zero)
                        for s in (True, False)), ())
                updates, opt_state = optimizer.update(grads, opt_state,
                                                      params, norm=norm)
                if donate:
                    for k, p in params.items():
                        p.add_(updates[k].to(p.dtype))
                else:
                    params = apply_updates(params, updates)
                return params, opt_state, dict(
                    metrics, grad_norm=_gnorm(grads) if norm is None
                    else norm)
            g_shard = device_agg.reduce_scatter_mean_flat(mesh,
                                                          sh.flat(grads))
            del grads
            if tp > 1:
                norm = norm_of(*sh.square_sums(g_shard, split), rep)
            else:
                norm = torch.sqrt(device_agg.psum(
                    mesh, torch.sum(torch.square(g_shard)), rep))
            p_shard = params if gs == "zero3" else sh.shard(params)
            updates, opt_state = optimizer.update(g_shard, opt_state,
                                                  p_shard, norm=norm)
            if gs == "zero3" and not donate:
                p_shard = p_shard + updates
            else:
                p_shard.add_(updates)
            new = p_shard if gs == "zero3" else sh.gather(p_shard)
        return new, opt_state, dict(metrics, grad_norm=norm)

    return step


# ---------------------------------------------------------------------------
# shard_map path — explicit GradsSharding over devices
# ---------------------------------------------------------------------------

def make_shardmap_train_step(cfg: ModelConfig, mesh, lr: float,
                             momentum: float = 0.9,
                             compress: str = "none"):
    """Paper-faithful device port: every replica computes local grads (its
    micro-batch = a "client"), the flat gradient is reduce-scattered so
    rank j holds averaged shard j (M = replica count), the SGD update runs
    on the shard (O(|θ|/M) optimizer state), and updated shards are
    all-gathered (Step 4 reconstruct).

    Returns ``(step, init_velocity)``: ``step(params, velocity, batch) ->
    (params, velocity, loss)``, called in every rank with the same
    parameters and global batch; the velocity is this rank's flat f32
    shard of length ⌈|θ|/M⌉, updated in place. The shard update is
    ``v ← μ·v + g; p ← p − η·v`` through the fused-SGD kernel on the card
    (its plain version on the CPU: the reference's two f32 ops, rounded
    separately), after ``compress="qsgd8"`` has passed the averaged shard
    through the quantize/dequantize kernels.
    """
    if compress not in ("none", "qsgd8"):
        raise ValueError(f"compress must be 'none' or 'qsgd8', got "
                         f"{compress!r}")
    rep = device_agg.replica_axes(mesh)
    sh = _Shards(mesh, flat_spec(cfg))

    def step(params, velocity_shard, batch):
        # per-rank local gradients (client update) on its block of rows
        batch = _local_batch(batch, {k: (rep,) for k in batch}, mesh)
        loss, _, grads = _value_and_grad(cfg, params, batch)
        with torch.no_grad():
            # Step 3: reduce-scatter mean (each rank = one shard aggregator)
            shard_avg = device_agg.reduce_scatter_mean_flat(mesh,
                                                            sh.flat(grads))
            del grads
            loss = device_agg.pmean(mesh, loss, rep)
            if compress == "qsgd8":
                # compress the *averaged* shard (paper §VI: per-shard)
                codes, scales, _ = ops.qsgd_compress(shard_avg)
                shard_avg = ops.qsgd_decompress(codes, scales)
            # sharded SGD-momentum update on this rank's |θ|/M slice
            my_shard = sh.shard(params)
            _sgd.fused_sgd(my_shard, shard_avg, velocity_shard, lr, momentum)
            # Step 4: reconstruct (all-gather updated shards)
            new_params = sh.gather(my_shard)
        return new_params, velocity_shard, loss

    def init_velocity(params):
        dev = next(iter(params.values())).device
        return torch.zeros(sh.k, dtype=torch.float32, device=dev)

    return step, init_velocity


# ---------------------------------------------------------------------------
# Serverless federated training (multi-round, schedule-aware)
# ---------------------------------------------------------------------------

class FederatedPipeline:
    """Deprecated: absorbed into :class:`repro_torch.api.FederatedSession`,
    which threads ``client_done_s -> client_ready_s`` internally. Kept as
    a shim for external callers that drive ``aggregate_round`` by hand.

    Under the pipelined schedule a client may finish reading round r's
    averaged shards while stragglers are still downloading; feeding each
    round's ``client_done_s`` into the next round's ``client_ready_s`` lets
    that client's round r+1 upload start immediately — uploads overlap
    read-back, and the session wall-clock is the true makespan rather than
    a sum of round walls."""

    def __init__(self, schedule: str | None = None, upload=None):
        self.schedule = schedule
        self.upload = upload
        self.client_ready: tuple | None = None
        self.session_start_s: float | None = None
        self.session_end_s: float = 0.0
        self.round_walls: list[float] = []

    def round_kwargs(self) -> dict:
        """kwargs for the next ``aggregate_round`` call."""
        return {"schedule": self.schedule, "upload": self.upload,
                "client_ready_s": self.client_ready}

    def observe(self, result) -> None:
        """Fold one round's result into the session timeline."""
        if self.session_start_s is None:
            self.session_start_s = result.round_start_s
        done = result.client_done_s
        self.client_ready = done if len(done) else None
        self.session_end_s = max(self.session_end_s, result.round_end_s)
        self.round_walls.append(result.wall_clock_s)

    @property
    def session_wall_s(self) -> float:
        """Makespan of the whole session (first upload to last read-back)."""
        if self.session_start_s is None:
            return 0.0
        return self.session_end_s - self.session_start_s


def federated_train_loop(client_grad_fn, *, rounds: int,
                         topology: str = "gradssharding", n_shards: int = 4,
                         partition: str = "uniform", tensor_sizes=None,
                         engine=None, schedule: str | None = None,
                         upload=None, store=None, runtime=None,
                         on_round=None, device: str = "cuda") -> dict:
    """Multi-round serverless aggregation loop.

    ``client_grad_fn(rnd)`` returns the round's client gradients (flat f32
    vectors, numpy arrays or tensors — typically local-SGD deltas). Rounds
    run through a :class:`repro_torch.api.FederatedSession` on ``device``
    (the card unless the caller asks for ``"cpu"``), which threads
    per-client timing internally so pipelined sessions overlap rounds.
    ``on_round(rnd, result)`` is called after each round (apply the
    update, log). Returns the results plus session timing:
    ``session_wall_s`` (makespan) and ``sum_round_walls_s`` (what a fully
    barriered session would report).
    """
    from repro_torch.api import FederatedSession, SessionConfig

    session = FederatedSession(
        SessionConfig(topology=topology, n_shards=n_shards,
                      partition=partition, tensor_sizes=tensor_sizes,
                      engine=engine, schedule=schedule, upload=upload,
                      device=device),
        store=store, runtime=runtime)
    results = []
    for rnd, res in enumerate(session.run(client_grad_fn, rounds)):
        results.append(res)
        if on_round is not None:
            on_round(rnd, res)
    return {
        "results": results,
        "session_wall_s": session.session_wall_s,
        "sum_round_walls_s": session.sum_round_walls_s,
        "lambda_cost": session.runtime.total_cost(),
        "store": session.store,
        "runtime": session.runtime,
    }


# ---------------------------------------------------------------------------
# Training loop with checkpoint/restart
# ---------------------------------------------------------------------------

def train_loop(cfg: ModelConfig, *, steps: int, batch_size: int, seq_len: int,
               lr: float = 3e-4, mesh=None,
               plan: ShardingPlan = ShardingPlan(),
               ckpt_dir: str | None = None, ckpt_every: int = 50,
               seed: int = 0, log_every: int = 10,
               data=None, device: str = "cuda") -> dict:
    """End-to-end driver: synthetic LM data, AdamW, checkpoint/restart.

    Parameters come from a ``torch.Generator`` on ``device`` seeded with
    ``seed``; with no ``mesh`` the loop runs on a one-device mesh
    ("data", "model"). Checkpoints hold the whole ``(params, AdamState)``
    whatever the plan, written by the first rank, so a run may resume
    under another plan or M."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import SyntheticLM

    dev = resolve_device(device)
    if mesh is None:
        mesh = make_mesh((1, 1), ("data", "model"), dev.type)
    data = data or SyntheticLM(vocab=cfg.vocab, seq_len=seq_len, seed=seed)
    shape = ShapeConfig("train", seq_len=seq_len, global_batch=batch_size,
                        kind="train")

    optimizer = adamw(lr, grad_clip_norm=1.0)
    params = models.init_params(torch.Generator(device=dev).manual_seed(seed),
                                cfg)
    opt_state = optimizer.init(params)
    start_step = 0

    manager = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if manager is not None:
        restored = manager.restore_latest((params, opt_state))
        if restored is not None:
            start_step, (params, opt_state), _ = restored
            print(f"[train] resumed from step {start_step}")

    step_fn = jit_train_step(cfg, shape, mesh, plan, optimizer, opt_state)

    def save(step: int) -> None:
        # every rank gathers (a collective); the first one writes
        state = gather_state(cfg, mesh, plan, params, opt_state)
        if torch.distributed.get_rank() == 0:
            manager.save(step, state)

    losses = []
    t0 = host_timer()
    for step in range(start_step, steps):
        batch = data.batch(client=0, step=step, batch_size=batch_size,
                           device=dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if log_every and step % log_every == 0:
            print(f"[train] step {step:5d} loss {losses[-1]:.4f} "
                  f"({host_timer() - t0:.1f}s)")
        if manager is not None and (step + 1) % ckpt_every == 0:
            save(step + 1)
    if manager is not None:
        save(steps)
    params, _ = gather_state(cfg, mesh, plan, params, opt_state)
    return {"losses": losses, "params": params, "final_loss":
            float(sum(losses[-5:]) / len(losses[-5:])) if losses
            else math.nan}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description="single-program trainer")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad_sharding", default="zero1", choices=PLANS)
    ap.add_argument("--ckpt_dir", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch
    spec = get_arch(args.arch)
    cfg = spec.smoke if args.smoke else spec.model
    plan = ShardingPlan(grad_sharding=args.grad_sharding)
    out = train_loop(cfg, steps=args.steps, batch_size=args.batch,
                     seq_len=args.seq, lr=args.lr, plan=plan,
                     ckpt_dir=args.ckpt_dir, device=args.device)
    print(f"[train] done: final loss {out['final_loss']:.4f}")


if __name__ == "__main__":
    maybe_preload_tcmalloc()
    main()
