"""Rank bodies for the multi-rank CPU tests (``_torch_ranks.run_ranks``).

Each function runs in every rank of a gloo process group and imports
torch and the port only; what it returns (numpy arrays, numbers) is held
against numpy and the reference package in the test process.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

MESHES = {"pod2_data2": ((2, 2, 1), ("pod", "data", "model")),
          "data4": ((4, 1), ("data", "model"))}


def rank_tree(rank: int) -> dict:
    """This rank's "gradient": a (4, 6) and a 17-element leaf."""
    rng = np.random.default_rng(100 + rank)
    return {"a": rng.standard_normal((4, 6)).astype(np.float32),
            "b": rng.standard_normal(17).astype(np.float32)}


def collectives(rank: int, world: int) -> dict:
    from repro_torch.core import device_agg as da
    from repro_torch.core.sharding import flatten
    from repro_torch.launch.mesh import make_mesh

    tree = {k: torch.from_numpy(v) for k, v in rank_tree(rank).items()}
    out = {}
    for name, (shape, axes) in MESHES.items():
        mesh = make_mesh(shape, axes, "cpu")
        m = da.replica_size(mesh)
        flat, _ = flatten(tree)
        padded, pad = da.pad_to_multiple(flat, m)
        shard = da.reduce_scatter_mean_flat(mesh, padded)
        rep = da.replica_axes(mesh)
        out[name] = {
            "index": da.replica_index(mesh), "m": m, "pad": pad,
            "pmean": {k: v.numpy() for k, v in
                      da.all_reduce_mean(mesh, tree).items()},
            "hier": {k: v.numpy() for k, v in da.all_reduce_mean(
                mesh, tree, hierarchical=True).items()},
            "psum": da.psum(mesh, flat, rep).numpy(),
            "shard": shard.numpy(),
            "gathered": da.all_gather_shards(mesh, shard).numpy(),
            "scatter_last": da.psum_scatter_mean(mesh, padded,
                                                 rep[-1]).numpy(),
            "gather_last": da.all_gather_flat(mesh, padded[:m],
                                              rep[-1]).numpy(),
        }
    return out


def smoke_lm(d_model: int = 65, dtype=torch.float32):
    """tinyllama's smoke config at 2 layers; at d_model 65 its |θ| =
    108,485 is odd, so every M > 1 pads the flat vector."""
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("tinyllama-1.1b").smoke, n_layers=2,
                               d_model=d_model, remat=False,
                               compute_dtype=dtype)


def _batch(tokens: np.ndarray) -> dict:
    t = torch.from_numpy(np.asarray(tokens, np.int64))
    return {"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()}


def _flat(params) -> np.ndarray:
    from repro_torch.core.sharding import flatten
    return flatten(params)[0].numpy()


def trainer(rank: int, world: int, params: dict, tokens: np.ndarray,
            qsgd_params: dict, qsgd_tokens: np.ndarray, moe_params: dict,
            moe_tokens: np.ndarray, ckpt_dir: str) -> dict:
    from repro_torch.config import ShapeConfig, ShardingPlan
    from repro_torch.configs import get_arch
    from repro_torch.convert import params_from_jax
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import meshctx, registry as R
    from repro_torch.optim import adamw

    cfg = smoke_lm()
    p0 = params_from_jax(params)
    batch = _batch(tokens)
    out = {}

    # the shard_map step on (2, 2): M = 2, the model ranks repeat it
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    step, init_v = T.make_shardmap_train_step(cfg, mesh, lr=0.1,
                                              momentum=0.0)
    new, v, loss = step({k: t.clone() for k, t in p0.items()}, init_v(p0),
                        batch)
    out["shardmap"] = {"params": _flat(new), "loss": float(loss),
                       "velocity": v.numpy()}

    # qsgd8-compressed training with momentum, bf16 compute
    qcfg = smoke_lm(64, torch.bfloat16)
    qp = params_from_jax(qsgd_params)
    step, init_v = T.make_shardmap_train_step(qcfg, mesh, lr=0.05,
                                              momentum=0.9, compress="qsgd8")
    v = init_v(qp)
    losses = []
    for toks in qsgd_tokens:
        qp, v, loss = step(qp, v, _batch(toks))
        losses.append(float(loss))
    out["qsgd8_losses"] = losses

    # the three plans on (2, 2, 1): M = 4, pod-local first
    mesh3 = make_mesh((2, 2, 1), ("pod", "data", "model"), "cpu")
    shape = ShapeConfig("t", seq_len=16, global_batch=8, kind="train")
    opt = adamw(1e-3, grad_clip_norm=1.0)
    for gs in T.PLANS:
        plan = ShardingPlan(grad_sharding=gs)
        step = T.jit_train_step(cfg, shape, mesh3, plan, opt, None,
                                donate=False)
        state = opt.init(p0)
        new, state, metrics = step(p0, state, batch)
        layout = (type(new).__name__, type(state.mu).__name__,
                  tuple(state.mu.shape) if torch.is_tensor(state.mu) else ())
        new, state = T.gather_state(cfg, mesh3, plan, new, state)
        out[gs] = {"params": _flat(new), "loss": float(metrics["loss"]),
                   "grad_norm": float(metrics["grad_norm"]),
                   "mu": _flat(state.mu), "layout": layout}

    # train_loop on the 4 ranks, zero1, checkpointing every 2 steps
    out["train_loop"] = T.train_loop(
        smoke_lm(64, torch.bfloat16), steps=3, batch_size=8, seq_len=16,
        mesh=mesh3, plan=ShardingPlan(grad_sharding="zero1"),
        ckpt_dir=ckpt_dir, ckpt_every=2, log_every=0,
        device="cpu")["losses"]

    # MoE: the local dispatch on (2, 2) (each rank's rows of the batch
    # over "data", its d_ff block of the experts over "model") against the
    # global one on one device
    from _torch_rank_tp import forward_and_loss
    from repro_torch.core import device_agg as da
    from repro_torch.launch import partitioning as parts
    smoke = get_arch("phi3.5-moe-42b-a6.6b").smoke
    mcfg = dataclasses.replace(
        smoke, compute_dtype=torch.float32, remat=False,
        moe=dataclasses.replace(smoke.moe, capacity_factor=8.0))
    mp = params_from_jax(moe_params)
    mbatch = _batch(moe_tokens)
    res = {}
    for label, c in (("global", mcfg),
                     ("local", dataclasses.replace(mcfg,
                                                   moe_dispatch="local"))):
        if label == "global":
            logits = R.forward(mp, c, mbatch).detach().numpy()
            _, _, grads = T._value_and_grad(c, mp, mbatch)
        else:
            blocks = parts.shard_params(mp, c, mesh)
            logits, _ = forward_and_loss(mesh, c, blocks, mbatch)
            rows = T._local_batch(mbatch, {k: ("data",) for k in mbatch},
                                  mesh)
            with meshctx.use_mesh(mesh):
                _, _, grads = T._value_and_grad(c, blocks, rows)
            grads = parts.gather_params(da.pmean(mesh, grads, ("data",)), c,
                                        mesh)
        res[label] = {"logits": logits,
                      "grad_abs": float(sum(g.abs().sum() for g in
                                            grads.values())),
                      "grads": _flat(grads)}
    out["moe"] = res
    return out
