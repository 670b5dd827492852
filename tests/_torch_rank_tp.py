"""Rank bodies of the tensor-parallel CPU tests (``tests/test_torch_tp.py``),
run by ``_torch_ranks.run_ranks`` in every rank of a 4-rank gloo group.

They import torch and the port only. Weights come in as the reference's
numpy trees (``convert.params_from_jax``), every rank gets the same
global batch, and what comes back (numpy arrays, numbers) is whole: the
logits joined over ``model`` and the replica axes, the parameters and
gradients gathered.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
AXES = ("data", "model")
# the forward's configs beyond the smoke ones: d_model 65 makes the flat
# vector of a rank's blocks pad; gpt2-large's odd vocabulary (255 here, as
# its 50,257) splits the embedding's d_model and the head's rows instead
OVERRIDES = {"tinyllama-1.1b": {"d_model": 65}, "gpt2-large": {"vocab": 255}}


def smoke(arch: str, **over):
    """An arch's smoke config at f32 compute, 2 layers, no remat."""
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(arch).smoke, n_layers=2,
                               remat=False, compute_dtype=torch.float32,
                               **over)


def moe_cfg(dispatch: str = "global"):
    cfg = dataclasses.replace(smoke("phi3.5-moe-42b-a6.6b"),
                              moe_dispatch=dispatch)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))


def _batch(tokens: np.ndarray) -> dict:
    t = torch.from_numpy(np.asarray(tokens, np.int64))
    return {"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()}


def _flat(tree) -> np.ndarray:
    from repro_torch.core.sharding import flatten
    return flatten(tree)[0].detach().numpy()


def _whole_rows(mesh, x: torch.Tensor, split: bool) -> torch.Tensor:
    """A rank's rows of the batch joined over the replica axes."""
    from repro_torch.core import device_agg as da
    if not split:
        return x
    return da.GatherRows.apply(x, mesh, da.replica_index(mesh))


def forward_and_loss(mesh, cfg, params, batch) -> tuple:
    """The TP forward's whole logits and the loss (the replicas' mean)."""
    from repro_torch.config import ShapeConfig
    from repro_torch.core import device_agg as da
    from repro_torch.launch import partitioning as parts
    from repro_torch.launch import train as T
    from repro_torch.models import meshctx, registry as R

    shape = ShapeConfig("t", seq_len=batch["tokens"].shape[1],
                        global_batch=batch["tokens"].shape[0], kind="train")
    specs = parts.batch_pspecs(cfg, shape, mesh)
    local = T._local_batch(batch, specs, mesh)
    with torch.no_grad(), meshctx.use_mesh(mesh):
        logits = R.forward(params, cfg, local)
        loss, _ = R.loss_fn(params, cfg, local)
    if logits.shape[-1] != cfg.vocab:       # a vocabulary block
        logits = da.all_gather_model(mesh, logits, -1)
    logits = _whole_rows(mesh, logits, specs["tokens"][0] is not None)
    loss = da.pmean(mesh, loss, da.replica_axes(mesh))
    return logits.numpy(), float(loss)


def tp_everything(rank: int, world: int, lm: dict, tokens: np.ndarray,
                  archs: dict, moe: dict, moe_tokens: np.ndarray,
                  serve: dict, serve_tokens: np.ndarray,
                  serve_mqa: dict) -> dict:
    from repro_torch import optim
    from repro_torch.config import ShapeConfig, ShardingPlan
    from repro_torch.convert import params_from_jax
    from repro_torch.core import device_agg as da
    from repro_torch.launch import partitioning as parts
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import meshctx, registry as R

    out = {"forward": {}, "roundtrip": {}, "init_local": {}, "decode": {}}
    meshes = {k: make_mesh(v, AXES, "cpu") for k, v in MESHES.items()}
    batch = _batch(tokens)

    # forward and loss, and the blocks' round trip, on both meshes
    for arch, tree in archs.items():
        cfg = smoke(arch, **OVERRIDES.get(arch, {}))
        whole = params_from_jax(tree)
        for name, mesh in meshes.items():
            blocks = parts.shard_params(whole, cfg, mesh)
            back = parts.gather_params(blocks, cfg, mesh)
            again = parts.shard_params(blocks, cfg, mesh)   # passes through
            out["roundtrip"][arch, name] = all(
                torch.equal(back[k], whole[k]) and back[k].dtype ==
                whole[k].dtype and again[k] is blocks[k] for k in whole) \
                and back.keys() == whole.keys()
            out["forward"][arch, name] = forward_and_loss(mesh, cfg, blocks,
                                                          batch)

    # init_local_params: the blocks of the one-device init
    for name, mesh in meshes.items():
        cfg = smoke("qwen3-32b")
        gen = lambda: torch.Generator().manual_seed(7)
        local = parts.init_local_params(gen(), cfg, mesh)
        want = parts.shard_params(R.init_params(gen(), cfg), cfg, mesh)
        out["init_local"][name] = all(torch.equal(local[k], want[k])
                                      for k in want) and \
            {k: tuple(t.shape) for k, t in local.items()} == \
            parts.local_param_shapes(cfg, mesh)

    # the plans on (2, 2) from the reference's weights
    mesh = meshes["2x2"]
    cfg = smoke("tinyllama-1.1b", d_model=65)
    p0 = params_from_jax(lm)
    shape = ShapeConfig("t", seq_len=16, global_batch=8, kind="train")
    opt = optim.adamw(1e-3, grad_clip_norm=1.0)
    out["plans"] = {}
    for gs in T.PLANS:
        plan = ShardingPlan(grad_sharding=gs)
        step = T.jit_train_step(cfg, shape, mesh, plan, opt, None,
                                donate=False)
        new, state, metrics = step(p0, opt.init(p0), batch)
        new, state = T.gather_state(cfg, mesh, plan, new, state)
        out["plans"][gs] = {"params": _flat(new),
                            "loss": float(metrics["loss"]),
                            "grad_norm": float(metrics["grad_norm"]),
                            "mu": _flat(state.mu)}
    # the whole gradient's norm, from the gathered gradient
    local = T._local_batch(batch, parts.batch_pspecs(cfg, shape, mesh), mesh)
    blocks = parts.shard_params(p0, cfg, mesh)
    with meshctx.use_mesh(mesh):
        _, _, grads = T._value_and_grad(cfg, blocks, local)
    grads = da.pmean(mesh, grads, da.replica_axes(mesh))
    out["whole_grad_norm"] = float(optim.global_norm(
        parts.gather_params(grads, cfg, mesh)))
    out["split_leaves"] = parts.model_sharded(cfg, mesh)

    # MoE, global and local dispatch, on (2, 2)
    mbatch = _batch(moe_tokens)
    out["moe"] = {}
    for dispatch in ("global", "local"):
        c = moe_cfg(dispatch)
        mp = parts.shard_params(params_from_jax(moe), c, mesh)
        logits, loss = forward_and_loss(mesh, c, mp, mbatch)
        shape = ShapeConfig("t", seq_len=16, global_batch=8, kind="train")
        local = T._local_batch(mbatch, parts.batch_pspecs(c, shape, mesh),
                               mesh)
        with meshctx.use_mesh(mesh):
            _, _, grads = T._value_and_grad(c, mp, local)
        grads = da.pmean(mesh, grads, da.replica_axes(mesh))
        out["moe"][dispatch] = {
            "logits": logits, "loss": loss,
            "grads": _flat(parts.gather_params(grads, c, mesh))}

    # decode through make_serve_step on both meshes (6 steps, the ring of
    # 4 slots wraps), and one kv head at batch 1 on (2, 2): the length
    # split over ("data", "model")
    for name, mesh in meshes.items():
        decode(out, name, mesh, smoke("tinyllama-1.1b"), serve,
               serve_tokens)
    decode(out, "2x2-b1", meshes["2x2"], smoke("tinyllama-1.1b",
                                                n_kv_heads=1), serve_mqa,
           serve_tokens[:1])
    return out


def decode(out, name, mesh, scfg, tree, serve_tokens) -> None:
    """6 steps of the sharded make_serve_step from a zero cache."""
    from repro_torch.config import ShapeConfig
    from repro_torch.convert import params_from_jax
    from repro_torch.launch import partitioning as parts
    from repro_torch.launch import serve as S
    from repro_torch.models import meshctx, registry as R

    sp = params_from_jax(tree)
    b, max_len = serve_tokens.shape[0], 4
    sshape = ShapeConfig("serve", seq_len=max_len, global_batch=b,
                         kind="decode")
    like = R.cache_specs(scfg, b, max_len, dtype=torch.float32)
    step = S.make_serve_step(scfg, sshape, mesh, like)
    with meshctx.use_mesh(mesh):
        cache = R.init_cache(scfg, b, max_len, dtype=torch.float32)
    steps = []
    for i in range(serve_tokens.shape[1]):
        tok = torch.from_numpy(np.asarray(serve_tokens[:, i:i + 1],
                                          np.int64))
        logits, cache = step(sp, tok, cache)
        steps.append(logits.numpy())
    specs = parts.cache_pspecs(scfg, sshape, mesh, like)
    out["decode"][name] = {
        "logits": np.stack(steps), "k_spec": specs["k"],
        "k_shape": tuple(cache["k"].shape), "idx": int(cache["idx"])}
