"""Rank bodies of the SSM, hybrid and encoder-decoder tensor-parallel CPU
tests (``tests/test_torch_tp_families.py``), run by
``_torch_ranks.run_ranks`` in every rank of a 4-rank gloo group, and of the
8-rank plan check of ``tests/test_torch_tp.py``.

They import torch and the port only. Weights come in as the reference's
numpy trees (``convert.params_from_jax``), every rank gets the same global
batch, and what comes back is whole: logits joined over ``model`` and the
replica axes, parameters gathered.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from _torch_rank_tp import AXES, MESHES, _batch, _flat, forward_and_loss

ARCHS = ("falcon-mamba-7b", "zamba2-2.7b", "whisper-tiny")
#: beyond each arch's smoke config: whisper at 6 heads (they split over 2
#: ranks, not 4) and an odd vocabulary of 255 (the d_model-split embedding
#: and the row-parallel head, as at 51,865); zamba2 keeps its smoke depth
#: of 4 (two shared-block calls)
OVERRIDES = {"falcon-mamba-7b": {"n_layers": 2}, "zamba2-2.7b": {},
             "whisper-tiny": {"n_layers": 2, "n_heads": 6, "n_kv_heads": 6,
                              "vocab": 255}}
DECODE_STEPS, DECODE_BATCH, DECODE_LEN = 6, 4, 4
PLAN_SHAPE = dict(seq_len=16, global_batch=8, kind="train")


def family_cfg(arch: str):
    """An arch's smoke config at f32 compute, no remat."""
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(arch).smoke, remat=False,
                               compute_dtype=torch.float32,
                               **OVERRIDES[arch])


def _with_frames(batch: dict, frames) -> dict:
    if frames is not None:
        batch["frames"] = torch.from_numpy(np.asarray(frames, np.float32))
    return batch


def decode(mesh, cfg, params, tokens, frames) -> dict:
    """DECODE_STEPS steps of the sharded make_serve_step from an empty cache
    (an encoder-decoder's cross-attention cache built from ``frames``
    under the mesh): the whole logits of every step and the cache's
    layout."""
    from repro_torch.config import ShapeConfig
    from repro_torch.launch import partitioning as parts
    from repro_torch.launch import serve as S
    from repro_torch.models import encdec, meshctx, registry as R

    b, max_len = tokens.shape[0], DECODE_LEN
    shape = ShapeConfig("serve", seq_len=max_len, global_batch=b,
                        kind="decode")
    family = encdec if R.is_encdec(cfg) else R
    like = family.cache_specs(cfg, b, max_len, dtype=torch.float32)
    step = S.make_serve_step(cfg, shape, mesh, like)
    with meshctx.use_mesh(mesh):
        if R.is_encdec(cfg):
            cache = encdec.init_cache(
                cfg, b, max_len, params=params, dtype=torch.float32,
                frames=torch.from_numpy(np.asarray(frames, np.float32)))
        else:
            cache = R.init_cache(cfg, b, max_len, dtype=torch.float32)
    steps = []
    for i in range(tokens.shape[1]):
        tok = torch.from_numpy(np.asarray(tokens[:, i:i + 1], np.int64))
        logits, cache = step(params, tok, cache)
        steps.append(logits.numpy())
    specs = parts.cache_pspecs(cfg, shape, mesh, like)
    return {"logits": np.stack(steps), "specs": specs,
            "shapes": {k: tuple(v.shape) for k, v in _leaves(cache)},
            "idx": int(cache["idx"])}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def split_norm(mesh) -> dict:
    """The split gated norm on the ``model`` ranks: each rank's block of a
    seeded (rows, 4·16) row, forward and backward through
    ``layers.rmsnorm_split``, beside the whole-row ``layers.rmsnorm`` on
    the whole row (this rank's block of its output and gradients)."""
    from repro_torch.models import layers as L
    from repro_torch.models import meshctx

    ax = None
    with meshctx.use_mesh(mesh):
        ax = meshctx.model_axis()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        rng = np.random.default_rng(5)
        x = torch.from_numpy(rng.standard_normal((6, 64)).astype(
            np.float32) * 3).to(dtype)
        g = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
        dy = torch.from_numpy(rng.standard_normal((6, 64)).astype(
            np.float32)).to(dtype)
        lo, hi = ax.index * 16, (ax.index + 1) * 16
        xw, gw = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
        whole = L.rmsnorm(xw, gw, 1e-5)
        whole.backward(dy)
        xb = x[:, lo:hi].clone().requires_grad_(True)
        gb = g[lo:hi].clone().requires_grad_(True)
        split = L.rmsnorm_split(xb, gb, 1e-5, 64, ax.group)
        split.backward(dy[:, lo:hi])
        out[str(dtype)] = {
            "out": (split.detach().float().numpy(),
                    whole.detach()[:, lo:hi].float().numpy()),
            "dx": (xb.grad.float().numpy(), xw.grad[:, lo:hi].float().numpy()),
            "dg": (gb.grad.numpy(), gw.grad[lo:hi].numpy())}
    return out


def tp_families(rank: int, world: int, archs: dict, tokens: np.ndarray,
                frames: np.ndarray, decode_tokens: np.ndarray) -> dict:
    """Every arch on both meshes: the forward's logits and loss, the three
    plans' step from the reference's weights, the sharded decode; and the
    split gated norm on (1, 4)'s model group."""
    from repro_torch import optim
    from repro_torch.config import ShapeConfig, ShardingPlan
    from repro_torch.convert import params_from_jax
    from repro_torch.launch import partitioning as parts
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry as R

    meshes = {k: make_mesh(v, AXES, "cpu") for k, v in MESHES.items()}
    shape = ShapeConfig("t", **PLAN_SHAPE)
    opt = optim.adamw(1e-3, grad_clip_norm=1.0)
    out = {"forward": {}, "plans": {}, "decode": {}, "blocks": {}}
    for arch, tree in archs.items():
        cfg = family_cfg(arch)
        whole = params_from_jax(tree)
        encdec = R.is_encdec(cfg)
        batch = _with_frames(_batch(tokens), frames if encdec else None)
        for name, mesh in meshes.items():
            blocks = parts.shard_params(whole, cfg, mesh)
            out["blocks"][arch, name] = parts.model_sharded(cfg, mesh)
            out["forward"][arch, name] = forward_and_loss(mesh, cfg, blocks,
                                                          batch)
            for gs in T.PLANS:
                plan = ShardingPlan(grad_sharding=gs)
                step = T.jit_train_step(cfg, shape, mesh, plan, opt, None,
                                        donate=False)
                new, state, metrics = step(whole, opt.init(whole), batch)
                new, _ = T.gather_state(cfg, mesh, plan, new, state)
                out["plans"][arch, name, gs] = {
                    "params": _flat(new), "loss": float(metrics["loss"])}
            out["decode"][arch, name] = decode(
                mesh, cfg, blocks, decode_tokens,
                frames[:DECODE_BATCH] if encdec else None)
    out["split_norm"] = split_norm(meshes["1x4"])
    return out


def plans_8(rank: int, world: int, lm: dict, tokens: np.ndarray) -> dict:
    """The three plans on (2, 2, 2) ("pod", "data", "model"): tinyllama's
    smoke config at 2 layers and f32, AdamW at 1e-3, one step from the
    reference's weights (``tests/test_distributed.py``'s plan check)."""
    from repro_torch import optim
    from repro_torch.config import ShapeConfig, ShardingPlan
    from repro_torch.convert import params_from_jax
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    from _torch_rank_tp import smoke

    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    cfg = smoke("tinyllama-1.1b")
    p0 = params_from_jax(lm)
    shape = ShapeConfig("t", **PLAN_SHAPE)
    opt = optim.adamw(1e-3)
    out = {}
    for gs in T.PLANS:
        plan = ShardingPlan(grad_sharding=gs)
        step = T.jit_train_step(cfg, shape, mesh, plan, opt, None,
                                donate=False)
        new, state, metrics = step(p0, opt.init(p0), _batch(tokens))
        new, _ = T.gather_state(cfg, mesh, plan, new, state)
        out[gs] = {"params": _flat(new), "loss": float(metrics["loss"])}
    return out
