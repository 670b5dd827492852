"""Partition specs for every model family, shape kind, and plan.

Layout summary:
  * TP ("model" axis): attention heads, FFN hidden, MoE expert-FFN hidden,
    Mamba d_inner / SSD heads, vocab (embed rows / lm_head cols).
  * DP ("pod","data" axes): batch; with zero1, also the optimizer state;
    with zero3, also the parameters themselves (FSDP — all-gather on use).
  * Decode caches: batch over data; KV-head over model when divisible, else
    cache length over model (flash-decoding-style partial softmax);
    batch=1 long-context shards length over data×model.

The paper's GradsSharding maps to the zero1/zero3 rows: gradients are
reduce-scattered over the replica axes so each device owns an |θ|/M shard
of the optimizer update — O(|θ|/M) memory, the paper's bound.

A spec is a tuple with one entry a tensor dimension: ``None``
(replicated), an axis name, or a tuple of axis names (the dimension split
over all of them, the first slowest) — entry for entry the reference's
``PartitionSpec``. Every function takes a ``DeviceMesh`` or a
:class:`repro_torch.config.MeshConfig` (only the axis names and sizes
count), and a tree is a dict under the port's dotted names (nested dicts
for a cache). :func:`to_placements` turns a spec into the DTensor
placements of a mesh. The trainer (:mod:`repro_torch.launch.train`)
shards the batch and the optimizer state over the replica axes and does
not yet apply the ``model`` axis to the forward.
"""
from __future__ import annotations

from typing import Any, Mapping

from repro_torch.config import ModelConfig, ShapeConfig, ShardingPlan
from repro_torch.core.device_agg import replica_axes, replica_size
from repro_torch.launch.mesh import axis_sizes

Tree = Any


def _axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def _replica_spec(rep: tuple[str, ...]):
    return rep if len(rep) > 1 else rep[0]


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def _leaf_name(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def _param_rule(name: str, shape: tuple[int, ...], cfg: ModelConfig,
                tp: int) -> tuple:
    """Trailing-dims spec for a leaf (leading stacked-L dim padded later).

    Every rule is divisibility-guarded: a dim that the `model` axis does not
    divide falls back to the next-best layout (e.g. whisper's odd 51,865
    vocab shards d_model instead) or replication."""
    kh_ok = cfg.n_kv_heads and cfg.n_kv_heads % tp == 0
    h_ok = cfg.n_heads and cfg.n_heads % tp == 0
    d_ok = cfg.d_model % tp == 0
    v_ok = cfg.vocab % tp == 0
    f_ok = cfg.d_ff % tp == 0 if cfg.d_ff else False

    if name == "embed":
        if v_ok:
            return ("model", None)
        return (None, "model") if d_ok else (None, None)
    if name == "lm_head":
        if v_ok:
            return (None, "model")
        return ("model", None) if d_ok else (None, None)
    if name == "frontend_proj":
        return (None, None)
    if name == "router":
        return (None, None)
    if name in ("wq",):
        return (None, "model", None) if h_ok else (None, None, None)
    if name in ("wk", "wv"):
        return (None, "model", None) if kh_ok else (None, None, None)
    if name == "bq":
        return ("model", None) if h_ok else (None, None)
    if name in ("bk", "bv"):
        return ("model", None) if kh_ok else (None, None)
    if name == "wo":
        return ("model", None, None) if h_ok else (None, None, None)
    if name in ("w1", "w3"):
        if len(shape) >= 3 and cfg.moe is not None:      # (E, D, F)
            return (None, None, "model") if f_ok else (None, None, None)
        return (None, "model") if f_ok else (None, None)
    if name == "w2":
        if len(shape) >= 3 and cfg.moe is not None:      # (E, F, D)
            return (None, "model", None) if f_ok else (None, None, None)
        return ("model", None) if f_ok else (None, None)
    # --- mamba (shard the d_inner / ssd-head axis when divisible) ---
    di_ok = cfg.ssm is not None and (cfg.ssm.expand * cfg.d_model) % tp == 0
    mh_ok = (cfg.ssm is not None and cfg.ssm.head_dim
             and (cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim) % tp == 0)
    if name in ("in_x", "in_z", "dt_proj"):
        return (None, "model") if di_ok else (None, None)
    if name == "in_dt":
        return (None, "model") if mh_ok else (None, None)
    if name in ("conv_w", "conv_xw"):
        return (None, "model") if di_ok else (None, None)
    if name in ("conv_b", "conv_xb", "norm_g"):
        return ("model",) if di_ok else (None,)
    if name in ("dt_bias", "d_skip"):
        if cfg.ssm is not None and cfg.ssm.version == 2:
            return ("model",) if mh_ok else (None,)
        return ("model",) if di_ok else (None,)
    if name == "a_log":
        if len(shape) >= 2 and shape[-1] == (cfg.ssm.d_state if cfg.ssm
                                             else 0):     # mamba1 (di, ds)
            return ("model", None) if di_ok else (None, None)
        return ("model",) if mh_ok else (None,)
    if name == "x_proj":
        return ("model", None) if di_ok else (None, None)
    if name == "out_proj":
        return ("model", None) if di_ok else (None, None)
    # norms, small convs (in_b/in_c/conv_bw/...), biases: replicate
    return tuple(None for _ in shape)


def _right_aligned(name: str, shape: tuple[int, ...], cfg: ModelConfig,
                   tp: int) -> list:
    """The rule's trailing spec with leading stacked dims replicated."""
    base = _param_rule(_leaf_name(name), shape, cfg, tp)
    return [None] * (len(shape) - len(base)) + list(base)


def _shard_largest(spec: list, shape: tuple[int, ...], axes: tuple,
                   size: int) -> list:
    """Shard the largest still-replicated dim that ``size`` divides over
    ``axes`` (the FSDP / ZeRO rule)."""
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if spec[i] is None and shape[i] % size == 0 and shape[i] >= size:
            spec[i] = _replica_spec(axes)
            break
    return spec


def param_pspecs(cfg: ModelConfig, mesh, plan: ShardingPlan) -> dict:
    """``{name: spec}`` matching ``registry.param_specs(cfg)``."""
    from repro_torch.models import param_specs as _specs
    tp = _axis_size(mesh, "model")
    fsdp_axes = replica_axes(mesh) if plan.grad_sharding == "zero3" else ()
    out = {}
    for name, leaf in _specs(cfg).items():
        shape = tuple(leaf.shape)
        spec = _right_aligned(name, shape, cfg, tp)
        if fsdp_axes:
            spec = _shard_largest(spec, shape, fsdp_axes, replica_size(mesh))
        out[name] = tuple(spec)
    return out


def _map_named(fn, tree: Tree, name: str = "") -> Tree:
    """``fn(name, leaf)`` over a tree of dicts, tuples and named tuples;
    ``name`` is the leaf's dict key, or its index in a tuple (the last
    element of the reference's key path)."""
    if isinstance(tree, Mapping):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [_map_named(fn, v, str(i)) for i, v in enumerate(tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else tuple(vals)
    return fn(name, tree)


def opt_state_pspecs(cfg: ModelConfig, mesh, plan: ShardingPlan,
                     opt_state_like: Tree, params_pspecs: Tree) -> Tree:
    """Optimizer-state specs. zero1: state leaves (param-shaped)
    additionally sharded over the replica axes — the GradsSharding/ZeRO-1
    memory bound: the gradients are reduce-scattered, each replica
    updates its shard, and the parameters are all-gathered."""
    rep = replica_axes(mesh)
    rep_size = replica_size(mesh)
    tp = _axis_size(mesh, "model")

    def assign(name, leaf):
        if not hasattr(leaf, "shape") or leaf.ndim == 0:
            return ()
        shape = tuple(leaf.shape)
        spec = _right_aligned(name, shape, cfg, tp)
        if plan.grad_sharding in ("zero1", "zero3"):
            spec = _shard_largest(spec, shape, rep, rep_size)
        return tuple(spec)

    return _map_named(assign, opt_state_like)


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------

def _batch_spec(b: int, mesh):
    """The batch dim's entry: the replica axes, or None (replicated) when
    they do not divide the batch."""
    rep = replica_axes(mesh)
    rep_size = replica_size(mesh)
    if not rep or b % rep_size or b < rep_size:
        return None
    return _replica_spec(rep)


def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    bspec = _batch_spec(shape.global_batch, mesh)
    out = {"tokens": (bspec, None)}
    if shape.kind == "train":
        out["labels"] = (bspec, None)
    if cfg.is_encdec or cfg.family in ("audio",):
        if shape.kind in ("train", "prefill"):
            out["frames"] = (bspec, None, None)
    return out


def cache_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 cache_like: Tree) -> Tree:
    """Decode-cache partition specs (see module docstring)."""
    tp = _axis_size(mesh, "model")
    bspec = _batch_spec(shape.global_batch, mesh)
    batch_ok = bspec is not None
    kh_ok = cfg.n_kv_heads and cfg.n_kv_heads % tp == 0
    sizes = axis_sizes(mesh)

    def assign(name, leaf):
        nd = leaf.ndim
        if name in ("k", "v", "xk", "xv"):
            # (L, B, T, KH, hd)
            length = leaf.shape[2]
            t_ok = length % tp == 0
            if kh_ok:
                return (None, bspec, None, "model", None)
            if not batch_ok:
                # batch=1 long-context: shard cache length over everything
                axes_all = tuple(sizes)
                total = 1
                for a in axes_all:
                    total *= sizes[a]
                if length % total == 0:
                    return (None, None, axes_all, None, None)
                return (None, None, "model" if t_ok else None, None, None)
            return (None, bspec, "model" if t_ok else None, None, None)
        if name == "h":                       # mamba state
            # (L,B,di,ds) v1 | (L,B,H,hd,ds) v2
            third = "model" if leaf.shape[2] % tp == 0 else None
            return tuple([None, bspec, third] + [None] * (nd - 3))
        if name.startswith("conv"):           # (L,B,K-1,C)
            c = leaf.shape[-1]
            last = "model" if c % tp == 0 else None
            return tuple([None, bspec] + [None] * (nd - 3) + [last])
        if name == "idx":
            return ()
        return tuple([None] * nd)

    return _map_named(assign, cache_like)


def decode_token_pspec(shape: ShapeConfig, mesh) -> tuple:
    return (_batch_spec(shape.global_batch, mesh), None)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------

def to_placements(mesh, specs: Tree) -> Tree:
    """Each spec as the DTensor placements of ``mesh``: one a mesh axis,
    ``Shard(i)`` for the axis that splits tensor dim i, ``Replicate()``
    for an axis no dim names."""
    from torch.distributed.tensor import Replicate, Shard

    axes = tuple(axis_sizes(mesh))

    def one(spec: tuple) -> tuple:
        dim_of = {}
        for i, entry in enumerate(spec):
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                if ax is not None:
                    dim_of[ax] = i
        return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                     for a in axes)

    def walk(tree):
        if isinstance(tree, Mapping):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(walk(v) for v in tree))
        return one(tree)

    return walk(specs)
