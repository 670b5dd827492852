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
placements of a mesh.

A rank holds the block of each leaf that its coordinates pick
(:func:`model_block`, :func:`rank_block`). The trainer
(:mod:`repro_torch.launch.train`) and the server
(:mod:`repro_torch.launch.serve`) shard the batch over the replica axes
and every weight over ``model`` by :func:`param_pspecs`
(:func:`shard_params`, :func:`init_local_params`); the forward of every
family then runs tensor-parallel with explicit collectives
(:mod:`repro_torch.core.device_agg`). What ``model`` does not divide stays
whole, as in the reference.

Two layouts differ from the reference's, with the same numbers (under
GSPMD a layout is only storage; a port rank computes on its blocks):

* a Mamba-2 cache's B and C conv histories (``conv_b``, ``conv_c``, C =
  d_state) stay whole on every rank, where the reference splits them over
  ``model`` whenever d_state divides: a port rank computes B and C whole
  (``in_b``, ``in_c`` are replicated);
* Mamba-2's stacked ``a_log`` (L, H) splits its heads, where the
  reference, which tells Mamba-1's (di, ds) from it by the last dim,
  splits the layer axis when H equals d_state (zamba2's smoke width: 8
  heads, d_state 8; at full width 80 and 64).
"""
from __future__ import annotations

import math
from typing import Any, Mapping

import torch

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
        # Mamba-1's (di, ds) or Mamba-2's (H,), told apart by the version:
        # the reference tells them by the shape, which reads a stacked
        # Mamba-2 (L, H) as (di, ds) when H == d_state (ROADMAP §3)
        if cfg.ssm is not None and cfg.ssm.version == 1:
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
        if name in ("conv_b", "conv_c"):      # Mamba-2's B/C: whole
            return tuple([None, bspec] + [None] * (nd - 2))
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
# A rank's blocks
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def block_index(mesh, axes: tuple[str, ...]) -> tuple[int, int]:
    """``(index, count)``: this rank's block of a dim split over ``axes``,
    counted in their order (the first slowest), and the number of
    blocks."""
    sizes = axis_sizes(mesh)
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx, math.prod(sizes[a] for a in axes)


def _blocks(spec: tuple, shape, mesh, pick) -> tuple[slice, ...]:
    """Each dim's slice for the rank, over the entries ``pick`` takes
    (:func:`block_index` of the entry's axes)."""
    out = []
    for entry, n in zip(spec, shape):
        axes = _entry_axes(entry)
        if not axes or not pick(axes):
            out.append(slice(None))
            continue
        idx, count = block_index(mesh, axes)
        width = n // count
        out.append(slice(idx * width, (idx + 1) * width))
    return tuple(out)


def model_block(spec: tuple, shape, mesh) -> tuple[slice, ...]:
    """The slice of each dim whose entry names ``model`` (alone, or in a
    tuple of axes, where the block follows the tuple's order); every other
    dim whole."""
    return _blocks(spec, shape, mesh, lambda axes: "model" in axes)


def rank_block(spec: tuple, shape, mesh) -> tuple[slice, ...]:
    """The slice of every dim that the spec splits, over any axes."""
    return _blocks(spec, shape, mesh, lambda axes: True)


def local_shape(spec: tuple, shape, mesh, model_only: bool = True
                ) -> tuple[int, ...]:
    """The shape of a rank's block (:func:`model_block`, or
    :func:`rank_block` with ``model_only=False``); needs only the axis
    sizes, so a ``MeshConfig`` will do."""
    sizes = axis_sizes(mesh)
    out = []
    for entry, n in zip(spec, shape):
        axes = _entry_axes(entry)
        if model_only and "model" not in axes:
            axes = ()
        out.append(n // math.prod(sizes[a] for a in axes))
    return tuple(out)


def _tp_specs(cfg: ModelConfig, mesh, plan: ShardingPlan | None) -> dict:
    return param_pspecs(cfg, mesh, plan or ShardingPlan(grad_sharding="none"))


def local_param_shapes(cfg: ModelConfig, mesh,
                       plan: ShardingPlan | None = None) -> dict:
    """``{name: shape}`` of a rank's ``model``-axis block of each leaf."""
    from repro_torch.models.registry import param_shapes
    specs = _tp_specs(cfg, mesh, plan)
    return {name: local_shape(specs[name], shape, mesh)
            for name, shape in param_shapes(cfg).items()}


def model_sharded(cfg: ModelConfig, mesh,
                  plan: ShardingPlan | None = None) -> dict:
    """``{name: True}`` for each leaf split over ``model`` (a ``model``
    axis of one rank splits none)."""
    specs = _tp_specs(cfg, mesh, plan)
    tp = _axis_size(mesh, "model")
    return {name: tp > 1 and any("model" in _entry_axes(e) for e in spec)
            for name, spec in specs.items()}


def shard_params(params: Mapping, cfg: ModelConfig, mesh,
                 plan: ShardingPlan | None = None) -> dict:
    """Each whole leaf cut to this rank's ``model``-axis block (a copy); a
    leaf already of its block's shape stays as it is, so a tree of blocks
    passes through (as does every leaf when ``model`` has one rank)."""
    specs = _tp_specs(cfg, mesh, plan)
    local = local_param_shapes(cfg, mesh, plan)
    out = {}
    for name, t in params.items():
        if tuple(t.shape) == local[name]:
            out[name] = t
        else:
            out[name] = t[model_block(specs[name], t.shape, mesh)].clone()
    return out


def gather_params(params: Mapping, cfg: ModelConfig, mesh,
                  plan: ShardingPlan | None = None) -> dict:
    """The inverse of :func:`shard_params`: every leaf whole on every rank
    (an all-gather over ``model`` of each split leaf)."""
    from repro_torch.core.device_agg import all_gather_model
    specs = model_sharded(cfg, mesh, plan)
    pspecs = _tp_specs(cfg, mesh, plan)
    out = {}
    for name, t in params.items():
        if not specs[name]:
            out[name] = t
            continue
        dim = next(i for i, e in enumerate(pspecs[name])
                   if "model" in _entry_axes(e))
        out[name] = all_gather_model(mesh, t.detach(), dim)
    return out


def init_local_params(gen: torch.Generator, cfg: ModelConfig, mesh,
                      plan: ShardingPlan | None = None) -> dict:
    """This rank's blocks of ``init_params(gen, cfg)``: each leaf drawn
    whole in ``init_params``' order, its block kept and the rest freed
    before the next draw, so the blocks are those of the one-device init
    and the peak is one whole leaf beside the blocks."""
    from repro_torch.models import registry
    if _axis_size(mesh, "model") == 1:
        return registry.init_params(gen, cfg)
    tp = _axis_size(mesh, "model")

    def keep(leaf: str, t: torch.Tensor) -> torch.Tensor:
        spec = _right_aligned(leaf, tuple(t.shape), cfg, tp)
        if tuple(t.shape) == local_shape(spec, t.shape, mesh):
            return t
        return t[model_block(spec, t.shape, mesh)].clone()

    return registry.init_params(gen, cfg, keep=keep)


def kv_length_axes(cache_specs_tree: Mapping, key: str = "k"
                   ) -> tuple[str, ...]:
    """The mesh axes that split a decode cache's length (the third entry of
    its ``key`` spec: ``k`` for the self-attention ring, ``xk`` for an
    encoder-decoder's cross-attention cache), () when none does."""
    spec = cache_specs_tree.get(key)
    return _entry_axes(spec[2]) if spec else ()


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
