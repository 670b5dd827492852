"""Mixture-of-Experts MLP block: top-k routing with capacity dropping, on
torch tensors.

The reference's ``models/moe.py`` with its global dispatch. Each token's
top-k experts come from an f32 router; an assignment's slot in its
expert's buffer is an exclusive cumsum over one-hot expert counts, taken
slot first and token second (every token's first choice is placed before
any second choice), so that memory stays O(T·k + E·Cap·D). Assignments
past an expert's capacity are dropped (GShard): the residual stream
carries those tokens unchanged.

Kept ``(expert, slot)`` pairs are unique, so the dispatch is an
``index_put`` into a buffer with one spare expert row that takes every
dropped assignment and is then cut off: no atomic scatter-add. The
combine gathers each assignment's row with the expert index clamped into
range, as JAX clamps ``out_buf[e_idx, p_idx]``, and multiplies by a zero
weight where the assignment was dropped.

Under a mesh with a ``model`` axis
(:func:`repro_torch.models.meshctx.use_mesh`) each rank holds a block of
the experts' d_ff (``w1``/``w3`` column-, ``w2`` row-parallel) and routes
its own rows through it; one all-reduce over ``model`` joins the blocks.
``cfg.moe_dispatch == "local"`` runs this path under any such mesh, also
one whose ``model`` axis has one rank; the global dispatch runs it where
the weights are split. The router stays replicated.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.core import device_agg
from repro_torch.models import meshctx
from repro_torch.models.layers import dense_init, keep_whole, row_sum

#: leaves that stay f32 whatever ``cfg.param_dtype``: the router
F32_LEAVES = ("router",)


def moe_shapes(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    p = {"router": (d, e), "w1": (e, d, f), "w2": (e, f, d)}
    if cfg.gated_mlp:
        p["w3"] = (e, d, f)
    return p


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             lead: tuple = (), keep=keep_whole) -> dict:
    """The MoE weights; ``lead`` prepends axes (the layer stack);
    ``keep`` as in ``layers.attn_init``."""
    shapes = moe_shapes(cfg)
    fan_in = {"router": cfg.d_model, "w1": cfg.d_model, "w2": cfg.d_ff,
              "w3": cfg.d_model}
    return {k: keep(k, dense_init(gen, lead + shape, fan_in[k],
                                  torch.float32 if k in F32_LEAVES
                                  else dtype))
            for k, shape in shapes.items()}


def expert_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    cap = int(n_tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, -(-cap // 8) * 8)  # round up to 8


def route(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """The router's choice for x (B,S,D): ``(top_p (T,k) renormalised f32,
    top_e (T,k), flat_e (kT,), flat_pos (kT,), keep (kT,))``; the flat
    arrays are slot-major (slot j of every token, then slot j + 1)."""
    m = cfg.moe
    t = x.shape[0] * x.shape[1]
    xt = x.reshape(t, x.shape[-1])
    logits = torch.einsum("td,de->te", xt.to(torch.float32), p["router"])
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, m.top_k, dim=-1)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    flat_e = top_e.T.reshape(-1)
    onehot = F.one_hot(flat_e, m.n_experts)
    pos_in_e = torch.cumsum(onehot, dim=0) - onehot          # exclusive
    flat_pos = torch.gather(pos_in_e, 1, flat_e[:, None])[:, 0]
    keep = flat_pos < expert_capacity(t, cfg)
    return top_p, top_e, flat_e, flat_pos, keep


def moe_block(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B,S,D) -> (B,S,D). Top-k routing with capacity dropping.

    Under a mesh with a ``model`` axis whose ranks hold blocks of d_ff (or
    with ``cfg.moe_dispatch == "local"`` under any mesh with a ``model``
    axis) the dispatch runs split (:func:`_moe_block_local`): the rank's
    rows, local capacity, the expert FFN on its d_ff block and one
    all-reduce — the reference's global dispatch under GSPMD otherwise
    moves the whole (E, Cap, D) buffer every layer."""
    mesh = meshctx.get_mesh()
    has_model = mesh is not None and "model" in (mesh.mesh_dim_names or ())
    if has_model and (cfg.moe_dispatch == "local"
                      or p["w1"].shape[-1] != cfg.d_ff):
        return _moe_block_local(p, x, cfg, mesh)
    return _moe_block_global(p, x, cfg)


def _moe_block_local(p: dict, x: torch.Tensor, cfg: ModelConfig, mesh
                     ) -> torch.Tensor:
    """The split dispatch: this rank's rows (the same on every rank of its
    ``model`` group) routed through its d_ff block of the experts
    (``w1``/``w3`` column-, ``w2`` row-parallel), one all-reduce over
    ``model``. The gradients of x and of the replicated router are summed
    over the ``model`` ranks, each of which holds one part of them."""
    from repro_torch.launch.mesh import axis_sizes
    tp = axis_sizes(mesh)["model"]
    if p["w1"].shape[-1] * tp != cfg.d_ff:
        raise ValueError(f"the model axis ({tp}) must hold d_ff "
                         f"({cfg.d_ff}) in blocks of {p['w1'].shape[-1]}: "
                         f"shard the weights (partitioning.shard_params)")
    model = mesh.get_group("model")
    x = device_agg.SumGrad.apply(x, (model,))
    pl = dict(p, router=device_agg.SumGrad.apply(p["router"], (model,)))
    return row_sum(_moe_block_global(pl, x, cfg), model)


def _moe_block_global(p: dict, x: torch.Tensor, cfg: ModelConfig
                      ) -> torch.Tensor:
    cd = cfg.compute_dtype
    b, s, d = x.shape
    t = b * s
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    cap = expert_capacity(t, cfg)
    top_p, _, flat_e, flat_pos, keep = route(p, x, cfg)

    # dispatch into (E + 1, Cap, D): row E takes the dropped assignments
    src = x.reshape(t, d).to(cd).repeat(k, 1)                 # (kT, D)
    e_idx = torch.where(keep, flat_e, e)
    p_idx = torch.where(keep, flat_pos, 0)
    buf = torch.zeros((e + 1, cap, d), dtype=cd, device=x.device)
    buf = buf.index_put((e_idx, p_idx), src)[:e]

    # the experts' FFN, batched over experts
    h = torch.einsum("ecd,edf->ecf", buf, p["w1"].to(cd))
    if cfg.gated_mlp:
        g = torch.einsum("ecd,edf->ecf", buf, p["w3"].to(cd))
        h = F.silu(h) * g
    else:
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
    out_buf = torch.einsum("ecf,efd->ecd", h, p["w2"].to(cd))

    # combine: a dropped assignment reads a clamped row at weight 0
    gathered = out_buf[torch.clamp(e_idx, max=e - 1), p_idx]
    flat_w = top_p.T.reshape(-1).to(torch.float32)
    gathered = gathered.to(torch.float32) * torch.where(
        keep, flat_w, torch.zeros_like(flat_w))[:, None]
    combined = torch.sum(gathered.reshape(k, t, d), dim=0)
    return combined.reshape(b, s, d).to(x.dtype)
