"""Decoder-only LM stack on torch tensors: the dense, MoE, VLM, SSM and
hybrid families.

Parameters are a flat dict of tensors (a state dict) under the reference
tree's names, joined with dots, and in its **stacked** layout: every layer
weight carries a leading ``n_layers`` axis (``layers.attn.wq`` is one
``(n_layers, d, heads, head_dim)`` tensor), and layer ``i`` reads index
``i`` of each. So the port's flat parameter vector
(:func:`repro_torch.core.sharding.flatten`) is the reference's element for
element. :class:`Transformer` holds the same tensors as an ``nn.Module``
whose ``named_parameters()`` are those names.

* dense and vlm (early fusion: image tokens share the vocabulary): an
  attention block and an MLP per layer; moe: the MLP is a top-k MoE
  (:mod:`repro_torch.models.moe`);
* ssm: a Mamba-1 block per layer (:mod:`repro_torch.models.ssm`);
* hybrid (zamba2): Mamba-2 layers, and after every ``attn_every`` of them
  one transformer block whose weights all groups share
  (``shared_attn.*``).

The layers run in a Python loop (the reference's ``lax.scan`` has no
counterpart to keep); ``cfg.remat`` checkpoints each layer (and each
application of the shared block) with ``torch.utils.checkpoint``.
One-token decode (:func:`decode_step`) runs against a cache dict: ``idx``
(0-d int32), ``k``/``v`` of shape (A, B, W, KH, hd) for the A attention
blocks, whose ring buffer holds ``W = min(max_len, sliding_window)``
positions (A = ``n_layers // attn_every`` for the hybrid family, none for
ssm), and for the Mamba layers a nested ``mamba`` dict of per-layer
stacks: ``{"h", "conv"}`` (Mamba-1) or ``{"h", "conv_x", "conv_b",
"conv_c"}`` (Mamba-2). The encoder-decoder models live in
:mod:`repro_torch.models.encdec`.
"""
from __future__ import annotations

from typing import Mapping

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import meshctx
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM


def _join(prefix: str, tree: Mapping) -> dict:
    """A nested dict as a flat dict under dotted names."""
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_join(name + ".", val))
        else:
            out[name] = val
    return out


# ---------------------------------------------------------------------------
# Parameter shapes / init
# ---------------------------------------------------------------------------

DECODER_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid")
_ATTN_FAMILIES = ("dense", "moe", "vlm")


def _check_family(cfg: ModelConfig) -> None:
    """Raise for a family this module does not hold."""
    if cfg.family not in DECODER_FAMILIES:
        raise ValueError(f"{cfg.name}: no decoder-only family "
                         f"{cfg.family!r}")


def _layer_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    if cfg.family == "ssm":
        return {"ln": (d,), "mamba": SSM.mamba1_shapes(cfg)}
    if cfg.family == "hybrid":
        return {"ln": (d,), "mamba": SSM.mamba2_shapes(cfg)}
    p = {"ln1": (d,), "attn": L.attn_shapes(cfg), "ln2": (d,)}
    if cfg.moe is not None:
        p["moe"] = MOE.moe_shapes(cfg)
    else:
        p["mlp"] = L.mlp_shapes(cfg)
    return p


def _shared_attn_shapes(cfg: ModelConfig) -> dict:
    """The hybrid family's one shared transformer block (attention + MLP)."""
    d = cfg.d_model
    return {"ln1": (d,), "attn": L.attn_shapes(cfg), "ln2": (d,),
            "mlp": L.mlp_shapes(cfg)}


def param_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    """Every parameter's name and shape, stacked layers included."""
    _check_family(cfg)
    n = (cfg.n_layers,)
    p = {"embed": (cfg.vocab, cfg.d_model)}
    p.update({k: n + s for k, s in _join("layers.", _layer_shapes(cfg))
              .items()})
    p["final_norm"] = (cfg.d_model,)
    if not cfg.tie_embeddings:
        p["lm_head"] = (cfg.d_model, cfg.vocab)
    if cfg.family == "hybrid":
        p.update(_join("shared_attn.", _shared_attn_shapes(cfg)))
    return p


def _block_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
                lead: tuple, moe: bool, keep=L.keep_whole) -> dict:
    """An attention block's parameters (norms, attention, MLP or MoE)."""
    ones = torch.ones(lead + (cfg.d_model,), dtype=dtype, device=gen.device)
    p = {"ln1": ones, "attn": L.attn_init(gen, cfg, dtype, lead=lead,
                                          keep=keep),
         "ln2": ones.clone()}
    if moe:
        p["moe"] = MOE.moe_init(gen, cfg, dtype, lead=lead, keep=keep)
    else:
        p["mlp"] = L.mlp_init(gen, cfg, dtype, lead=lead, keep=keep)
    return p


def _layer_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
                n: int, keep=L.keep_whole) -> dict:
    """``n`` layers' parameters, stacked on a leading axis."""
    if cfg.family in ("ssm", "hybrid"):
        init = SSM.mamba1_init if cfg.family == "ssm" else SSM.mamba2_init
        return {"ln": torch.ones((n, cfg.d_model), dtype=dtype,
                                 device=gen.device),
                "mamba": init(gen, cfg, dtype, lead=(n,), keep=keep)}
    return _block_init(gen, cfg, dtype, (n,), cfg.moe is not None, keep)


def init_params(gen: torch.Generator, cfg: ModelConfig,
                keep=L.keep_whole) -> dict:
    """Seeded parameters on the generator's device. A ``torch.Generator``
    does not replay ``jax.random``: to compute with the reference's
    weights, carry them over with ``convert.params_from_jax``.
    ``keep(leaf, tensor)`` takes each drawn weight and returns what is kept
    of it (``partitioning.init_local_params``: a rank's block); the draws
    are the same whatever it keeps."""
    _check_family(cfg)
    dt = cfg.param_dtype
    p = {"embed": keep("embed", L.embed_init(gen, (cfg.vocab, cfg.d_model),
                                             dt))}
    p.update(_join("layers.", _layer_init(gen, cfg, dt, cfg.n_layers, keep)))
    p["final_norm"] = torch.ones((cfg.d_model,), dtype=dt, device=gen.device)
    if not cfg.tie_embeddings:
        p["lm_head"] = keep("lm_head", L.embed_init(
            gen, (cfg.d_model, cfg.vocab), dt))
    if cfg.family == "hybrid":
        p.update(_join("shared_attn.", _block_init(gen, cfg, dt, (), False,
                                                   keep)))
    return p


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _unstack(params: Mapping[str, torch.Tensor], n: int,
             prefix: str = "layers.") -> list[dict]:
    """Per-layer nested dicts of views into the stacked ``prefix*``
    tensors. ``unbind`` gives one backward node per tensor, which stacks
    the layers' gradients once."""
    out: list[dict] = [{} for _ in range(n)]
    for name, stacked in params.items():
        if not name.startswith(prefix):
            continue
        *path, leaf = name[len(prefix):].split(".")
        for lp, t in zip(out, stacked.unbind(0)):
            _nest_into(lp, path)[leaf] = t
    return out


def _nest_into(node: dict, path) -> dict:
    for part in path:
        node = node.setdefault(part, {})
    return node


def _nest(params: Mapping[str, torch.Tensor], prefix: str) -> dict:
    """The ``prefix*`` tensors as a nested dict (no layer axis)."""
    out: dict = {}
    for name, t in params.items():
        if name.startswith(prefix):
            *path, leaf = name[len(prefix):].split(".")
            _nest_into(out, path)[leaf] = t
    return out


def _run(fn, cfg: ModelConfig, *args):
    """``fn(*args)``, checkpointed when ``cfg.remat``."""
    if cfg.remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _attn_mlp_layer(lp: dict, x: torch.Tensor, cfg: ModelConfig, positions
                    ) -> torch.Tensor:
    """A transformer block: attention, then the MLP or the MoE (the
    hybrid family's shared block is one of these)."""
    h = L.self_attention_block(lp["attn"], L.rmsnorm(x, lp["ln1"],
                                                     cfg.norm_eps),
                               cfg, positions=positions)
    x = x + h
    xi = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    if "moe" in lp:
        return x + MOE.moe_block(lp["moe"], xi, cfg)
    return x + L.mlp_block(lp["mlp"], xi, cfg)


def _mamba_layer(lp: dict, x: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    block = SSM.mamba1_block if cfg.ssm.version == 1 else SSM.mamba2_block
    h, _ = block(lp["mamba"], L.rmsnorm(x, lp["ln"], cfg.norm_eps), cfg)
    return x + h


def forward(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B,S) integer -> logits (B,S,V) in the compute dtype.

    Under a mesh (``meshctx``) whose ``model`` axis splits the weights
    (``partitioning.shard_params``) the forward is tensor-parallel, every
    family alike (the Mamba blocks: :mod:`repro_torch.models.ssm`), and the
    logits are this rank's vocabulary block (B,S,V/tp), as the LM head
    holds it; ``device_agg.all_gather_model(mesh, logits, -1)`` joins
    them."""
    _check_family(cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = L.embed_tokens(params["embed"], tokens, cfg.compute_dtype, cfg)
    layers = _unstack(params, cfg.n_layers)
    if cfg.family in _ATTN_FAMILIES:
        for lp in layers:
            x = _run(_attn_mlp_layer, cfg, lp, x, cfg, positions)
    else:
        # hybrid: after every ``attn_every`` Mamba-2 layers, the shared block
        every = cfg.attn_every if cfg.family == "hybrid" else 0
        shared = _nest(params, "shared_attn.")
        for i, lp in enumerate(layers):
            x = _run(_mamba_layer, cfg, lp, x, cfg)
            if every and (i + 1) % every == 0:
                x = _run(_attn_mlp_layer, cfg, shared, x, cfg, positions)
    return _logits(params, cfg, x)


def _logits(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
            x: torch.Tensor) -> torch.Tensor:
    """The final norm and the LM head."""
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.lm_logits(x, head, cfg.compute_dtype, cfg)


# ---------------------------------------------------------------------------
# Decode (one token against the cache)
# ---------------------------------------------------------------------------

def map_tree(fn, tree: Mapping) -> dict:
    """``fn`` applied to every tensor of a nested dict."""
    return {k: map_tree(fn, v) if isinstance(v, Mapping) else fn(v)
            for k, v in tree.items()}


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """The decode cache's tensors on the ``meta`` device (shapes and types,
    no storage): a K/V ring buffer of ``W = min(max_len, sliding_window)``
    slots per attention block, and per Mamba layer the SSM state and conv
    histories (:func:`ssm.mamba_cache_specs`) under ``mamba``. Under a
    mesh (``meshctx``) each tensor is this rank's block by
    ``partitioning.cache_pspecs`` (batch over the replica axes, kv heads
    or the ring's length over ``model``)."""
    whole = _whole_cache_specs(cfg, batch, max_len, dtype)
    mesh = meshctx.get_mesh()
    if mesh is None:
        return whole
    from repro_torch.config import ShapeConfig
    from repro_torch.launch import partitioning as parts
    specs = parts.cache_pspecs(
        cfg, ShapeConfig("serve", seq_len=max_len, global_batch=batch,
                         kind="decode"), mesh, whole)

    def local(spec, t):
        if isinstance(t, Mapping):
            return {k: local(spec[k], v) for k, v in t.items()}
        return torch.empty(parts.local_shape(spec, t.shape, mesh, False),
                           dtype=t.dtype, device=t.device)

    return local(specs, whole)


def _whole_cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                       dtype: torch.dtype) -> dict:
    _check_family(cfg)
    w = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    meta = torch.device("meta")
    c: dict = {"idx": torch.empty((), dtype=torch.int32, device=meta)}
    if cfg.family in ("ssm", "hybrid"):
        c["mamba"] = map_tree(
            lambda t: torch.empty((cfg.n_layers,) + tuple(t.shape),
                                  dtype=t.dtype, device=meta),
            SSM.mamba_cache_specs(cfg, batch, dtype))
    n_attn = {"ssm": 0, "hybrid": cfg.n_layers // max(1, cfg.attn_every)
              }.get(cfg.family, cfg.n_layers)
    if n_attn:
        kv = (n_attn, batch, w, cfg.n_kv_heads, cfg.resolved_head_dim)
        c["k"] = torch.empty(kv, dtype=dtype, device=meta)
        c["v"] = torch.empty(kv, dtype=dtype, device=meta)
    return c


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cpu") -> dict:
    """An empty decode cache (zeros, ``idx`` 0) on ``device``."""
    return map_tree(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device),
                    cache_specs(cfg, batch, max_len, dtype))


def _mamba_decode_layer(lp: dict, x: torch.Tensor, mc: dict,
                        cfg: ModelConfig) -> torch.Tensor:
    """One Mamba layer's single-token step; writes the layer's new state
    and conv histories into its cache views ``mc`` in place."""
    v1 = cfg.ssm.version == 1
    block = SSM.mamba1_block if v1 else SSM.mamba2_block
    conv = mc["conv"] if v1 else \
        {"x": mc["conv_x"], "b": mc["conv_b"], "c": mc["conv_c"]}
    h, (h_new, conv_new) = block(
        lp["mamba"], L.rmsnorm(x, lp["ln"], cfg.norm_eps), cfg,
        h0=mc["h"], conv_cache=conv, single_step=True)
    mc["h"].copy_(h_new)
    if v1:
        mc["conv"].copy_(conv_new)
    else:
        for key in ("x", "b", "c"):
            mc["conv_" + key].copy_(conv_new[key])
    return x + h


def _decode_block(lp: dict, x: torch.Tensor, cfg: ModelConfig, kc, vc, idx,
                  length_axes: tuple = ()) -> torch.Tensor:
    """A transformer block's single-token step against its K/V ring."""
    x = x + L.decode_attention_block(
        lp["attn"], L.rmsnorm(x, lp["ln1"], cfg.norm_eps), cfg,
        k_cache=kc, v_cache=vc, idx=idx, length_axes=length_axes)
    xi = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    if "moe" in lp:
        return x + MOE.moe_block(lp["moe"], xi, cfg)
    return x + L.mlp_block(lp["mlp"], xi, cfg)


def decode_step(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
                tokens: torch.Tensor, cache: dict, length_axes: tuple = ()):
    """tokens (B,1) -> (logits (B,1,V), cache). Writes this token's keys and
    values (and every Mamba layer's state) into ``cache`` and advances its
    ``idx``, in place (the reference's donated cache), and returns the
    same dict. The conv histories keep the cache's type.

    Under a mesh (``meshctx``) the step is tensor-parallel on this rank's
    blocks (see :func:`forward`: the logits are its vocabulary block), the
    cache is its block (:func:`cache_specs`) and ``length_axes`` names the
    mesh axes that split the ring's length
    (``partitioning.kv_length_axes``), () when none does."""
    _check_family(cfg)
    idx = cache["idx"]
    x = L.embed_tokens(params["embed"], tokens, cfg.compute_dtype, cfg)
    layers = _unstack(params, cfg.n_layers)
    if cfg.family in _ATTN_FAMILIES:
        for lp, kc, vc in zip(layers, cache["k"], cache["v"]):
            x = _decode_block(lp, x, cfg, kc, vc, idx, length_axes)
    else:
        every = cfg.attn_every if cfg.family == "hybrid" else 0
        shared = _nest(params, "shared_attn.")
        for i, lp in enumerate(layers):
            x = _mamba_decode_layer(lp, x, map_tree(lambda t: t[i],
                                                    cache["mamba"]), cfg)
            if every and (i + 1) % every == 0:
                g = (i + 1) // every - 1
                x = _decode_block(shared, x, cfg, cache["k"][g],
                                  cache["v"][g], idx, length_axes)
    idx.add_(1)
    return _logits(params, cfg, x), cache


def loss_fn(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
            batch: Mapping[str, torch.Tensor]):
    logits = forward(params, cfg, batch["tokens"])
    loss = L.cross_entropy(logits, batch["labels"], batch.get("mask"),
                           vocab=cfg.vocab)
    return loss, {"loss": loss}


class Transformer(nn.Module):
    """The decoder LM as an ``nn.Module``: ``named_parameters()`` are the
    reference tree's dotted names in its stacked layout, so
    ``dict(model.named_parameters())`` is a parameter dict of this module's
    functions."""

    def __init__(self, cfg: ModelConfig, params: Mapping[str, torch.Tensor]):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        for name, tensor in params.items():
            *path, leaf = name.split(".")
            mod: nn.Module = self
            for part in path:
                if part not in mod._modules:
                    mod.add_module(part, nn.Module())
                mod = mod._modules[part]
            mod.register_parameter(leaf, nn.Parameter(tensor))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(dict(self.named_parameters()), self.cfg, tokens)

    def loss(self, batch: Mapping[str, torch.Tensor]):
        return loss_fn(dict(self.named_parameters()), self.cfg, batch)
