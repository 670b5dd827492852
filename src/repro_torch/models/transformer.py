"""Decoder-only LM stack, dense family, on torch tensors.

Parameters are a flat dict of tensors (a state dict) under the reference
tree's names, joined with dots, and in its **stacked** layout: every layer
weight carries a leading ``n_layers`` axis (``layers.attn.wq`` is one
``(n_layers, d, heads, head_dim)`` tensor), and layer ``i`` reads index
``i`` of each. So the port's flat parameter vector
(:func:`repro_torch.core.sharding.flatten`) is the reference's element for
element. :class:`Transformer` holds the same tensors as an ``nn.Module``
whose ``named_parameters()`` are those names.

The layers run in a Python loop (the reference's ``lax.scan`` has no
counterpart to keep); ``cfg.remat`` checkpoints each layer with
``torch.utils.checkpoint``. One-token decode (:func:`decode_step`) runs
against a KV cache, a dict ``{"idx": 0-d int32, "k", "v": (L, B, W, KH,
hd)}`` whose ring buffer holds ``W = min(max_len, sliding_window)``
positions. The MoE, SSM and hybrid families and the encoder-decoder
models are not ported yet (ROADMAP queue 1, item 3) and raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Mapping

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.moe is not None or cfg.ssm is not None \
            or cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; the port "
            f"runs the dense decoder only (ROADMAP queue 1, item 3)")


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

def _layer_shapes(cfg: ModelConfig) -> dict:
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
    return p


def _layer_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
                n: int) -> dict:
    """``n`` layers' parameters, stacked on a leading axis."""
    ones = torch.ones((n, cfg.d_model), dtype=dtype, device=gen.device)
    return {"ln1": ones,
            "attn": L.attn_init(gen, cfg, dtype, lead=(n,)),
            "ln2": ones.clone(),
            "mlp": L.mlp_init(gen, cfg, dtype, lead=(n,))}


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Seeded parameters on the generator's device. A ``torch.Generator``
    does not replay ``jax.random``: to compute with the reference's
    weights, carry them over with ``convert.params_from_jax``."""
    _check_family(cfg)
    dt = cfg.param_dtype
    p = {"embed": L.embed_init(gen, (cfg.vocab, cfg.d_model), dt)}
    p.update(_join("layers.", _layer_init(gen, cfg, dt, cfg.n_layers)))
    p["final_norm"] = torch.ones((cfg.d_model,), dtype=dt, device=gen.device)
    if not cfg.tie_embeddings:
        p["lm_head"] = L.embed_init(gen, (cfg.d_model, cfg.vocab), dt)
    return p


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _unstack(params: Mapping[str, torch.Tensor], n: int) -> list[dict]:
    """Per-layer nested dicts of views into the stacked ``layers.*``
    tensors. ``unbind`` gives one backward node per tensor, which stacks
    the layers' gradients once."""
    out: list[dict] = [{} for _ in range(n)]
    for name, stacked in params.items():
        if not name.startswith("layers."):
            continue
        *path, leaf = name.split(".")[1:]
        for lp, t in zip(out, stacked.unbind(0)):
            node = lp
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = t
    return out


def _attn_mlp_layer(lp: dict, x: torch.Tensor, cfg: ModelConfig, positions
                    ) -> torch.Tensor:
    h = L.self_attention_block(lp["attn"], L.rmsnorm(x, lp["ln1"],
                                                     cfg.norm_eps),
                               cfg, positions=positions)
    x = x + h
    return x + L.mlp_block(lp["mlp"], L.rmsnorm(x, lp["ln2"], cfg.norm_eps),
                           cfg)


def forward(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B,S) integer -> logits (B,S,V) in the compute dtype."""
    _check_family(cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = L.embed_tokens(params["embed"], tokens, cfg.compute_dtype)
    for lp in _unstack(params, cfg.n_layers):
        if cfg.remat:
            x = checkpoint(_attn_mlp_layer, lp, x, cfg, positions,
                           use_reentrant=False)
        else:
            x = _attn_mlp_layer(lp, x, cfg, positions)
    return _logits(params, cfg, x)


def _logits(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
            x: torch.Tensor) -> torch.Tensor:
    """The final norm and the LM head."""
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.lm_logits(x, head, cfg.compute_dtype)


# ---------------------------------------------------------------------------
# Decode (one token against the KV cache)
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """The decode cache's tensors on the ``meta`` device (shapes and types,
    no storage). A sliding window keeps a ring buffer of its width."""
    _check_family(cfg)
    w = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    kv = (cfg.n_layers, batch, w, cfg.n_kv_heads, cfg.resolved_head_dim)
    meta = torch.device("meta")
    return {"idx": torch.empty((), dtype=torch.int32, device=meta),
            "k": torch.empty(kv, dtype=dtype, device=meta),
            "v": torch.empty(kv, dtype=dtype, device=meta)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cpu") -> dict:
    """An empty decode cache (zeros, ``idx`` 0) on ``device``."""
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in cache_specs(cfg, batch, max_len, dtype).items()}


def decode_step(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
                tokens: torch.Tensor, cache: dict):
    """tokens (B,1) -> (logits (B,1,V), cache). Writes this token's keys and
    values into ``cache`` and advances its ``idx``, in place (the
    reference's donated cache), and returns the same dict."""
    _check_family(cfg)
    idx = cache["idx"]
    x = L.embed_tokens(params["embed"], tokens, cfg.compute_dtype)
    for lp, kc, vc in zip(_unstack(params, cfg.n_layers), cache["k"],
                          cache["v"]):
        x = x + L.decode_attention_block(
            lp["attn"], L.rmsnorm(x, lp["ln1"], cfg.norm_eps), cfg,
            k_cache=kc, v_cache=vc, idx=idx)
        x = x + L.mlp_block(lp["mlp"], L.rmsnorm(x, lp["ln2"], cfg.norm_eps),
                            cfg)
    idx.add_(1)
    return _logits(params, cfg, x), cache


def loss_fn(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
            batch: Mapping[str, torch.Tensor]):
    logits = forward(params, cfg, batch["tokens"])
    loss = L.cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss, {"loss": loss}


class Transformer(nn.Module):
    """The dense LM as an ``nn.Module``: ``named_parameters()`` are the
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
