"""Uniform model API, dispatched by config family.

The port's share of the reference's ``models/registry.py``: the dense
decoder family only. Every function takes the configuration and, where it
computes, a parameter dict (a flat state dict under the reference's dotted
names, :mod:`repro_torch.models.transformer`):

    param_specs(cfg)                  -> parameter dict on the meta device
    init_params(gen, cfg)             -> parameter dict on the generator's device
    loss_fn(params, cfg, batch)       -> (loss, metrics)
    forward(params, cfg, batch)       -> logits (full sequence)
    decode_step(params, cfg, tok, c)  -> (logits, cache)   (single token)
    cache_specs(cfg, batch, max_len)  -> the cache on the meta device
    init_cache(cfg, batch, max_len)   -> an empty cache
    param_count(cfg)                  -> exact count, from the shapes alone

plus ``active_param_count``, ``input_specs(cfg, shape)`` (stand-ins on the
meta device, no allocation) and ``model_flops``. A spec is a tensor on the
``meta`` device, PyTorch's counterpart of ``jax.ShapeDtypeStruct``. The
encoder-decoder, MoE, SSM and hybrid families raise
``NotImplementedError`` (ROADMAP queue 1, item 3).
"""
from __future__ import annotations

import math

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.models import transformer


def param_specs(cfg: ModelConfig) -> dict:
    return {name: torch.empty(shape, dtype=cfg.param_dtype, device="meta")
            for name, shape in transformer.param_shapes(cfg).items()}


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return transformer.init_params(gen, cfg)


def loss_fn(params, cfg: ModelConfig, batch):
    return transformer.loss_fn(params, cfg, batch)


def forward(params, cfg: ModelConfig, batch):
    return transformer.forward(params, cfg, batch["tokens"])


def decode_step(params, cfg: ModelConfig, tokens, cache):
    return transformer.decode_step(params, cfg, tokens, cache)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    return transformer.cache_specs(cfg, batch, max_len, dtype)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cpu") -> dict:
    return transformer.init_cache(cfg, batch, max_len, dtype, device)


def param_count(cfg: ModelConfig) -> int:
    return int(sum(math.prod(s) for s in
                   transformer.param_shapes(cfg).values()))


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token: all of them in the dense family."""
    return param_count(cfg)


# ---------------------------------------------------------------------------
# Dry-run input stand-ins
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                cache_dtype: torch.dtype = torch.bfloat16) -> dict:
    """Stand-ins on the meta device for every model input of this cell:
    train/prefill -> the token batch (+ labels); decode -> one new token
    plus the KV cache of ``seq_len``."""
    transformer._check_family(cfg)
    b, s = shape.global_batch, shape.seq_len
    tokens = lambda *dims: torch.empty(dims, dtype=torch.int32, device="meta")
    if shape.kind == "train":
        return {"tokens": tokens(b, s), "labels": tokens(b, s)}
    if shape.kind == "prefill":
        return {"tokens": tokens(b, s)}
    if shape.kind == "decode":
        return {"tokens": tokens(b, 1),
                "cache": cache_specs(cfg, b, s, cache_dtype)}
    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# Analytic FLOPs model (6ND for dense) + attention term
# ---------------------------------------------------------------------------

def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS for the roofline's usefulness ratio, as the reference
    reckons it for the dense family.

    Train: 6 * N_active * tokens (+ attention 12*L*S^2*H*hd per batch elem,
    causal halved). Prefill: 2 * N_active * tokens + attn fwd. Decode: 2 *
    N_active * batch (one token each) + cache attention reads (matmul flops).
    """
    n_act = active_param_count(cfg)
    b, s = shape.global_batch, shape.seq_len
    hd = cfg.resolved_head_dim
    h = cfg.n_heads
    nl = cfg.n_layers

    def attn_flops(q_len, k_len, causal=True):
        # qk + pv matmuls: 2 * 2 * q*k*h*hd, causal halves the useful area
        eff = 0.5 if (causal and q_len == k_len) else 1.0
        if cfg.sliding_window and k_len > cfg.sliding_window:
            eff *= cfg.sliding_window / k_len if not causal else 1.0
            if causal and q_len == k_len:
                eff = cfg.sliding_window / k_len  # band instead of triangle
        return 4.0 * q_len * k_len * h * hd * eff

    if shape.kind == "decode":
        attn_total = b * nl * attn_flops(1, s, causal=False)
    else:
        attn_total = b * nl * attn_flops(s, s)

    if shape.kind == "train":
        return 6.0 * n_act * b * s + 3.0 * attn_total
    if shape.kind == "prefill":
        return 2.0 * n_act * b * s + attn_total
    return 2.0 * n_act * b + attn_total
