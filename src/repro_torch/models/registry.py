"""Uniform model API, dispatched by config family.

The port's counterpart of the reference's ``models/registry.py``: the
decoder-only families (dense, moe, vlm, ssm, hybrid;
:mod:`repro_torch.models.transformer`) and the encoder-decoder models
(:mod:`repro_torch.models.encdec`). Every function takes the
configuration and, where it computes, a parameter dict (a flat state dict
under the reference's dotted names):

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
``meta`` device, PyTorch's counterpart of ``jax.ShapeDtypeStruct``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.models import encdec, moe, ssm, transformer
from repro_torch.models.layers import keep_whole

#: leaves that stay f32 whatever ``cfg.param_dtype``: the MoE router and
#: the SSM's ``dt_bias``, ``a_log`` and ``d_skip``
F32_LEAVES = moe.F32_LEAVES + ssm.F32_LEAVES


def is_encdec(cfg: ModelConfig) -> bool:
    return cfg.family in ("audio", "encdec") or cfg.is_encdec


def _family(cfg: ModelConfig):
    return encdec if is_encdec(cfg) else transformer


def param_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    return _family(cfg).param_shapes(cfg)


def param_specs(cfg: ModelConfig) -> dict:
    return {name: torch.empty(shape, device="meta", dtype=torch.float32
                              if name.rsplit(".", 1)[-1] in F32_LEAVES
                              else cfg.param_dtype)
            for name, shape in param_shapes(cfg).items()}


def init_params(gen: torch.Generator, cfg: ModelConfig,
                keep=keep_whole) -> dict:
    """``keep(leaf, tensor)``: what is kept of each drawn weight (a rank's
    block: ``partitioning.init_local_params``); default every leaf whole."""
    return _family(cfg).init_params(gen, cfg, keep=keep)


def loss_fn(params, cfg: ModelConfig, batch):
    return _family(cfg).loss_fn(params, cfg, batch)


def forward(params, cfg: ModelConfig, batch):
    if is_encdec(cfg):
        return encdec.forward(params, cfg, batch["tokens"], batch["frames"])
    return transformer.forward(params, cfg, batch["tokens"])


def decode_step(params, cfg: ModelConfig, tokens, cache,
                length_axes: tuple = (), cross_length_axes: tuple = ()):
    """``length_axes``: the mesh axes that split the KV ring's length
    (``transformer.decode_step``); ``cross_length_axes``: those that split
    an encoder-decoder's cross-attention cache (``encdec.decode_step``)."""
    if is_encdec(cfg):
        return encdec.decode_step(params, cfg, tokens, cache, length_axes,
                                  cross_length_axes)
    return transformer.decode_step(params, cfg, tokens, cache, length_axes)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    return _family(cfg).cache_specs(cfg, batch, max_len, dtype)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cpu") -> dict:
    """An empty cache (an encoder-decoder's cross-attention K/V zero: build
    them with ``encdec.init_cache(params=, frames=)``)."""
    return _family(cfg).init_cache(cfg, batch, max_len, dtype=dtype,
                                   device=device)


def param_count(cfg: ModelConfig) -> int:
    return int(sum(math.prod(s) for s in param_shapes(cfg).values()))


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: top_k of n_experts)."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    expert = int(sum(
        math.prod(s) for name, s in param_shapes(cfg).items()
        if name.rsplit(".", 1)[-1] in ("w1", "w2", "w3")
        and "moe" in name.split(".")))
    active_frac = cfg.moe.top_k / cfg.moe.n_experts
    return int(total - expert * (1.0 - active_frac))


def norms_per_decode_step(cfg: ModelConfig) -> int:
    """The RMSNorms of one decode step, worked out from the config (on the
    card, the rmsnorm kernel's launches a step): two per attention block
    (two more under ``qk_norm``), a third for an encoder-decoder layer's
    cross-attention, one per Mamba layer (two for Mamba-2, the gated norm)
    and the final norm."""
    qk = 2 if cfg.qk_norm else 0
    if is_encdec(cfg):
        return cfg.n_layers * (3 + qk) + 1
    mamba = 0 if cfg.ssm is None else cfg.n_layers * (
        2 if cfg.ssm.version == 2 else 1)
    blocks = {"ssm": 0, "hybrid": cfg.n_layers // max(1, cfg.attn_every)
              }.get(cfg.family, cfg.n_layers)
    return mamba + blocks * (2 + qk) + 1


# ---------------------------------------------------------------------------
# Dry-run input stand-ins
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                cache_dtype: torch.dtype = torch.bfloat16) -> dict:
    """Stand-ins on the meta device for every model input of this cell:
    train/prefill -> the token batch (+ labels, + frames for an
    encoder-decoder); decode -> one new token plus the cache of
    ``seq_len``."""
    b, s = shape.global_batch, shape.seq_len
    meta = lambda *dims, dt=torch.int32: torch.empty(dims, dtype=dt,
                                                     device="meta")
    if shape.kind in ("train", "prefill"):
        out = {"tokens": meta(b, s)}
        if shape.kind == "train":
            out["labels"] = meta(b, s)
        if is_encdec(cfg):
            out["frames"] = meta(b, cfg.encoder_seq,
                                 cfg.frontend_dim or cfg.d_model,
                                 dt=torch.float32)
        return out
    if shape.kind == "decode":
        return {"tokens": meta(b, 1),
                "cache": cache_specs(cfg, b, s, cache_dtype)}
    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# Analytic FLOPs model (6ND for dense; 6·N_active·D for MoE) + attention term
# ---------------------------------------------------------------------------

def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS for the roofline's usefulness ratio, as the reference
    reckons it.

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

    if cfg.family == "ssm":
        attn_total = 0.0
    elif cfg.family == "hybrid":
        n_attn = nl // max(1, cfg.attn_every)
        if shape.kind == "decode":
            attn_total = b * n_attn * attn_flops(1, s, causal=False)
        else:
            attn_total = b * n_attn * attn_flops(s, s)
    else:
        if shape.kind == "decode":
            attn_total = b * nl * attn_flops(1, s, causal=False)
        else:
            attn_total = b * nl * attn_flops(s, s)
        if is_encdec(cfg):
            e = cfg.encoder_seq
            attn_total += b * cfg.encoder_layers * attn_flops(e, e, False)
            q = 1 if shape.kind == "decode" else s
            attn_total += b * nl * attn_flops(q, e, False)

    if shape.kind == "train":
        return 6.0 * n_act * b * s + 3.0 * attn_total
    if shape.kind == "prefill":
        return 2.0 * n_act * b * s + attn_total
    return 2.0 * n_act * b + attn_total
