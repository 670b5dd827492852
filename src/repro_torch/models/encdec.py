"""Whisper-style encoder-decoder transformer backbone, on torch tensors.

The reference's ``models/encdec.py``. The audio conv frontend is a stub
there and here: the inputs are precomputed frame embeddings (B, S_enc,
frontend_dim), mapped into d_model by a learned projection. The encoder
is bidirectional; the decoder has causal self-attention and
cross-attention to the encoder's output. RoPE stands in for whisper's
positions, as in the reference.

Parameters are a flat dict under the reference tree's dotted names, the
encoder's and decoder's layers stacked (``enc_layers.*``,
``dec_layers.*``). Decode runs against a cache ``{"idx", "k", "v", "xk",
"xv"}``: the decoder's self-attention K/V (``max_len`` slots, no window)
and the cross-attention K/V of the ``encoder_seq`` encoder positions,
which :func:`init_cache` computes once from the frames.

Tensor parallelism over ``model`` follows the reference's layout
(``partitioning._param_rule``), as the decoder-only stack does: the
attention and cross-attention heads split where ``model`` divides them
(at whisper's 6 heads: over 2 ranks, not 4), the MLP always (d_ff 1,536),
and the odd 51,865 vocabulary takes the ``d_model``-split embedding and
the row-parallel head, which give whole logits. Under a mesh the decode
cache is a rank's block (``partitioning.cache_pspecs``): where the kv
heads do not split, the self- and cross-attention caches split over their
length (1,500 = 4 × 375 encoder positions), and the ranks' partial
softmaxes are joined (:func:`layers.attention_length_split`).
"""
from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import meshctx
from repro_torch.models.transformer import _join, _run, _unstack, map_tree


# ---------------------------------------------------------------------------
# Cross attention (no rope, not causal)
# ---------------------------------------------------------------------------

def _xattn_shapes(cfg: ModelConfig) -> dict:
    d, h, kh, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    return {"wq": (d, h, hd), "wk": (d, kh, hd), "wv": (d, kh, hd),
            "wo": (h, hd, d)}


def cross_kv(p: dict, enc: torch.Tensor, cfg: ModelConfig
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention K/V (B,T,KH,hd) of the encoder output: this
    rank's kv heads when ``wk`` holds a block of them. In a split layer
    (``wq`` a block of the heads) the encoder output's gradient, and that
    of an unsplit ``wk``/``wv``, is summed over the ``model`` ranks."""
    cd = cfg.compute_dtype
    wk, wv = p["wk"], p["wv"]
    ax = L._split_axis(p["wq"].shape[-2], cfg.n_heads)
    if ax is not None:
        enc = L._sum_grad(enc, ax)
        if wk.shape[-2] == cfg.n_kv_heads:
            wk, wv = L._sum_grad(wk, ax), L._sum_grad(wv, ax)
    k = torch.einsum("btd,dhk->bthk", enc, wk.to(cd))
    v = torch.einsum("btd,dhk->bthk", enc, wv.to(cd))
    return k, v


def cross_attention(p: dict, x: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, cfg: ModelConfig,
                    length_axes: tuple = ()) -> torch.Tensor:
    """Attention of x (B,S,D) to the encoder's K/V (no rope, not causal).
    Split over ``model`` (``wq`` a block of the heads) q holds this rank's
    heads, and whole K/V are cut to the heads they read; ``wo`` is
    row-parallel. ``length_axes``: the mesh axes that split the cached
    K/V's length (decode), whose partial softmaxes are then joined."""
    cd = cfg.compute_dtype
    ax = L._split_axis(p["wq"].shape[-2], cfg.n_heads)
    if ax is not None:
        x = L._sum_grad(x, ax)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cd))
    k, v = k.to(cd), v.to(cd)
    s, t = q.shape[1], k.shape[1]
    if length_axes:
        bias = torch.zeros((s, t), dtype=torch.float32, device=x.device)
        o = L.attention_length_split(q, k, v, bias, length_axes, ax)
    else:
        if ax is not None and k.shape[2] == cfg.n_kv_heads:
            k = L._kv_heads(k, cfg, q.shape[2], ax)
            v = L._kv_heads(v, cfg, q.shape[2], ax)
        o = L.attention(q, k, v, q_pos=torch.arange(s, device=x.device),
                        k_pos=torch.arange(t, device=x.device), causal=False,
                        chunk=cfg.attn_chunk)
    return L.attn_out(p, o, cfg)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def _enc_layer_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {"ln1": (d,), "attn": L.attn_shapes(cfg), "ln2": (d,),
            "mlp": L.mlp_shapes(cfg)}


def _dec_layer_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {"ln1": (d,), "attn": L.attn_shapes(cfg), "lnx": (d,),
            "xattn": _xattn_shapes(cfg), "ln2": (d,),
            "mlp": L.mlp_shapes(cfg)}


def param_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    """Every parameter's name and shape, stacked layers included."""
    d, fd = cfg.d_model, cfg.frontend_dim or cfg.d_model
    p = {"frontend_proj": (fd, d)}
    p.update({k: (cfg.encoder_layers,) + s for k, s in
              _join("enc_layers.", _enc_layer_shapes(cfg)).items()})
    p["enc_norm"] = (d,)
    p["embed"] = (cfg.vocab, d)
    p.update({k: (cfg.n_layers,) + s for k, s in
              _join("dec_layers.", _dec_layer_shapes(cfg)).items()})
    p["final_norm"] = (d,)
    p["lm_head"] = (d, cfg.vocab)
    return p


def _layers_init(gen: torch.Generator, cfg: ModelConfig, dtype, n: int,
                 decoder: bool, keep=L.keep_whole) -> dict:
    ones = lambda: torch.ones((n, cfg.d_model), dtype=dtype,
                              device=gen.device)
    p = {"ln1": ones(), "attn": L.attn_init(gen, cfg, dtype, lead=(n,),
                                            keep=keep),
         "ln2": ones(), "mlp": L.mlp_init(gen, cfg, dtype, lead=(n,),
                                          keep=keep)}
    if decoder:
        d, h, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
        fan_in = {"wq": d, "wk": d, "wv": d, "wo": h * hd}
        p["lnx"] = ones()
        p["xattn"] = {k: keep(k, L.dense_init(gen, (n,) + s, fan_in[k],
                                              dtype))
                      for k, s in _xattn_shapes(cfg).items()}
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig,
                keep=L.keep_whole) -> dict:
    """Seeded parameters on the generator's device (not the reference's
    draws: carry those over with ``convert.params_from_jax``).
    ``keep(leaf, tensor)`` takes each drawn weight and returns what is kept
    of it (``partitioning.init_local_params``: a rank's block); the draws
    are the same whatever it keeps."""
    dt, d = cfg.param_dtype, cfg.d_model
    fd = cfg.frontend_dim or d
    dev = gen.device
    p = {"frontend_proj": keep("frontend_proj",
                               L.dense_init(gen, (fd, d), fd, dt))}
    p.update(_join("enc_layers.", _layers_init(gen, cfg, dt,
                                               cfg.encoder_layers, False,
                                               keep)))
    p["enc_norm"] = torch.ones((d,), dtype=dt, device=dev)
    p["embed"] = keep("embed", L.embed_init(gen, (cfg.vocab, d), dt))
    p.update(_join("dec_layers.", _layers_init(gen, cfg, dt, cfg.n_layers,
                                               True, keep)))
    p["final_norm"] = torch.ones((d,), dtype=dt, device=dev)
    p["lm_head"] = keep("lm_head", L.embed_init(gen, (d, cfg.vocab), dt))
    return p


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _enc_layer(lp: dict, x: torch.Tensor, cfg: ModelConfig, positions
               ) -> torch.Tensor:
    x = x + L.self_attention_block(
        lp["attn"], L.rmsnorm(x, lp["ln1"], cfg.norm_eps), cfg,
        positions=positions, causal=False)
    return x + L.mlp_block(lp["mlp"], L.rmsnorm(x, lp["ln2"], cfg.norm_eps),
                           cfg)


def encode(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """frames (B, S_enc, frontend_dim) -> (B, S_enc, D)."""
    cd = cfg.compute_dtype
    x = torch.einsum("bsf,fd->bsd", frames.to(cd),
                     params["frontend_proj"].to(cd))
    positions = torch.arange(x.shape[1], device=x.device)
    for lp in _unstack(params, cfg.encoder_layers, "enc_layers."):
        x = _run(_enc_layer, cfg, lp, x, cfg, positions)
    return L.rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def _dec_layer(lp: dict, x: torch.Tensor, enc: torch.Tensor,
               cfg: ModelConfig, positions) -> torch.Tensor:
    x = x + L.self_attention_block(
        lp["attn"], L.rmsnorm(x, lp["ln1"], cfg.norm_eps), cfg,
        positions=positions, causal=True)
    xk, xv = cross_kv(lp["xattn"], enc, cfg)
    x = x + cross_attention(lp["xattn"], L.rmsnorm(x, lp["lnx"],
                                                   cfg.norm_eps), xk, xv, cfg)
    return x + L.mlp_block(lp["mlp"], L.rmsnorm(x, lp["ln2"], cfg.norm_eps),
                           cfg)


def forward(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
            tokens: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
    """The teacher-forced decoder over the whole token sequence: tokens
    (B,S) and frames -> logits (B,S,V) in the compute dtype (under a mesh
    that splits the vocabulary, this rank's block of it, as
    ``transformer.forward``'s)."""
    enc = encode(params, cfg, frames)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = L.embed_tokens(params["embed"], tokens, cfg.compute_dtype, cfg)
    for lp in _unstack(params, cfg.n_layers, "dec_layers."):
        x = _run(_dec_layer, cfg, lp, x, enc, cfg, positions)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return L.lm_logits(x, params["lm_head"], cfg.compute_dtype, cfg)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """The decode cache on the meta device; under a mesh (``meshctx``) this
    rank's block of it by ``partitioning.cache_pspecs``."""
    whole = _whole_cache(cfg, batch, max_len, dtype)
    mesh = meshctx.get_mesh()
    if mesh is None:
        return whole
    specs, parts = _cache_pspecs(cfg, batch, max_len, mesh, whole)
    return {k: torch.empty(parts.local_shape(specs[k], t.shape, mesh, False),
                           dtype=t.dtype, device="meta")
            for k, t in whole.items()}


def _whole_cache(cfg: ModelConfig, batch: int, max_len: int,
                 dtype: torch.dtype) -> dict:
    kh, hd, nl = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    meta = lambda *shape, dt=dtype: torch.empty(shape, dtype=dt, device="meta")
    return {"idx": meta(dt=torch.int32),
            "k": meta(nl, batch, max_len, kh, hd),
            "v": meta(nl, batch, max_len, kh, hd),
            "xk": meta(nl, batch, cfg.encoder_seq, kh, hd),
            "xv": meta(nl, batch, cfg.encoder_seq, kh, hd)}


def _cache_pspecs(cfg: ModelConfig, batch: int, max_len: int, mesh,
                  whole: dict):
    from repro_torch.config import ShapeConfig
    from repro_torch.launch import partitioning as parts
    shape = ShapeConfig("serve", seq_len=max_len, global_batch=batch,
                        kind="decode")
    return parts.cache_pspecs(cfg, shape, mesh, whole), parts


def init_cache(cfg: ModelConfig, batch: int, max_len: int, params=None,
               frames=None, dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cpu") -> dict:
    """An empty decode cache on ``device``; with ``params`` and ``frames``
    (the whole batch) the encoder runs once and every decoder layer's
    cross-attention K/V fill ``xk``/``xv``. Under a mesh (``meshctx``) the
    cache is this rank's block (:func:`cache_specs`), ``params`` its blocks
    of the weights, and the encoder runs tensor-parallel on its rows."""
    c = map_tree(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                       device=device),
                 cache_specs(cfg, batch, max_len, dtype))
    if params is None or frames is None:
        return c
    mesh = meshctx.get_mesh()
    block = None
    if mesh is not None:
        specs, parts = _cache_pspecs(cfg, batch, max_len, mesh, _whole_cache(
            cfg, batch, max_len, dtype))
        spec = specs["xk"]
        frames = frames[parts.rank_block((spec[1], None, None),
                                         frames.shape, mesh)]
        # the length (encoder positions) block; the heads come split from
        # a split wk
        block = parts.rank_block((None, spec[2], None, None),
                                 (batch, cfg.encoder_seq, 1, 1), mesh)
    enc = encode(params, cfg, frames)
    for i, lp in enumerate(_unstack(params, cfg.n_layers, "dec_layers.")):
        k, v = cross_kv(lp["xattn"], enc, cfg)
        if block is not None:
            k, v = k[block], v[block]
        c["xk"][i].copy_(k)
        c["xv"][i].copy_(v)
    return c


def decode_step(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
                tokens: torch.Tensor, cache: dict, length_axes: tuple = (),
                cross_length_axes: tuple = ()):
    """tokens (B,1) -> (logits (B,1,V), cache), the cross-attention K/V
    read from the cache. Writes this token's self-attention K/V and
    advances ``idx`` in place, and returns the same dict. Under a mesh the
    step is tensor-parallel on this rank's blocks and cache;
    ``length_axes`` and ``cross_length_axes`` name the mesh axes that
    split the self- and cross-attention caches' lengths
    (``partitioning.kv_length_axes(specs, "k")``, ``(specs, "xk")``)."""
    cd = cfg.compute_dtype
    idx = cache["idx"]
    x = L.embed_tokens(params["embed"], tokens, cd, cfg)
    for i, lp in enumerate(_unstack(params, cfg.n_layers, "dec_layers.")):
        x = x + L.decode_attention_block(
            lp["attn"], L.rmsnorm(x, lp["ln1"], cfg.norm_eps), cfg,
            k_cache=cache["k"][i], v_cache=cache["v"][i], idx=idx,
            length_axes=length_axes)
        x = x + cross_attention(lp["xattn"],
                                L.rmsnorm(x, lp["lnx"], cfg.norm_eps),
                                cache["xk"][i], cache["xv"][i], cfg,
                                cross_length_axes)
        x = x + L.mlp_block(lp["mlp"], L.rmsnorm(x, lp["ln2"], cfg.norm_eps),
                            cfg)
    idx.add_(1)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return L.lm_logits(x, params["lm_head"], cd, cfg), cache


def loss_fn(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
            batch: Mapping[str, torch.Tensor]):
    logits = forward(params, cfg, batch["tokens"], batch["frames"])
    loss = L.cross_entropy(logits, batch["labels"], batch.get("mask"),
                           vocab=cfg.vocab)
    return loss, {"loss": loss}
