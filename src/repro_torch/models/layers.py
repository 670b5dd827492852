"""Shared layers of the port's decoder LM, on torch tensors.

The reference's ``models/layers.py``: the initializers, RMSNorm, RoPE,
dense, KV-chunked and 2-D-tiled causal attention with GQA, the attention
and MLP blocks, the embedding, the LM head and the cross-entropy. Parameters are plain dicts of tensors under the
reference's names and layouts (``wq`` is ``(d, heads, head_dim)``), so a
JAX parameter tree carries over element for element
(:func:`repro_torch.convert.params_from_jax`).

Numerics follow the reference: weights are cast to ``cfg.compute_dtype``
before each projection; RoPE, the attention scores, the softmax and the
probability-value product run in f32 (the reference's einsums ask for an
f32 result, ``preferred_element_type``; here q, k, the rounded
probabilities and v are cast to f32 before the product); the loss is
taken in f32. RMSNorm runs through the hand-written kernel
(:mod:`repro_torch.kernels.rmsnorm`) on the card, and causal self-attention
at bf16 with head dim 64 or 128 through the attention kernel
(:mod:`repro_torch.kernels.causal_attention`, the dense path's function
with bf16 tensor-core products), RoPE on the card through its kernel
(:mod:`repro_torch.kernels.rope`, the plain chain's bits); a row cut over
the ranks of the ``model`` axis (Mamba-2's gated norm under tensor
parallelism) through its split route (:func:`rmsnorm_split`).

One-token decode runs against a ring-buffer KV cache
(:func:`decode_attention_block`), with the grouped-query form of
:func:`attention_dense` when ``cfg.decode_grouped_attn``. Sequences longer
than ``cfg.attn_chunk`` run the KV-chunked online-softmax attention
(:func:`attention_chunked`), or with ``cfg.attn_causal_skip`` the 2-D
causal tiling that skips fully masked key blocks
(:func:`attention_causal_2d`); the reference's ``lax.scan`` over chunks is
a Python loop here, so ``cfg.unroll_scans`` changes nothing. One
difference from the reference: keys padded onto the last chunk are masked
out here, also without a window (the reference gives them position
``-(10**9)``, which only a window masks, so there they take part in the
softmax with score 0); the chunked path equals :func:`attention_dense`.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.core import device_agg as _da
from repro_torch.kernels import causal_attention as _ca
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import rope as _rope
from repro_torch.launch import partitioning as _pt
from repro_torch.models import meshctx

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

#: a leaf of more elements is drawn one leading index at a time: the f32
#: draw of qwen3-32b's whole (64, 5120, 25600) ``w1`` would take 34 GB
CHUNKED_DRAW_ELEMS = 1 << 31


def dense_init(gen: torch.Generator, shape, in_axis_size: int,
               dtype: torch.dtype) -> torch.Tensor:
    """Normal(0, 1/in_axis_size) on the generator's device."""
    scale = 1.0 / math.sqrt(max(1, in_axis_size))
    if math.prod(shape) <= CHUNKED_DRAW_ELEMS:
        return (torch.randn(shape, generator=gen, device=gen.device) * scale
                ).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for i in range(shape[0]):
        out[i] = (torch.randn(shape[1:], generator=gen, device=gen.device)
                  * scale).to(dtype)
    return out


def keep_whole(leaf: str, t: torch.Tensor) -> torch.Tensor:
    """The init functions' default ``keep``: every leaf whole."""
    return t


def embed_init(gen: torch.Generator, shape, dtype: torch.dtype
               ) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device) * 0.02
            ).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

class _RMSNorm(torch.autograd.Function):
    """Forward: the rmsnorm kernel (its plain version on the CPU), which
    also returns each row's ``rstd``. Backward: plain PyTorch from the
    saved rows, γ and ``rstd``, in f32:

        x̂ = x·r,  dγ = Σ_rows dy·x̂,  dx = r·(dy·γ − x̂·mean(dy·γ·x̂))
    """

    @staticmethod
    def forward(ctx, x, gamma, eps):
        rows = x.reshape(-1, x.shape[-1])
        out, rstd = _rn.rmsnorm(rows, gamma, eps)
        ctx.save_for_backward(rows, gamma, rstd)
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        rows, gamma, rstd = ctx.saved_tensors
        r = rstd[:, None]
        xhat = rows.to(torch.float32) * r
        dyf = dy.reshape(rows.shape).to(torch.float32)
        dgamma = None
        if ctx.needs_input_grad[1]:
            dgamma = (dyf * xhat).sum(dim=0).to(gamma.dtype)
        gy = dyf * gamma.to(torch.float32)
        dx = r * (gy - xhat * torch.mean(gy * xhat, dim=-1, keepdim=True))
        return dx.to(rows.dtype).reshape(dy.shape), dgamma, None


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """``x·rsqrt(mean(x²) + eps)·γ`` over the last axis, in x's type."""
    return _RMSNorm.apply(x, gamma, eps)


class _RMSNormSplit(torch.autograd.Function):
    """RMSNorm of rows whose last axis is cut over the ranks of ``group``
    (each rank holds its block of x and of γ; ``d_total`` is the whole
    width). Forward: Σx² of the block by the rmsnorm kernel's split route,
    one all-reduce of a (rows,) f32 over ``group``, then the kernel's scale
    launch. Backward, plain PyTorch in f32, with one all-reduce of a
    (rows,) f32:

        dx = r·(gy − x̂·Σ_ranks Σ_block(gy·x̂)/d_total),  gy = dy·γ

    and dγ this rank's block of Σ_rows dy·x̂."""

    @staticmethod
    def forward(ctx, x, gamma, eps, d_total, group):
        rows = x.reshape(-1, x.shape[-1])
        ssq = _rn.rmsnorm_sumsq(rows)
        dist.all_reduce(ssq, group=group)
        out, rstd = _rn.rmsnorm_scale(rows, ssq, gamma, eps, d_total)
        ctx.save_for_backward(rows, gamma, rstd)
        ctx.d_total, ctx.group = d_total, group
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        rows, gamma, rstd = ctx.saved_tensors
        r = rstd[:, None]
        xhat = rows.to(torch.float32) * r
        dyf = dy.reshape(rows.shape).to(torch.float32)
        dgamma = None
        if ctx.needs_input_grad[1]:
            dgamma = (dyf * xhat).sum(dim=0).to(gamma.dtype)
        gy = dyf * gamma.to(torch.float32)
        dot = torch.sum(gy * xhat, dim=-1, keepdim=True)
        dist.all_reduce(dot, group=ctx.group)
        dx = r * (gy - xhat * (dot / ctx.d_total))
        return dx.to(rows.dtype).reshape(dy.shape), dgamma, None, None, None


def rmsnorm_split(x: torch.Tensor, gamma: torch.Tensor, eps: float,
                  d_total: int, group) -> torch.Tensor:
    """:func:`rmsnorm` of rows of ``d_total`` elements, of which this rank
    holds a block (x's last axis, and γ's) and the other ranks of
    ``group`` the rest (:class:`_RMSNormSplit`)."""
    return _RMSNormSplit.apply(x, gamma, eps, d_total, group)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: broadcastable to (..., S).
    Rotates the two halves of each head (the reference's layout).

    Where the card's kernel takes the tensors (a contiguous CUDA x
    (B, S, H, hd) with an even head dim, positions (S,) or (1,):
    :func:`repro_torch.kernels.rope.takes`), it rotates in one launch each
    way, with the same bits; everything else runs the plain chain."""
    if _rope.takes(x, positions):
        return _rope.rope(x, positions, theta)
    return _rope.apply_rope_plain(x, positions, theta)


# ---------------------------------------------------------------------------
# Attention core
# ---------------------------------------------------------------------------

def _expand_kv(kv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, T, KH, D) -> (B, T, H, D): q head h reads kv head h // (H/KH)."""
    kh = kv.shape[2]
    if kh == n_heads:
        return kv
    return kv.repeat_interleave(n_heads // kh, dim=2)


def _mask_bias(q_pos, k_pos, *, causal: bool, window: int,
               k_valid=None) -> torch.Tensor:
    """Additive f32 bias (S, T), 0 where a query may attend, else NEG_INF."""
    m = torch.ones(q_pos.shape[-1], k_pos.shape[-1], dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    if k_valid is not None:
        m &= k_valid[None, :]
    return torch.zeros(m.shape, dtype=torch.float32,
                       device=m.device).masked_fill(~m, NEG_INF)


def attention_dense(q, k, v, *, q_pos, k_pos, causal=True, window=0,
                    k_valid=None, grouped=False):
    """q: (B,S,H,D); k,v: (B,T,KH,D). Returns (B,S,H,D) in q's type. The
    scores, softmax and weighted sum run in f32; the probabilities are
    rounded to v's type first, as in the reference.

    ``grouped=True`` keeps k and v at KH heads and runs a grouped-query
    einsum (q reshaped to (B,S,KH,G,D)): no expansion of the cache to H
    heads on the decode path."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    bias = _mask_bias(q_pos, k_pos, causal=causal, window=window,
                      k_valid=k_valid)
    f32 = torch.float32
    if grouped and k.shape[2] != h:
        kh = k.shape[2]
        qg = q.reshape(b, s, kh, h // kh, d)
        scores = torch.einsum("bskgd,btkd->bkgst", qg.to(f32),
                              k.to(f32)) * scale
        probs = torch.softmax(scores + bias[None, None, None], dim=-1)
        out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype).to(f32),
                           v.to(f32))
        return out.reshape(b, s, h, d).to(q.dtype)
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    scores = torch.einsum("bshd,bthd->bhst", q.to(f32), k.to(f32)) * scale
    probs = torch.softmax(scores + bias[None, None], dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs.to(v.dtype).to(f32),
                       v.to(f32))
    return out.to(q.dtype)


def attention_chunked(q, k, v, *, q_pos, k_pos, causal=True, window=0,
                      chunk=2048):
    """Online-softmax attention over KV chunks of ``chunk`` keys: peak
    activation memory O(S·chunk) instead of O(S·T). The running max ``m``,
    denominator ``l`` and weighted sum ``acc`` are f32; ``l`` is clamped
    at 1e-30 before the divide; the probabilities are rounded to v's type
    before the PV product, as in :func:`attention_dense`. A last chunk
    padded to ``chunk`` keys masks its padding."""
    b, s, h, d = q.shape
    t = k.shape[1]
    valid = None
    if t % chunk:
        pad = chunk - t % chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.cat([k_pos, torch.full((pad,), -(10 ** 9),
                                             dtype=k_pos.dtype,
                                             device=k_pos.device)])
        valid = torch.arange(t + pad, device=k_pos.device) < t
        t += pad
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    scale = 1.0 / math.sqrt(d)
    f32 = torch.float32
    qf = q.to(f32)
    m = torch.full((b, h, s), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((b, h, s), dtype=f32, device=q.device)
    acc = torch.zeros((b, s, h, d), dtype=f32, device=q.device)
    for lo in range(0, t, chunk):
        hi = lo + chunk
        k_i, v_i = k[:, lo:hi], v[:, lo:hi]
        s_i = torch.einsum("bshd,bthd->bhst", qf, k_i.to(f32)) * scale
        s_i = s_i + _mask_bias(
            q_pos, k_pos[lo:hi], causal=causal, window=window,
            k_valid=None if valid is None else valid[lo:hi])[None, None]
        m_new = torch.maximum(m, torch.amax(s_i, dim=-1))
        p = torch.exp(s_i - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha.transpose(1, 2)[..., None] + torch.einsum(
            "bhst,bthd->bshd", p.to(v_i.dtype).to(f32), v_i.to(f32))
        m = m_new
    l = torch.clamp(l, min=1e-30)
    return (acc / l.transpose(1, 2)[..., None]).to(q.dtype)


def attention_causal_2d(q, k, v, *, positions, window=0, chunk=2048):
    """2-D-tiled causal attention: query blocks × key blocks, skipping the
    blocks that are fully masked (above the diagonal; with a window, also
    those older than it). S must be a multiple of ``chunk`` (the dispatch
    in :func:`attention` sees to it)."""
    s = q.shape[1]
    nq = s // chunk
    outs = []
    for i in range(nq):
        sl = slice(i * chunk, (i + 1) * chunk)
        # the earliest key block this query block sees (a window: the block
        # holding position i*chunk - window + 1)
        j0 = max(0, (i * chunk - window + 1) // chunk) if window else 0
        lo, hi = j0 * chunk, (i + 1) * chunk
        args = (q[:, sl], k[:, lo:hi], v[:, lo:hi])
        kw = dict(q_pos=positions[sl], k_pos=positions[lo:hi], causal=True,
                  window=window)
        outs.append(attention_chunked(*args, chunk=chunk, **kw)
                    if hi - lo > chunk else attention_dense(*args, **kw))
    return torch.cat(outs, dim=1)


def attention(q, k, v, *, q_pos, k_pos, causal=True, window=0, chunk=0,
              k_valid=None, causal_skip=False):
    """The reference's dispatch: the 2-D causal tiling for full causal
    self-attention longer than (and a multiple of) ``chunk`` under
    ``causal_skip``; else the chunked path for keys longer than ``chunk``;
    else the dense path.

    Where the dense path would run on causal self-attention without a
    window or padding, and the card's kernel takes the tensors (bf16 on
    CUDA, head dim 64 or 128, KH dividing H:
    :func:`repro_torch.kernels.causal_attention.takes`), the kernel
    computes the dense path's function instead. It masks by index, which
    is the position mask here: ``q_pos is k_pos`` holds only for
    self-attention, and every caller builds those positions as
    ``torch.arange(S)``."""
    if (causal and not window and k_valid is None and q_pos is k_pos
            and not (chunk and k.shape[1] > chunk) and _ca.takes(q, k, v)):
        return _ca.causal_attention(q, k, v)
    full_self = causal and k_valid is None and q.shape[1] == k.shape[1]
    if (causal_skip and full_self and chunk and q.shape[1] > chunk
            and q.shape[1] % chunk == 0):
        return attention_causal_2d(q, k, v, positions=q_pos, window=window,
                                   chunk=chunk)
    if chunk and k.shape[1] > chunk and k_valid is None:
        return attention_chunked(q, k, v, q_pos=q_pos, k_pos=k_pos,
                                 causal=causal, window=window, chunk=chunk)
    return attention_dense(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=causal,
                           window=window, k_valid=k_valid)


# ---------------------------------------------------------------------------
# Attention block (projections + rope)
# ---------------------------------------------------------------------------

def attn_shapes(cfg: ModelConfig) -> dict:
    d, h, kh, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    p = {"wq": (d, h, hd), "wk": (d, kh, hd), "wv": (d, kh, hd),
         "wo": (h, hd, d)}
    if cfg.qkv_bias:
        p.update(bq=(h, hd), bk=(kh, hd), bv=(kh, hd))
    if cfg.qk_norm:
        p.update(qnorm=(hd,), knorm=(hd,))
    return p


def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
              lead: tuple = (), keep=keep_whole) -> dict:
    """The attention weights; ``lead`` prepends axes (the layer stack).
    ``keep(leaf, tensor)`` takes each leaf as it is drawn and returns what
    is kept of it (a rank's block: ``partitioning.init_local_params``)."""
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    shapes = attn_shapes(cfg)
    fan_in = {"wq": d, "wk": d, "wv": d, "wo": h * hd}
    p = {k: keep(k, dense_init(gen, lead + shapes[k], fan_in[k], dtype))
         for k in ("wq", "wk", "wv", "wo")}
    dev = gen.device
    for k in ("bq", "bk", "bv"):
        if k in shapes:
            p[k] = keep(k, torch.zeros(lead + shapes[k], dtype=dtype,
                                       device=dev))
    for k in ("qnorm", "knorm"):
        if k in shapes:
            p[k] = torch.ones(lead + shapes[k], dtype=dtype, device=dev)
    return p


def _split_axis(local: int, whole: int):
    """The current mesh's ``model`` axis when a weight's local width is a
    block of its whole width (the layer runs split), else None."""
    if local == whole:
        return None
    ax = meshctx.model_axis()
    if ax is None:
        raise ValueError(f"a weight of width {local} (of {whole}) needs a "
                         f"mesh with a model axis (meshctx.use_mesh)")
    return ax


def row_sum(partial: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel product's partial sums joined over the ``model``
    ranks of ``group`` (Megatron's g), added in f32 and rounded once to
    the compute type, as one device's product accumulates in f32 and
    rounds once."""
    return _da.SumOut.apply(partial.to(torch.float32), group
                            ).to(partial.dtype)


def _sum_grad(t: torch.Tensor, ax) -> torch.Tensor:
    """``t`` with its gradient summed over the ``model`` ranks (Megatron's
    f: a replicated input of a split layer)."""
    return _da.SumGrad.apply(t, (ax.group,))


def _kv_heads(t: torch.Tensor, cfg: ModelConfig, h_local: int, ax
              ) -> torch.Tensor:
    """The kv heads this rank's q heads read, one a q head, from a tensor
    holding all of ``cfg.n_kv_heads`` (its dim 2): q head h of the whole
    model reads kv head h // (H/KH), and this rank holds q heads
    [index·h_local, (index+1)·h_local)."""
    group = cfg.n_heads // cfg.n_kv_heads
    idx = (ax.index * h_local + torch.arange(h_local, device=t.device)
           ) // group
    return t.index_select(2, idx)


def project_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, positions,
                select_kv: bool = True):
    """x: (B,S,D) -> q (B,S,H,hd), k,v (B,S,KH,hd), rope applied.

    Split over ``model`` (``wq`` holds a block of the heads) it is
    column-parallel: x's gradient is summed over the ranks, and q holds
    this rank's heads. Where the kv heads are split too, k and v hold this
    rank's; where they are not (``n_kv_heads`` not divisible), the
    replicated ``wk``/``wv`` give every kv head, and with ``select_kv``
    k and v are cut to the one each local q head reads. A replicated leaf
    inside the split layer (q/k norms, unsplit kv weights) has its
    gradient summed over the ranks."""
    cd = cfg.compute_dtype
    ax = _split_axis(p["wq"].shape[-2], cfg.n_heads)
    if ax is not None:
        x = _sum_grad(x, ax)
        kv_split = p["wk"].shape[-2] != cfg.n_kv_heads
        p = {k: t if k in ("wq", "wo", "bq") or (kv_split and k in (
            "wk", "wv", "bk", "bv")) else _sum_grad(t, ax)
             for k, t in p.items()}
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cd))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(cd))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(cd))
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["qnorm"], cfg.norm_eps)
        k = rmsnorm(k, p["knorm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if select_kv and ax is not None and k.shape[2] == cfg.n_kv_heads:
        k = _kv_heads(k, cfg, q.shape[2], ax)
        v = _kv_heads(v, cfg, q.shape[2], ax)
    return q, k, v


def attn_out(p: dict, o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The output projection; row-parallel (one all-reduce over ``model``)
    when ``wo`` holds a block of the heads."""
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(cfg.compute_dtype))
    ax = _split_axis(p["wo"].shape[-3], cfg.n_heads)
    return out if ax is None else row_sum(out, ax.group)


def self_attention_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                         positions, causal=True) -> torch.Tensor:
    """Full-sequence self-attention (train / prefill)."""
    q, k, v = project_qkv(p, x, cfg, positions)
    o = attention(q, k, v, q_pos=positions, k_pos=positions, causal=causal,
                  window=cfg.sliding_window, chunk=cfg.attn_chunk,
                  causal_skip=cfg.attn_causal_skip)
    return attn_out(p, o, cfg)


def _attention_partial(q, k, v, bias):
    """Softmax attention of q (B,S,H,D) over one block of keys k, v
    (B,T,H,D) with the additive f32 ``bias`` (S,T): the block's running
    max and denominator (B,H,S) and numerator (B,S,H,D), f32, the
    probabilities rounded to v's type before the PV product (as
    :func:`attention_chunked`)."""
    f32 = torch.float32
    s = torch.einsum("bshd,bthd->bhst", q.to(f32), k.to(f32)) \
        / math.sqrt(q.shape[-1]) + bias[None, None]
    m = torch.amax(s, dim=-1)
    e = torch.exp(s - m[..., None])
    acc = torch.einsum("bhst,bthd->bshd", e.to(v.dtype).to(f32), v.to(f32))
    return m, torch.sum(e, dim=-1), acc


def decode_attention_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                           k_cache: torch.Tensor, v_cache: torch.Tensor,
                           idx: torch.Tensor, length_axes: tuple = ()
                           ) -> torch.Tensor:
    """One-token decode against a (possibly ring-buffer) KV cache.

    x: (B,1,D); k_cache/v_cache: (B,W,KH,hd); idx: a 0-d integer tensor on
    x's device, the tokens already cached. Writes this token's k and v
    into ring slot ``idx % W`` of the caches, in place, and returns the
    block's output (B,1,D). Every index stays on the device: no host sync.

    Under a mesh the caches are this rank's block, in either layout of
    ``partitioning.cache_pspecs``: this rank's kv heads (nothing crosses
    ranks), or, with ``length_axes`` (the axes that split the length, the
    first slowest), this rank's block of the ring's W slots. Then the
    rank that holds slot ``idx % W`` writes it (the others write back what
    they hold), every rank scores all heads' queries against its slots,
    and :func:`device_agg.combine_partial_softmax` joins the blocks.
    """
    pos = idx.reshape(1)
    q, k, v = project_qkv(p, x, cfg, pos, select_kv=False)
    ax = _split_axis(q.shape[2], cfg.n_heads)
    w_local = w = k_cache.shape[1]
    if length_axes:
        block, count = _pt.block_index(meshctx.get_mesh(), length_axes)
        lo, w = block * w_local, count * w_local
    slot = torch.remainder(pos, w).long()
    if length_axes:
        slot = slot - lo
        own = (slot >= 0) & (slot < w_local)
        slot = torch.clamp(slot, 0, w_local - 1)
        k = torch.where(own, k.to(k_cache.dtype), k_cache.index_select(1, slot))
        v = torch.where(own, v.to(v_cache.dtype), v_cache.index_select(1, slot))
    k_cache.index_copy_(1, slot, k.to(k_cache.dtype))
    v_cache.index_copy_(1, slot, v.to(v_cache.dtype))
    # absolute position held by each ring slot after this write; idx - j
    # is negative for slots not yet filled, so the modulo must floor
    j = torch.arange(w_local, device=idx.device)
    if length_axes:
        j = j + lo                       # this rank's slots of the ring
    k_pos = idx - torch.remainder(idx - j, w)
    k_valid = k_pos >= torch.clamp(idx - w + 1, min=0)
    kk, vv = k_cache.to(q.dtype), v_cache.to(q.dtype)
    if not length_axes:
        if ax is not None and kk.shape[2] == cfg.n_kv_heads:
            kk = _kv_heads(kk, cfg, q.shape[2], ax)
            vv = _kv_heads(vv, cfg, q.shape[2], ax)
        o = attention_dense(q, kk, vv, q_pos=pos, k_pos=k_pos, causal=True,
                            window=cfg.sliding_window, k_valid=k_valid,
                            grouped=cfg.decode_grouped_attn)
        return attn_out(p, o, cfg)
    bias = _mask_bias(pos, k_pos, causal=True, window=cfg.sliding_window,
                      k_valid=k_valid)
    return attn_out(p, attention_length_split(q, kk, vv, bias, length_axes,
                                              ax), cfg)


def attention_length_split(q, k, v, bias, length_axes: tuple, ax
                           ) -> torch.Tensor:
    """Attention of q (B,S,H_local,D) over keys whose length is split over
    the mesh axes ``length_axes``: k, v (B,T_local,KH,D) are this rank's
    block of the keys, ``bias`` (S,T_local) its f32 mask. Every head's
    scores against this rank's keys (q's heads all-gathered over the
    ``model`` axis ``ax`` when they are split), then
    :func:`device_agg.combine_partial_softmax` joins the blocks; returns
    this rank's heads (B,S,H_local,D) in q's type."""
    qa = q if ax is None else _da.all_gather_model(ax.mesh, q, 2)
    m, l, acc = _attention_partial(qa, _expand_kv(k, qa.shape[2]),
                                   _expand_kv(v, qa.shape[2]), bias)
    o = _da.combine_partial_softmax(meshctx.get_mesh(), length_axes, m, l,
                                    acc).to(q.dtype)
    if ax is not None:
        o = o[:, :, ax.index * q.shape[2]:(ax.index + 1) * q.shape[2]]
    return o


# ---------------------------------------------------------------------------
# MLP (dense)
# ---------------------------------------------------------------------------

def mlp_shapes(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    p = {"w1": (d, f), "w2": (f, d)}
    if cfg.gated_mlp:
        p["w3"] = (d, f)
    return p


def mlp_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             lead: tuple = (), keep=keep_whole) -> dict:
    fan_in = {"w1": cfg.d_model, "w2": cfg.d_ff, "w3": cfg.d_model}
    return {k: keep(k, dense_init(gen, lead + shape, fan_in[k], dtype))
            for k, shape in mlp_shapes(cfg).items()}


def mlp_block(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The FFN; split over ``model`` (``w1`` holds a block of d_ff),
    ``w1``/``w3`` are column-parallel and ``w2`` row-parallel."""
    cd = cfg.compute_dtype
    ax = _split_axis(p["w1"].shape[-1], cfg.d_ff)
    if ax is not None:
        x = _sum_grad(x, ax)
    h = torch.einsum("bsd,df->bsf", x, p["w1"].to(cd))
    if cfg.gated_mlp:
        g = torch.einsum("bsd,df->bsf", x, p["w3"].to(cd))
        h = F.silu(h) * g
    else:
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
    out = torch.einsum("bsf,fd->bsd", h, p["w2"].to(cd))
    return out if ax is None else row_sum(out, ax.group)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(table: torch.Tensor, tokens: torch.Tensor, cd,
                 cfg: ModelConfig | None = None) -> torch.Tensor:
    """The rows of ``tokens``. Split over ``model`` (``cfg`` given): a
    vocabulary block looks up the tokens it holds, zeros elsewhere, and one
    all-reduce joins them (exact: one nonzero addend); a ``d_model`` block
    looks up its columns and an all-gather joins them."""
    if cfg is not None:
        ax = _split_axis(table.shape[0], cfg.vocab)
        if ax is not None:
            rows = table.shape[0]
            local = tokens - ax.index * rows
            held = (local >= 0) & (local < rows)
            e = F.embedding(torch.clamp(local, 0, rows - 1), table)
            e = torch.where(held[..., None], e, torch.zeros_like(e))
            return _da.SumOut.apply(e, ax.group).to(cd)
        ax = _split_axis(table.shape[1], cfg.d_model)
        if ax is not None:
            return _da.all_gather_model(
                ax.mesh, F.embedding(tokens, table), -1).to(cd)
    return F.embedding(tokens, table).to(cd)


def lm_logits(x: torch.Tensor, head: torch.Tensor, cd,
              cfg: ModelConfig | None = None) -> torch.Tensor:
    """x @ head. Split over ``model`` (``cfg`` given): a vocabulary block of
    the head is column-parallel and gives this rank's block of the logits;
    a ``d_model`` block is row-parallel (this rank's columns of x, one
    all-reduce) and gives them whole."""
    if cfg is not None:
        ax = _split_axis(head.shape[1], cfg.vocab)
        if ax is not None:
            return torch.einsum("bsd,dv->bsv", _sum_grad(x, ax), head.to(cd))
        ax = _split_axis(head.shape[0], cfg.d_model)
        if ax is not None:
            d = head.shape[0]
            xs = _sum_grad(x, ax)[..., ax.index * d:(ax.index + 1) * d]
            return row_sum(torch.einsum("bsd,dv->bsv", xs, head.to(cd)),
                           ax.group)
    return torch.einsum("bsd,dv->bsv", x, head.to(cd))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  vocab: int | None = None) -> torch.Tensor:
    """Mean next-token CE. logits (B,S,V) any float type; labels (B,S).

    Logits that hold this rank's block of a ``vocab``-wide vocabulary
    (the TP forward's) take the vocabulary-parallel form: the local max
    and a max all-reduce, the local sum of exponentials and a sum
    all-reduce, the label's logit from the rank that holds it and a sum
    all-reduce; the logits are never gathered."""
    logits = logits.to(torch.float32)
    ax = None if vocab is None else _split_axis(logits.shape[-1], vocab)
    if ax is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    else:
        top = torch.amax(logits.detach(), dim=-1)
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=ax.group)
        se = torch.sum(torch.exp(logits - top[..., None]), dim=-1)
        lse = top + torch.log(_da.SumOut.apply(se, ax.group))
        cols = logits.shape[-1]
        local = labels.long() - ax.index * cols
        held = (local >= 0) & (local < cols)
        ll = torch.gather(logits, -1,
                          torch.clamp(local, 0, cols - 1)[..., None])[..., 0]
        ll = _da.SumOut.apply(torch.where(held, ll, torch.zeros_like(ll)),
                              ax.group)
    nll = lse - ll
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
