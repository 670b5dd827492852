"""State-space model blocks on torch tensors: Mamba-1 (selective scan) and
Mamba-2 (SSD).

The reference's ``models/ssm.py``, with its separate projections
(``in_x``, ``in_z``, ...) and parameter names, so that its weights carry
over leaf for leaf. ``dt_bias``, ``a_log`` and ``d_skip`` are f32 whatever
``cfg.param_dtype`` (``F32_LEAVES``).

* The causal depthwise conv is ``F.conv1d`` with ``groups=C`` on a
  left-padded, channels-first view; the reference's ``(K, C)`` weight is
  read as ``(C, 1, K)``.
* Mamba-1's recurrence ``h_t = exp(dt_t·A)·h_{t-1} + dt_t·x_t·B_t`` runs
  chunk by chunk as in the reference, and within a chunk through the
  reference's associative scan (:func:`_assoc_scan_chunk`):
  :func:`associative_scan` is ``lax.associative_scan``'s odd/even
  recursion in torch ops, each product and sum in the reference's order,
  so a chunk's states equal the reference's bit for bit on the same
  inputs. Gradients come from autograd through the same ops.
* Mamba-2's SSD is the reference's quadratic-within-chunk,
  linear-across-chunks form; its decay ``exp(cl_i - cl_j)`` may overflow
  above the diagonal, and ``torch.where`` masks it as the reference's
  ``jnp.where`` does.
* Mamba-2's gated RMSNorm runs through :func:`layers.rmsnorm`, the rmsnorm
  kernel on the card, at d = d_inner.

Decode is a single-step state update against a cache of the SSM state
(f32) and the conv's last K - 1 inputs (:func:`mamba_cache_specs`).

Tensor parallelism over ``model`` (the reference's layout,
``partitioning._param_rule``): a block runs split when its ``in_x`` holds
a block of ``d_inner`` (``partitioning.shard_params``), under a mesh with
a ``model`` axis (``meshctx``); every local width is read from a weight.

* Mamba-1: ``in_x``, ``in_z``, the conv, ``dt_proj``, ``dt_bias``,
  ``a_log`` and ``d_skip`` are column-parallel on ``d_inner``; ``x_proj``
  and ``out_proj`` row-parallel (one all-reduce each). The all-reduced
  ``dt_raw``, B and C feed every rank's channels, so their gradient is
  summed over the ranks (``SumGrad``), as is the block input's.
* Mamba-2: ``in_x``, ``in_z``, the x conv and ``norm_g`` split on
  ``d_inner``; ``in_dt``, ``dt_bias``, ``a_log`` and ``d_skip`` over the
  SSD heads; ``in_b``, ``in_c`` and their convs stay whole and their
  outputs take ``SumGrad``; ``out_proj`` is row-parallel. The gated norm
  normalises a row cut over the ranks: :func:`layers.rmsnorm_split`, the
  rmsnorm kernel's split route on the card.
* The decode caches are a rank's blocks: the state and the x history
  split with ``d_inner`` and the heads, the B and C histories whole
  (``partitioning.cache_pspecs``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import dense_init, keep_whole, rmsnorm

#: leaves that stay f32 whatever ``cfg.param_dtype``
F32_LEAVES = ("dt_bias", "a_log", "d_skip")

_F32 = torch.float32


def dt_rank(cfg: ModelConfig) -> int:
    return math.ceil(cfg.d_model / 16)


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm.expand * cfg.d_model


def m2_heads(cfg: ModelConfig) -> int:
    return d_inner(cfg) // cfg.ssm.head_dim


# ---------------------------------------------------------------------------
# Causal depthwise conv1d
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                  ) -> torch.Tensor:
    """x: (B,S,C); w: (K,C) depthwise; left-padded causal conv."""
    k, c = w.shape
    xp = F.pad(x.transpose(1, 2), (k - 1, 0))
    out = F.conv1d(xp, w.T.reshape(c, 1, k), groups=c)
    return out.transpose(1, 2) + b


def conv_step(cache: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token conv using a (B, K-1, C) history cache; returns the
    new history and the output (B, C)."""
    window = torch.cat([cache, x_t[:, None]], dim=1)             # (B,K,C)
    out = torch.einsum("bkc,kc->bc", window, w) + b
    return window[:, 1:], out


def _init(gen: torch.Generator, shapes: dict, fan_in: dict,
          dtype: torch.dtype, lead: tuple, keep) -> dict:
    """``dense_init`` for the leaves named in ``fan_in`` (their fan-in),
    zeros for the others but the f32 leaves, which the caller sets; each
    through ``keep(leaf, tensor)`` as it is drawn."""
    return {k: keep(k, dense_init(gen, lead + s, fan_in[k], dtype)
                    if k in fan_in else
                    torch.zeros(lead + s, dtype=dtype, device=gen.device))
            for k, s in shapes.items() if k not in F32_LEAVES}


# ---------------------------------------------------------------------------
# Mamba-1
# ---------------------------------------------------------------------------

def mamba1_shapes(cfg: ModelConfig) -> dict:
    d, di, ds, r, k = (cfg.d_model, d_inner(cfg), cfg.ssm.d_state,
                       dt_rank(cfg), cfg.ssm.d_conv)
    return {"in_x": (d, di), "in_z": (d, di), "conv_w": (k, di),
            "conv_b": (di,), "x_proj": (di, r + 2 * ds), "dt_proj": (r, di),
            "dt_bias": (di,), "a_log": (di, ds), "d_skip": (di,),
            "out_proj": (di, d)}


def mamba1_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
                lead: tuple = (), keep=keep_whole) -> dict:
    """The Mamba-1 weights; ``lead`` prepends axes (the layer stack);
    ``keep(leaf, tensor)`` returns what is kept of each (a rank's
    block)."""
    d, di, ds, r, k = (cfg.d_model, d_inner(cfg), cfg.ssm.d_state,
                       dt_rank(cfg), cfg.ssm.d_conv)
    p = _init(gen, mamba1_shapes(cfg),
              {"in_x": d, "in_z": d, "conv_w": k, "x_proj": di, "dt_proj": r,
               "out_proj": di}, dtype, lead, keep)
    dev = gen.device
    a = torch.log(torch.arange(1, ds + 1, dtype=_F32, device=dev))
    p.update(dt_bias=torch.full(lead + (di,), -4.6, device=dev),  # softplus ~ 0.01
             a_log=a.expand(lead + (di, ds)).clone(),
             d_skip=torch.ones(lead + (di,), device=dev))
    return {name: keep(name, t) if name in F32_LEAVES else t
            for name, t in p.items()}


def associative_scan(fn, elems: tuple, axis: int = 0) -> tuple:
    """Inclusive scan of the tuple of tensors ``elems`` along ``axis``
    under the associative ``fn(l, r)`` (tuples in, a tuple out):
    ``jax.lax.associative_scan``'s recursion, so that ``fn`` combines the
    same elements in the same order. Pairs of neighbours are reduced and
    scanned by recursion, which gives the odd places; each even place
    (but the first, the first element itself) combines the odd place
    before it with its own element; the two are interleaved. Built from
    slices, ``torch.cat`` and ``torch.stack``: no fused or reordered
    arithmetic beyond ``fn``'s own. (The reference interleaves by padding
    with zeros and adding, which turns a -0.0 into +0.0; here a -0.0
    stays.)"""
    def take(e, start, stop=None, step=1):
        return e[(slice(None),) * axis + (slice(start, stop, step),)]

    def interleave(even, odd):
        # even holds as many places as odd, or one more (the last)
        n = odd.shape[axis]
        pairs = torch.stack([take(even, 0, n), odd], dim=axis + 1)
        joined = pairs.flatten(axis, axis + 1)
        if even.shape[axis] == n:
            return joined
        return torch.cat([joined, take(even, n)], dim=axis)

    def scan(elems):
        n = elems[0].shape[axis]
        if n < 2:
            return elems
        odd = scan(fn(tuple(take(e, 0, -1, 2) for e in elems),
                      tuple(take(e, 1, None, 2) for e in elems)))
        rest = tuple(take(e, 2, None, 2) for e in elems)
        even = fn(tuple(take(o, 0, -1) for o in odd) if n % 2 == 0
                  else odd, rest)
        even = tuple(torch.cat([take(e, 0, 1), r], dim=axis)
                     for e, r in zip(elems, even))
        return tuple(interleave(e, o) for e, o in zip(even, odd))

    elems = tuple(elems)
    axis %= elems[0].dim()
    return scan(elems)


def _assoc_scan_chunk(da, db, h0):
    """h_t = da_t * h_{t-1} + db_t within one chunk via associative scan.

    da, db: (B, C, di, ds) f32; h0: (B, di, ds). Returns (h (B,C,di,ds),
    h_last)."""
    def comb(l, r):
        return (r[0] * l[0], r[0] * l[1] + r[1])

    a_cum, b_cum = associative_scan(comb, (da, db), axis=1)
    h = a_cum * h0[:, None] + b_cum
    return h, h[:, -1]


def mamba1_ssm(dt, bmat, cmat, xc, a, h0, chunk: int):
    """Chunked selective scan.

    dt, xc: (B,S,di); bmat, cmat: (B,S,ds); a: (di,ds) (negative);
    h0: (B,di,ds). Returns y (B,S,di) f32 and h_last.
    """
    s = dt.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by ssm chunk {chunk}")
    dt, bmat, cmat, xc = (t.to(_F32) for t in (dt, bmat, cmat, xc))
    h, ys = h0, []
    for lo in range(0, s, chunk):
        sl = slice(lo, lo + chunk)
        da = torch.exp(dt[:, sl, :, None] * a)                   # (B,C,di,ds)
        db = (dt[:, sl] * xc[:, sl])[..., None] * bmat[:, sl, None, :]
        h_seq, h = _assoc_scan_chunk(da, db, h)
        ys.append(torch.einsum("bcdn,bcn->bcd", h_seq, cmat[:, sl]))
    return torch.cat(ys, dim=1), h


def mamba1_block(p: dict, x: torch.Tensor, cfg: ModelConfig, h0=None,
                 conv_cache=None, single_step: bool = False):
    """x: (B,S,D) full-sequence, or (B,1,D) with ``single_step``.

    Returns (out (B,S,D), (h_last, conv_cache)). Split over ``model`` (a
    block of ``d_inner`` in ``in_x``) the state, the conv history and the
    channels are this rank's."""
    cd = cfg.compute_dtype
    ds, r = cfg.ssm.d_state, dt_rank(cfg)
    di_ = p["in_x"].shape[-1]
    ax = L._split_axis(di_, d_inner(cfg))
    b = x.shape[0]
    if h0 is None:
        h0 = torch.zeros((b, di_, ds), dtype=_F32, device=x.device)
    if ax is not None:
        x = L._sum_grad(x, ax)

    x_in = torch.einsum("bsd,de->bse", x, p["in_x"].to(cd))
    z = torch.einsum("bsd,de->bse", x, p["in_z"].to(cd))
    if single_step:
        conv_cache, xc_t = conv_step(conv_cache, x_in[:, 0],
                                     p["conv_w"].to(cd), p["conv_b"].to(cd))
        xc = F.silu(xc_t)[:, None]
    else:
        xc = F.silu(causal_conv1d(x_in, p["conv_w"].to(cd),
                                  p["conv_b"].to(cd)))
        conv_cache = None

    proj = torch.einsum("bsd,de->bse", xc, p["x_proj"].to(cd))
    if ax is not None:                   # row-parallel, read by every rank
        proj = L._sum_grad(L.row_sum(proj, ax.group), ax)
    dt_raw, bmat, cmat = torch.split(proj, [r, ds, ds], dim=-1)
    dt = F.softplus(torch.einsum("bsr,rd->bsd", dt_raw, p["dt_proj"].to(cd))
                    .to(_F32) + p["dt_bias"])
    a = -torch.exp(p["a_log"])

    if single_step:
        da = torch.exp(dt[:, 0, :, None] * a)
        db = (dt[:, 0] * xc[:, 0].to(_F32))[..., None] \
            * bmat[:, 0, None, :].to(_F32)
        h_last = da * h0 + db
        y = torch.einsum("bdn,bn->bd", h_last,
                         cmat[:, 0].to(_F32))[:, None]
    else:
        y, h_last = mamba1_ssm(dt, bmat, cmat, xc, a, h0, cfg.ssm.chunk)

    y = y + xc.to(_F32) * p["d_skip"]
    y = y.to(cd) * F.silu(z)
    out = torch.einsum("bsd,de->bse", y, p["out_proj"].to(cd))
    if ax is not None:
        out = L.row_sum(out, ax.group)
    return out, (h_last, conv_cache)


# ---------------------------------------------------------------------------
# Mamba-2 (SSD)
# ---------------------------------------------------------------------------

def mamba2_shapes(cfg: ModelConfig) -> dict:
    d, di, ds, k = cfg.d_model, d_inner(cfg), cfg.ssm.d_state, cfg.ssm.d_conv
    h = m2_heads(cfg)
    return {"in_x": (d, di), "in_z": (d, di), "in_b": (d, ds),
            "in_c": (d, ds), "in_dt": (d, h), "conv_xw": (k, di),
            "conv_xb": (di,), "conv_bw": (k, ds), "conv_bb": (ds,),
            "conv_cw": (k, ds), "conv_cb": (ds,), "dt_bias": (h,),
            "a_log": (h,), "d_skip": (h,), "norm_g": (di,),
            "out_proj": (di, d)}


def mamba2_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
                lead: tuple = (), keep=keep_whole) -> dict:
    """The Mamba-2 weights; ``lead`` prepends axes (the layer stack);
    ``keep(leaf, tensor)`` returns what is kept of each (a rank's
    block)."""
    d, di, k = cfg.d_model, d_inner(cfg), cfg.ssm.d_conv
    h = m2_heads(cfg)
    p = _init(gen, mamba2_shapes(cfg),
              {"in_x": d, "in_z": d, "in_b": d, "in_c": d, "in_dt": d,
               "conv_xw": k, "conv_bw": k, "conv_cw": k, "out_proj": di},
              dtype, lead, keep)
    dev = gen.device
    rest = dict(dt_bias=torch.full(lead + (h,), -4.6, device=dev),
                a_log=torch.zeros(lead + (h,), device=dev),
                d_skip=torch.ones(lead + (h,), device=dev),
                norm_g=torch.ones(lead + (di,), dtype=dtype, device=dev))
    p.update({name: keep(name, t) for name, t in rest.items()})
    return p


def ssd_chunked(xh, dt, bmat, cmat, a_head, h0, chunk: int):
    """Mamba-2 SSD: quadratic within a chunk, linear across chunks.

    xh: (B,S,H,P); dt: (B,S,H) f32; bmat/cmat: (B,S,N); a_head: (H,) (<0);
    h0: (B,H,P,N). Returns y (B,S,H,P) f32 and h_last.
    """
    s = xh.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by ssd chunk {chunk}")
    xh, bmat, cmat = (t.to(_F32) for t in (xh, bmat, cmat))
    log_a = dt * a_head                               # (B,S,H)  <= 0
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))[None, :, :, None]
    zero = torch.zeros((), dtype=_F32, device=xh.device)
    hstate, ys = h0.to(_F32), []
    for lo in range(0, s, chunk):
        sl = slice(lo, lo + chunk)
        x_c, dt_c, b_c, c_c = xh[:, sl], dt[:, sl], bmat[:, sl], cmat[:, sl]
        cl = torch.cumsum(log_a[:, sl], dim=1)        # (B,C,H) inclusive
        # within the chunk: y_i += sum_{j<=i} exp(cl_i - cl_j) dt_j (C_i.B_j) x_j
        g = torch.einsum("bin,bjn->bij", c_c, b_c)    # (B,C,C)
        decay = torch.exp(cl[:, :, None, :] - cl[:, None, :, :])  # (B,C,C,H)
        w = torch.where(mask, g[..., None] * decay, zero)
        w = w * dt_c[:, None, :, :]                   # scale by dt_j
        y = torch.einsum("bijh,bjhp->bihp", w, x_c)
        # the carried state: exp(cl_i) * C_i . h0
        y = y + torch.einsum("bin,bhpn,bih->bihp", c_c, hstate,
                             torch.exp(cl))
        # the next state: exp(cl_last - cl_j) dt_j x_j (x) B_j, summed over j
        rev = torch.exp(cl[:, -1:, :] - cl)           # (B,C,H)
        contrib = torch.einsum("bjh,bjhp,bjn->bhpn", rev * dt_c, x_c, b_c)
        hstate = hstate * torch.exp(cl[:, -1])[..., None, None] + contrib
        ys.append(y)
    return torch.cat(ys, dim=1), hstate


def mamba2_block(p: dict, x: torch.Tensor, cfg: ModelConfig, h0=None,
                 conv_cache=None, single_step: bool = False):
    """Mamba-2 block. x: (B,S,D); conv_cache: dict(x=, b=, c=) histories.

    Returns (out, (h_last, conv_cache)). Split over ``model`` (a block of
    ``d_inner`` in ``in_x``, of the heads in ``in_dt``) the state, the x
    history and the channels are this rank's; the B and C histories are
    whole."""
    cd = cfg.compute_dtype
    di_ = p["in_x"].shape[-1]
    nh, hd = p["in_dt"].shape[-1], cfg.ssm.head_dim
    ax = L._split_axis(di_, d_inner(cfg))
    if nh * hd != di_:
        raise ValueError(f"{cfg.name}: {nh} SSD heads of {hd} do not cover "
                         f"this rank's {di_} channels (split d_inner and the "
                         f"heads over the same ranks)")
    b, s, _ = x.shape
    if h0 is None:
        h0 = torch.zeros((b, nh, hd, cfg.ssm.d_state), dtype=_F32,
                         device=x.device)

    # the split projections read x with its gradient summed over the
    # ranks; the whole in_b/in_c read it as it is (their outputs take the
    # sum below)
    xs = x if ax is None else L._sum_grad(x, ax)
    proj = lambda name, v=xs: torch.einsum("bsd,de->bse", v, p[name].to(cd))
    z, xr, br, cr = proj("in_z"), proj("in_x"), proj("in_b", x), \
        proj("in_c", x)
    dt_raw = torch.einsum("bsd,dh->bsh", xs, p["in_dt"].to(cd))

    convs = (("x", xr, "conv_xw", "conv_xb"), ("b", br, "conv_bw", "conv_bb"),
             ("c", cr, "conv_cw", "conv_cb"))
    if single_step:
        new_cache, outs = {}, []
        for key, v, w, bias in convs:
            new_cache[key], o = conv_step(conv_cache[key], v[:, 0],
                                          p[w].to(cd), p[bias].to(cd))
            outs.append(F.silu(o)[:, None])
        conv_cache = new_cache
    else:
        outs = [F.silu(causal_conv1d(v, p[w].to(cd), p[bias].to(cd)))
                for _, v, w, bias in convs]
        conv_cache = None
    xr, br, cr = outs
    if ax is not None:                   # whole, read by every rank's heads
        br, cr = L._sum_grad(br, ax), L._sum_grad(cr, ax)

    xh = xr.reshape(b, s, nh, hd)
    dt = F.softplus(dt_raw.to(_F32) + p["dt_bias"])               # (B,S,H)
    a_head = -torch.exp(p["a_log"])

    if single_step:
        la = dt[:, 0] * a_head                                     # (B,H)
        h_last = h0 * torch.exp(la)[..., None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dt[:, 0], xh[:, 0].to(_F32),
            br[:, 0].to(_F32))
        y = torch.einsum("bhpn,bn->bhp", h_last,
                         cr[:, 0].to(_F32))[:, None]
    else:
        y, h_last = ssd_chunked(xh, dt, br, cr, a_head, h0, cfg.ssm.chunk)

    y = y + xh.to(_F32) * p["d_skip"][:, None]
    y = y.reshape(b, s, di_).to(cd)
    # gated RMSNorm (Mamba-2): norm(y * silu(z)), over the whole d_inner
    g = y * F.silu(z)
    if ax is None:
        y = rmsnorm(g, p["norm_g"], cfg.norm_eps)
    else:
        y = L.rmsnorm_split(g, p["norm_g"], cfg.norm_eps, d_inner(cfg),
                            ax.group)
    out = torch.einsum("bsd,de->bse", y, p["out_proj"].to(cd))
    if ax is not None:
        out = L.row_sum(out, ax.group)
    return out, (h_last, conv_cache)


def mamba_cache_specs(cfg: ModelConfig, batch: int,
                      dtype: torch.dtype = torch.float32) -> dict:
    """One layer's whole decode cache on the meta device (the caller
    prepends the layer axis): the SSM state in f32, the conv histories in
    ``dtype``. Under tensor parallelism a rank holds its block of it
    (``transformer.cache_specs`` cuts it by ``partitioning.cache_pspecs``),
    at the local widths the split blocks read from their weights."""
    k, di, ds = cfg.ssm.d_conv, d_inner(cfg), cfg.ssm.d_state
    meta = lambda *shape, dt=dtype: torch.empty(shape, dtype=dt, device="meta")
    if cfg.ssm.version == 1:
        return {"h": meta(batch, di, ds, dt=_F32),
                "conv": meta(batch, k - 1, di)}
    return {"h": meta(batch, m2_heads(cfg), cfg.ssm.head_dim, ds, dt=_F32),
            "conv_x": meta(batch, k - 1, di),
            "conv_b": meta(batch, k - 1, ds),
            "conv_c": meta(batch, k - 1, ds)}
