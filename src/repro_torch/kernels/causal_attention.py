"""Causal self-attention, forward and backward: a hand-written Hopper
kernel and its plain PyTorch version.

Replaces no TPU kernel. The reference computes attention with ``jnp``
einsums (``repro/models/layers.py``: ``attention_dense``), and the port
ran them as f32 einsums over f32 copies of q, k and v
(:func:`repro_torch.models.layers.attention_dense`). A traced training
round of GPT-2 Large on the H100 put about half of the card's time there:
QKᵀ and PV on the f32 FFMA path, and the (B, H, S, S) f32 scores passed
through some ten elementwise and softmax kernels each way, with the f32
probabilities saved for the backward. The kernel (``csrc/causal_attention.cu``)
computes the same function at the same rounding points with bf16
tensor-core products, keeping nothing of size S × S in device memory:

    s = (q·k)·scale (f32), keys after the query masked (p = 0)
    p = exp(s − m)/l (f32; m the row max, l = Σ exp(s − m))
    o = bf16(Σ bf16(p)·v)                      (f32 sum)
    dp = bf16(do·v), ds = p·(dp − Σ p·dp)·scale  (f32)
    dq = bf16(ds·k), dk = bf16(dsᵀ·q), dv = bf16(bf16(p)ᵀ·do)

with ds taken into its products at f32 precision (hi + lo bf16 parts).
Only the order of summation differs from ``attention_dense``'s autograd
graph, and the divide by l: the kernels multiply by 1/l (taken once a
row) and correct the product by one FMA, which gives the IEEE quotient
but for one ulp in about 3 of 10,000 cases, fewer ulps than the row
sum's own order of summation moves p by. Bound: tensor-core operations (14 causal-half products a layer,
the recomputations included); it never writes the scores. The forward
is one launch, the backward two (a dq kernel that also forms the row
term Σ p·dp, then a dk/dv kernel over key blocks), with no atomics: the
same inputs give the same bits on every run.

It takes bf16 q (B, S, H, D) and k, v (B, S, KH, D), head dim 64 or 128,
KH dividing H (q head h reads kv head h // (H/KH), never expanded), any
S ≥ 1, contiguous and 16-byte aligned; :func:`causal_attention` copies a
tensor that is not (``project_qkv``'s q, k and v are). The forward
saves each row's max ``m`` and sum ``l`` (B, H, S) f32, from which the
backward recomputes p to the bit.

:func:`forward` and :func:`backward` launch the kernels for CUDA tensors
and run the plain versions (:func:`forward_plain`, :func:`backward_plain`)
for CPU and meta tensors; inputs they do not take raise, on every device.
``LAUNCHES`` counts kernel launches: one a forward, two a backward.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

#: kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0

HEAD_DIMS = (64, 128)              # the kernel's template instances
MAX_BATCH_HEADS = 65535            # a grid's y dimension
_BF16 = torch.bfloat16
_F32 = torch.float32


def _scores(q, k):
    """The masked f32 scores (B, H, S, S), -inf after the query (masked by
    index, as the kernels do), and k expanded to q's heads."""
    from repro_torch.models import layers    # layers routes to this module
    s, h, d = q.shape[1], q.shape[2], q.shape[3]
    kf = layers._expand_kv(k, h).to(_F32)
    sc = torch.einsum("bshd,bthd->bhst", q.to(_F32), kf) * (1.0 / math.sqrt(d))
    i = torch.arange(s, device=q.device)
    return sc.masked_fill(i[:, None] < i[None, :], -math.inf), kf


def forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward kernel's outputs in plain PyTorch, from scores masked by
    index: o = (softmax(s) rounded to v's type)·v in f32, rounded to q's
    type, (B,S,H,D); each row's max m and sum l = Σ exp(s − m), (B,H,S)
    f32. Any type; o is ``attention_dense``'s at positions arange(S)."""
    from repro_torch.models import layers
    s, _ = _scores(q, k)
    m = torch.amax(s, dim=-1)
    l = torch.sum(torch.exp(s - m[..., None]), dim=-1)
    vf = layers._expand_kv(v, q.shape[2]).to(_F32)
    o = torch.einsum("bhst,bthd->bshd",
                     torch.softmax(s, dim=-1).to(v.dtype).to(_F32), vf)
    return o.to(q.dtype), m, l


def backward_plain(q, k, v, dout, m, l
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' recipe in plain PyTorch, from the forward's
    m and l: p = exp(s − m)/l; dp = bf16(do·v); the row term Σ p·dp;
    ds = p·(dp − row)·scale split into hi = bf16(ds) and lo = bf16(ds −
    hi); dq = (hi + lo)·k, dk = (hi + lo)ᵀ·q and dv = bf16(p)ᵀ·do in f32,
    each summed over the q heads of a kv head, then rounded once to q's,
    k's and v's types."""
    from repro_torch.models import layers
    b, s, h, d = q.shape
    kh = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    sc, kf = _scores(q, k)
    vf = layers._expand_kv(v, h).to(_F32)
    qf, dof = q.to(_F32), dout.to(_F32)
    p = torch.exp(sc - m[..., None]) / l[..., None]
    dp = torch.einsum("bshd,bthd->bhst", dof, vf).to(v.dtype).to(_F32)
    row = torch.sum(p * dp, dim=-1, keepdim=True)
    ds = p * (dp - row) * scale
    hi = ds.to(_BF16).to(_F32)
    lo = (ds - hi).to(_BF16).to(_F32)
    dq = torch.einsum("bhst,bthd->bshd", hi, kf) \
        + torch.einsum("bhst,bthd->bshd", lo, kf)
    dk = torch.einsum("bhst,bshd->bthd", hi, qf) \
        + torch.einsum("bhst,bshd->bthd", lo, qf)
    dv = torch.einsum("bhst,bshd->bthd", p.to(v.dtype).to(_F32), dof)
    group = lambda t: t.reshape(b, s, kh, h // kh, d).sum(dim=3)
    return dq.to(q.dtype), group(dk).to(k.dtype), group(dv).to(v.dtype)


def _reason(q, k, v) -> str | None:
    """Why the kernel does not take (q, k, v), or None when it does."""
    if q.dtype != _BF16 or k.dtype != _BF16 or v.dtype != _BF16:
        return f"takes bf16 q, k, v, got {q.dtype}, {k.dtype}, {v.dtype}"
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        return (f"takes q (B,S,H,D) and k, v (B,S,KH,D), got "
                f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        return (f"takes self-attention (k, v of q's batch, length and head "
                f"dim), got {tuple(q.shape)} and {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        return f"takes head dim {HEAD_DIMS}, got {d}"
    if k.shape[2] == 0 or h % k.shape[2]:
        return f"takes kv heads dividing {h} q heads, got {k.shape[2]}"
    if b * h > MAX_BATCH_HEADS:
        return f"takes batch × heads <= {MAX_BATCH_HEADS}, got {b * h}"
    if not (q.device == k.device == v.device) or \
            q.device.type not in ("cuda", "cpu", "meta"):
        return "takes q, k, v on one cuda, cpu or meta device"
    return None


def takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the kernels compute :func:`forward_plain`'s o for these
    CUDA tensors (the route's test in ``layers.attention``)."""
    return q.is_cuda and _reason(q, k, v) is None


def _check(q, k, v) -> None:
    why = _reason(q, k, v)
    if why is not None:
        raise (TypeError if "bf16" in why else ValueError)(
            f"causal_attention {why}")


def _in_place(t: torch.Tensor) -> bool:
    """Whether the kernels read t where it lies: contiguous and 16-byte
    aligned, as every fresh allocation is."""
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def _dense(t: torch.Tensor) -> torch.Tensor:
    """t, or a fresh contiguous copy where the kernels cannot read it."""
    return t if _in_place(t) else t.clone(memory_format=torch.contiguous_format)


def _check_in_place(*named) -> None:
    for name, t in named:
        if not _in_place(t):
            raise ValueError(f"causal_attention takes {name} contiguous and "
                             f"16-byte aligned, got strides {t.stride()} at "
                             f"offset {t.storage_offset()}")


@functools.cache
def _fwd_launcher():
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return build.launcher("causal_attention", "causal_attention_fwd_launch",
                          [ptr] * 6 + [i32] * 5 + [ctypes.c_float, ptr])


@functools.cache
def _bwd_launcher():
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return build.launcher("causal_attention", "causal_attention_bwd_launch",
                          [ptr] * 10 + [i32] * 5 + [ctypes.c_float, ptr])


def forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(o (B,S,H,D) bf16, m, l (B,H,S) f32): the forward kernel on CUDA
    tensors, :func:`forward_plain` on CPU and meta tensors."""
    global LAUNCHES
    _check(q, k, v)
    if q.device.type != "cuda":
        return forward_plain(q, k, v)
    b, s, h, d = q.shape
    o = q.new_empty((b, s, h, d))
    m = q.new_empty((b, h, s), dtype=_F32)
    l = torch.empty_like(m)
    if o.numel() == 0:
        return o, m, l
    _check_in_place(("q", q), ("k", k), ("v", v))
    rc = _fwd_launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), m.data_ptr(),
        l.data_ptr(), b, s, h, k.shape[2], d, 1.0 / math.sqrt(d),
        build.raw_stream(q.device.index))
    if rc != 0:
        raise RuntimeError(f"causal_attention forward launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    return o, m, l


def backward(q, k, v, dout, m, l
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in bf16 from the forward's m and l: the two backward
    kernels on CUDA tensors, :func:`backward_plain` on CPU and meta
    tensors."""
    global LAUNCHES
    _check(q, k, v)
    b, s, h, d = q.shape
    if dout.shape != q.shape or dout.dtype != _BF16 or \
            dout.device != q.device:
        raise ValueError(f"causal_attention backward takes do like q "
                         f"{tuple(q.shape)} bf16, got {tuple(dout.shape)} "
                         f"{dout.dtype} on {dout.device}")
    for t in (m, l):
        if t.shape != (b, h, s) or t.dtype != _F32 or \
                t.device != q.device or not t.is_contiguous():
            raise ValueError(f"causal_attention backward takes m, l "
                             f"{(b, h, s)} f32 contiguous, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if q.device.type != "cuda":
        return backward_plain(q, k, v, dout, m, l)
    dq = q.new_empty((b, s, h, d))
    dk = k.new_empty(k.shape)
    dv = v.new_empty(v.shape)
    if dq.numel() == 0:
        return dq, dk, dv
    _check_in_place(("q", q), ("k", k), ("v", v), ("do", dout))
    row = m.new_empty((2, b, h, s))          # the row term, 1/l
    rc = _bwd_launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        m.data_ptr(), l.data_ptr(), row.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, h, k.shape[2], d,
        1.0 / math.sqrt(d), build.raw_stream(q.device.index))
    if rc != 0:
        raise RuntimeError(f"causal_attention backward launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES += 2
    return dq, dk, dv


class _CausalAttention(torch.autograd.Function):
    """Forward and backward both kernels; q, k, v (bf16) and the rows' m
    and l are saved, nothing of size S × S."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, m, l = forward(q, k, v)
        ctx.save_for_backward(q, k, v, m, l)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, m, l = ctx.saved_tensors
        return backward(q, k, v, _dense(dout), m, l)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> torch.Tensor:
    """Causal self-attention of bf16 q (B,S,H,D) over k, v (B,S,KH,D),
    differentiable: ``attention_dense``'s function, by the kernels on the
    card."""
    _check(q, k, v)
    if q.device.type == "cuda":
        q, k, v = _dense(q), _dense(k), _dense(v)
    return _CausalAttention.apply(q, k, v)
