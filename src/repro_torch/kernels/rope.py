"""Rotary position embedding (RoPE), forward and backward: a hand-written
Hopper kernel and its plain PyTorch version.

Replaces no TPU kernel. The reference rotates with ``jnp`` ops
(``repro/models/layers.py``: ``apply_rope``), and the port ran the same
chain (:func:`apply_rope_plain`): the cos/sin table built anew from the
positions (nine launches), then the rotation over an f32 copy of x, its
two halves and a ``torch.cat`` (nine launches forward, ten backward). A
GPT-2 Large step calls it for q and k in each of 36 layers: 2,016 of the
step's ~4,800 launches. The kernel (``csrc/rope.cu``) rotates in one
launch each way at the chain's rounding points:

    forward   out1 = x1·c − x2·s,  out2 = x1·s + x2·c
    backward  dx1  = g1·c + g2·s,  dx2  = g2·c − g1·s

each product and sum rounded to f32, the result to x's type. The backward
is what autograd does through the plain chain (two-term sums, whose order
cannot move their bits), so both give the plain path's bits on the card.
Bound: device-memory bytes, one read of x and one write of the output.

The table is the plain chain's own (:func:`table_plain`: the same torch
ops, so the same bits), kept in a one-entry memo (:func:`table`) keyed by
the positions tensor itself (``is``, which the memo's reference keeps from
being reused), its ``_version``, the head dim and theta. The transformer
passes one positions tensor to every layer, so a forward builds one table
where the plain chain built two a layer. Positions made under inference
mode carry no version counter: their table is built each call, as the
plain chain did.

:func:`rope` is differentiable; :func:`rotate` launches the kernel for
CUDA tensors and runs the plain rotation for CPU and meta tensors. The
route (``layers.apply_rope``) takes the kernel where :func:`takes` holds;
everything else runs :func:`apply_rope_plain`. ``LAUNCHES`` counts kernel
launches (one a rotation each way), ``TABLE_BUILDS`` the memo's misses.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0
#: tables built by :func:`table` (its memo's misses)
TABLE_BUILDS = 0

_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_F32 = torch.float32
MAX_PAIRS = 2 ** 31 - 1            # B·S·H·hd/2 the kernel indexes in 32 bits

# (positions, its _version, head_dim, theta, cos, sin) of the last table
_MEMO: tuple | None = None


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=_F32,
                                         device=device) / head_dim))


def table_plain(positions: torch.Tensor, head_dim: int, theta: float,
                device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of the angles positions × freqs, (*positions.shape,
    head_dim/2) f32, with ``freqs`` made on ``device`` (positions' own by
    default)."""
    freqs = rope_freqs(head_dim, theta,
                       positions.device if device is None else device)
    angles = positions[..., None].to(_F32) * freqs
    return torch.cos(angles), torch.sin(angles)


def rotate_plain(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                 ) -> torch.Tensor:
    """x (..., hd) rotated by cos and sin broadcastable to (..., hd/2), in
    f32, cast back to x's type."""
    x1, x2 = x.to(_F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rotate_backward_plain(g: torch.Tensor, cos: torch.Tensor,
                          sin: torch.Tensor) -> torch.Tensor:
    """The gradient of :func:`rotate_plain` with respect to x, from the
    output's gradient g, as autograd forms it through the chain."""
    g1, g2 = g.to(_F32).chunk(2, dim=-1)
    dx = torch.cat([g1 * cos + g2 * sin, g2 * cos - g1 * sin], dim=-1)
    return dx.to(g.dtype)


def apply_rope_plain(x: torch.Tensor, positions: torch.Tensor, theta: float
                     ) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: broadcastable to (..., S).
    Rotates the two halves of each head (the reference's layout)."""
    cos, sin = table_plain(positions, x.shape[-1], theta, x.device)
    return rotate_plain(x, cos[..., None, :], sin[..., None, :])


def table(positions: torch.Tensor, head_dim: int, theta: float
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`table_plain` of these positions, from the memo when it holds
    this very tensor, unchanged since, at this head dim and theta. An
    inference tensor keeps no version counter, so its table is built
    every call and not kept."""
    global _MEMO, TABLE_BUILDS
    if positions.is_inference():
        TABLE_BUILDS += 1
        return table_plain(positions, head_dim, theta)
    memo = _MEMO
    if (memo is not None and memo[0] is positions
            and memo[1] == positions._version and memo[2] == head_dim
            and memo[3] == theta):
        return memo[4], memo[5]
    cos, sin = table_plain(positions, head_dim, theta)
    _MEMO = (positions, positions._version, head_dim, theta, cos, sin)
    TABLE_BUILDS += 1
    return cos, sin


def takes(x: torch.Tensor, positions: torch.Tensor) -> bool:
    """Whether the kernel rotates x (B, S, H, hd) at these positions (the
    route's test in ``layers.apply_rope``): a contiguous CUDA tensor of
    f32, bf16 or f16 with an even head dim, positions 1-D of length S or 1
    on x's device."""
    return (x.is_cuda and x.dtype in _TYPES and x.dim() == 4
            and x.is_contiguous() and x.shape[-1] % 2 == 0
            and 0 < x.numel() // 2 <= MAX_PAIRS and positions.dim() == 1
            and positions.shape[0] in (x.shape[1], 1)
            and positions.device == x.device)


@functools.cache
def _launcher():
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return build.launcher("rope", "rope_rotate_launch",
                          [ptr, i32, ptr, ptr, i32, ptr, i32, i32, i32, i32,
                           i32, ptr])


def _check(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> None:
    if x.dtype not in _TYPES or cos.dtype != _F32 or sin.dtype != _F32:
        raise TypeError(f"rope takes f32, bf16 or f16 x and an f32 table, "
                        f"got {x.dtype}, {cos.dtype}, {sin.dtype}")
    if x.dim() != 4 or x.shape[-1] % 2 or x.shape[-1] == 0:
        raise ValueError(f"rope takes x (B, S, H, hd) with hd even, got "
                         f"{tuple(x.shape)}")
    want = (x.shape[-1] // 2,)
    if cos.dim() != 2 or cos.shape != sin.shape or \
            cos.shape[0] not in (x.shape[1], 1) or cos.shape[1:] != want:
        raise ValueError(f"rope takes a table (S or 1, hd/2) for x "
                         f"{tuple(x.shape)}, got {tuple(cos.shape)} and "
                         f"{tuple(sin.shape)}")
    if not (x.device == cos.device == sin.device) or \
            x.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError("rope takes x and its table on one cuda, cpu or "
                         "meta device")


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
           backward: bool = False) -> torch.Tensor:
    """x (B, S, H, hd) rotated by the table (S or 1, hd/2), or with
    ``backward`` the gradient through that rotation of an output gradient
    x: the kernel on CUDA tensors, the plain versions on CPU and meta
    tensors. The result is contiguous, in x's type."""
    global LAUNCHES
    _check(x, cos, sin)
    if x.device.type != "cuda":
        plain = rotate_backward_plain if backward else rotate_plain
        return plain(x, cos[:, None, :], sin[:, None, :])
    b, s, h, d = x.shape
    if not x.is_contiguous():
        raise ValueError(f"the rope kernel takes a contiguous x, got "
                         f"strides {x.stride()}")
    if not 0 < x.numel() // 2 <= MAX_PAIRS:
        raise ValueError(f"the rope kernel takes 1..{MAX_PAIRS} pairs, got "
                         f"{tuple(x.shape)}")
    if not (cos.is_contiguous() and sin.is_contiguous()):
        raise ValueError("the rope kernel takes a contiguous table")
    out = torch.empty_like(x)
    rc = _launcher()(
        x.data_ptr(), _TYPES[x.dtype], cos.data_ptr(), sin.data_ptr(),
        int(cos.shape[0] != 1), out.data_ptr(), b, s, h, d // 2,
        int(backward), build.raw_stream(x.device.index))
    if rc != 0:
        raise RuntimeError(f"rope kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


class _Rope(torch.autograd.Function):
    """Both directions one :func:`rotate`; the table is kept on the
    context (not saved as a tensor: the memo may have built it under
    inference mode)."""

    @staticmethod
    def forward(ctx, x, cos, sin):
        ctx.table = (cos, sin)
        return rotate(x, cos, sin)

    @staticmethod
    def backward(ctx, g):
        return rotate(g.contiguous(), *ctx.table, backward=True), None, None


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x (B, S, H, hd) rotated at positions (S,) or (1,), differentiable:
    :func:`apply_rope_plain`'s function, by the kernel on the card, with
    the table from :func:`table`."""
    cos, sin = table(positions, x.shape[-1], theta)
    return _Rope.apply(x, cos, sin)
