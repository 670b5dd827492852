"""Fused RMSNorm over rows: a hand-written Hopper kernel and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``rmsnorm`` of the reference package
(``repro/kernels/rmsnorm.py``: ``_rmsnorm_kernel``). Per row of a
(rows, d) matrix, d ≤ 8192:

    out = x · rsqrt(mean(x²) + eps) · γ      (in f32, cast to x's type)

``x`` is f32 or bf16, ``γ`` f32 or bf16 (the model's norms are f32
parameters applied to bf16 activations). Both versions also return the
per-row ``rstd = rsqrt(mean(x²) + eps)`` in f32, which the model's
backward pass (plain PyTorch, ``models/layers.py``) reuses.

The kernel (``csrc/rmsnorm.cu``) is bound by device-memory bytes; at the
trainer's (512, 2048) it is short enough that latency decides. One block
normalises one row from registers (128 threads up to d = 2048, 256
above), with its part of ``γ`` read straight into registers, once per
block. Loads and stores are 16 bytes wide where the addresses and widths
allow it, element by element otherwise; ``x`` may be any view whose rows
are contiguous (``stride(1) == 1``), and is never copied.
The sum runs in another order than ``torch.mean``'s, so it agrees with
:func:`rmsnorm_plain` to a tolerance: rtol 1e-5 and atol 1e-6 for f32
output, one bf16 ulp for bf16.

:func:`rmsnorm` launches the kernel for CUDA tensors and runs
:func:`rmsnorm_plain` for CPU tensors and for meta tensors (which hold no
data, so no kernel exists to launch: the meta-device dry run); any other
device raises. The CUDA
path keeps its host work small, since at the trainer's size the host's
dispatch, not the kernel, sets the time of a call: the launcher is
resolved once, the checks read a few attributes, and the stream comes
from one call. ``LAUNCHES`` counts kernel launches.

**The split route.** Under tensor parallelism a row may be cut over the
ranks of the ``model`` axis (Mamba-2's gated norm, whose ``d_inner`` is
split). Two more entry points of the same source normalise such a row
without holding it whole, with the whole-row kernel's own load, sum and
store code:

    rmsnorm_sumsq(x)                         -> Σx² of each row's block (f32)
    (an all-reduce of that sum over ``model``, by the caller)
    rmsnorm_scale(x, ssq, γ, eps, d_total)
        -> (x·rsqrt(ssq/d_total + eps)·γ, rstd)

The scale launch does no reduction of its own. Two launches a split norm,
counted apart in ``SPLIT_LAUNCHES``; ``LAUNCHES`` counts the whole-row
kernel only. Against :func:`rmsnorm_plain` of the whole row the split
route holds the whole-row tolerance (rtol 1e-5 and atol 1e-6 for f32, one
bf16 ulp for bf16); with one block (``d_total`` = d) its sum is the
whole-row kernel's, so the two agree bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0
#: the split route's launches (two a split norm), apart from LAUNCHES
SPLIT_LAUNCHES = 0

MAX_D = 8192                       # as in csrc/rmsnorm.cu
_TYPES = {torch.float32: 0, torch.bfloat16: 1}
_F32 = torch.float32


def rmsnorm_plain(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, d) -> (out in x's type, rstd (rows,) f32): the reference's op
    sequence (``ref.rmsnorm_ref``) in torch."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    out = (xf * rstd * gamma.to(torch.float32)).to(x.dtype)
    return out, rstd.reshape(-1)


def _check(x: torch.Tensor, gamma: torch.Tensor | None = None,
           ssq: torch.Tensor | None = None, d_total: int = 0) -> None:
    """x (rows, d >= 1) f32 or bf16; gamma (d,) where given; for the split
    route's scale, ssq (rows,) f32 and d_total >= d; all on one device
    that has a kernel or a plain version."""
    if x.dtype not in _TYPES or (gamma is not None
                                 and gamma.dtype not in _TYPES):
        raise TypeError(f"rmsnorm takes f32 or bf16 x and gamma, got "
                        f"{x.dtype} and {getattr(gamma, 'dtype', None)}")
    if x.dim() != 2 or x.shape[1] == 0 or (
            gamma is not None and gamma.shape != (x.shape[1],)):
        raise ValueError(f"rmsnorm takes x (rows, d >= 1) and gamma (d,), "
                         f"got {tuple(x.shape)} and "
                         f"{getattr(gamma, 'shape', None)}")
    for t in (gamma, ssq):
        if t is not None and t.device != x.device:
            raise ValueError(f"x on {x.device}, another operand on "
                             f"{t.device}")
    if x.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"no rmsnorm kernel for device {x.device}")
    if ssq is not None and (ssq.dtype != _F32 or ssq.shape != (x.shape[0],)
                            or d_total < x.shape[1]):
        raise ValueError(
            f"rmsnorm_scale takes x (rows, d), ssq (rows,) f32 and d_total "
            f">= d; got {tuple(x.shape)}, {tuple(ssq.shape)} {ssq.dtype}, "
            f"{d_total}")




@functools.cache
def _launcher():
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    return build.launcher("rmsnorm", "rmsnorm_launch",
                          [ptr, i32, i64, ptr, i32, i64, ptr, ptr, i64, i32,
                           ctypes.c_float, ptr])


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, d) -> (out in x's type, rstd (rows,) f32): the kernel on CUDA
    tensors, the plain version on CPU and meta tensors."""
    global LAUNCHES
    device = x.device
    if device.type != "cuda":
        _check(x, gamma)
        return rmsnorm_plain(x, gamma, eps)
    # each attribute read once: at the trainer's size the host's work is
    # the call's time
    shape, xs, gs = x.shape, x.stride(), gamma.stride()
    xt, gt = _TYPES.get(x.dtype), _TYPES.get(gamma.dtype)
    if xt is None or gt is None or len(xs) != 2 or len(gs) != 1 \
            or not 0 < shape[1] <= MAX_D or gamma.numel() != shape[1] \
            or gamma.device != device:
        _check(x, gamma)
        raise ValueError(f"the rmsnorm kernel takes d <= {MAX_D}, got "
                         f"{tuple(shape)}")
    rows, d = shape
    if xs[1] != 1 and d > 1:
        raise ValueError(f"the rmsnorm kernel takes rows with stride(1) == "
                         f"1, got strides {xs}")
    out = torch.empty_like(x) if xs[0] == d else x.new_empty((rows, d))
    rstd = x.new_empty(rows, dtype=_F32)
    if rows == 0:
        return out, rstd
    rc = _launcher()(
        x.data_ptr(), xt, xs[0], gamma.data_ptr(), gt, gs[0], out.data_ptr(),
        rstd.data_ptr(), rows, d, eps, build.raw_stream(device.index))
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out, rstd


# ---------------------------------------------------------------------------
# The split route: a row cut over the ranks of the model axis
# ---------------------------------------------------------------------------

def rmsnorm_sumsq_plain(x: torch.Tensor) -> torch.Tensor:
    """(rows, d) -> each row's f32 Σx² over this block."""
    xf = x.to(torch.float32)
    return torch.sum(xf * xf, dim=-1)


def rmsnorm_scale_plain(x: torch.Tensor, ssq: torch.Tensor,
                        gamma: torch.Tensor, eps: float, d_total: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, d) block, the rows' Σx² over the whole width ``d_total`` ->
    (out in x's type, rstd (rows,) f32), as :func:`rmsnorm_plain` forms
    them."""
    rstd = torch.rsqrt(ssq.to(torch.float32)[:, None] / d_total + eps)
    out = (x.to(torch.float32) * rstd * gamma.to(torch.float32)).to(x.dtype)
    return out, rstd.reshape(-1)


def _check_split(x: torch.Tensor, gamma: torch.Tensor | None = None,
                 ssq: torch.Tensor | None = None, d_total: int = 0) -> None:
    _check(x, gamma, ssq, d_total)
    if x.shape[1] > MAX_D:
        raise ValueError(f"the rmsnorm split route takes x (rows, 1..{MAX_D}),"
                         f" got {tuple(x.shape)}")


def _row_view(x: torch.Tensor) -> None:
    if x.stride(1) != 1 and x.shape[1] > 1:
        raise ValueError(f"the rmsnorm kernel takes rows with stride(1) == "
                         f"1, got strides {x.stride()}")


@functools.cache
def _sumsq_launcher():
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    return build.launcher("rmsnorm", "rmsnorm_sumsq_launch",
                          [ptr, i32, i64, ptr, i64, i32, ptr])


@functools.cache
def _scale_launcher():
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    return build.launcher("rmsnorm", "rmsnorm_scale_launch",
                          [ptr, i32, i64, ptr, ptr, i32, i64, ptr, ptr, i64,
                           i32, i64, ctypes.c_float, ptr])


def rmsnorm_sumsq(x: torch.Tensor) -> torch.Tensor:
    """(rows, d) -> (rows,) f32 Σx² of each row's block: the kernel's first
    split entry point on CUDA tensors, the plain version otherwise."""
    global SPLIT_LAUNCHES
    _check_split(x)
    if x.device.type != "cuda":
        return rmsnorm_sumsq_plain(x)
    _row_view(x)
    rows, d = x.shape
    ssq = x.new_empty(rows, dtype=_F32)
    if rows == 0:
        return ssq
    rc = _sumsq_launcher()(x.data_ptr(), _TYPES[x.dtype], x.stride(0),
                           ssq.data_ptr(), rows, d,
                           build.raw_stream(x.device.index))
    if rc != 0:
        raise RuntimeError(f"rmsnorm_sumsq kernel launch failed: CUDA error "
                           f"{rc}")
    SPLIT_LAUNCHES += 1
    return ssq


def rmsnorm_scale(x: torch.Tensor, ssq: torch.Tensor, gamma: torch.Tensor,
                  eps: float, d_total: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """A row block's norm from its rows' Σx² over the whole width
    ``d_total`` (summed over the ranks by the caller): (out in x's type,
    rstd (rows,) f32). The kernel's second split entry point on CUDA
    tensors, the plain version otherwise."""
    global SPLIT_LAUNCHES
    _check_split(x, gamma, ssq, d_total)
    if x.device.type != "cuda":
        return rmsnorm_scale_plain(x, ssq, gamma, eps, d_total)
    _row_view(x)
    if not ssq.is_contiguous():
        raise ValueError("rmsnorm_scale takes a contiguous ssq")
    rows, d = x.shape
    out = x.new_empty((rows, d))
    rstd = x.new_empty(rows, dtype=_F32)
    if rows == 0:
        return out, rstd
    rc = _scale_launcher()(
        x.data_ptr(), _TYPES[x.dtype], x.stride(0), ssq.data_ptr(),
        gamma.data_ptr(), _TYPES[gamma.dtype], gamma.stride(0),
        out.data_ptr(), rstd.data_ptr(), rows, d, d_total, eps,
        build.raw_stream(x.device.index))
    if rc != 0:
        raise RuntimeError(f"rmsnorm_scale kernel launch failed: CUDA error "
                           f"{rc}")
    SPLIT_LAUNCHES += 1
    return out, rstd
