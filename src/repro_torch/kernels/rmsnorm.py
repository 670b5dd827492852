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
:func:`rmsnorm_plain` for CPU tensors; any other device raises. The CUDA
path keeps its host work small, since at the trainer's size the host's
dispatch, not the kernel, sets the time of a call: the launcher is
resolved once, the checks read a few attributes, and the stream comes
from one call. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0

MAX_D = 8192                       # as in csrc/rmsnorm.cu
_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_plain(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, d) -> (out in x's type, rstd (rows,) f32): the reference's op
    sequence (``ref.rmsnorm_ref``) in torch."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    out = (xf * rstd * gamma.to(torch.float32)).to(x.dtype)
    return out, rstd.reshape(-1)


def _check(x: torch.Tensor, gamma: torch.Tensor) -> None:
    if x.dtype not in _TYPES or gamma.dtype not in _TYPES:
        raise TypeError(f"rmsnorm takes f32 or bf16 x and gamma, got "
                        f"{x.dtype} and {gamma.dtype}")
    if x.dim() != 2 or x.shape[1] == 0 or gamma.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm takes x (rows, d >= 1) and gamma (d,), "
                         f"got {tuple(x.shape)} and {tuple(gamma.shape)}")
    if x.device != gamma.device:
        raise ValueError(f"x on {x.device}, gamma on {gamma.device}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no rmsnorm kernel for device {x.device}")


_F32 = torch.float32


@functools.cache
def _launcher():
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    return build.launcher("rmsnorm", "rmsnorm_launch",
                          [ptr, i32, i64, ptr, i32, i64, ptr, ptr, i64, i32,
                           ctypes.c_float, ptr])


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, d) -> (out in x's type, rstd (rows,) f32): the kernel on CUDA
    tensors, the plain version on CPU tensors."""
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
