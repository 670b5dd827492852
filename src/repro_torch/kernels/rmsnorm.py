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

The kernel (``csrc/rmsnorm.cu``) runs one block per row: a strided f32 sum
of squares, a warp-shuffle and shared-memory reduction in a fixed order,
then the scaled row. It is bound by device-memory bytes for large inputs
and by the launch at the trainer's (512, 2048). Its sum runs in another
order than ``torch.mean``'s, so it agrees with :func:`rmsnorm_plain` to a
tolerance: rtol 1e-5 and atol 1e-6 for f32 output, one bf16 ulp for bf16.

:func:`rmsnorm` launches the kernel for CUDA tensors and runs
:func:`rmsnorm_plain` for CPU tensors; any other device raises.
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

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


def _library() -> ctypes.CDLL:
    lib = build.load("rmsnorm")
    if lib.rmsnorm_launch.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rmsnorm_launch.argtypes = [ptr, i32, ptr, i32, ptr, ptr,
                                       ctypes.c_int64, i32, ctypes.c_float,
                                       ptr]
        lib.rmsnorm_launch.restype = ctypes.c_int
    return lib


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, d) -> (out in x's type, rstd (rows,) f32): the kernel on CUDA
    tensors (``x`` is made contiguous first), the plain version on CPU
    tensors."""
    global LAUNCHES
    _check(x, gamma)
    if x.device.type == "cpu":
        return rmsnorm_plain(x, gamma, eps)
    rows, d = x.shape
    if d > MAX_D:
        raise ValueError(f"the rmsnorm kernel takes d <= {MAX_D}, got {d}")
    x = x.contiguous()
    gamma = gamma.contiguous()
    out = torch.empty_like(x)
    rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows == 0:
        return out, rstd
    rc = _library().rmsnorm_launch(
        x.data_ptr(), _TYPES[x.dtype], gamma.data_ptr(), _TYPES[gamma.dtype],
        out.data_ptr(), rstd.data_ptr(), rows, d, eps,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out, rstd
