"""Fused SGD-with-momentum update: a hand-written Hopper kernel and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``fused_sgd`` of the reference package
(``repro/kernels/fused_sgd.py``: ``_sgd_kernel``) and its flat-vector
wrapper ``sgd_momentum_update`` (``repro/kernels/ops.py``), which donates
``p`` and ``v``. The port updates them in place instead:

    v ← μ·v + g;  p ← p − η·v

``p`` is f32 or bf16 (it keeps its type), ``g`` f32 or bf16, ``v`` f32.
The update is bound by device-memory bytes: three reads and two writes per
element, 20 bytes for an f32 ``p``, and three operations. The CUDA kernel
(``csrc/fused_sgd.cu``) is one grid-stride pass over the flat leaf with
16-byte vector loads of ``v`` (and of an f32 ``p`` or ``g``; 8 bytes of a
bf16 one) from the first index where all three are aligned, scalar loads
before it and at the ragged end; a leaf whose three offsets no index
aligns runs the scalar loop throughout.

Bits: the kernel rounds every operation to nearest and contracts none, so
it equals :func:`fused_sgd_plain` on the card bit for bit. ``μ`` and ``η``
reach both as f32, the way PyTorch turns a Python scalar into the operand
of an f32 op.

:func:`fused_sgd` launches the kernel for CUDA tensors and runs
:func:`fused_sgd_plain` for CPU tensors and for meta tensors (no data, so
no kernel to launch: the meta-device dry run); any other device raises.
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0

_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_sgd_plain(p: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
                    lr: float, momentum: float = 0.9
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in whole-tensor torch ops, in place on ``p``
    and ``v``. No ``alpha=``, ``addcmul`` or ``lerp``: they fuse."""
    v.mul_(momentum).add_(g)
    p.sub_(v * lr)
    return p, v


def _check(p: torch.Tensor, g: torch.Tensor, v: torch.Tensor) -> None:
    if p.dtype not in _TYPES or g.dtype not in _TYPES:
        raise TypeError(f"fused_sgd takes f32 or bf16 p and g, got {p.dtype} "
                        f"and {g.dtype}")
    if v.dtype != torch.float32:
        raise TypeError(f"velocity must be float32, got {v.dtype}")
    if not p.shape == g.shape == v.shape:
        raise ValueError(f"shapes differ: p {tuple(p.shape)}, g "
                         f"{tuple(g.shape)}, v {tuple(v.shape)}")
    if not p.device == g.device == v.device:
        raise ValueError(f"devices differ: p {p.device}, g {g.device}, v "
                         f"{v.device}")
    if p.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"no fused_sgd kernel for device {p.device}")


@functools.cache
def _launcher():
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return build.launcher("fused_sgd", "fused_sgd_launch",
                          [ptr, i32, ptr, i32, ptr, ctypes.c_int64,
                           ctypes.c_float, ctypes.c_float, ptr])


def fused_sgd(p: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
              lr: float, momentum: float = 0.9
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``v ← μ·v + g; p ← p − η·v`` in place; returns ``(p, v)``. The
    kernel on CUDA tensors (contiguous, any shape and start offset), the
    plain version on CPU and meta tensors."""
    global LAUNCHES
    _check(p, g, v)
    if p.device.type != "cuda":
        return fused_sgd_plain(p, g, v, lr, momentum)
    if not (p.is_contiguous() and g.is_contiguous() and v.is_contiguous()):
        raise ValueError("fused_sgd takes contiguous tensors on the card")
    n = p.numel()
    if n == 0:
        return p, v
    rc = _launcher()(
        p.data_ptr(), _TYPES[p.dtype], g.data_ptr(), _TYPES[g.dtype],
        v.data_ptr(), n, lr, momentum, build.raw_stream(p.device.index))
    if rc != 0:
        raise RuntimeError(f"fused_sgd kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return p, v
