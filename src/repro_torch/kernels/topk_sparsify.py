"""Per-tile magnitude top-k sparsification (the ``topk`` wire codec): a
hand-written Hopper kernel and its plain PyTorch version.

Replaces the Pallas TPU kernel ``topk_sparsify`` of the reference package
(``repro/kernels/topk_sparsify.py``) and its flat-vector wrapper
``topk_sparsify`` (``repro/kernels/ops.py``).

Per 4096-element tile (the last one zero-padded) the threshold comes from
``BISECT_ITERS`` f32 bisection steps: ``lo = 0``, ``hi = max|x| + 1e-12``,
then ``mid = 0.5 · (lo + hi)`` and ``lo = mid`` while at least ``k``
elements have ``|x| >= mid``, else ``hi = mid``. Every element with
``|x| < lo`` is zeroed; ties at the threshold may keep more than ``k``.

The kernel (``csrc/topk_sparsify.cu``) is bound by device-memory bytes: it
reads and writes 4 bytes per element, one block per tile with the tile in
registers, so the 24 counting passes never touch device memory.

:func:`topk_sparsify` launches the kernel for a CUDA tensor and runs
:func:`topk_plain` for a CPU tensor; any other device raises. ``LAUNCHES``
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.quantize import _check_vector, f32_scalar, pad_tiles

BISECT_ITERS = 24

#: kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0


def topk_plain(x: torch.Tensor, k_per_block: int) -> torch.Tensor:
    """(n,) f32 -> (n,) f32 with all but ~``k_per_block`` largest-|x|
    entries of each tile zeroed, in whole-tensor torch ops."""
    n = int(x.shape[0])
    tiles = pad_tiles(x.to(torch.float32))
    ax = tiles.abs()
    lo = torch.zeros(tiles.shape[0], dtype=torch.float32, device=x.device)
    hi = ax.amax(dim=1) + f32_scalar(1e-12, x.device)
    half = f32_scalar(0.5, x.device)
    for _ in range(BISECT_ITERS):
        mid = half * (lo + hi)
        keep = (ax >= mid[:, None]).sum(dim=1) >= k_per_block
        lo = torch.where(keep, mid, lo)
        hi = torch.where(keep, hi, mid)
    dense = torch.where(ax >= lo[:, None], tiles, f32_scalar(0.0, x.device))
    return dense.reshape(-1)[:n]


def _library() -> ctypes.CDLL:
    lib = build.load("topk_sparsify")
    fn = lib.topk_sparsify_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def topk_sparsify(x: torch.Tensor, k_per_block: int) -> torch.Tensor:
    """The tile-local top-k of a flat f32 vector, dense: the kernel on a
    CUDA tensor (any start offset), the plain version on a CPU tensor."""
    global LAUNCHES
    _check_vector(x, torch.float32, "topk input")
    if x.device.type == "cpu":
        return topk_plain(x, k_per_block)
    if x.device.type != "cuda":
        raise ValueError(f"no topk kernel for device {x.device}")
    n = int(x.shape[0])
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    lib = _library()
    rc = lib.topk_sparsify_launch(
        x.data_ptr(), n, int(k_per_block), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"topk kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
