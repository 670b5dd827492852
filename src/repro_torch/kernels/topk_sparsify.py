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

A tile that holds a NaN has a NaN ``hi``, so no count reaches ``k``,
``lo`` stays 0, every non-NaN element is kept and NaN is zeroed, as in the
reference's numpy mirror.

The kernel (``csrc/topk_sparsify.cu``) is bound by device-memory bytes: it
reads and writes 4 bytes per element. A persistent grid walks the tiles;
each block streams its next tile into shared memory (16-byte ``cp.async``)
while it searches the current one from registers, and once at most 256
elements can still fall on either side of a ``mid``, one warp finishes the
24 steps on those alone. Each step is decided by the same exact count as
the plain version's, so the two agree bit for bit.

:func:`topk_sparsify` launches the kernel for a CUDA tensor and runs
:func:`topk_plain` for a CPU tensor; any other device raises. ``LAUNCHES``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

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


@functools.cache
def _launcher():
    return build.launcher("topk_sparsify", "topk_sparsify_launch",
                          [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_void_p])


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
    out = torch.empty_like(x)
    if n == 0:
        return out
    rc = _launcher()(x.data_ptr(), n, int(k_per_block), out.data_ptr(),
                     build.raw_stream(x.device.index))
    if rc != 0:
        raise RuntimeError(f"topk kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
