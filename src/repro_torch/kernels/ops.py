"""Flat-vector entry points of the codec kernels, under the reference's
names (``repro/kernels/ops.py``: ``qsgd_compress``, ``qsgd_decompress``,
``topk_sparsify``).

The reference pads a flat vector to (R, 128) tiles around each Pallas
call; the port's kernels take the flat vector itself, so codes keep the
input's length and there is no padding to cut off. A CUDA tensor goes to
the kernel, a CPU tensor to the plain version, and any other device
raises; there is no switch besides the tensor's device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import quantize as _q
from repro_torch.kernels.topk_sparsify import topk_sparsify  # noqa: F401


def qsgd_compress(flat: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """(L,) f32 -> (codes int8 (L,), scales f32 (ceil(L/4096),), L)."""
    codes, scales = _q.quantize(flat)
    return codes, scales, int(flat.shape[0])


def qsgd_decompress(codes: torch.Tensor, scales: torch.Tensor,
                    start: int = 0, stop: int | None = None) -> torch.Tensor:
    """Elements ``[start, stop)`` (default: all) of a compressed vector,
    decoded to f32."""
    return _q.dequantize(codes, scales, start, stop)
