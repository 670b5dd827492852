"""Per-tile int8 quantization (the ``qsgd8`` wire codec): hand-written
Hopper kernels and their plain PyTorch versions.

Replaces the Pallas TPU kernels ``quantize`` and ``dequantize`` of the
reference package (``repro/kernels/quantize.py``) and their flat-vector
wrappers ``qsgd_compress`` / ``qsgd_decompress`` (``repro/kernels/ops.py``).

A tile is ``TILE`` = 32 × 128 = 4096 consecutive elements of a flat f32
vector, the last one zero-padded. Per tile: ``amax = max|x|``, ``scale =
amax / 127`` (1.0 when ``amax`` is 0 or NaN), ``codes = clip(round(x /
scale), ±127)`` as int8, rounding half to even; a NaN quotient codes to
0. A NaN anywhere in a tile makes its ``amax`` NaN, as ``np.max`` does.
Codes keep the input's length and scales are one f32 per tile: the layout
of the reference's wire payload. Dequantize computes ``f32(code) · scale``
over any range ``[start, stop)``.

Both kernels (``csrc/quantize.cu``) are bound by device-memory bytes:
quantize reads 4 and writes 1 byte per element, dequantize the reverse.
Quantize runs one block per tile with the tile in registers, so each input
element is read once; dequantize is one elementwise pass.

:func:`quantize` and :func:`dequantize` launch the kernels for CUDA tensors
and run :func:`quantize_plain` / :func:`dequantize_plain` for CPU tensors;
any other device raises. ``QUANTIZE_LAUNCHES`` and ``DEQUANTIZE_LAUNCHES``
count kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

LANES = 128
BLOCK_ROWS = 32
TILE = BLOCK_ROWS * LANES        # elements per tile, as in csrc/quantize.cu
QMAX = 127.0

#: kernel launches since import (or since a caller reset them to 0)
QUANTIZE_LAUNCHES = 0
DEQUANTIZE_LAUNCHES = 0


def tiles_of(n_elems: int) -> int:
    return math.ceil(n_elems / TILE)


def pad_tiles(flat: torch.Tensor) -> torch.Tensor:
    """(L,) -> (n_tiles, TILE), zero-padded: the reference's tiling."""
    n = int(flat.shape[0])
    nt = tiles_of(n)
    if nt * TILE != n:
        flat = torch.nn.functional.pad(flat, (0, nt * TILE - n))
    return flat.reshape(nt, TILE)


def f32_scalar(value: float, device) -> torch.Tensor:
    """A 0-d f32 tensor on ``device``. The plain versions divide by device
    tensors, never by a Python number: CUDA's true divide by a CPU scalar
    multiplies by the reciprocal, which can be 1 ulp off the quotient."""
    return torch.full((), value, dtype=torch.float32, device=device)


def quantize_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(n,) f32 -> (codes int8 (n,), scales f32 (ceil(n/4096),)), the
    kernel's arithmetic in whole-tensor torch ops."""
    n = int(x.shape[0])
    tiles = pad_tiles(x.to(torch.float32))
    amax = tiles.abs().amax(dim=1)
    scales = torch.where(amax > 0, amax / f32_scalar(QMAX, x.device),
                         f32_scalar(1.0, x.device))
    q = torch.clamp(torch.round(tiles / scales[:, None]), -QMAX, QMAX)
    # a NaN quotient codes to 0, as the reference's numpy cast gives; the
    # float-to-int8 cast alone leaves NaN to the platform
    q = torch.nan_to_num(q, nan=0.0)
    return q.to(torch.int8).reshape(-1)[:n], scales


def dequantize_plain(codes: torch.Tensor, scales: torch.Tensor,
                     start: int = 0, stop: int | None = None
                     ) -> torch.Tensor:
    """``f32(codes[i]) · scales[i // 4096]`` for i in ``[start, stop)``."""
    stop = int(codes.shape[0]) if stop is None else stop
    tile = torch.arange(start, stop, device=codes.device) // TILE
    return codes[start:stop].to(torch.float32) * scales[tile]


def _check_vector(x: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if x.dim() != 1:
        raise ValueError(f"{what} must be 1-D, got shape {tuple(x.shape)}")
    if x.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {x.dtype}")
    if x.shape[0] > 1 and x.stride(0) != 1:
        raise ValueError(f"{what} must be contiguous")


_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_ARGTYPES = {"qsgd_quantize_launch": [_P, _I64, _P, _P, _P],
             "qsgd_dequantize_launch": [_P, _P, _I64, _I64, _P, _P]}


@functools.cache
def _launcher(symbol: str):
    return build.launcher("quantize", symbol, _ARGTYPES[symbol])


def _route(x: torch.Tensor) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no quantize kernel for device {x.device}")
    return x.device.type


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(n,) f32 -> (codes int8 (n,), scales f32 (ceil(n/4096),)): the
    kernel on a CUDA tensor (any start offset), the plain version on a CPU
    tensor."""
    global QUANTIZE_LAUNCHES
    _check_vector(x, torch.float32, "quantize input")
    if _route(x) == "cpu":
        return quantize_plain(x)
    n = int(x.shape[0])
    codes = torch.empty(n, dtype=torch.int8, device=x.device)
    scales = torch.empty(tiles_of(n), dtype=torch.float32, device=x.device)
    if n == 0:
        return codes, scales
    rc = _launcher("qsgd_quantize_launch")(
        x.data_ptr(), n, codes.data_ptr(), scales.data_ptr(),
        build.raw_stream(x.device.index))
    if rc != 0:
        raise RuntimeError(f"quantize kernel launch failed: CUDA error {rc}")
    QUANTIZE_LAUNCHES += 1
    return codes, scales


def dequantize(codes: torch.Tensor, scales: torch.Tensor, start: int = 0,
               stop: int | None = None) -> torch.Tensor:
    """Decoded ``[start, stop)`` of a (codes, scales) payload as f32: the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    global DEQUANTIZE_LAUNCHES
    _check_vector(codes, torch.int8, "codes")
    _check_vector(scales, torch.float32, "scales")
    n = int(codes.shape[0])
    stop = n if stop is None else int(stop)
    start = int(start)
    if not 0 <= start <= stop <= n:
        raise ValueError(f"range [{start}, {stop}) is not inside 0..{n}")
    if int(scales.shape[0]) != tiles_of(n):
        raise ValueError(f"{scales.shape[0]} scales for {n} codes "
                         f"({tiles_of(n)} tiles)")
    if scales.device != codes.device:
        raise ValueError(f"codes on {codes.device}, scales on "
                         f"{scales.device}")
    if _route(codes) == "cpu":
        return dequantize_plain(codes, scales, start, stop)
    out = torch.empty(stop - start, dtype=torch.float32, device=codes.device)
    if stop == start:
        return out
    rc = _launcher("qsgd_dequantize_launch")(
        codes.data_ptr(), scales.data_ptr(), start, stop - start,
        out.data_ptr(), build.raw_stream(codes.device.index))
    if rc != 0:
        raise RuntimeError(f"dequantize kernel launch failed: CUDA error "
                           f"{rc}")
    DEQUANTIZE_LAUNCHES += 1
    return out
