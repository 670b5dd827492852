"""Entry points of the kernels under the reference's names
(``repro/kernels/ops.py``): the codecs' ``qsgd_compress``,
``qsgd_decompress`` and ``topk_sparsify`` on flat vectors, the model's
``rmsnorm`` on ``(..., d)`` activations, and the optimizer's
``sgd_momentum_update`` on a leaf.

The reference pads a flat vector to (R, 128) tiles around each Pallas
call; the port's kernels take the flat vector itself, so codes keep the
input's length and there is no padding to cut off. A CUDA tensor goes to
the kernel, a CPU tensor to the plain version, and any other device
raises; there is no switch besides the tensor's device. The reference's
``sgd_momentum_update`` donates ``p`` and ``v``; the port updates them in
place and returns them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fused_sgd as _sgd
from repro_torch.kernels import quantize as _q
from repro_torch.kernels import rmsnorm as _rn
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


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """x: (..., d) -> ``x·rsqrt(mean(x²) + eps)·γ`` in x's type, the rows
    of x normalised as one (rows, d) matrix."""
    shape = x.shape
    out, _ = _rn.rmsnorm(x.reshape(-1, shape[-1]), gamma, eps)
    return out.reshape(shape)


def sgd_momentum_update(params: torch.Tensor, grads: torch.Tensor,
                        velocity: torch.Tensor, lr: float,
                        momentum: float = 0.9
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused ``v ← μv + g; p ← p − ηv`` on a leaf, in place on ``params``
    and ``velocity``; returns them."""
    return _sgd.fused_sgd(params, grads, velocity, lr, momentum)
