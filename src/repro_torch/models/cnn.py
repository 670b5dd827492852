"""Compact CNNs for the paper's federated-learning workloads, on torch
tensors.

The reference's ``models/cnn.py``: a small residual CNN that the
end-to-end federated runs train (the aggregation layer only sees its flat
gradient). The parameter dict keeps the reference's names, its HWIO
kernels and its ``(in, out)`` head, and images are NHWC, so the flat
vector (:func:`repro_torch.core.sharding.flatten`) is the reference's
element for element; :func:`conv` permutes at the call to ``F.conv2d``.

XLA's ``"SAME"`` padding is asymmetric where the total is odd: a stride-2
3×3 conv pads an even side by (0, 1) and an odd side by (1, 1). Every
conv and the shortcut's 2×2 average pool pad explicitly by that rule
(:func:`same_pad`), never by ``padding=1``, which would shift every
stride-2 output by one pixel.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class CNNConfig:
    name: str = "resnet-mini"
    n_classes: int = 10
    channels: tuple = (16, 32, 64)      # per stage
    blocks_per_stage: int = 2
    in_channels: int = 3
    img_size: int = 32


def same_pad(size: int, window: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one side: (low, high), the odd element
    at the high end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pad_nchw(x: torch.Tensor, kh: int, kw: int, stride: int
              ) -> torch.Tensor:
    (t, b), (lft, r) = (same_pad(x.shape[2], kh, stride),
                        same_pad(x.shape[3], kw, stride))
    return F.pad(x, (lft, r, t, b))


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x (B,H,W,Cin) NHWC, w (kh,kw,Cin,Cout) HWIO, ``"SAME"`` padding ->
    (B,H',W',Cout)."""
    xn = _pad_nchw(x.permute(0, 3, 1, 2), w.shape[0], w.shape[1], stride)
    return F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride
                    ).permute(0, 2, 3, 1)


def avg_pool_same(x: torch.Tensor, stride: int) -> torch.Tensor:
    """The reference's ``reduce_window`` sum over ``stride``×``stride``
    windows, ``"SAME"`` (zero) padding, divided by ``stride²``; NHWC."""
    xn = _pad_nchw(x.permute(0, 3, 1, 2), stride, stride, stride)
    return F.avg_pool2d(xn, stride, stride).permute(0, 2, 3, 1)


def param_shapes(cfg: CNNConfig) -> dict[str, tuple]:
    p = {"stem": (3, 3, cfg.in_channels, cfg.channels[0])}
    cin = cfg.channels[0]
    for si, c in enumerate(cfg.channels):
        for bi in range(cfg.blocks_per_stage):
            pre = f"s{si}b{bi}"
            p[f"{pre}_c1"] = (3, 3, cin, c)
            p[f"{pre}_c2"] = (3, 3, c, c)
            if cin != c:
                p[f"{pre}_proj"] = (1, 1, cin, c)
            cin = c
    p["head_w"] = (cin, cfg.n_classes)
    p["head_b"] = (cfg.n_classes,)
    return p


def init_params(gen: torch.Generator, cfg: CNNConfig) -> dict:
    """Seeded f32 parameters on the generator's device: conv kernels
    Normal(0, 1/fan_in), the head Normal(0, 1/in), the bias zeros (not the
    reference's draws: carry those over with ``convert.params_from_jax``)."""
    out = {}
    for name, shape in sorted(param_shapes(cfg).items()):
        if name.endswith("_b"):
            out[name] = torch.zeros(shape, device=gen.device)
            continue
        fan_in = math.prod(shape[:-1]) if len(shape) == 4 else shape[0]
        out[name] = torch.randn(shape, generator=gen, device=gen.device) \
            / math.sqrt(fan_in)
    return out


def forward(params: Mapping[str, torch.Tensor], cfg: CNNConfig,
            images: torch.Tensor) -> torch.Tensor:
    """images (B,H,W,C) -> logits (B,n_classes)."""
    x = F.relu(conv(images, params["stem"]))
    cin = cfg.channels[0]
    for si, c in enumerate(cfg.channels):
        for bi in range(cfg.blocks_per_stage):
            pre = f"s{si}b{bi}"
            stride = 2 if (bi == 0 and si > 0) else 1
            h = F.relu(conv(x, params[f"{pre}_c1"], stride))
            h = conv(h, params[f"{pre}_c2"])
            # the reference's shortcut: identity or the 1x1 projection; on
            # a stride-2 block the average pool, which a strided
            # projection overwrites when the width changes
            if cin != c:
                sc = conv(x, params[f"{pre}_proj"], stride)
            elif stride != 1:
                sc = avg_pool_same(x, stride)
            else:
                sc = x
            x = F.relu(h + sc)
            cin = c
    x = torch.mean(x, dim=(1, 2))
    return x @ params["head_w"] + params["head_b"]


def loss_fn(params: Mapping[str, torch.Tensor], cfg: CNNConfig,
            batch: Mapping[str, torch.Tensor]):
    logits = forward(params, cfg, batch["images"])
    labels = batch["labels"].long()
    logp = F.log_softmax(logits, dim=-1)
    loss = -torch.mean(torch.gather(logp, 1, labels[:, None]))
    acc = torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
    return loss, {"loss": loss, "acc": acc}
