"""Uniform model API, dispatched by config family.

The port's share of the reference's ``models/registry.py``: the dense
decoder family only. Every function takes the configuration and, where it
computes, a parameter dict (a flat state dict under the reference's dotted
names, :mod:`repro_torch.models.transformer`):

    init_params(gen, cfg)          -> parameter dict on the generator's device
    loss_fn(params, cfg, batch)    -> (loss, metrics)
    forward(params, cfg, batch)    -> logits (full sequence)
    param_count(cfg)               -> exact count, from the shapes alone

The encoder-decoder, MoE, SSM and hybrid families raise
``NotImplementedError`` (ROADMAP queue 1, item 12).
"""
from __future__ import annotations

import math

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import transformer


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return transformer.init_params(gen, cfg)


def loss_fn(params, cfg: ModelConfig, batch):
    return transformer.loss_fn(params, cfg, batch)


def forward(params, cfg: ModelConfig, batch):
    return transformer.forward(params, cfg, batch["tokens"])


def param_count(cfg: ModelConfig) -> int:
    return int(sum(math.prod(s) for s in
                   transformer.param_shapes(cfg).values()))
