"""Carry the reference package's state across to the port.

A round's state is the clients' flat f32 gradients and the partition
plan. Gradients arrive as numpy arrays (the reference's form) or tensors,
and become contiguous f32 tensors on the session's device; a plan is any
object with ``total``, ``segments`` and ``strategy``. The federated LM
trainer adds weights and a model configuration: a reference parameter
tree (nested dicts of arrays) becomes a parameter dict under dotted
names, and a reference ``ModelConfig`` the port's, field for field. No
function here imports the reference: they read the objects they are
given.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch import config as _config

from repro_torch.core.sharding import PartitionPlan, as_grad_tensor


def grads_from_numpy(grads: Sequence, device: str | torch.device = "cpu"
                     ) -> list[torch.Tensor]:
    """The reference's list of numpy f32 gradients as contiguous f32
    tensors on ``device``."""
    return [as_grad_tensor(g, device) for g in grads]


def plan_from_reference(plan) -> PartitionPlan:
    """The port's :class:`PartitionPlan` equal to a reference plan (any
    object with ``.total``, ``.segments`` and ``.strategy``)."""
    return PartitionPlan(
        total=int(plan.total),
        segments=tuple(tuple((int(a), int(b)) for a, b in segs)
                       for segs in plan.segments),
        strategy=str(plan.strategy))


def tensor_from_numpy(array, device: str | torch.device = "cpu"
                      ) -> torch.Tensor:
    """A numpy (or array-protocol) array as a tensor of the same type;
    bf16 arrays (``ml_dtypes.bfloat16``) carry over by their bits."""
    a = np.asarray(array)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree: Mapping, device: str | torch.device = "cpu"
                    ) -> dict:
    """A reference parameter tree (nested dicts of numpy or JAX arrays) as
    the port's parameter dict: dotted names, same shapes, types and bits."""
    out = {}
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, Mapping):
            out.update({f"{key}.{k}": v for k, v in
                        params_from_jax(val, device).items()})
        else:
            out[str(key)] = tensor_from_numpy(val, device)
    return out


def _torch_dtype(dtype) -> torch.dtype:
    return getattr(torch, np.dtype(dtype).name)


def model_config_from_jax(cfg) -> _config.ModelConfig:
    """The port's :class:`~repro_torch.config.ModelConfig` equal to a
    reference one: every field by name, dtypes as torch dtypes."""
    kw = {f.name: getattr(cfg, f.name)
          for f in dataclasses.fields(_config.ModelConfig)}
    kw["param_dtype"] = _torch_dtype(kw["param_dtype"])
    kw["compute_dtype"] = _torch_dtype(kw["compute_dtype"])
    if kw["moe"] is not None:
        kw["moe"] = _config.MoEConfig(**dataclasses.asdict(kw["moe"]))
    if kw["ssm"] is not None:
        kw["ssm"] = _config.SSMConfig(**dataclasses.asdict(kw["ssm"]))
    return _config.ModelConfig(**kw)
