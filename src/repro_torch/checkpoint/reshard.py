"""Elastic shard-count checkpointing: save at M shards, resume at M′.

The reference's ``checkpoint/reshard.py`` on the port's partition plans:
state is persisted per *logical shard* (one ``.npy`` each) together with
its plan (``meta.json``); a restart may choose any new M′ — the loader
reconstructs the flat vector from the old shards and re-partitions it with
the new plan. The files are the reference's, so either package restores
the other's.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch.core.sharding import (
    PartitionPlan,
    make_plan,
    reconstruct,
    shard,
)


def _plan_to_json(plan: PartitionPlan) -> dict:
    return {"total": plan.total, "strategy": plan.strategy,
            "segments": [[list(r) for r in segs] for segs in plan.segments]}


def _plan_from_json(d: dict) -> PartitionPlan:
    segs = tuple(tuple(tuple(r) for r in segs) for segs in d["segments"])
    return PartitionPlan(d["total"], segs, d["strategy"])


def save_sharded(directory: str, flat, plan: PartitionPlan, step: int = 0,
                 extra: dict | None = None) -> None:
    """``flat`` (a tensor or an array, stored as f32) cut by ``plan``."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, ".tmp_sharded")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = torch.as_tensor(flat).detach().to("cpu", torch.float32)
    for j, sh in enumerate(shard(flat, plan)):
        np.save(os.path.join(tmp, f"shard_{j:05d}.npy"), sh.numpy())
    meta = {"plan": _plan_to_json(plan), "step": step, "extra": extra or {}}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    final = os.path.join(directory, f"sharded_{step:010d}")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def load_resharded(directory: str, step: int, new_m: int,
                   strategy: str = "uniform", tensor_sizes=None
                   ) -> tuple[list[torch.Tensor], PartitionPlan, dict]:
    """Load a sharded checkpoint and re-partition it to ``new_m`` shards:
    (the new shards as CPU tensors, the new plan, the saved meta)."""
    d = os.path.join(directory, f"sharded_{step:010d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    old_plan = _plan_from_json(meta["plan"])
    shards = [torch.from_numpy(np.load(os.path.join(d, f"shard_{j:05d}.npy")))
              for j in range(old_plan.n_shards)]
    flat = reconstruct(shards, old_plan)
    new_plan = make_plan(strategy, old_plan.total, new_m, tensor_sizes)
    return shard(flat, new_plan), new_plan, meta
