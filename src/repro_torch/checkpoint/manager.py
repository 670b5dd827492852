"""Fault-tolerant checkpointing of flat state dicts.

The reference's ``checkpoint/manager.py`` on the port's trees (a tensor,
or a dict of tensors under dotted names), with the reference's on-disk
form, so a checkpoint that either package writes restores in the other:

  * atomic: write to ``<dir>/tmp_<step>`` then rename — a crash mid-save
    never corrupts the latest checkpoint;
  * manifested: ``manifest.json`` carries the step, every leaf's name,
    npz key, shape, type and ``crc32``; restore verifies before handing
    the tensors back;
  * resumable: ``latest_step()`` scans for the newest *complete*
    checkpoint, and ``restore_latest`` skips partial or corrupt ones;
  * bounded: ``keep`` old checkpoints are retained, older ones deleted.

Leaves are stored in the reference's leaf order (dict keys sorted at every
level, :func:`repro_torch.core.sharding.leaf_order`) under its names: the
dotted parts joined with ``/`` (a bare tensor is ``leaf``). npz has no
bf16: a bf16 leaf is stored as f32 with ``"dtype": "bfloat16"`` in the
manifest, as the reference stores its ``ml_dtypes`` leaves, and restore
casts it back. Storage is shard-layout-agnostic: the elastic M → M′ path
lives in :mod:`repro_torch.checkpoint.reshard`.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.sharding import leaf_order


def _leaf_paths(tree) -> list[tuple[str, str]]:
    """(dotted name or None for a bare tensor, stored name) in leaf order."""
    if isinstance(tree, Mapping):
        return [(name, name.replace(".", "/")) for name in leaf_order(tree)]
    return [(None, "leaf")]


def _leaf(tree, name):
    return tree if name is None else tree[name]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """The array stored for a leaf, and its type's name in the manifest."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.to(torch.float32).numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def save(self, step: int, tree, extra: dict | None = None) -> str:
        tmp = os.path.join(self.directory, f"tmp_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": [], "extra": extra or {}}
        arrays = {}
        for i, (name, stored) in enumerate(_leaf_paths(tree)):
            arr, dtype = _to_numpy(_leaf(tree, name))
            key = f"a{i:05d}"
            arrays[key] = arr
            manifest["leaves"].append({
                "name": stored, "key": key, "shape": list(arr.shape),
                "dtype": dtype,
                "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
            })
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = self._step_dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)               # atomic publish
        self._gc()
        return final

    def _complete(self, d: str) -> bool:
        return (os.path.exists(os.path.join(d, "manifest.json"))
                and os.path.exists(os.path.join(d, "arrays.npz")))

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and \
                    self._complete(os.path.join(self.directory, name)):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, like, verify: bool = True):
        """Restore into the structure of ``like``: the same names, and each
        leaf's shape (checked), type and device. Returns (tree, extra)."""
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(d, "arrays.npz"))
        paths = _leaf_paths(like)
        entries = manifest["leaves"]
        if len(entries) != len(paths):
            raise ValueError(
                f"checkpoint has {len(entries)} leaves, expected "
                f"{len(paths)}")
        out = {}
        for entry, (name, stored) in zip(entries, paths):
            ref = _leaf(like, name)
            if entry["name"] != stored:
                raise ValueError(
                    f"checkpoint leaf {entry['name']!r} where {stored!r} "
                    f"was expected")
            arr = data[entry["key"]]
            if list(arr.shape) != list(ref.shape):
                raise ValueError(
                    f"{entry['name']}: shape {arr.shape} != "
                    f"{tuple(ref.shape)}")
            if verify:
                crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
                if crc != entry["crc32"]:
                    raise IOError(
                        f"{entry['name']}: checksum mismatch (corrupt "
                        f"checkpoint at step {step})")
            out[name] = torch.from_numpy(np.array(arr)).to(
                device=ref.device, dtype=ref.dtype)
        tree = out[None] if None in out else out
        return tree, manifest.get("extra", {})

    def restore_latest(self, like):
        """Newest complete and valid checkpoint as (step, tree, extra),
        skipping corrupt ones; None when there is none."""
        for step in reversed(self.steps()):
            try:
                tree, extra = self.restore(step, like)
                return step, tree, extra
            except (IOError, ValueError, KeyError):
                continue
        return None

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
