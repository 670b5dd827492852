"""Fault-tolerant checkpointing of flat state dicts.

The reference's ``checkpoint/manager.py`` on the port's trees (a tensor,
a dict of tensors under dotted names, or tuples and named tuples of
those, such as the trainer's ``(params, AdamState)``), with the
reference's on-disk form, so a checkpoint that either package writes
restores in the other:

  * atomic: write to ``<dir>/tmp_<step>`` then rename — a crash mid-save
    never corrupts the latest checkpoint;
  * manifested: ``manifest.json`` carries the step, every leaf's name,
    npz key, shape, type and ``crc32``; restore verifies before handing
    the tensors back;
  * resumable: ``latest_step()`` scans for the newest *complete*
    checkpoint, and ``restore_latest`` skips partial or corrupt ones;
  * bounded: ``keep`` old checkpoints are retained, older ones deleted.

Leaves are stored in the reference's leaf order (dict keys sorted at every
level, :func:`repro_torch.core.sharding.leaf_order`; tuple elements in
order) under its key-path names: the dotted parts joined with ``/``, a
tuple element by its index, a named tuple's field as ``.field`` (a bare
tensor is ``leaf``). npz has no
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


def _leaves(tree, parts: tuple = ()) -> list[tuple[str, torch.Tensor]]:
    """(stored name, tensor) of every leaf, in leaf order."""
    if isinstance(tree, Mapping):
        return [leaf for name in leaf_order(tree)
                for leaf in _leaves(tree[name], parts + tuple(
                    name.split(".")))]
    if isinstance(tree, tuple):
        keys = [f".{f}" for f in tree._fields] if hasattr(tree, "_fields") \
            else [str(i) for i in range(len(tree))]
        return [leaf for key, val in zip(keys, tree)
                for leaf in _leaves(val, parts + (key,))]
    return [("/".join(parts) or "leaf", tree)]


def _rebuild(like, values):
    """``like``'s structure with its leaves taken from the iterator
    ``values`` in leaf order."""
    if isinstance(like, Mapping):
        out = {name: _rebuild(like[name], values)
               for name in leaf_order(like)}
        return {name: out[name] for name in like}
    if isinstance(like, tuple):
        vals = [_rebuild(v, values) for v in like]
        return type(like)(*vals) if hasattr(like, "_fields") \
            else tuple(vals)
    return next(values)


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
        for i, (stored, leaf) in enumerate(_leaves(tree)):
            arr, dtype = _to_numpy(leaf)
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
        paths = _leaves(like)
        entries = manifest["leaves"]
        if len(entries) != len(paths):
            raise ValueError(
                f"checkpoint has {len(entries)} leaves, expected "
                f"{len(paths)}")
        out = []
        for entry, (stored, ref) in zip(entries, paths):
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
            out.append(torch.from_numpy(np.array(arr)).to(
                device=ref.device, dtype=ref.dtype))
        return _rebuild(like, iter(out)), manifest.get("extra", {})

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
