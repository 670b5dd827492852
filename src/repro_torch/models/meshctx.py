"""Process-level mesh context for model-internal collectives.

Set by the trainer or server before a forward; model code reads it to
find the mesh its collectives run on. None = single-device/test mode.

Under a mesh whose ``model`` axis has more than one rank the forward is
tensor-parallel (TP): the parameters are this rank's ``model``-axis blocks
(:func:`repro_torch.launch.partitioning.shard_params`), the inputs are
this rank's rows, the same on every rank of its ``model`` group, and each
layer finds its local widths from its weights. The MoE block's local
dispatch runs under any mesh with a ``model`` axis.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import NamedTuple

# every mesh axis but ``model``, under the reference's name here too
from repro_torch.core.device_agg import replica_axes  # noqa: F401

_CURRENT = None


class ModelAxis(NamedTuple):
    """The current mesh's ``model`` axis: the mesh, this rank's index on
    the axis and the axis's process group."""
    mesh: object
    index: int
    group: object


def set_mesh(mesh) -> None:
    global _CURRENT
    _CURRENT = mesh


def get_mesh():
    return _CURRENT


def model_axis() -> ModelAxis | None:
    """The current mesh's ``model`` axis, or None with no mesh set or a
    ``model`` axis of one rank (the forward then takes its one-device
    ops)."""
    mesh = _CURRENT
    if mesh is None or "model" not in (mesh.mesh_dim_names or ()):
        return None
    if mesh.size(mesh.mesh_dim_names.index("model")) == 1:
        return None
    return ModelAxis(mesh, mesh.get_local_rank("model"),
                     mesh.get_group("model"))


@contextmanager
def use_mesh(mesh):
    global _CURRENT
    prev = _CURRENT
    _CURRENT = mesh
    try:
        yield
    finally:
        _CURRENT = prev
