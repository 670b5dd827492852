"""Process-level mesh context for model-internal collectives.

Set by the trainer or server before a forward; model code (the MoE
local-dispatch path) reads it to find the mesh its collectives run on.
None = single-device/test mode.
"""
from __future__ import annotations

from contextlib import contextmanager

# every mesh axis but ``model``, under the reference's name here too
from repro_torch.core.device_agg import replica_axes  # noqa: F401

_CURRENT = None


def set_mesh(mesh) -> None:
    global _CURRENT
    _CURRENT = mesh


def get_mesh():
    return _CURRENT


@contextmanager
def use_mesh(mesh):
    global _CURRENT
    prev = _CURRENT
    _CURRENT = mesh
    try:
        yield
    finally:
        _CURRENT = prev
