"""Device meshes over ``torch.distributed``.

The reference's ``launch/mesh.py``: ``make_production_mesh`` and
``make_mesh`` are functions, so importing this module touches no device
and no process group. A mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` whose dimensions carry
the reference's axis names; its per-axis process groups are what
:mod:`repro_torch.core.device_agg` runs its collectives on.

One process drives one device (one rank). A caller that runs M ranks
starts the default process group itself (``init_process_group`` with its
address, world size and rank) before it builds a mesh of M devices. A mesh
of one device needs no such set-up: with no process group started,
:func:`make_mesh` starts a one-rank group on an in-process store, so no
port is opened.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist


def _backend(device_type: str) -> str:
    if device_type == "cuda":
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                     f"{device_type!r}")


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the default process group, its
    dimensions named ``axes`` (tests use small meshes like (2, 2, 2)).
    Ranks fill the mesh in row-major order. ``device_type`` is the
    caller's device: ``"cuda"`` (NCCL) or ``"cpu"`` (gloo)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    backend = _backend(device_type)
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a mesh of {n} devices needs {n} ranks: start the default "
                f"process group (init_process_group with world_size={n}) "
                f"in every rank first")
        if device_type == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != n:
        raise ValueError(f"mesh shape {shape} holds {n} devices, the "
                         f"process group {dist.get_world_size()} ranks")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: 16x16 = 256 devices ("data","model"). Multi-pod: 2
    pods = 512 devices ("pod","data","model"); the pod axis is the slow
    cross-pod domain."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a
    :class:`repro_torch.config.MeshConfig` (the specs of
    :mod:`repro_torch.launch.partitioning` need only the names and
    sizes)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = mesh.axes
    return dict(zip(names, tuple(mesh.shape)))
