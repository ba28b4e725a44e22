"""Process meshes of the data-parallel path (twin of ``repro/launch/mesh.py``).

A mesh here is a ``core.collectives.DataMesh``: the process group, its size
under ``shape[axis]`` and this process's rank. It is built over
``torch.distributed``'s default group (gloo; ``launch.multiproc``), not with
``init_device_mesh("cuda", ...)``, which would pick NCCL: NCCL takes one card
a rank, and the card's host has one card. The production (data, model)
meshes come with the sharding plans (ROADMAP item 24).
"""
from __future__ import annotations

from ..core.collectives import DataMesh


def make_data_mesh(axis: str = "data", group=None) -> DataMesh:
    """1-D pure data-parallel mesh over every process of ``group`` (None:
    the default group, which ``multiproc.initialize_from_env`` sets up)."""
    return DataMesh(group, axis)


def data_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def batch_axes_if_divisible(mesh, batch_size: int):
    """Largest prefix of (pod, data) whose product divides the batch."""
    axes = []
    prod = 1
    for a in data_axes(mesh):
        if batch_size % (prod * mesh.shape[a]) == 0:
            axes.append(a)
            prod *= mesh.shape[a]
    return tuple(axes) if axes else None
