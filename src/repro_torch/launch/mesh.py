"""Mesh construction.

The port's copy of the reference's ``launch/mesh.py``.  Importing it starts
no process group.

* ``make_host_mesh(device)`` is the mesh this host runs on: a
  ``torch.distributed.device_mesh.DeviceMesh`` of shape (world, 1) with dims
  ``("data", "model")``, the reference's ``make_host_mesh``.  When no process
  group exists it starts a world-1 group on an in-process ``HashStore`` (no
  port, no environment variables): NCCL for ``cuda``, gloo for ``cpu``.
  Ranks are numbered row-major, as ``jax.make_mesh`` orders its devices.
* ``make_production_mesh(multi_pod=)`` is the reference's production mesh
  as plain data, a ``MeshShape`` with no devices: (16, 16) over
  ``("data", "model")``, or (2, 16, 16) with ``"pod"``.  The specs of
  ``models/registry.py`` size themselves from such a shape.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..kernels import ops

__all__ = ["MeshShape", "make_production_mesh", "make_host_mesh"]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's extents and axis names, without devices."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16x16 single pod (256 chips) or 2x16x16 (512 chips, 2 pods)."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_host_mesh(device=None) -> DeviceMesh:
    """Every rank of this job on the data axis: shape (world, 1), dims
    ``("data", "model")``, on ``device``'s type (CUDA unless the caller
    names the CPU; raises without a card).  Starts a world-1 process group
    (NCCL on ``cuda``, gloo on ``cpu``) if none exists; the caller ends it
    with ``torch.distributed.destroy_process_group()``."""
    dev = ops.resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return init_device_mesh(dev.type, (dist.get_world_size(), 1),
                            mesh_dim_names=("data", "model"))
