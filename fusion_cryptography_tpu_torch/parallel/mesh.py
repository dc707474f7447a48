"""Device meshes over the ranks of the process group.

Port of the JAX package's ``parallel/mesh.py``: a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose ranks are laid out
row-major, as JAX's ``np.array(devices).reshape(dp, tp)``, so that the
port's shard *i* along an axis is JAX's shard *i*.  Every rank of the world
calls :func:`make_mesh` (it builds one process group per axis row); a rank
outside a mesh smaller than the world holds no coordinate in it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .distributed import rank_device


def make_mesh(axis_sizes: Optional[Tuple[int, int]] = None,
              axis_names: Tuple[str, str] = ("dp", "tp"), device=None) -> DeviceMesh:
    """A 2-D (dp, tp) mesh over the world's ranks on ``device``'s type (the
    card unless ``"cpu"``; it must be the process group's device).

    Defaults, as in the JAX package: every rank, tp = 2 when the world is
    even and at least 2, else 1, and dp = world // tp.  Raises ValueError
    when the mesh needs more ranks than the world has."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group (distributed.initialize)")
    n = dist.get_world_size()
    if axis_sizes is None:
        tp = 2 if n % 2 == 0 and n >= 2 else 1
        axis_sizes = (n // tp, tp)
    dp, tp = axis_sizes
    if dp * tp > n:
        raise ValueError(f"mesh {tuple(axis_sizes)} needs {dp * tp} ranks, have {n}")
    return init_device_mesh(rank_device(device).type, (dp, tp), mesh_dim_names=tuple(axis_names))


def mesh_axis(mesh: DeviceMesh, name: str) -> Tuple[int, int, dist.ProcessGroup]:
    """(size, this rank's index, process group) of mesh axis ``name``;
    raises ValueError on a rank outside the mesh."""
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh}")
    names = mesh.mesh_dim_names or ()
    if name not in names:
        raise ValueError(f"mesh has no axis {name!r} (axes {names})")
    i = names.index(name)
    return mesh.size(i), mesh.get_local_rank(i), mesh.get_group(i)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank drives in ``mesh``: the current card for a CUDA
    mesh, the CPU for a CPU one."""
    return rank_device(mesh.device_type)
