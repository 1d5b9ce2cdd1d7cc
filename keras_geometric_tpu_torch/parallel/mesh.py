"""Device mesh construction over ``torch.distributed``.

Counterpart of the JAX package's ``parallel/mesh.py``: the rest of the
distribution tier speaks one vocabulary, a ``graph`` axis for graph/edge
partitioning (the sequence-parallel analog), and, on a multi-host layout, a
``(host, chip)`` pair of axes for the hierarchical halo exchange. A mesh is a
``torch.distributed.device_mesh.DeviceMesh``; each axis's process group is
``mesh.get_group(axis)`` and a rank's coordinate on it
``mesh.get_local_rank(axis)``.

The reference's sharding specs (``graph_sharding``, ``replicated``, ``P`` and
``Mesh``) describe how XLA lays a global array over a TPU mesh; PyTorch has
no global arrays: every rank holds its own shard (``shard_partitioned_graph``
keeps each rank's slice of the per-partition arrays), parameters are
replicated by construction, and the gradient sum that ``shard_map`` inserts
is an explicit ``all_reduce``. So those names have no counterpart here.

A mesh needs a process group. :func:`make_mesh` uses the one the caller
initialised (``torch.distributed.init_process_group`` with its address,
world size and rank), or starts one from a ``torchrun`` environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL for
``device_type="cuda"``, gloo for ``"cpu"``. With neither it raises: it never
starts a group of its own accord.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_mesh", "local_device", "DeviceMesh"]

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _ensure_process_group(device_type: str) -> None:
    if dist.is_initialized():
        return
    if all(k in os.environ for k in _TORCHRUN_ENV):
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo")
        return
    raise RuntimeError(
        "make_mesh needs a torch.distributed process group: initialise one "
        "(init_process_group with its address, world size and rank) or run "
        "under torchrun")


def local_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shard lives on: ``cuda:{LOCAL_RANK}`` on a
    CUDA mesh (``LOCAL_RANK`` from the environment, else the rank modulo the
    visible cards), the CPU on a CPU mesh."""
    return _device_of(mesh.device_type)


def _device_of(device_type: str) -> torch.device:
    if device_type != "cuda":
        return torch.device(device_type)
    local = os.environ.get("LOCAL_RANK")
    index = (int(local) if local is not None
             else dist.get_rank() % torch.cuda.device_count())
    return torch.device("cuda", index)


def make_mesh(
    shape: tuple[int, ...] | None = None,
    axis_names: tuple[str, ...] = ("graph",),
    *,
    device_type: str = "cuda",
) -> DeviceMesh:
    """A mesh over every rank of the process group (default: a 1-D
    ``graph`` axis of the world size).

    Ranks fill the mesh in row-major order, so on a ``(host, chip)`` mesh
    rank ``p`` is ``host * chips_per_host + chip``, the partition order of
    ``build_hier_halo_plan``. On a CUDA mesh the rank's current device is set
    to :func:`local_device`.
    """
    _ensure_process_group(device_type)
    world = dist.get_world_size()
    if shape is None:
        shape = (world,)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} != world size {world}")
    if len(axis_names) != len(shape):
        raise ValueError(f"{len(shape)} axes but names {axis_names}")
    if device_type == "cuda":
        torch.cuda.set_device(_device_of(device_type))
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_names))
