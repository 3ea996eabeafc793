"""Meshes of ``torch.distributed`` ranks, the reference's
``repro/launch/mesh.py`` over ``DeviceMesh``.

Single pod: 256 ranks as (data=16, model=16).  Multi-pod: 2 pods × 256
as (pod=2, data=16, model=16); the ``pod`` axis carries only data
parallelism.  Host meshes ``(data, model)`` span every rank of the
running process group (``repro_torch.distributed.spawn`` or torchrun
starts them).  Functions, so that importing this module touches no
process group.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...]):
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    # NCCL ranks each own a card; gloo ranks (the CPU, or several ranks
    # sharing one card) hold CPU groups that also move CUDA tensors
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 512 if multi_pod else 256
    if _world() < n:
        raise RuntimeError(f"mesh {shape} needs {n} ranks, found {_world()}")
    return _mesh(shape, axes)


def batch_axes_of(mesh) -> Tuple[str, ...]:
    names = tuple(mesh) if isinstance(mesh, dict) else mesh.mesh_dim_names
    return ("pod", "data") if "pod" in names else ("data",)


def make_host_mesh(data: int = 1, model: int = 1):
    """A ``(data, model)`` mesh over the ranks of the running process
    group, which must hold exactly ``data × model`` of them."""
    n = data * model
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(
            f"host mesh (data={data}, model={model}) needs {n} ranks, the "
            f"process group has {_world() if dist.is_initialized() else 0}"
            f" — start {n} ranks (repro_torch.distributed.spawn.launch or "
            f"torchrun --nproc-per-node {n})")
    return _mesh((data, model), ("data", "model"))


def mesh_coords(mesh) -> Dict[str, int]:
    """This rank's coordinate on every axis of ``mesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
