"""Mesh definitions of the port (counterpart of ``repro.launch.mesh``).

The ``make_*`` functions return abstract meshes (axis names and sizes, no
devices) with the reference's shapes: what the sharding rules and the dry
run read.  :func:`device_mesh` turns one into a live
``torch.distributed`` ``DeviceMesh`` over the ranks of the process group.
"""

from __future__ import annotations

from ..distributed.sharding import AbstractMesh, abstract_mesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16x16 = 256 devices per pod; 2 pods = 512 devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return abstract_mesh(shape, axes)


def make_test_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """Small mesh for the 8-rank tests."""
    shape = (2, 2, 2) if multi_pod else (2, 4)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return abstract_mesh(shape, axes)


def make_single_device_mesh() -> AbstractMesh:
    return abstract_mesh((1, 1), ("data", "model"))


def device_mesh(abstract: AbstractMesh, device=None):
    """The live ``DeviceMesh`` of ``abstract`` over the default process
    group, rank ``r`` at row-major position ``r``.

    ``device=None`` places it on CUDA (the group's backend NCCL),
    ``device="cpu"`` on the CPU (gloo).  The caller initialises the process
    group; a group whose world size differs from the mesh's size raises,
    as does a CUDA mesh without a card: there is no fallback to the CPU.
    """
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    kind = "cuda" if device is None else str(device)
    if not dist.is_initialized():
        raise RuntimeError("device_mesh needs an initialised process group")
    world = dist.get_world_size()
    if world != abstract.size:
        raise ValueError(f"the process group has {world} ranks, the mesh "
                         f"{abstract.shape} needs {abstract.size}")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device_mesh(device=None) needs a CUDA device; "
                           "pass device='cpu' for a gloo mesh")
    ids = torch.arange(abstract.size).reshape(tuple(abstract.shape.values()))
    return DeviceMesh(kind, ids, mesh_dim_names=abstract.axis_names)
