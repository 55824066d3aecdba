"""Meshes over the initialised ``torch.distributed`` world (counterpart of
``repro.launch.mesh``).

Every function here builds on a process group the caller has initialised
(``torch.distributed.init_process_group`` with its address, world size and
rank); nothing here starts one.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over ranks ``0 .. n-1`` of
the world, on the card (``cuda``) when one is present; building one is
collective (every rank of the world builds it, in the same order), and so
is building the process groups its collective plans use, which happens
here too (:func:`repro_torch.core.topology.mesh_of_shape`, which
``use_level`` shares).

Axis roles (DESIGN.md §4):
    pod    outer data-parallel axis; reductions across it are the last,
           already-reduced stage of a hierarchical schedule
    data   inner data parallelism (batch dim)
    model  tensor parallelism (heads, ffn, vocab) and expert parallelism
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.core.topology import mesh_of_shape

__all__ = ["make_production_mesh", "make_mesh", "mesh_of_shape",
           "describe"]


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production meshes: (data 16, model 16), or (pod 2,
    data 16, model 16) with ``multi_pod``; raises unless the world has the
    ranks they need."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    import torch.distributed as dist

    have = dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 0
    if have != math.prod(shape):
        raise RuntimeError(f"the production mesh {dict(zip(axes, shape))} "
                           f"needs a world of {math.prod(shape)} ranks; "
                           f"this one has {have}")
    return mesh_of_shape(shape, axes)


def make_mesh(data: int = 1, model: int = 1, pod: Optional[int] = None,
              *, device_type: Optional[str] = None):
    """A (data, model) mesh, or (pod, data, model) with ``pod``, over the
    world's first ranks."""
    if pod:
        return mesh_of_shape((pod, data, model), ("pod", "data", "model"),
                             device_type)
    return mesh_of_shape((data, model), ("data", "model"), device_type)


def describe(mesh) -> str:
    dims = ", ".join(f"{n}={s}" for n, s in
                     zip(mesh.mesh_dim_names, mesh.shape))
    return f"Mesh({dims}; {math.prod(mesh.shape)} devices)"
