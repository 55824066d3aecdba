"""Mesh topology: axis names, sizes, and *roles* — what variant selection
and the hierarchical collectives plane reason about (counterpart of
``repro.core.topology``, DESIGN.md §8).

The paper's only parallel knob is a thread count (``ARBB_NUM_CORES``); our
meshes are richer — an O4 mesh is ``(pod, data, model)`` and each axis plays
a different *role* (DESIGN.md §4):

    pod     outer data-parallel axis (the slow link between hosts);
            reductions across it should be the terminal all-reduce of a
            hierarchical schedule
    data    inner data parallelism (the fast link); reduce-scatter lives
            here
    model   tensor/expert parallelism; numeric kernels replicate over it
            unless a variant explicitly tiles it (e.g. mesh_psum_2d)

:class:`MeshTopology` is the hashable, selection-friendly summary of an
ambient mesh: it rides on :class:`repro_torch.core.registry.SelectContext`
so variants can predicate on mesh *rank* (how many non-degenerate axes
exist), and it seeds :func:`repro_torch.distributed.collectives.reduce_plan`.

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` (its
``mesh_dim_names`` and ``shape``), or a :class:`LocalMesh`: the
degenerate mesh of one process with no process group, which
``use_level(O3)`` builds where no world is initialised, as the reference
builds a ``(1, 1)`` mesh on one device.

Roles are inferred from axis names (the repo's meshes use the role names
themselves) and can be overridden for exotically-named meshes with the
scoped :func:`axis_roles` declaration.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Iterator, Mapping, Optional

__all__ = ["ROLES", "MeshTopology", "LocalMesh", "axis_roles",
           "declared_roles", "topology_of", "mesh_of_shape"]

#: The axis roles the collectives plane understands.
ROLES = ("pod", "data", "model")

_state = threading.local()


@contextlib.contextmanager
def axis_roles(**mapping: str) -> Iterator[Mapping[str, str]]:
    """Scoped axis-name -> role declaration, e.g. ``axis_roles(x='data',
    y='model')`` for a mesh whose axes aren't named after their roles.
    Inference by name still covers undeclared axes."""
    for role in mapping.values():
        if role not in ROLES:
            raise ValueError(f"unknown axis role {role!r}; choose from {ROLES}")
    prev = getattr(_state, "roles", None)
    _state.roles = {**(prev or {}), **mapping}
    try:
        yield _state.roles
    finally:
        _state.roles = prev


def declared_roles() -> Mapping[str, str]:
    return getattr(_state, "roles", None) or {}


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """Hashable summary of a mesh: parallel tuples of names, sizes, roles
    (mesh order, outermost first)."""
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    roles: tuple[str, ...]

    @property
    def rank(self) -> int:
        """Number of non-degenerate axes — the 'dimensionality' a variant
        can predicate on (a (8, 1) mesh has rank 1, a (2, 2, 2) rank 3)."""
        return sum(1 for s in self.axis_sizes if s > 1)

    def size(self, name: str) -> int:
        try:
            return self.axis_sizes[self.axis_names.index(name)]
        except ValueError:
            return 0

    def axes(self, *roles: str) -> tuple[str, ...]:
        """Axis names playing any of ``roles``, in mesh (outer-first) order."""
        return tuple(n for n, r in zip(self.axis_names, self.roles)
                     if r in roles)

    def extent(self, *roles: str) -> int:
        """Product of the sizes of the axes playing ``roles`` (1 if none)."""
        w = 1
        for n, r in zip(self.axis_names, self.roles):
            if r in roles:
                w *= self.size(n)
        return w

    def describe(self) -> str:
        """Canonical short form, e.g. ``pod2xdata2xmodel2`` — the mesh
        component of autotune cache keys (DESIGN.md §8).  An axis whose
        declared role differs from its name carries the role as a suffix
        (``replica2:pod``), so two role declarations of the same mesh —
        which schedule collectives differently — never alias one key."""
        return "x".join(
            f"{n}{s}" if n == r else f"{n}{s}:{r}"
            for n, s, r in zip(self.axis_names, self.axis_sizes, self.roles))


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """A mesh of this process alone, with no process group behind it: the
    degenerate mesh ``use_level(O3|O4)`` builds where no world is
    initialised.  Every axis has size 1, so no collective plan has an axis
    to run over and every mesh variant degrades to chip scope; it never
    waits for a peer."""
    mesh_dim_names: tuple[str, ...]
    shape: tuple[int, ...]


def topology_of(mesh, roles: Optional[Mapping[str, str]] = None
                ) -> Optional[MeshTopology]:
    """The :class:`MeshTopology` of ``mesh`` (a ``DeviceMesh`` or a
    :class:`LocalMesh`; None for no mesh).

    Role resolution per axis: explicit ``roles`` arg > the scoped
    :func:`axis_roles` declaration > the axis's own name when it is a role >
    ``data`` (an unnamed parallel axis is batch-like by default)."""
    if mesh is None:
        return None
    declared = {**declared_roles(), **(roles or {})}
    names = tuple(str(n) for n in mesh.mesh_dim_names)
    sizes = tuple(int(s) for s in mesh.shape)
    resolved = tuple(
        declared.get(n, n if n in ROLES else "data") for n in names)
    return MeshTopology(axis_names=names, axis_sizes=sizes, roles=resolved)


#: (shape, names, device type, world group) -> DeviceMesh: the meshes
#: ``use_level`` builds by default are built once.
_MESHES: dict = {}


def _world():
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed."
                           "init_process_group(...) on every rank first")
    return dist


def mesh_of_shape(shape: tuple[int, ...], names: tuple[str, ...],
                  device_type: Optional[str] = None):
    """The ``DeviceMesh`` of ``shape`` over the first ``prod(shape)``
    ranks of the world, with its plan groups; one per (shape, names,
    device type) and world."""
    import torch

    dist = _world()
    n = math.prod(shape)
    if n > dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {n} ranks; the world has "
                         f"{dist.get_world_size()}")
    device_type = device_type or ("cuda" if torch.cuda.is_available()
                                  else "cpu")
    key = (tuple(shape), tuple(names), device_type, dist.group.WORLD)
    mesh = _MESHES.get(key)
    if mesh is None:
        from torch.distributed.device_mesh import DeviceMesh

        from repro_torch.distributed.collectives import mesh_groups

        mesh = DeviceMesh(device_type, torch.arange(n).reshape(shape),
                          mesh_dim_names=tuple(names))
        mesh_groups(mesh)
        _MESHES[key] = mesh
    return mesh
