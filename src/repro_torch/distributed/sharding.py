"""Mesh-adaptive sharding helpers (counterpart of
``repro.distributed.sharding``).

Model code names logical axes: BATCH (data parallel) and MODEL (tensor or
expert parallel).  At O3 the mesh is (data, model); at O4 (pod, data,
model).  ``batch_axes()`` resolves BATCH to whichever data axes exist, so
the same code runs on both meshes and on no mesh at all (every helper is
then a no-op).  The active mesh is the ambient execution level's
(``use_level(O3|O4)``), a ``DeviceMesh``.

A sharded tensor is a ``DTensor``: a global view with this rank's shard
local.  Placement moves only where these helpers say so, with explicit
collectives of :mod:`repro_torch.distributed.collectives`, never through
DTensor's implicit redistribution:

    shard(x, sharding)   a full tensor every rank holds -> its DTensor
                         (each rank keeps its own slice; no communication)
    gather(x)            a DTensor -> the full tensor on every rank (an
                         all-gather per sharded mesh axis, inner first)
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core import execlevel
from repro_torch.core.sharding import NamedSharding, PartitionSpec as P
from repro_torch.core.topology import LocalMesh

__all__ = ["active_mesh", "batch_axes", "bspec", "constrain", "spec",
           "named", "shard", "gather", "is_sharded", "MODEL"]

MODEL = "model"


def active_mesh() -> Optional[Any]:
    """The ambient O3/O4 ``DeviceMesh``, or None (no mesh, or the
    one-process mesh of a run without a process group)."""
    m = execlevel.current().mesh
    return None if m is None or isinstance(m, LocalMesh) else m


def batch_axes(mesh=None) -> tuple[str, ...]:
    m = mesh or active_mesh()
    if m is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in m.mesh_dim_names)


def bspec(mesh=None):
    """The spec entry for a batch dimension on the active mesh."""
    axes = batch_axes(mesh)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def spec(*entries) -> P:
    """Build a PartitionSpec, resolving the sentinel 'batch' to bspec()."""
    resolved = []
    for e in entries:
        if e == "batch":
            resolved.append(bspec())
        elif e == MODEL:
            m = active_mesh()
            resolved.append(MODEL if (m is not None
                                      and MODEL in m.mesh_dim_names)
                            else None)
        else:
            resolved.append(e)
    return P(*resolved)


def named(mesh, *entries) -> NamedSharding:
    """A sharding over ``mesh``; 'batch' resolves to its batch axes, and
    axis names the mesh lacks to None."""
    axes = set(mesh.mesh_dim_names)
    resolved = []
    for e in entries:
        if e == "batch":
            b = tuple(a for a in ("pod", "data") if a in axes)
            resolved.append(b if len(b) > 1 else (b[0] if b else None))
        elif isinstance(e, str) and e not in axes:
            resolved.append(None)
        else:
            resolved.append(e)
    return NamedSharding(mesh, P(*resolved))


def is_sharded(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _coord(mesh, axes: tuple[str, ...]) -> tuple[int, int]:
    """(flat index of this rank over ``axes``, outer first; their count)."""
    from repro_torch.distributed.collectives import mesh_groups

    coords = mesh_groups(mesh).coords
    names = tuple(mesh.mesh_dim_names)
    idx, n = 0, 1
    for a in axes:
        size = int(mesh.shape[names.index(a)])
        idx, n = idx * size + coords[a], n * size
    return idx, n


def shard(x: torch.Tensor, sharding: NamedSharding):
    """The DTensor of a full tensor that every rank holds: each rank keeps
    its own slice of every sharded dim (no communication)."""
    from torch.distributed.tensor import DTensor

    loc = x
    for d in range(x.dim()):
        axes = sharding.axes_of(d)
        if axes:
            i, n = _coord(sharding.mesh, axes)
            step = x.shape[d] // n
            loc = loc.narrow(d, i * step, step)
    return DTensor.from_local(loc.contiguous(), sharding.mesh,
                              sharding.placements, run_check=False,
                              shape=x.shape, stride=x.contiguous().stride())


def gather(x) -> torch.Tensor:
    """The full tensor of a DTensor on every rank (``x`` itself when it is
    not one): one all-gather per sharded mesh axis, the innermost first,
    over the mesh's own groups and transport."""
    if not is_sharded(x):
        return x
    from torch.distributed.tensor import Shard

    from repro_torch.distributed.collectives import all_gather, mesh_groups

    mesh = x.device_mesh
    g = mesh_groups(mesh)
    out = x.to_local()
    names = tuple(mesh.mesh_dim_names)
    for i in reversed(range(len(names))):
        p = x.placements[i]
        if isinstance(p, Shard) and mesh.shape[i] > 1:
            out = all_gather(out, g.axis[names[i]], int(mesh.shape[i]),
                             g.transport, p.dim)
    return out


def constrain(x, *entries):
    """Put ``x`` in the layout ``entries`` name on the active mesh (a
    no-op without one): a full tensor is sliced, a DTensor in another
    layout gathered and sliced."""
    mesh = active_mesh()
    if mesh is None:
        return x
    want = named(mesh, *spec(*entries))
    if is_sharded(x) and tuple(x.placements) == want.placements:
        return x
    return shard(gather(x), want)
