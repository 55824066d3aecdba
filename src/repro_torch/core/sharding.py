"""Container -> mesh sharding rules for the DSL execution levels
(counterpart of ``repro.core.sharding``).

ArBB never exposes data placement: the runtime decides how containers are
split across cores.  The port keeps that contract: when a call runs at
O3/O4 the framework picks shardings from container rank and divisibility
alone.

Rules (first matching axis wins, axis must divide the dim):
  1-D containers: shard dim 0 over the batch axes ('pod','data' flattened).
  2-D containers: dim 0 over batch axes, dim 1 over 'model'.
  3-D containers: dim 0 over batch axes, dim 2 over 'model'.
  Anything that does not divide evenly stays replicated on that dim.

A :class:`PartitionSpec` is a tuple with one entry per tensor dim (None, an
axis name, or a tuple of axis names, outer first), as JAX's; a
:class:`NamedSharding` pairs it with a mesh and maps it onto DTensor
placements (``Shard(dim)`` on every mesh axis an entry names,
``Replicate()`` elsewhere), the global view with local shards that a
``NamedSharding``-ed ``jax.Array`` is.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

__all__ = ["PartitionSpec", "P", "NamedSharding", "auto_spec",
           "auto_sharding", "batch_axes", "replicated"]


class PartitionSpec(tuple):
    """One entry per tensor dim: None, an axis name, or a tuple of axis
    names (the dim is split over their product, the first outermost)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def _size(mesh, axis: str) -> int:
    return int(mesh.shape[_names(mesh).index(axis)])


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A :class:`PartitionSpec` over a mesh (a ``DeviceMesh``)."""
    mesh: Any
    spec: PartitionSpec

    def __post_init__(self):
        names = _names(self.mesh)
        seen: list[str] = []
        for entry in self.spec:
            axes = entry if isinstance(entry, tuple) else \
                (() if entry is None else (entry,))
            for a in axes:
                if a not in names or a in seen:
                    raise ValueError(f"{self.spec}: axis {a!r} is not a "
                                     f"free axis of the mesh {names}")
                seen.append(a)
            if list(axes) != sorted(axes, key=names.index):
                raise ValueError(f"{self.spec}: axes {axes} are not in the "
                                 f"mesh's order {names}")

    def axes_of(self, dim: int) -> tuple[str, ...]:
        """The mesh axes tensor dim ``dim`` is split over, outer first."""
        entry = self.spec[dim] if dim < len(self.spec) else None
        if entry is None:
            return ()
        return entry if isinstance(entry, tuple) else (entry,)

    @property
    def placements(self) -> tuple:
        """DTensor placements, one per mesh axis."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for name in _names(self.mesh):
            dims = [d for d in range(len(self.spec))
                    if name in self.axes_of(d)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def __str__(self) -> str:
        dims = ", ".join(f"{n}={s}" for n, s in zip(_names(self.mesh),
                                                    self.mesh.shape))
        return f"NamedSharding(mesh=({dims}), spec={self.spec!r})"


def batch_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh: ('pod', 'data') when present."""
    return tuple(a for a in ("pod", "data") if a in _names(mesh))


def _axis_size(mesh, axes: Sequence[str]) -> int:
    n = 1
    for a in axes:
        n *= _size(mesh, a)
    return n


def auto_spec(shape: Sequence[int], mesh) -> PartitionSpec:
    """Rank/divisibility-driven spec for a DSL container."""
    ndim = len(shape)
    if ndim == 0:
        return P()
    parts: list = [None] * ndim
    baxes = batch_axes(mesh)
    if baxes and shape[0] % _axis_size(mesh, baxes) == 0 and shape[0] > 0:
        parts[0] = baxes if len(baxes) > 1 else baxes[0]
    if ndim >= 2 and "model" in _names(mesh):
        mdim = ndim - 1 if ndim <= 2 else 2
        if shape[mdim] % _size(mesh, "model") == 0 and shape[mdim] > 0:
            parts[mdim] = "model"
    return P(*parts)


def auto_sharding(shape: Sequence[int], mesh) -> Optional[NamedSharding]:
    if mesh is None:
        return None
    return NamedSharding(mesh, auto_spec(shape, mesh))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
