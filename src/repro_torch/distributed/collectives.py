"""Hierarchical collectives plane (counterpart of
``repro.distributed.collectives``, DESIGN.md §8): axis-role-aware
reduction plans for the mesh-scoped numerics, over ``torch.distributed``.

A :class:`ReducePlan` is built from the ambient mesh's *topology* (axis
names, sizes, roles: :mod:`repro_torch.core.topology`) and emits
**hierarchical schedules**:

    psum          partial -> all-reduce over the data axes -> all-reduce
                  over the pod axes
    psum_scatter  reduce-scatter over the data axes, then all-reduce over
                  the pod axes: every participant ends with its shard of the
                  fully-reduced result, and only already-reduced data
                  crosses the pod boundary
    all_gather    gather over the data axes first, then the pod axes (the
                  dual of the sharding order, so row shards reassemble in
                  global order)

:class:`RingPlan` is the neighbour rotation of sequence-parallel attention
(a pod-major ring over the batch-role axes; its callers are
:mod:`repro_torch.distributed.attention` and the ring-striped page pool of
the serve tier), and :class:`CannonPlan` the fold of
the mesh SpGEMM's partials.  Plans are frozen and hashable, and their
``schedule()`` output, degenerate-axis rules and shard order equal the
reference's for the same axis names and sizes.

Where the reference runs these inside ``shard_map``, the port runs them
eagerly on each rank's local shard (``DTensor.to_local()``), with explicit
collectives over one process group per mesh axis and per axis pair, built
once per mesh (:func:`mesh_groups`).

**Transport.**  Chosen when a plan is built, by the groups' backend and the
mesh's device type, and never changed after a failure:

    nccl       the tensors' own device (one card per rank)
    gloo       host tensors, directly
    gloo-host  CUDA tensors staged through host memory: laid out on the
               card, copied out into pinned buffers, reduced by gloo,
               copied back (NCCL refuses two ranks on one card, and gloo's
               own CUDA paths are not taken)

:meth:`ReducePlan.transports` names the transport of each collective the
plan runs.  Sums are deterministic: gloo's and NCCL's all-reduce leave
the same bits on every rank, run to run.

**Tracing.**  While :data:`repro_torch.obs.trace.TRACER` is on, each plan
execution is a ``collectives.<kind>`` event, each low-level collective a
``collective:<kind>`` span with its operand bytes and transport, and a
gloo-host staging copy a ``collective:stage`` span inside it.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Optional

import torch

from repro_torch.core import registry
from repro_torch.core.topology import MeshTopology, topology_of
from repro_torch.obs import trace as obs_trace

__all__ = ["ReducePlan", "reduce_plan", "ambient_plan", "flat_index",
           "RingPlan", "ring_plan", "ambient_ring_plan",
           "CannonPlan", "cannon_plan", "ambient_cannon_plan",
           "MeshGroups", "mesh_groups", "transport_of"]


def _plan_event(kind: str, axes: tuple[str, ...], **attrs) -> None:
    """One trace event per plan execution (the tracer's ``event`` is a
    no-op while it is off)."""
    obs_trace.TRACER.event(f"collectives.{kind}", cat="collectives",
                           axes="x".join(axes) or "-", **attrs)


def _entry(axes: tuple[str, ...]):
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def flat_index(axes: tuple[str, ...], sizes: tuple[int, ...],
               coords: dict) -> int:
    """This rank's flat shard index over ``axes`` (outer-first) from its
    per-axis ``coords``: the global row offset of a (pod, data) row shard
    is ``flat_index(('pod', 'data'), (2, 2), coords) * rows_per_shard``."""
    idx = 0
    for name, size in zip(axes, sizes):
        idx = idx * size + coords[name]
    return idx


def transport_of(backend: str, device_type: str) -> str:
    """The transport for groups of ``backend`` on a mesh of
    ``device_type`` (see the module docstring)."""
    if backend == "nccl":
        return "nccl"
    return "gloo-host" if device_type == "cuda" else "gloo"


# ---------------------------------------------------------------------------
# process groups: one per mesh axis and per axis pair, built once per mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshGroups:
    """The process groups of one mesh, and this rank's place in them."""
    axis: dict           # axis name -> ProcessGroup
    pair: dict           # (axis, axis), mesh order -> ProcessGroup
    coords: dict         # axis name -> this rank's coordinate
    transport: str

    def group(self, axes: tuple[str, ...]):
        if len(axes) == 1:
            return self.axis[axes[0]]
        return self.pair[tuple(axes)]


#: id(mesh) -> (mesh, MeshGroups); the mesh is kept so its id stays unique.
_GROUPS: dict[int, tuple[Any, MeshGroups]] = {}


def mesh_groups(mesh) -> MeshGroups:
    """The :class:`MeshGroups` of a ``DeviceMesh``, built on first use.
    Building is collective: every rank of the world builds the groups of a
    mesh together (``launch.mesh.make_mesh`` does it when the mesh is
    made)."""
    hit = _GROUPS.get(id(mesh))
    if hit is not None and hit[0] is mesh:
        return hit[1]
    import torch.distributed as dist

    names = tuple(mesh.mesh_dim_names)
    ranks = mesh.mesh                    # tensor of global ranks
    me = dist.get_rank()
    # a rank outside a mesh over the world's first ranks makes the groups
    # with the others and has no place in them
    member = me in ranks.flatten().tolist()
    axis = {n: mesh.get_group(n) for n in names} if member else {}
    coords = {n: mesh.get_local_rank(n) for n in names} if member else {}
    pair = {}
    for i, j in itertools.combinations(range(len(names)), 2):
        rest = [d for d in range(len(names)) if d not in (i, j)]
        rows = ranks.permute(*rest, i, j).reshape(-1, ranks.shape[i]
                                                  * ranks.shape[j])
        for row in rows.tolist():        # every rank makes every group
            g = dist.new_group(ranks=row)
            if me in row:
                pair[(names[i], names[j])] = g
    backend = str(dist.get_backend(axis[names[0]] if member else None))
    out = MeshGroups(axis=axis, pair=pair, coords=coords,
                     transport=transport_of(backend, mesh.device_type))
    _GROUPS[id(mesh)] = (mesh, out)
    return out


# ---------------------------------------------------------------------------
# the collectives, on local tensors
# ---------------------------------------------------------------------------

def _dist():
    import torch.distributed as dist
    return dist


def _span(kind: str, x: torch.Tensor, transport: str):
    """A span over one low-level collective, named ``collective:<kind>``,
    with its operand bytes and transport (the tracer's no-op while it is
    off)."""
    return obs_trace.TRACER.span(f"collective:{kind}", cat="collectives",
                                 bytes=x.numel() * x.element_size(),
                                 transport=transport)


def _staged(transport: str, x: torch.Tensor):
    """``(tensor to hand gloo or NCCL, device to return to)``.  A CUDA
    tensor that gloo-host stages is copied into pinned host memory (a DMA
    at the link's rate; PyTorch's caching host allocator keeps the buffer
    for the next call), under a ``collective:stage`` span: the copy waits
    for the kernels queued before it."""
    if transport == "gloo-host" and x.device.type != "cpu":
        with obs_trace.TRACER.span("collective:stage", cat="collectives"):
            h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            h.copy_(x)
        return h, x.device
    return x, None


def _out(h: torch.Tensor, shape, device) -> torch.Tensor:
    """A buffer for a collective's result on the device of ``h``, the
    tensor handed to the transport: the card's for NCCL, pinned host
    memory when staged."""
    return torch.empty(shape, dtype=h.dtype, device=h.device,
                       pin_memory=device is not None)


def _back(out: torch.Tensor, device) -> torch.Tensor:
    """The result on the caller's device; a staged copy back is queued on
    the stream (the pinned buffer is not reused until it has run)."""
    return out if device is None else out.to(device, non_blocking=True)


def all_reduce(x: torch.Tensor, group, transport: str, op=None
               ) -> torch.Tensor:
    """A new tensor: ``x`` reduced (default: summed) over ``group``."""
    dist = _dist()
    with _span("all_reduce", x, transport):
        h, dev = _staged(transport, x)
        out = h if dev is not None else h.clone()    # staged: a copy
        dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=group)
        return _back(out, dev)


def reduce_scatter(x: torch.Tensor, group, n: int, transport: str,
                   dim: int = 0) -> torch.Tensor:
    """Sum over ``group`` and keep this rank's ``1/n`` tile of ``dim``
    (tiled, in group-rank order), contiguous.  Layout moves run on ``x``'s
    device."""
    dist = _dist()
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    with _span("reduce_scatter", x, transport):
        h, dev = _staged(transport, x.movedim(dim, 0).contiguous())
        out = _out(h, (h.shape[0] // n,) + tuple(h.shape[1:]), dev)
        fn(out, h, group=group)
        return _back(out, dev).movedim(0, dim).contiguous()


def all_gather(x: torch.Tensor, group, n: int, transport: str,
               dim: int = 0) -> torch.Tensor:
    """The ``n`` tiles of ``group`` concatenated along ``dim`` in
    group-rank order, contiguous (a restored checkpoint's layout, so that
    the products that read it take the same kernels).  Layout moves run on
    ``x``'s device."""
    dist = _dist()
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    with _span("all_gather", x, transport):
        h, dev = _staged(transport, x.movedim(dim, 0).contiguous())
        out = _out(h, (h.shape[0] * n,) + tuple(h.shape[1:]), dev)
        fn(out, h, group=group)
        return _back(out, dev).movedim(0, dim).contiguous()


def all_to_all(x: torch.Tensor, group, n: int, transport: str,
               split_dim: int, concat_dim: int) -> torch.Tensor:
    """Tiled all-to-all: ``x`` cut into ``n`` tiles along ``split_dim``,
    tile ``j`` to group rank ``j``, the tiles received concatenated along
    ``concat_dim`` in group-rank order (``jax.lax.all_to_all(...,
    tiled=True)``).  Layout moves run on ``x``'s device."""
    dist = _dist()
    with _span("all_to_all", x, transport):
        h, dev = _staged(transport, torch.stack(x.chunk(n, dim=split_dim))
                         .contiguous())
        recv = _out(h, h.shape, dev)
        dist.all_to_all_single(recv, h, group=group)
        return torch.cat(list(_back(recv, dev).unbind(0)), dim=concat_dim)


def rotate(x: torch.Tensor, group, n: int, transport: str) -> torch.Tensor:
    """Group rank ``i`` sends ``x`` to ``i + 1`` (mod n) and returns what
    ``i - 1`` sent (``batch_isend_irecv``)."""
    dist = _dist()
    with _span("rotate", x, transport):
        h, dev = _staged(transport, x.contiguous())
        me = dist.get_rank(group)
        out = _out(h, h.shape, dev)
        ops = [dist.P2POp(dist.isend, h,
                          dist.get_global_rank(group, (me + 1) % n)),
               dist.P2POp(dist.irecv, out,
                          dist.get_global_rank(group, (me - 1) % n))]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return _back(out, dev)


# ---------------------------------------------------------------------------
# reduce plans
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReducePlan:
    """A hierarchical reduction schedule over a mesh's batch-role axes.

    ``data_axes``/``pod_axes`` are in mesh (outer-first) order; execution
    always runs the data stage first and the pod stage last, so the slow
    boundary only ever carries already-reduced values.  ``mesh`` rides
    along so the plan alone reaches its process groups.
    """
    mesh: object                     # DeviceMesh (or LocalMesh), hashable
    topo: MeshTopology
    pod_axes: tuple[str, ...]
    data_axes: tuple[str, ...]

    # -- structure ----------------------------------------------------------

    @property
    def batch_axes(self) -> tuple[str, ...]:
        """All reduction axes, outer-first (pod-major): the shard order of
        row shards."""
        return self.pod_axes + self.data_axes

    @property
    def width(self) -> int:
        """Total participants = product of the batch-axis sizes."""
        w = 1
        for a in self.batch_axes:
            w *= self.topo.size(a)
        return w

    @property
    def data_width(self) -> int:
        w = 1
        for a in self.data_axes:
            w *= self.topo.size(a)
        return w

    @property
    def hierarchical(self) -> bool:
        """True when the schedule has a real inter-pod stage."""
        return bool(self.pod_axes) and bool(self.data_axes)

    def spec_entry(self):
        """The partition-spec entry sharding a dim over the batch axes
        (None / name / tuple)."""
        return _entry(self.batch_axes)

    def data_spec_entry(self):
        """The entry for a dim sharded over the *data* axes only: the
        layout :meth:`psum_scatter` leaves the scattered dim in."""
        return _entry(self.data_axes)

    def schedule(self, terminal: str = "all_reduce"
                 ) -> tuple[tuple[str, str], ...]:
        """The emitted schedule as (collective, axis) steps.  ``terminal``
        names the data-stage collective of :meth:`psum_scatter`
        ('reduce_scatter') or of :meth:`psum` ('all_reduce')."""
        first = "reduce_scatter" if terminal == "reduce_scatter" \
            else "all_reduce"
        steps = [(first, a) for a in self.data_axes]
        steps += [("all_reduce", a) for a in self.pod_axes]
        return tuple(steps)

    @property
    def groups(self) -> MeshGroups:
        return mesh_groups(self.mesh)

    def transports(self) -> dict[str, str]:
        """The transport of each collective this plan runs."""
        t = self.groups.transport
        return {"all_reduce": t, "reduce_scatter": t, "all_gather": t,
                "all_to_all": t}

    # -- execution (on this rank's local shard) -----------------------------

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Hierarchical all-reduce: data axes first, then pod."""
        _plan_event("psum", self.batch_axes, hierarchical=self.hierarchical)
        g = self.groups
        for a in self.data_axes + self.pod_axes:
            x = all_reduce(x, g.axis[a], g.transport)
        return x

    def psum_scatter(self, x: torch.Tensor, scatter_dimension: int = 0
                     ) -> torch.Tensor:
        """Reduce-scatter over the data axes, all-reduce over the pod axes.
        The result is sharded over the data axes along
        ``scatter_dimension`` and replicated over the pod axes; data axes
        scatter outermost-first, so the shard layout is the data axes'
        pod-major order."""
        _plan_event("psum_scatter", self.batch_axes,
                    hierarchical=self.hierarchical,
                    scatter_dimension=scatter_dimension)
        g = self.groups
        for a in self.data_axes:
            x = reduce_scatter(x, g.axis[a], self.topo.size(a), g.transport,
                               scatter_dimension)
        for a in self.pod_axes:
            x = all_reduce(x, g.axis[a], g.transport)
        return x

    def all_gather(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """Reassemble batch-axis row shards: gather over the data axes
        first, then the pod axes.  Inverse of sharding by
        :meth:`spec_entry`."""
        _plan_event("all_gather", self.batch_axes,
                    hierarchical=self.hierarchical)
        g = self.groups
        for a in reversed(self.data_axes):
            x = all_gather(x, g.axis[a], self.topo.size(a), g.transport, axis)
        for a in reversed(self.pod_axes):
            x = all_gather(x, g.axis[a], self.topo.size(a), g.transport, axis)
        return x

    def all_to_all(self, x: torch.Tensor, axis_name: str, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """Tiled all-to-all within one axis (the FFT's corner turn)."""
        _plan_event("all_to_all", (axis_name,))
        g = self.groups
        return all_to_all(x, g.axis[axis_name], self.topo.size(axis_name),
                          g.transport, split_dim, concat_dim)

    def shard_index(self) -> int:
        """This rank's flat batch-shard index (pod-major)."""
        sizes = tuple(self.topo.size(a) for a in self.batch_axes)
        return flat_index(self.batch_axes, sizes, self.groups.coords)

    # -- ZeRO: one flat shard over every batch axis --------------------------

    def zero_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Sum ``x`` over every batch axis and keep this rank's tile of
        ``dim`` (tile :meth:`shard_index`, pod-major): the layout a dim of
        ``zero1_specs`` sharded over ``(pod, data)`` takes.  One
        reduce-scatter over the batch axes' group."""
        _plan_event("zero_scatter", self.batch_axes, dim=dim,
                    bytes=x.numel() * x.element_size())
        g = self.groups
        return reduce_scatter(x, g.group(self.batch_axes), self.width,
                              g.transport, dim)

    def zero_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The inverse of :meth:`zero_scatter`'s tiling: every rank's tile
        concatenated along ``dim`` in pod-major order.  One all-gather over
        the batch axes' group."""
        _plan_event("zero_gather", self.batch_axes, dim=dim,
                    bytes=x.numel() * x.element_size())
        g = self.groups
        return all_gather(x, g.group(self.batch_axes), self.width,
                          g.transport, dim)

    def psum_all(self, x: torch.Tensor, op=None) -> torch.Tensor:
        """All-reduce over every batch axis at once (one collective over
        their group; ``op`` default sum): the scalars of the mesh trainer
        (token counts, the clip's squared norm, the loss)."""
        _plan_event("psum_all", self.batch_axes)
        g = self.groups
        return all_reduce(x, g.group(self.batch_axes), g.transport, op)


def reduce_plan(mesh, topo: Optional[MeshTopology] = None) -> ReducePlan:
    """Build the :class:`ReducePlan` for ``mesh`` from its axis roles.

    Degenerate (size-1) axes are dropped from the schedule: a ``(data=8,
    model=1)`` mesh plans a single flat all-reduce over ``data``; only a
    real pod axis buys the hierarchical form."""
    topo = topo if topo is not None else topology_of(mesh)
    if topo is None:
        raise ValueError("reduce_plan needs a mesh (got None)")
    pod = tuple(a for a in topo.axes("pod") if topo.size(a) > 1)
    data = tuple(a for a in topo.axes("data") if topo.size(a) > 1)
    if not data and pod:
        # all batch parallelism lives on pod axes: the data stage is empty
        # and the pod stage is the whole (flat) reduction
        pod, data = (), pod
    return ReducePlan(mesh=mesh, topo=topo, pod_axes=pod, data_axes=data)


def ambient_plan() -> Optional[ReducePlan]:
    """The plan for the ambient O3/O4 mesh, or None outside one (or when
    the mesh has no batch-role parallelism to reduce over)."""
    ctx = registry.select_context()
    if ctx.scope != "mesh" or ctx.topology is None:
        return None
    plan = reduce_plan(ctx.mesh, ctx.topology)
    return plan if plan.batch_axes else None


# ---------------------------------------------------------------------------
# ring schedules (the sequence-parallel plane, DESIGN.md §10)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RingPlan:
    """A neighbour-rotation schedule over a mesh's batch-role axes: the
    collective shape of sequence-parallel (ring) attention.

    ``axes`` are in mesh (outer-first, pod-major) order, so on an O4
    ``(pod, data, model)`` mesh the ring walks all data shards of pod 0,
    then pod 1, ...: only the pod-seam hops cross the slow link."""
    mesh: object
    topo: MeshTopology
    axes: tuple[str, ...]            # pod-major ring axes

    @property
    def size(self) -> int:
        """Ring participants = product of the ring-axis sizes."""
        w = 1
        for a in self.axes:
            w *= self.topo.size(a)
        return w

    def spec_entry(self):
        """The entry sharding the sequence dim over the ring."""
        return _entry(self.axes)

    @property
    def perm(self) -> tuple[tuple[int, int], ...]:
        """One rotation hop: shard ``i`` sends its K/V panel to ``i + 1``
        (mod size), so after ``h`` hops shard ``r`` holds the panel that
        started on shard ``(r - h) mod size``."""
        w = self.size
        return tuple((i, (i + 1) % w) for i in range(w))

    def schedule(self) -> tuple[tuple[str, tuple[str, ...]], ...]:
        """One ``ppermute`` rotation per non-self hop, as (collective,
        axes) steps (the reference's names)."""
        return (("ppermute", self.axes),) * (self.size - 1)

    def _group(self):
        return mesh_groups(self.mesh).group(self.axes)

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        """Rotate ``x`` one hop around the ring (pod-major flat order)."""
        _plan_event("ring_shift", self.axes, size=self.size)
        return rotate(x, self._group(), self.size,
                      mesh_groups(self.mesh).transport)

    def ring_index(self) -> int:
        """This rank's flat ring position (pod-major)."""
        sizes = tuple(self.topo.size(a) for a in self.axes)
        return flat_index(self.axes, sizes, mesh_groups(self.mesh).coords)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce ``x`` over the ring participants."""
        _plan_event("ring_psum", self.axes, size=self.size)
        return all_reduce(x, self._group(), mesh_groups(self.mesh).transport)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """All-max over the ring participants."""
        _plan_event("ring_pmax", self.axes, size=self.size)
        return all_reduce(x, self._group(), mesh_groups(self.mesh).transport,
                          op=_dist().ReduceOp.MAX)

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ring's ``x`` concatenated along ``dim`` in ring order (the
        inverse of sharding a dim by :meth:`spec_entry`)."""
        _plan_event("ring_all_gather", self.axes, size=self.size)
        return all_gather(x, self._group(), self.size,
                          mesh_groups(self.mesh).transport, dim)

    def all_to_all(self, x: torch.Tensor, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """Tiled all-to-all over the ring: ``x`` cut into :attr:`size`
        tiles along ``split_dim``, tile ``j`` to ring position ``j``, the
        tiles received concatenated along ``concat_dim`` in ring order.
        Its transpose swaps the two dims."""
        _plan_event("ring_all_to_all", self.axes, size=self.size)
        return all_to_all(x, self._group(), self.size,
                          mesh_groups(self.mesh).transport, split_dim,
                          concat_dim)


def ring_plan(mesh, topo: Optional[MeshTopology] = None) -> RingPlan:
    """Build the :class:`RingPlan` for ``mesh``: the batch-role (pod x
    data) axes, degenerate ones dropped; model axes never join the ring."""
    topo = topo if topo is not None else topology_of(mesh)
    if topo is None:
        raise ValueError("ring_plan needs a mesh (got None)")
    axes = tuple(a for a in topo.axes("pod", "data") if topo.size(a) > 1)
    return RingPlan(mesh=mesh, topo=topo, axes=axes)


def ambient_ring_plan() -> Optional[RingPlan]:
    """The ring plan for the ambient O3/O4 mesh, or None outside one (or
    when the mesh has no batch-role axis to ring over)."""
    ctx = registry.select_context()
    if ctx.scope != "mesh" or ctx.topology is None:
        return None
    plan = ring_plan(ctx.mesh, ctx.topology)
    return plan if plan.axes else None


# ---------------------------------------------------------------------------
# Cannon schedules (the SpGEMM mesh plane, DESIGN.md §15)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CannonPlan:
    """A Cannon-style 2-D distribution schedule for mesh SpGEMM.

    Every rank computes a slice of the block-product pair list (sharded
    flat over all participating axes: the skew collapsed into the
    partition); partials then meet C's owners through an all-reduce over
    the col (model) axes and a tiled reduce-scatter over the row (pod x
    data) axes, leaving C's value blocks row-sharded."""
    mesh: object
    topo: MeshTopology
    row_axes: tuple[str, ...]        # pod-major: C's block-row shard axes
    col_axes: tuple[str, ...]        # model-role: partial-product axes

    @property
    def rows(self) -> int:
        """Row ranks = product of the row-axis sizes (C's shard count)."""
        w = 1
        for a in self.row_axes:
            w *= self.topo.size(a)
        return w

    @property
    def cols(self) -> int:
        """Column ranks = product of the col-axis sizes."""
        w = 1
        for a in self.col_axes:
            w *= self.topo.size(a)
        return w

    @property
    def size(self) -> int:
        """Total participants = rows x cols (the pair-list shard count)."""
        return self.rows * self.cols

    @property
    def all_axes(self) -> tuple[str, ...]:
        """Every participating axis, row-major then col: the flat pair-list
        partition order."""
        return self.row_axes + self.col_axes

    def row_spec_entry(self):
        """The entry sharding a dim over the row axes: the layout
        :meth:`reduce_partials` leaves C's values in."""
        return _entry(self.row_axes)

    def pair_spec_entry(self):
        """The entry sharding the pair list over *all* axes."""
        return _entry(self.all_axes)

    def schedule(self) -> tuple[tuple[str, str], ...]:
        """Col-axis all-reduces first, then row-axis reduce-scatters, as
        (collective, axis) steps."""
        steps = [("all_reduce", a) for a in self.col_axes]
        steps += [("reduce_scatter", a) for a in self.row_axes]
        return tuple(steps)

    def reduce_partials(self, x: torch.Tensor, scatter_dimension: int = 0
                        ) -> torch.Tensor:
        """Fold the per-rank partial block products into row-sharded C
        values: all-reduce over the col axes, then tiled reduce-scatter
        over the row axes (outermost-first)."""
        _plan_event("cannon_reduce", self.all_axes, rows=self.rows,
                    cols=self.cols)
        g = mesh_groups(self.mesh)
        for a in self.col_axes:
            x = all_reduce(x, g.axis[a], g.transport)
        for a in self.row_axes:
            x = reduce_scatter(x, g.axis[a], self.topo.size(a), g.transport,
                               scatter_dimension)
        return x

    def pair_index(self) -> int:
        """This rank's flat pair-list shard index (row-major)."""
        sizes = tuple(self.topo.size(a) for a in self.all_axes)
        return flat_index(self.all_axes, sizes, mesh_groups(self.mesh).coords)


def cannon_plan(mesh, topo: Optional[MeshTopology] = None) -> CannonPlan:
    """Build the :class:`CannonPlan` for ``mesh``: batch-role (pod x data)
    axes become the row dimension, model-role axes the column dimension,
    degenerate axes dropped.  ``(data=8, model=1)`` plans 8x1,
    ``(pod=2, data=2, model=2)`` plans 4x2."""
    topo = topo if topo is not None else topology_of(mesh)
    if topo is None:
        raise ValueError("cannon_plan needs a mesh (got None)")
    rows = tuple(a for a in topo.axes("pod", "data") if topo.size(a) > 1)
    cols = tuple(a for a in topo.axes("model") if topo.size(a) > 1)
    return CannonPlan(mesh=mesh, topo=topo, row_axes=rows, col_axes=cols)


def ambient_cannon_plan() -> Optional[CannonPlan]:
    """The Cannon plan for the ambient O3/O4 mesh, or None outside one (or
    when the mesh has no batch-role axis to row-shard over)."""
    ctx = registry.select_context()
    if ctx.scope != "mesh" or ctx.topology is None:
        return None
    plan = cannon_plan(ctx.mesh, ctx.topology)
    return plan if plan.row_axes else None
