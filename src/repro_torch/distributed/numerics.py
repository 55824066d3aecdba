"""Mesh-scoped formulations of the paper's four kernels (counterpart of
``repro.distributed.numerics``, DESIGN.md §7-§8).

The paper scales one unchanged program text across cores with
``ARBB_NUM_CORES`` (§3, O2 -> O3) but stops at the shared-memory ceiling
(§4).  This module is the rung past it: for each paper kernel (mod2am
matmul, mod2as SpMV, mod2f FFT, the §3.4 CG solve) and the blocked-sparse
SpMM and SpGEMM, a program over the ranks of the ambient mesh registers as
a **mesh-scoped registry variant**.  The registry's scope dimension selects
it whenever an O3/O4 mesh is ambient and degrades to the chip formulation
without one (or when the shapes do not divide the mesh); call sites never
change.

Where the reference writes each as a ``shard_map`` program, the port runs
it on every rank at once (SPMD over ``torch.distributed``): each rank
slices its shard out of the operands (which every rank holds whole, as
``shard_map``'s in_specs slice a replicated array), computes on it with the
chip formulation, and meets the other ranks only through the explicit
collectives of a :mod:`~repro_torch.distributed.collectives` plan.  A
result comes back as a ``DTensor``, the global view with this rank's shard
local, in the layout the reference's ``out_specs`` name
(:func:`repro_torch.distributed.sharding.gather` makes it whole).

Partitioning per kernel (axis-role aware: every formulation asks
``reduce_plan`` for the ambient mesh's hierarchical schedule):

    solver_spmv  row partition over the batch axes (pod x data): ELL
                 values/cols by rows, DIA diagonals by columns, CSR row
                 pointer sections by rows with values/indices whole; ``x``
                 whole; each rank runs the chip formulation on its rows.
    matmul       ``mesh_psum``: K over the batch axes; each rank multiplies
                 its K panel with the chip ``matmul`` variant (the
                 hand-written kernel on the card), then the partials
                 reduce-scatter over data and all-reduce over pod into a
                 row-sharded C.  ``mesh_psum_2d`` also tiles N over the
                 model axis, its panels dealt block-cyclically.
    fft          the transpose (four-step) algorithm: row FFTs of length
                 n2 (``torch.fft.fft``, outside any kernel, as the
                 reference's ``jnp.fft``), twiddles (cached per plan), an
                 all-to-all corner turn within the data axis only, column
                 FFTs of length n1.
    cg           the whole solve row-sharded: ``p`` all-gathered once an
                 iteration, every dot product a local partial through the
                 plan's hierarchical all-reduce.

Every sum runs in a fixed order (no atomics): CSR row sections reduce as
one masked rectangle, SpGEMM partials as slot-sorted runs position by
position, and the collectives leave the same bits on every rank.
"""
from __future__ import annotations

import functools
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.core.blocking import round_up
from repro_torch.core.containers import Dense, unwrap, wrap
from repro_torch.core.sharding import NamedSharding, PartitionSpec as P
from repro_torch.core.topology import topology_of
from repro_torch.distributed import sharding as dsharding
from repro_torch.distributed.collectives import (CannonPlan, ReducePlan,
                                                 _entry, all_gather,
                                                 ambient_cannon_plan,
                                                 ambient_plan, cannon_plan,
                                                 mesh_groups, reduce_plan)
from repro_torch.kernels import ref
from repro_torch.numerics.sparse import CSR, DIA, ELL
from repro_torch.numerics.spmv import dia_panel
from repro_torch.sparse.formats import BSR

__all__ = ["cg_mesh", "mesh_matmul", "mesh_matmul_2d", "mesh_fft",
           "mesh_spmv", "mesh_spmm", "mesh_spgemm", "MESH_SPMV_VARIANTS",
           "block_cyclic_perm", "segment_sum_sorted"]

#: The mesh-scoped solver_spmv variant names, keyed by layout.
MESH_SPMV_VARIANTS = {CSR: "mesh_csr", ELL: "mesh_ell", DIA: "mesh_dia"}


def _plan_for_mesh(mesh) -> Optional[ReducePlan]:
    topo = topology_of(mesh)
    if topo is None:
        return None
    plan = reduce_plan(mesh, topo)
    return plan if plan.batch_axes else None


def _require_plan() -> ReducePlan:
    plan = ambient_plan()
    if plan is None:
        raise RuntimeError(
            "mesh-scoped variant invoked without an ambient O3/O4 mesh "
            "carrying a batch-role (pod/data) axis; enter use_level(O3) first")
    return plan


def _mesh_available(ctx: registry.SelectContext) -> bool:
    return (ctx.topology is not None and
            bool(reduce_plan(ctx.mesh, ctx.topology).batch_axes))


# ---------------------------------------------------------------------------
# local shards and sharded results
# ---------------------------------------------------------------------------

def _full(x) -> torch.Tensor:
    """The whole operand on this rank (a DTensor is gathered)."""
    return dsharding.gather(unwrap(wrap(x)))


def _shard_of(t: torch.Tensor, index: int, count: int, dim: int = 0
              ) -> torch.Tensor:
    step = t.shape[dim] // count
    return t.narrow(dim, index * step, step)


def _sharded(loc: torch.Tensor, mesh, spec: P, shape) -> torch.Tensor:
    """The DTensor of global ``shape`` whose local shard is ``loc``."""
    from torch.distributed.tensor import DTensor

    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(loc.contiguous(), mesh,
                              NamedSharding(mesh, spec).placements,
                              run_check=False, shape=shape, stride=stride)


# ---------------------------------------------------------------------------
# row-partitioned SpMV: matrix shards per layout, x whole, chip formulation
# per shard
# ---------------------------------------------------------------------------

def _spmv_parts(a) -> tuple[str, Any, tuple]:
    """(kind, static signature, arrays) for matrix ``a``."""
    if isinstance(a, ELL):
        return "ell", None, (a.values, a.cols)
    if isinstance(a, CSR):
        return "csr", None, (a.rowp[:-1], a.rowp[1:], a.matvals, a.indx)
    if isinstance(a, DIA):
        return "dia", a.offsets, (a.diags,)
    raise TypeError(f"no row partitioning for matrix type {type(a)!r}")


def _local_arrays(kind: str, arrays: tuple, plan: ReducePlan) -> tuple:
    """This rank's shard of each array (the reference's in_specs: ELL
    values/cols by rows, CSR row pointer sections by rows with values and
    indices whole, DIA diagonals by columns)."""
    i, n = plan.shard_index(), plan.width
    if kind == "ell":
        return tuple(_shard_of(t, i, n) for t in arrays)
    if kind == "csr":
        rowpi, rowpj, matvals, indx = arrays
        return (_shard_of(rowpi, i, n), _shard_of(rowpj, i, n), matvals,
                indx)
    (diags,) = arrays
    return (_shard_of(diags, i, n, dim=1),)


def _csr_sections(loc: tuple, xf: torch.Tensor) -> torch.Tensor:
    """The paper's ``map(local::reduce)`` over this rank's row sections:
    each row's recorded ``_for`` over ``[rowpi, rowpj)`` as one masked
    gather over the sections' rectangle (row length padded to the
    longest), summed along the row in a fixed order.  ``xf`` is a vector
    or an (n, k) panel."""
    rowpi, rowpj, matvals, indx = loc
    rowpi, rowpj = rowpi.long(), rowpj.long()
    lens = rowpj - rowpi
    width = int(lens.max()) if lens.numel() else 0
    out_shape = (rowpi.shape[0],) + tuple(xf.shape[1:])
    if width == 0:
        return torch.zeros(out_shape, dtype=matvals.dtype, device=xf.device)
    step = torch.arange(width, device=rowpi.device)
    live = step[None, :] < lens[:, None]
    idx = torch.where(live, rowpi[:, None] + step[None, :], 0)
    vals = torch.where(live, matvals[idx], 0)
    gathered = xf[indx[idx].long()]
    if xf.dim() == 2:
        vals = vals[..., None]
    return (vals * gathered).sum(dim=1)


def _local_spmv(kind: str, static, plan: ReducePlan):
    """``local(loc, x_full) -> this rank's rows of y``."""
    if kind == "ell":
        def local(loc, xf):
            vals, cols = loc
            shard = ELL(values=vals, cols=cols,
                        shape=(vals.shape[0], xf.shape[0]))
            return unwrap(registry.dispatch("solver_spmv", shard, wrap(xf),
                                            variant="ell"))
        return local

    if kind == "csr":
        return _csr_sections

    offsets = static                                # "dia"
    maxoff = max((abs(o) for o in offsets), default=0)

    def local(loc, xf):
        (diags,) = loc                      # (ndiags, n_local)
        n_local = diags.shape[1]
        row0 = plan.shard_index() * n_local    # flat pod-major row offset
        xp = torch.nn.functional.pad(xf, (maxoff, maxoff))
        y = torch.zeros((n_local,), dtype=diags.dtype, device=xf.device)
        for d, off in enumerate(offsets):       # shifted FMAs
            lo = row0 + off + maxoff
            y = y + diags[d] * xp[lo:lo + n_local]
        return y
    return local


def mesh_spmv(a, invec, **_: Any) -> Dense:
    """Row-partitioned SpMV over the ambient mesh (y sharded by rows)."""
    plan = _require_plan()
    kind, static, arrays = _spmv_parts(a)
    y = _local_spmv(kind, static, plan)(_local_arrays(kind, arrays, plan),
                                        _full(invec))
    return wrap(_sharded(y, plan.mesh, P(plan.spec_entry()), (a.shape[0],)))


def _spmv_accepts(layout):
    def accepts(m, v, **_):
        plan = ambient_plan()
        # 1-D x only: a 2-D multi-RHS x belongs to the spmm plane
        return (isinstance(m, layout) and
                getattr(unwrap(v), "ndim", 1) == 1 and plan is not None and
                m.shape[0] % plan.width == 0)
    return accepts


# costs mirror the chip ordering (dia < ell < csr): irrelevant against chip
# variants (scope ranks first) but meaningful among the mesh formulations.
registry.register("solver_spmv", "mesh_dia", mesh_spmv, scope="mesh",
                  cost=4.0, available=_mesh_available,
                  accepts=_spmv_accepts(DIA),
                  doc="row-sharded banded shifted-FMA over pod x data")
registry.register("solver_spmv", "mesh_ell", mesh_spmv, scope="mesh",
                  cost=8.0, available=_mesh_available,
                  accepts=_spmv_accepts(ELL),
                  doc="row-sharded ELL; chip formulation per shard")
registry.register("solver_spmv", "mesh_csr", mesh_spmv, scope="mesh",
                  cost=15.0, available=_mesh_available,
                  accepts=_spmv_accepts(CSR),
                  doc="row-pointer sections sharded; per-row recorded _for")


# ---------------------------------------------------------------------------
# row-partitioned SpMM: the same row sharding, the X panel whole
# ---------------------------------------------------------------------------

def _local_spmm(kind: str, static, plan: ReducePlan):
    """``local(loc, x_panel) -> this rank's rows of Y (rows_local, k)``."""
    if kind == "ell":
        def local(loc, xf):
            vals, cols = loc
            return ref.spmm_ell_ref(vals, cols.long(), xf)
        return local

    if kind == "csr":
        return _csr_sections

    offsets = static                                # "dia"

    def local(loc, xf):
        (diags,) = loc                      # (ndiags, n_local)
        row0 = plan.shard_index() * diags.shape[1]
        return dia_panel(diags, offsets, xf, row0=row0)
    return local


def mesh_spmm(a, x, **_: Any) -> Dense:
    """Row-partitioned SpMM over the ambient mesh: the matrix shards by
    rows over pod x data exactly as :func:`mesh_spmv`, the (n, k) panel is
    whole on every rank, and Y comes back row-sharded.  BSR stays a chip
    formulation (its ragged block-rows have no even row shard)."""
    plan = _require_plan()
    kind, static, arrays = _spmv_parts(a)
    xf = _full(x)
    y = _local_spmm(kind, static, plan)(_local_arrays(kind, arrays, plan),
                                        xf)
    return wrap(_sharded(y, plan.mesh, P(plan.spec_entry(), None),
                         (a.shape[0], xf.shape[1])))


def _spmm_accepts(m, v, **_):
    plan = ambient_plan()
    return (isinstance(m, (CSR, ELL, DIA)) and
            getattr(unwrap(v), "ndim", 0) == 2 and plan is not None and
            m.shape[0] % plan.width == 0)


registry.register("spmm", "mesh_spmm", mesh_spmm, scope="mesh", cost=1.0,
                  available=_mesh_available, accepts=_spmm_accepts,
                  doc="row-sharded SpMM over pod x data; RHS panel "
                      "replicated (CSR/ELL/DIA; BSR stays chip)")


# ---------------------------------------------------------------------------
# Cannon-style mesh SpGEMM: pair list sharded over all mesh axes, partials
# folded by a CannonPlan, the product returned block-row-sharded
# ---------------------------------------------------------------------------

def _require_cannon_plan() -> CannonPlan:
    plan = ambient_cannon_plan()
    if plan is None:
        raise RuntimeError(
            "mesh_spgemm invoked without an ambient O3/O4 mesh carrying a "
            "batch-role (pod/data) axis; enter use_level(O3) first")
    return plan


def _cannon_available(ctx: registry.SelectContext) -> bool:
    return (ctx.topology is not None and
            bool(cannon_plan(ctx.mesh, ctx.topology).row_axes))


def segment_sum_sorted(data: torch.Tensor, seg: torch.Tensor, num: int
                       ) -> torch.Tensor:
    """``out[s] = sum of data[t] over seg[t] == s`` for ``seg`` sorted
    ascending (equal ids contiguous), in a fixed order: the first member
    of every run, then the second, ... (one indexed add a position, each
    slot touched once: no atomics race).  Slots with no member are 0."""
    out = data.new_zeros((num,) + tuple(data.shape[1:]))
    if seg.numel() == 0:
        return out
    ids, counts = torch.unique_consecutive(seg, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    run = torch.repeat_interleave(torch.arange(ids.numel(),
                                               device=seg.device), counts)
    pos = torch.arange(seg.numel(), device=seg.device) - starts[run]
    acc = data.new_zeros((ids.numel(),) + tuple(data.shape[1:]))
    for p in range(int(counts.max())):
        sel = pos == p
        acc[run[sel]] += data[sel]
    out[ids.long()] = acc
    return out


def mesh_spgemm(a, b, **_: Any) -> BSR:
    """C = A·B over the ambient mesh, Cannon-style (DESIGN.md §15).

    The symbolic phase runs on the host exactly as on one card; the pair
    list (slot-sorted) shards flat over every participating axis, padded
    to a multiple of the plan size with pairs of exact zero, and the
    per-rank partials meet C's owners through the plan's fold.  C's value
    blocks come back sharded over the row axes with their count padded to
    a multiple of the row width; the pad blocks hold zeros and ``rowp``
    never references them.  Dispatch attaches the layout
    (``C.out_sharding``)."""
    from repro_torch.sparse.spgemm import spgemm_symbolic

    plan = _require_cannon_plan()
    sym = spgemm_symbolic(a, b, pairs=True)
    bs = a.block
    nc = sym.nc
    dev = a.values.device
    if nc == 0 or sym.npairs == 0:
        return BSR(values=torch.zeros((nc, bs, bs), dtype=a.values.dtype,
                                      device=dev),
                   cols=torch.as_tensor(sym.c_cols, device=dev),
                   rowp=torch.as_tensor(sym.c_rowp, device=dev),
                   shape=(a.shape[0], b.shape[1]), block=bs)
    ncpad = round_up(nc, plan.rows)
    per = round_up(sym.npairs, plan.size) // plan.size
    lo = plan.pair_index() * per
    hi = min(lo + per, sym.npairs)           # the fill pairs are exact zeros
    pp, pq, pr = (torch.as_tensor(x[lo:hi].astype(np.int64), device=dev)
                  for x in (sym.pair_p, sym.pair_q, sym.pair_r))
    av, bv = _full(a.values), _full(b.values)
    prod = torch.einsum("pij,pjk->pik", av[pp].float(), bv[pq].float())
    part = segment_sum_sorted(prod, pr, ncpad)
    loc = plan.reduce_partials(part, scatter_dimension=0).to(av.dtype)
    vals = _sharded(loc, plan.mesh, P(plan.row_spec_entry()),
                    (ncpad, bs, bs))
    cols = np.concatenate([np.asarray(sym.c_cols),
                           np.zeros(ncpad - nc, np.int32)])
    return BSR(values=vals, cols=torch.as_tensor(cols, device=dev),
               rowp=torch.as_tensor(sym.c_rowp, device=dev),
               shape=(a.shape[0], b.shape[1]), block=bs)


def _spgemm_mesh_accepts(a, b, **_):
    plan = ambient_cannon_plan()
    return (plan is not None and isinstance(a, BSR) and isinstance(b, BSR)
            and a.block == b.block and a.shape[1] == b.shape[0]
            and a.shape[0] % (plan.rows * a.block) == 0)


def _spgemm_out_sharding(ctx: registry.SelectContext, a, b, **_):
    """The layout mesh_spgemm leaves C.values in: block-sharded over the
    plan's row axes."""
    plan = ambient_cannon_plan()
    if plan is None:
        return None
    return NamedSharding(plan.mesh, P(plan.row_spec_entry()))


registry.register("spgemm", "mesh_spgemm", mesh_spgemm, scope="mesh",
                  cost=1.0, available=_cannon_available,
                  accepts=_spgemm_mesh_accepts,
                  out_sharding=_spgemm_out_sharding,
                  doc="Cannon-style pair partition over pod x data (x "
                      "model): psum cols + reduce-scatter rows; product "
                      "returned block-row-sharded")


# ---------------------------------------------------------------------------
# K-partitioned matmul: the chip kernel on each K panel + a hierarchical
# reduction plan
# ---------------------------------------------------------------------------

def _local_product(al, bl, blocks) -> torch.Tensor:
    """One rank's partial product through the chip ``matmul`` variant of
    the operands' plane (the hand-written kernel on the card)."""
    block_m, block_n, block_k = blocks
    plane = registry.resolve_backend(al, bl)     # chip variant names == planes
    return registry.dispatch("matmul", al, bl, variant=plane,
                             block_m=block_m, block_n=block_n,
                             block_k=block_k)


def mesh_matmul(a, b, *, block_m=None, block_n=None, block_k=None):
    """C = A @ B with A column- and B row-sharded along K (pod x data).

    Each rank multiplies its K panel with the chip kernel, then the
    full-size partials run the plan's hierarchical reduction:
    reduce-scatter over data, all-reduce over pod.  C comes back
    row-sharded over the data axes (replicated across pods); no rank
    holds more than (M, K/D) + (K/D, N) + (M, N) values."""
    plan = _require_plan()
    av, bv = _full(a), _full(b)
    i, n = plan.shard_index(), plan.width
    part = _local_product(_shard_of(av, i, n, dim=1), _shard_of(bv, i, n),
                          (block_m, block_n, block_k))
    loc = plan.psum_scatter(part, scatter_dimension=0)
    return _sharded(loc, plan.mesh, P(plan.data_spec_entry(), None),
                    (av.shape[0], bv.shape[1]))


def _matmul_accepts(a, b, **_):
    plan = ambient_plan()
    return (plan is not None and getattr(a, "ndim", 0) == 2 and
            getattr(b, "ndim", 0) == 2 and
            a.shape[0] % plan.data_width == 0 and
            a.shape[1] % plan.width == 0)


registry.register("matmul", "mesh_psum", mesh_matmul, scope="mesh", cost=1.0,
                  available=_mesh_available, accepts=_matmul_accepts,
                  doc="K-partitioned matmul, hierarchical "
                      "reduce-scatter/all-reduce along K")


def _model_axes(plan: ReducePlan) -> tuple:
    return tuple(a for a in plan.topo.axes("model") if plan.topo.size(a) > 1)


def _model_width(plan: ReducePlan) -> int:
    t = 1
    for ax in _model_axes(plan):
        t *= plan.topo.size(ax)
    return t


#: Column-panel unit for the block-cyclic N assignment.
N_PANEL = 128


@functools.lru_cache(maxsize=None)
def block_cyclic_perm(n: int, t: int, panel: int = N_PANEL):
    """Block-cyclic column assignment of N panels across ``t`` model tiles.

    Returns ``(perm, inv)`` such that after ``b[:, perm]`` the contiguous
    model sharding hands shard ``s`` the panels ``s, s+t, s+2t, ...``, and
    ``inv`` restores global column order on the result; None when the
    cyclic layout degenerates to the contiguous one (``n`` does not tile
    into ``t x panel`` panels, or exactly one panel per shard)."""
    if t <= 1 or n % (panel * t) != 0 or n // panel == t:
        return None
    npanels = n // panel
    order = np.concatenate([
        np.arange(p * panel, (p + 1) * panel)
        for s in range(t) for p in range(s, npanels, t)])
    inv = np.argsort(order)
    return order, inv


def mesh_matmul_2d(a, b, *, block_m=None, block_n=None, block_k=None):
    """C = A @ B on the 2-D (data, model) block layout.

    K partitions over the batch axes exactly as :func:`mesh_matmul`, and N
    also tiles over the model axis: each rank multiplies a (M, K/D) x
    (K/D, N/T) tile, so the local work and the partials shrink by T.  The
    K reduction is the plan's hierarchical schedule, leaving C in the
    (data, model) block layout, replicated across pods.  N panels are
    dealt block-cyclically (:func:`block_cyclic_perm`); on that path the
    column tiles are gathered over the model axis and C is returned in
    global column order, row-sharded over data."""
    plan = _require_plan()
    av, bv = _full(a), _full(b)
    t = _model_width(plan)
    cyclic = block_cyclic_perm(bv.shape[1], t, block_n or N_PANEL)
    if cyclic is not None:
        bv = bv[:, torch.as_tensor(cyclic[0], device=bv.device)]
    maxes = _model_axes(plan)
    g = mesh_groups(plan.mesh)
    m_idx = 0
    for ax in maxes:
        m_idx = m_idx * plan.topo.size(ax) + g.coords[ax]
    i, n = plan.shard_index(), plan.width
    bl = _shard_of(_shard_of(bv, i, n), m_idx, t, dim=1)
    part = _local_product(_shard_of(av, i, n, dim=1), bl,
                          (block_m, block_n, block_k))
    loc = plan.psum_scatter(part, scatter_dimension=0)
    shape = (av.shape[0], bv.shape[1])
    if cyclic is None:
        return _sharded(loc, plan.mesh,
                        P(plan.data_spec_entry(), _entry(maxes)), shape)
    for ax in reversed(maxes):
        loc = all_gather(loc, g.axis[ax], plan.topo.size(ax), g.transport,
                         dim=1)
    loc = loc[:, torch.as_tensor(cyclic[1], device=loc.device)]
    return _sharded(loc, plan.mesh, P(plan.data_spec_entry(), None), shape)


def _matmul2d_available(ctx: registry.SelectContext) -> bool:
    # rank >= 2 with a real model axis: the 2-D tiling needs a second
    # non-degenerate mesh dimension to tile N over
    return (_mesh_available(ctx) and ctx.mesh_rank >= 2 and
            ctx.topology.extent("model") > 1)


def _matmul2d_accepts(a, b, **_):
    plan = ambient_plan()
    if plan is None:
        return False
    t = _model_width(plan)
    return (t > 1 and getattr(a, "ndim", 0) == 2 and
            getattr(b, "ndim", 0) == 2 and
            a.shape[0] % plan.data_width == 0 and
            a.shape[1] % plan.width == 0 and
            b.shape[1] % t == 0)


registry.register("matmul", "mesh_psum_2d", mesh_matmul_2d, scope="mesh",
                  cost=0.5, available=_matmul2d_available,
                  accepts=_matmul2d_accepts,
                  doc="2-D (data, model) tiling: K over pod x data, N over "
                      "model; hierarchical K reduction")


# ---------------------------------------------------------------------------
# transpose-based distributed FFT (four-step: FFT, twiddle, corner turn, FFT)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fft_twiddles(n: int, n1: int, dtype: torch.dtype, device: str
                  ) -> torch.Tensor:
    """The (n1, n2) twiddle table W_n^{i1·k2} for the corner turn, built
    once per (n, subgrid width, dtype, device) and kept on the device."""
    i1 = np.arange(n1)[:, None]
    k2 = np.arange(n // n1)[None, :]
    return torch.as_tensor(np.exp(-2j * np.pi * (i1 * k2) / n)).to(
        device=device, dtype=dtype)


def mesh_fft(x):
    """Distributed DFT of a length-n vector via the transpose algorithm.

    With i = i1 + n1·i2 and k = k2 + n2·k1 (n1 = data-subgrid width D):

        X[n2·k1 + k2] = Σ_{i1} W_{n1}^{i1·k1} · W_n^{i1·k2}
                        · Σ_{i2} W_{n2}^{i2·k2} x[i1 + n1·i2]

    Each data shard owns n1/D = 1 i1-row: an n2-point row FFT, the twiddle
    scale, then one all-to-all corner turn within the data axis re-shards
    along k2 so the n1-point FFTs are column-local.  A second turn hands
    each rank its contiguous n/D outputs: X comes back sharded over data,
    replicated over the pod and model axes."""
    plan = _require_plan()
    xv = _full(x)
    (turn,) = plan.data_axes            # the corner turn stays in the pod
    n1 = plan.data_width
    n = xv.shape[0]
    tw = _fft_twiddles(n, n1, xv.dtype, str(xv.device))
    d = mesh_groups(plan.mesh).coords[turn]
    rows = n1 // plan.topo.size(turn)
    a = xv.reshape(n // n1, n1).T               # A[i1, i2] = x[i1 + n1 i2]
    al = a[d * rows:(d + 1) * rows]
    bl = torch.fft.fft(al, dim=1) * tw[d * rows:(d + 1) * rows]
    bt = plan.all_to_all(bl, turn, split_dim=1, concat_dim=0)
    c = torch.fft.fft(bt, dim=0)                # (n1, n2 / D): C[k1, k2]
    # X[n2 k1 + k2] = C[k1, k2]: turn back to whole rows of C, which are
    # contiguous pieces of X
    cr = plan.all_to_all(c, turn, split_dim=0, concat_dim=1)
    return _sharded(cr.reshape(-1).to(xv.dtype), plan.mesh, P(turn), (n,))


def _fft_accepts(x):
    plan = ambient_plan()
    if plan is None or len(plan.data_axes) != 1:
        return False
    D = plan.data_width
    n = x.shape[0] if getattr(x, "ndim", 0) == 1 else 0
    return (D > 1 and n >= 2 and (n & (n - 1)) == 0 and
            n % D == 0 and (n // D) % D == 0)


registry.register("fft", "mesh_transpose", mesh_fft, scope="mesh", cost=1.0,
                  available=_mesh_available, accepts=_fft_accepts,
                  doc="four-step transpose FFT: local FFTs + one all_to_all "
                      "inside the data subgrid")


# ---------------------------------------------------------------------------
# distributed CG: the whole solve row-sharded, every reduction a
# hierarchical plan
# ---------------------------------------------------------------------------

def cg_mesh(a, bv, *, stop, max_iters: int, mesh=None,
            variant: Any = None) -> tuple:
    """The paper's §3.4 CG iteration, row-sharded end-to-end.

    Vectors (x, r, p) live as row shards over the batch axes; each
    iteration all-gathers ``p`` (data axes first, then pod) for the local
    SpMV rows and pushes the two dot products through the plan's
    hierarchical all-reduce, the only traffic between ranks.  Loop control
    (r2, k) is the same on every rank, so every rank takes the same
    branch.  Returns (x, r2, k) with x a row-sharded DTensor.

    ``variant`` is the caller's explicit solver_spmv pin, if any: the
    partitioning is determined by the operand layout, so a pin that names
    a different mesh formulation is an error, not a silent substitution."""
    from repro_torch.core.control import arbb_while

    plan = _plan_for_mesh(mesh) if mesh is not None else _require_plan()
    if plan is None:
        raise RuntimeError(f"mesh {mesh} has no batch-role axis to shard over")
    expected = MESH_SPMV_VARIANTS[type(a)]
    if variant is not None and variant != expected:
        raise ValueError(
            f"solver_spmv variant {variant!r} was pinned, but a "
            f"{type(a).__name__} operand row-partitions as {expected!r}")
    kind, static, arrays = _spmv_parts(a)
    loc = _local_arrays(kind, arrays, plan)
    local_fn = _local_spmv(kind, static, plan)
    bfull = _full(bv)
    b_loc = _shard_of(bfull, plan.shard_index(), plan.width)

    def cond(state):
        x, r, p, r2, k = state
        return torch.logical_and(r2 > stop, k < max_iters)

    def body(state):
        x, r, p, r2, k = state
        ap = local_fn(loc, plan.all_gather(p))      # local rows of A @ p
        alpha = r2 / plan.psum(torch.sum(p * ap))
        r_new = r - alpha * ap
        r2_new = plan.psum(torch.sum(r_new * r_new))
        beta = r2_new / r2
        return (x + alpha * p, r_new, r_new + beta * p, r2_new, k + 1)

    init = (torch.zeros_like(b_loc), b_loc, b_loc,
            plan.psum(torch.sum(b_loc * b_loc)),
            torch.zeros((), dtype=torch.int32, device=b_loc.device))
    x, r, p, r2, k = arbb_while(cond, body, init)
    return (_sharded(x, plan.mesh, P(plan.spec_entry()), bfull.shape),
            r2, k)
