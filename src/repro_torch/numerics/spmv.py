"""mod2as — sparse matrix-vector multiplication (counterpart of
``repro.numerics.spmv``).

    arbb_spmv1   the paper's §3.2 port: ``map()`` over rows with a recorded
                 ``_for`` whose bounds come from rowp sections
    arbb_spmv2   the paper's contiguity rewrite, vectorised: one gather-
                 multiply over the nonzeros and a segment-sum by row
    spmv_ell     ELL layout: rectangular gather-multiply-reduce
    spmv_dia     banded/diagonal: shifted FMAs, gather-free

These are DSL programs: they call no kernel on either plane, as in the JAX
package.  The ELL and DIA kernels are reached through
``repro_torch.kernels.ops``.
"""
from __future__ import annotations

import torch

from repro_torch.core import Dense, call, emap, section, shift, unwrap, wrap
from repro_torch.core import registry
from repro_torch.core.registry import Cost
from repro_torch.numerics.sparse import CSR, DIA, ELL, csr_row_ids

__all__ = ["arbb_spmv1", "arbb_spmv2", "spmv_ell", "spmv_dia",
           "spmv1", "spmv2", "spmv_ell_jit", "spmv_dia_jit",
           "csr_row_reduce", "arbb_for_dynamic", "dia_panel"]


def arbb_for_dynamic(start, stop, body, init):
    """A recorded ``_for`` with data-dependent bounds, as the paper's
    ``_for (i = rowpi, i != rowpj, ++i)`` requires.

    With tensor bounds (one pair per mapped element, as :func:`emap` passes
    them) it runs the way ``jax.vmap`` of a ``fori_loop`` lowers: one loop
    of ``max(stop - start)`` steps over all elements at once, each element
    masked once its own range is done.  The trip count is read on the host
    once per call."""
    start, stop = unwrap(start), unwrap(stop)
    if not isinstance(start, torch.Tensor):
        state = init
        for i in range(int(start), int(stop)):
            state = body(i, state)
        return state
    trips = (stop - start).clamp(min=0)
    state = init.expand(start.shape).clone() if init.ndim == 0 else init
    for t in range(int(trips.max()) if trips.numel() else 0):
        live = t < trips
        i = torch.where(live, start + t, torch.zeros_like(start))
        state = torch.where(live, body(i, state), state)
    return state


def csr_row_reduce(matvals, indx, x):
    """The paper's per-row ``local::reduce``: a recorded ``_for`` over
    ``[rowpi, rowpj)`` gathering ``matvals[i] * x[indx[i]]``, as a function
    of the row-pointer pair so that it can be mapped."""
    def reduce(ri, rj):
        def body(i, acc):
            return acc + matvals[i] * x[indx[i]]
        return arbb_for_dynamic(ri, rj, body,
                                torch.zeros((), dtype=matvals.dtype,
                                            device=matvals.device))
    return reduce


def arbb_spmv1(csr: CSR, invec: Dense) -> Dense:
    """Faithful port of the paper's arbb_spmv1 (after Bell & Garland):
    ``map(local::reduce)`` over rows with a per-row recorded ``_for``."""
    invec = wrap(invec)
    nrows = csr.shape[0]
    rowp = Dense(csr.rowp)
    rowpi = section(rowp, 0, nrows)      # rowp[0 .. nrows)
    rowpj = section(rowp, 1, nrows)      # rowp[1 .. nrows+1)
    if csr.nnz == 0:
        return Dense(torch.zeros(nrows, dtype=csr.matvals.dtype,
                                 device=csr.device))
    reduce = csr_row_reduce(csr.matvals, csr.indx, unwrap(invec))
    return wrap(emap(reduce, in_axes=(0, 0))(rowpi, rowpj))


def arbb_spmv2(csr: CSR, invec: Dense) -> Dense:
    """The contiguity-exploiting variant, vectorised: a gather-multiply over
    the nonzero stream, then a row segment-sum."""
    x = unwrap(wrap(invec))
    nrows = csr.shape[0]
    prod = csr.matvals * x[csr.indx]
    seg = csr_row_ids(csr.rowp, prod.shape[0])
    out = torch.zeros(nrows, dtype=prod.dtype, device=prod.device)
    return wrap(out.index_add_(0, seg, prod))


def spmv_ell(ell: ELL, invec: Dense) -> Dense:
    """ELL SpMV: rectangular gather + row reduction."""
    x = unwrap(wrap(invec))
    return wrap(torch.sum(ell.values * x[ell.cols], dim=1))


def spmv_dia(dia: DIA, invec: Dense) -> Dense:
    """DIA SpMV: ``y_i = sum_d diag_d[i] * x[i + off_d]``, shifted FMAs only."""
    x = wrap(invec)
    n = dia.shape[0]
    y = Dense.zeros((n,), dia.diags.dtype, device=dia.device)
    for d, off in enumerate(dia.offsets):
        y = y + Dense(dia.diags[d]) * shift(x, -off)
    return y


def dia_panel(diags, offsets: tuple, xf, row0=0):
    """``y[i, :] = sum_d diags[d][i] * xf[row0 + i + offsets[d], :]``, the
    DIA shifted-FMA loop over a 2-D right-hand-side panel; out-of-range
    reads give 0 through edge padding."""
    n_local = diags.shape[1]
    maxoff = max((abs(o) for o in offsets), default=0)
    xp = torch.nn.functional.pad(xf, (0, 0, maxoff, maxoff))
    y = torch.zeros((n_local, xf.shape[1]),
                    dtype=torch.result_type(diags, xf), device=xf.device)
    for d, off in enumerate(offsets):
        lo = row0 + off + maxoff
        y = y + diags[d][:, None] * xp[lo:lo + n_local]
    return y


spmv1 = call(arbb_spmv1)
spmv2 = call(arbb_spmv2)
spmv_ell_jit = call(spmv_ell)
spmv_dia_jit = call(spmv_dia)


# The solver-facing SpMV formulations.  DSL-level (plane=None); ``accepts``
# keys on the matrix layout and a 1-D x (a 2-D x, and a BSR matrix, take the
# ``spmm`` route that repro_torch.sparse.spmm registers), and costs order the
# CSR variants by the paper's measured ranking (spmv2's contiguity rewrite
# beats spmv1).
def _takes(layout):
    return lambda m, v, **_: (isinstance(m, layout)
                              and getattr(unwrap(v), "ndim", 1) == 1)


registry.register("solver_spmv", "spmv1", arbb_spmv1, cost=2 * Cost.CSR,
                  accepts=_takes(CSR),
                  doc="paper §3.2 port: map() over rows + recorded _for")
registry.register("solver_spmv", "spmv2", arbb_spmv2, cost=Cost.CSR,
                  accepts=_takes(CSR),
                  doc="contiguity-exploiting flat segmented form")
registry.register("solver_spmv", "ell", spmv_ell, cost=Cost.ELL,
                  accepts=_takes(ELL),
                  doc="rectangular ELL gather-multiply-reduce")
registry.register("solver_spmv", "dia", spmv_dia, cost=Cost.DIA,
                  accepts=_takes(DIA),
                  doc="banded shifted-FMA, gather-free")
