"""``spmm``: sparse matrix x dense multi-RHS panel, as a registry op
(counterpart of ``repro.sparse.spmm``).

The op's variant table is the format auto-selector's execution layer
(DESIGN.md §9): each storage format registers the strongest formulation it
admits, ``accepts`` keys on the container layout (+ a 2-D RHS), and costs
mirror the selector's ranking, so ``sparse.spmm(A, X)`` retargets by the
shape of the data:

    dia        banded shifted FMAs over the whole panel, gather-free
               (plane-free: ``numerics/spmv.py`` ``dia_panel``)
    bsr        block-tile products, CUDA kernel (kernels/spmm.py)
    bsr_torch  the same in plain PyTorch (kernels/ref.py)
    ell        row-gather x RHS panel, CUDA kernel (kernels/spmm.py)
    ell_torch  the same in plain PyTorch
    csr        the 3-array oracle: one gather-multiply over the nonzeros
               and an ``index_add_`` segment sum; always correct, never
               the fastest

CUDA operands select the kernels, host operands the plain versions; nothing
falls back from one to the other.

This module also closes the solver seam: ``solver_spmv`` gains a low-cost
``spmm`` route that fires when ``x`` carries a trailing RHS dimension
(2-D), plus the BSR single-vector lift, so ``cg_solve`` works on blocked
matrices too.

Not ported: ``mesh_spmm`` (ROADMAP queue 1 item 11).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import Dense, registry, unwrap, wrap
from repro_torch.core.registry import Cost
from repro_torch.kernels import ref
from repro_torch.kernels import spmm as spmm_k
from repro_torch.numerics.sparse import CSR, DIA, ELL, csr_row_ids
from repro_torch.numerics.spmv import dia_panel
from repro_torch.sparse.formats import BSR

__all__ = ["spmm"]


def _panel_takes(layout):
    """accepts: the matrix layout matches and x is a 2-D RHS panel."""
    def accepts(m, v, **_):
        return isinstance(m, layout) and getattr(unwrap(v), "ndim", 0) == 2
    return accepts


def _spmm_dia(a: DIA, x, **_) -> Dense:
    return wrap(dia_panel(a.diags, a.offsets, unwrap(wrap(x))))


def _spmm_bsr(a: BSR, x, **_) -> Dense:
    return wrap(spmm_k.spmm_bsr(a.values.contiguous(), a.cols.contiguous(),
                                a.rowp.contiguous(),
                                unwrap(wrap(x)).contiguous()))


def _spmm_bsr_torch(a: BSR, x, **_) -> Dense:
    return wrap(ref.spmm_bsr_ref(a.values, a.cols, a.rowp, unwrap(wrap(x))))


def _spmm_ell(a: ELL, x, **_) -> Dense:
    return wrap(spmm_k.spmm_ell(a.values.contiguous(), a.cols.contiguous(),
                                unwrap(wrap(x)).contiguous()))


def _spmm_ell_torch(a: ELL, x, **_) -> Dense:
    return wrap(ref.spmm_ell_ref(a.values, a.cols, unwrap(wrap(x))))


def _spmm_csr(a: CSR, x, **_) -> Dense:
    xv = unwrap(wrap(x))
    prod = a.matvals[:, None] * xv[a.indx]                 # (nnz, k)
    out = torch.zeros((a.shape[0], xv.shape[1]), dtype=prod.dtype,
                      device=prod.device)
    return wrap(out.index_add_(0, csr_row_ids(a.rowp, a.nnz), prod))


# costs mirror the selector's strongest-first ranking (Cost.DIA < BSR < ELL
# < CSR); a format's kernel and plain version share its rank, since the
# operands' device admits only one of the two (DESIGN.md §6).
registry.register("spmm", "dia", _spmm_dia, cost=Cost.DIA,
                  accepts=_panel_takes(DIA),
                  doc="banded shifted panel-FMAs, gather-free")
registry.register("spmm", "bsr", _spmm_bsr, plane="cuda", cost=Cost.BSR,
                  accepts=_panel_takes(BSR),
                  doc="block-tile CUDA kernel (csrc/spmm.cu)")
registry.register("spmm", "bsr_torch", _spmm_bsr_torch, plane="torch",
                  cost=Cost.BSR, accepts=_panel_takes(BSR),
                  doc="per-block products + block-row index_add_")
registry.register("spmm", "ell", _spmm_ell, plane="cuda", cost=Cost.ELL,
                  accepts=_panel_takes(ELL),
                  doc="row-gather x RHS panel CUDA kernel (csrc/spmm.cu)")
registry.register("spmm", "ell_torch", _spmm_ell_torch, plane="torch",
                  cost=Cost.ELL, accepts=_panel_takes(ELL),
                  doc="gathered rows x values einsum")
registry.register("spmm", "csr", _spmm_csr, cost=Cost.ORACLE,
                  accepts=_panel_takes(CSR),
                  doc="3-array oracle: nnz-stream gather + index_add_")


def _check_rows(a, xv: torch.Tensor) -> None:
    """X must have one row per column of A: the kernels cannot check it
    (they take no matrix shape) and would read past a short X."""
    if xv.shape[0] != a.shape[1]:
        raise ValueError(f"spmm: A is {tuple(a.shape)} but x has "
                         f"{xv.shape[0]} rows (shape {tuple(xv.shape)})")


def spmm(a, x, *, variant: Optional[str] = None) -> Dense:
    """``A @ X`` for a sparse container ``A`` and a dense (n, k) panel.

    Selects the formulation from the container's layout (the
    statistics-driven choice happened at :func:`repro_torch.sparse.matrix`
    construction) and the operands' device; ``variant=`` pins one
    (DESIGN.md §6)."""
    xw = wrap(x)
    if unwrap(xw).ndim != 2:
        raise ValueError(f"spmm wants a 2-D RHS panel, got shape "
                         f"{tuple(unwrap(xw).shape)}; use solver_spmv for "
                         f"vectors")
    _check_rows(a, unwrap(xw))
    return registry.dispatch("spmm", a, xw, variant=variant)


# ---------------------------------------------------------------------------
# the solver seam: multi-RHS solves route solver_spmv through this plane
# ---------------------------------------------------------------------------

def _route_accepts(m, v, **_):
    nd = getattr(unwrap(v), "ndim", 0)
    # 2-D x on any layout; BSR also lifts 1-D so cg_solve works on blocked
    # matrices (no element-granular solver_spmv variant takes BSR)
    return (isinstance(m, (CSR, ELL, DIA, BSR)) and nd == 2) or \
        (isinstance(m, BSR) and nd == 1)


def _route_spmm(m, v, **_) -> Dense:
    xv = unwrap(wrap(v))
    _check_rows(m, xv)
    if xv.ndim == 1:
        return wrap(unwrap(registry.dispatch("spmm", m, wrap(xv[:, None])))
                    [:, 0])
    return registry.dispatch("spmm", m, wrap(xv))


registry.register("solver_spmv", "spmm", _route_spmm, cost=Cost.CUDA,
                  accepts=_route_accepts,
                  doc="multi-RHS seam: 2-D x (or BSR) routes to the spmm "
                      "plane")
