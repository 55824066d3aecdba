"""``spgemm``: sparse x sparse product on the blocked plane, as a registry op
(counterpart of ``repro.sparse.spgemm``, DESIGN.md §15).

The output's sparsity pattern is data-dependent, so the product runs in
two phases (Gustavson at block granularity):

    symbolic   host-side numpy over the operands' block patterns only: the
               output's deduplicated (cols, rowp) pattern and the count of
               contributing block products.  The construction
               statistics' :meth:`~repro_torch.sparse.stats.SparseStats.
               product_block_bound` bounds the pair count before it exists,
               and the realised count is asserted against it.
    numeric    device-side fill of the output's value blocks for that fixed
               pattern.

Numeric variants (accepts: both operands BSR, matching block, inner dims
equal):

    bsr        the Gustavson CUDA kernel (kernels/spgemm.py)
    bsr_torch  the kernel's plain version, the pair formulation: gather both
               blocks of every pair, one batched ``torch.bmm`` in f32,
               ``index_add_`` into the output slots
    dense      densify both, one matmul, gather the live tiles: the
               always-correct, never-fast oracle

``spgemm(A, B)`` accepts any pairing of the four formats or a dense host
array (CSR goes through the direct CSR->BSR path; ELL/DIA/dense densify on
the host).

Under an O3/O4 mesh the Cannon-style ``mesh_spgemm``
(:mod:`repro_torch.distributed.numerics`) is preferred; it returns the
product block-row-sharded and attaches that layout (``out_sharding``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.core.containers import resolve_device
from repro_torch.core.registry import Cost
from repro_torch.kernels import ref
from repro_torch.kernels import spgemm as spgemm_k
from repro_torch.numerics.sparse import CSR, DIA, ELL, index_array
from repro_torch.sparse.formats import BSR, bsr_from_csr, bsr_from_dense
from repro_torch.sparse.stats import DEFAULT_BLOCK

__all__ = ["spgemm", "spgemm_symbolic", "SpgemmPlan"]


# ---------------------------------------------------------------------------
# symbolic phase (host numpy, patterns only: no values touched)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SpgemmPlan:
    """The symbolic phase's product: C's block pattern, which both numeric
    formulations fill, and the count of contributing block products.

    The pair lists (A block, B block and C slot of every product, ordered
    by C slot so that equal-slot runs are contiguous) are built only on
    request (``spgemm_symbolic(..., pairs=True)``): their one consumer is
    the mesh variant, which shards them; the CUDA kernel and its plain
    version find each product's slot in ``c_cols`` themselves.
    """
    c_cols: np.ndarray            # (nc,) int32, C's block-column indices
    c_rowp: np.ndarray            # (nbrows+1,) int32, C's block-row pointers
    npairs: int                   # contributing block products
    nbrows: int                   # C's block-row count
    nbcols: int                   # C's block-column count
    pair_p: Optional[np.ndarray] = None   # (npairs,) int32, A block
    pair_q: Optional[np.ndarray] = None   # (npairs,) int32, B block
    pair_r: Optional[np.ndarray] = None   # (npairs,) int32, C slot

    @property
    def nc(self) -> int:
        return int(self.c_cols.shape[0])


def _empty_plan(nbrows: int, nbcols: int, pairs: bool) -> SpgemmPlan:
    z = np.zeros(0, np.int32) if pairs else None
    return SpgemmPlan(c_cols=np.zeros(0, np.int32),
                      c_rowp=np.zeros(nbrows + 1, np.int32), npairs=0,
                      nbrows=nbrows, nbcols=nbcols, pair_p=z, pair_q=z,
                      pair_r=z)


def spgemm_symbolic(a: BSR, b: BSR, *, pairs: bool = False) -> SpgemmPlan:
    """C = A·B's block pattern from the operands' patterns alone
    (host-side data-pipeline work, like every converter).

    Every A block ``p`` in inner block-column ``k`` pairs with every B block
    ``q`` in block-row ``k`` (a ragged arange over B's row extents).  The
    flat (row, col) keys of the products dedup into C's pattern
    (``np.unique`` returns them row-major sorted: CSR order).  When both
    operands carry construction statistics, the realised pair count is
    asserted against :meth:`SparseStats.product_block_bound`.  With
    ``pairs`` the plan also carries the slot-ordered pair lists (the
    inverse of the dedup is each pair's C slot)."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dims differ: {a.shape} @ {b.shape}")
    if a.block != b.block:
        raise ValueError(f"block mismatch: {a.block} vs {b.block}")
    a_rowp = a.rowp.cpu().numpy().astype(np.int64)
    b_rowp = b.rowp.cpu().numpy().astype(np.int64)
    # only the blocks rowp references are live
    a_cols = a.cols.cpu().numpy().astype(np.int64)[:int(a_rowp[-1])]
    b_cols = b.cols.cpu().numpy().astype(np.int64)[:int(b_rowp[-1])]
    nbrows = a_rowp.size - 1
    nbcols = b.shape[1] // b.block
    if a_cols.size == 0 or b_cols.size == 0:
        return _empty_plan(nbrows, nbcols, pairs)

    starts = b_rowp[a_cols]
    counts = b_rowp[a_cols + 1] - starts
    total = int(counts.sum())
    if (a.stats is not None and b.stats is not None
            and a.stats.block == a.block and b.stats.block == b.block
            and a.stats.block_col_counts and b.stats.block_row_counts):
        bound = a.stats.product_block_bound(b.stats)
        assert total <= bound, \
            f"pair count {total} exceeds stats bound {bound}"
    if total == 0:
        return _empty_plan(nbrows, nbcols, pairs)
    pair_p = np.repeat(np.arange(a_cols.size), counts)
    offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    pair_q = np.repeat(starts, counts) + offs

    a_rows = np.repeat(np.arange(nbrows), np.diff(a_rowp))
    uniq, slot = np.unique(a_rows[pair_p] * nbcols + b_cols[pair_q],
                           return_inverse=True)
    c_rowp = np.zeros(nbrows + 1, np.int32)
    np.cumsum(np.bincount(uniq // nbcols, minlength=nbrows), out=c_rowp[1:])
    lists = {}
    if pairs:
        order = np.argsort(slot, kind="stable")     # slot-contiguous pairs
        lists = {"pair_p": pair_p[order].astype(np.int32),
                 "pair_q": pair_q[order].astype(np.int32),
                 "pair_r": slot[order].astype(np.int32)}
    return SpgemmPlan(c_cols=(uniq % nbcols).astype(np.int32), c_rowp=c_rowp,
                      npairs=total, nbrows=nbrows, nbcols=nbcols, **lists)


def _assemble(plan: SpgemmPlan, vals: torch.Tensor, a: BSR, b: BSR) -> BSR:
    return BSR(values=vals, cols=index_array(plan.c_cols, vals.device),
               rowp=index_array(plan.c_rowp, vals.device),
               shape=(a.shape[0], b.shape[1]), block=a.block)


# ---------------------------------------------------------------------------
# numeric phase
# ---------------------------------------------------------------------------

def _takes_bsr_pair(a, b, **_):
    return (isinstance(a, BSR) and isinstance(b, BSR)
            and a.block == b.block and a.shape[1] == b.shape[0])


def _numeric(name: str):
    """A variant running ``kernels/spgemm.py``'s ``name`` (the CUDA kernel
    or its plain pair formulation) over the symbolic phase's pattern."""
    def impl(a: BSR, b: BSR, **_) -> BSR:
        plan = spgemm_symbolic(a, b)
        dev = a.device
        vals = getattr(spgemm_k, name)(
            a.values.contiguous(), a.cols.contiguous(), a.rowp.contiguous(),
            b.values.contiguous(), b.cols.contiguous(), b.rowp.contiguous(),
            index_array(plan.c_cols, dev), index_array(plan.c_rowp, dev),
            ncols=b.shape[1])
        return _assemble(plan, vals, a, b)
    return impl


def _spgemm_dense(a: BSR, b: BSR, **_) -> BSR:
    """Dense oracle: densify both operands, one full matmul, gather the
    symbolic pattern's live tiles back out."""
    plan = spgemm_symbolic(a, b)
    bs = a.block
    if plan.nc == 0:
        return _assemble(plan, torch.zeros((0, bs, bs), dtype=a.values.dtype,
                                           device=a.device), a, b)
    dense = ref.spgemm_bsr_ref(a.values, a.cols, a.rowp, b.values, b.cols,
                               b.rowp, a.shape, b.shape)
    tiles = dense.reshape(plan.nbrows, bs, plan.nbcols, bs) \
        .permute(0, 2, 1, 3)
    brows = np.repeat(np.arange(plan.nbrows), np.diff(plan.c_rowp))
    vals = tiles[torch.as_tensor(brows, device=a.device),
                 torch.as_tensor(plan.c_cols, dtype=torch.int64,
                                 device=a.device)]
    return _assemble(plan, vals.contiguous(), a, b)


registry.register("spgemm", "bsr", _numeric("spgemm_bsr"), plane="cuda",
                  cost=Cost.BSR, accepts=_takes_bsr_pair,
                  doc="Gustavson block-row CUDA kernel (csrc/spgemm.cu)")
registry.register("spgemm", "bsr_torch", _numeric("spgemm_bsr_plain"),
                  plane="torch",
                  cost=Cost.BSR, accepts=_takes_bsr_pair,
                  doc="pair bmm + index_add_ into output slots")
registry.register("spgemm", "dense", _spgemm_dense, cost=Cost.ORACLE,
                  accepts=_takes_bsr_pair, oracle=True,
                  doc="dense oracle: densify both, full matmul, gather "
                      "live tiles")


# ---------------------------------------------------------------------------
# the public op: any format pairing converges on the blocked plane
# ---------------------------------------------------------------------------

def _densify(x) -> np.ndarray:
    """Host-side dense view of an element-format operand (conversion-path
    work only; the BSR paths never touch this)."""
    if isinstance(x, CSR):
        return x.todense()
    if isinstance(x, ELL):
        vals = x.values.cpu().numpy()
        cols = x.cols.cpu().numpy()
        out = np.zeros(x.shape, vals.dtype)
        rows = np.repeat(np.arange(x.shape[0]), vals.shape[1])
        np.add.at(out, (rows, cols.ravel()), vals.ravel())
        return out
    if isinstance(x, DIA):
        diags = x.diags.cpu().numpy()
        out = np.zeros(x.shape, diags.dtype)
        idx = np.arange(x.shape[0])
        for d, off in enumerate(x.offsets):
            src = idx + off
            ok = (src >= 0) & (src < x.shape[1])
            out[idx[ok], src[ok]] = diags[d][ok]
        return out
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _device_of(x) -> Optional[torch.device]:
    """The torch device of a container or tensor; None for a host array."""
    dev = getattr(x, "device", None)
    return dev if isinstance(dev, torch.device) else None


def _as_bsr(x, block: int, device: Any) -> BSR:
    if isinstance(x, BSR) and x.block == block:
        return x
    if (isinstance(x, CSR) and x.shape[0] % block == 0
            and x.shape[1] % block == 0):
        return bsr_from_csr(x, block=block)
    dense = x.todense() if isinstance(x, BSR) else _densify(x)
    return bsr_from_dense(np.asarray(dense), block=block,
                          device=_device_of(x) or device)


def spgemm(a, b, *, block: Optional[int] = None,
           variant: Optional[str] = None) -> BSR:
    """``C = A @ B`` for sparse operands; returns a :class:`BSR` container.

    Both operands land on the blocked plane (any of BSR/CSR/ELL/DIA or a
    dense host array; mismatched blocks re-tile to ``block``, default the
    first BSR operand's edge), then the registry dispatches the numeric
    phase by the operands' device: the CUDA kernel on the card, the pair
    formulation on the host.  A host array goes to the other operand's
    device (the card when neither is a container).  ``variant=`` pins one
    (DESIGN.md §6)."""
    bs = block or (a.block if isinstance(a, BSR)
                   else b.block if isinstance(b, BSR) else DEFAULT_BLOCK)
    dev = _device_of(a) or _device_of(b) or resolve_device(None)
    aa = _as_bsr(a, bs, dev)
    bb = _as_bsr(b, bs, dev)
    if aa.shape[1] != bb.shape[0]:
        raise ValueError(f"inner dims differ: {aa.shape} @ {bb.shape}")
    return registry.dispatch("spgemm", aa, bb, variant=variant)
