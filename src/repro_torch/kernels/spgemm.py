"""SpGEMM numeric-phase kernel wrapper: BSR x BSR block products into a
precomputed output pattern.

``spgemm_bsr`` replaces the Pallas TPU kernel ``repro/kernels/spgemm.py:45``
(``spgemm_bsr_kernel``).  The CUDA kernel lives in ``csrc/spgemm.cu``; that
file's header says how it cuts the Pallas kernel's dense (bs, ncols) row
accumulator into warp-owned ranges of :func:`spgemm_span` block-columns in
shared memory, and what bounds it.  It runs block edges 1 to
``MAX_BSR_BLOCK`` (64); the wrapper takes any edge, running a larger one on
``spmm.bsr_recut``'s sub-blocks (A, B and the output pattern re-cut alike)
and putting C's blocks back together.

``spgemm_bsr_plain`` is the same function in plain PyTorch, the pair
formulation: it enumerates the contributing block pairs from the operands'
patterns, multiplies them in one batched ``torch.bmm`` and adds each
product into its output slot with ``index_add_``.

On host tensors the wrapper computes the plain version; on CUDA tensors it
launches the kernel or raises.  It takes f32 values and int32 indices.
Both raise when a block product's output tile is missing from the given
pattern: the pattern must be the symbolic phase's for these operands.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.spmm import bsr_recut, bsr_uncut, recut_edge
from repro_torch.numerics.sparse import csr_row_ids

__all__ = ["spgemm_bsr", "spgemm_bsr_plain", "spgemm_span", "SPGEMM_WARPS"]

#: Warps per CTA of the kernel (each owns one range of block-columns), and
#: the shared memory a warp's range accumulator may take.
SPGEMM_WARPS = 4
SPGEMM_ACC_BYTES = 4096

_NOT_IN_PLAN = ("spgemm_bsr: a block product's output tile is not in "
                "c_cols/c_rowp (the pattern must be spgemm_symbolic's for "
                "these operands)")


def spgemm_bsr_plain(a_vals, a_cols, a_rowp, b_vals, b_cols, b_rowp,
                     c_cols, c_rowp, *, ncols: int) -> torch.Tensor:
    """The numeric phase as a pair formulation, on the operands' device."""
    na, bs, _ = a_vals.shape
    nc = c_cols.shape[0]
    out = torch.zeros((nc, bs, bs), dtype=torch.float32,
                      device=a_vals.device)
    if nc == 0 or na == 0 or b_vals.shape[0] == 0:
        return out.to(a_vals.dtype)
    nbcols = ncols // bs
    ak = a_cols.long()
    starts = b_rowp.long()[ak]
    counts = b_rowp.long()[ak + 1] - starts
    # every A block p meets the run b_rowp[k]..b_rowp[k+1] of B blocks
    pair_p = torch.repeat_interleave(torch.arange(na, device=ak.device),
                                     counts)
    first = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    pair_q = torch.repeat_interleave(starts, counts) \
        + torch.arange(pair_p.shape[0], device=ak.device) - first
    # output slot of each pair: its (row, col) key among C's sorted keys
    key = csr_row_ids(a_rowp, na)[pair_p] * nbcols + b_cols.long()[pair_q]
    c_key = csr_row_ids(c_rowp, nc) * nbcols + c_cols.long()
    slot = torch.searchsorted(c_key, key)
    if not bool((c_key[slot.clamp(max=nc - 1)] == key).all()):
        raise ValueError(_NOT_IN_PLAN)
    prod = torch.bmm(a_vals[pair_p].float(), b_vals[pair_q].float())
    return out.index_add_(0, slot, prod).to(a_vals.dtype)


def spgemm_span(bs: int) -> int:
    """Block-columns of one output row a warp of the kernel owns: as many
    (bs, bs) f32 tiles as fit :data:`SPGEMM_ACC_BYTES`, at least 1 and at
    most 32 (a presence bit per block-column in one register): 16 at bs 8,
    4 at bs 16, 1 at bs 32 and 64."""
    return max(1, min(32, SPGEMM_ACC_BYTES // (4 * bs * bs)))


def spgemm_bsr(a_vals: torch.Tensor, a_cols: torch.Tensor,
               a_rowp: torch.Tensor, b_vals: torch.Tensor,
               b_cols: torch.Tensor, b_rowp: torch.Tensor,
               c_cols: torch.Tensor, c_rowp: torch.Tensor, *, ncols: int
               ) -> torch.Tensor:
    """``c_vals (nc, bs, bs)`` of ``A @ B`` for the output pattern
    ``c_cols``/``c_rowp`` (one row pointer per block-row of A, columns
    sorted within a row).  ``ncols`` is B's dense column count."""
    args = (a_vals, a_cols, a_rowp, b_vals, b_cols, b_rowp, c_cols, c_rowp)
    if _lib.on_host(*args):
        return spgemm_bsr_plain(*args, ncols=ncols)
    _lib.require_cuda("spgemm_bsr", *args)
    na, bs = a_vals.shape[0], a_vals.shape[-1]
    if a_vals.shape != (na, bs, bs) or b_vals.shape[1:] != (bs, bs) \
            or a_cols.shape != (na,) or b_cols.shape != b_vals.shape[:1] \
            or c_rowp.shape != a_rowp.shape or c_cols.ndim != 1 \
            or ncols % bs:
        raise ValueError(
            f"spgemm_bsr: a {tuple(a_vals.shape)}/{tuple(a_cols.shape)}/"
            f"{tuple(a_rowp.shape)}, b {tuple(b_vals.shape)}/"
            f"{tuple(b_cols.shape)}/{tuple(b_rowp.shape)}, c "
            f"{tuple(c_cols.shape)}/{tuple(c_rowp.shape)}, ncols {ncols}")
    _lib.require_dtypes("spgemm_bsr", (a_vals, b_vals),
                        (a_cols, a_rowp, b_cols, b_rowp, c_cols, c_rowp))
    nc = c_cols.shape[0]
    if nc == 0 or na == 0 or b_vals.shape[0] == 0:
        return torch.zeros((nc, bs, bs), dtype=torch.float32,
                           device=a_vals.device)
    d = recut_edge(bs)
    order = None
    if d != bs:
        # every sub-block pair of A(I, K) and B(K, J) lands in a sub-block
        # of C(I, J): the re-cut plan holds it exactly when the plan holds
        # C(I, J)
        a_vals, a_cols, a_rowp, _ = bsr_recut(a_vals, a_cols, a_rowp, bs, d)
        b_vals, b_cols, b_rowp, _ = bsr_recut(b_vals, b_cols, b_rowp, bs, d)
        _, c_cols, c_rowp, order = bsr_recut(None, c_cols, c_rowp, bs, d)
        args = (a_vals, a_cols, a_rowp, b_vals, b_cols, b_rowp, c_cols,
                c_rowp)
    c_vals = torch.empty((c_cols.shape[0], d, d), dtype=torch.float32,
                         device=a_vals.device)
    err = torch.zeros(1, dtype=torch.int32, device=a_vals.device)
    code = _lib.lib().spgemm_bsr_launch(
        *(t.data_ptr() for t in args), c_vals.data_ptr(), err.data_ptr(),
        a_rowp.shape[0] - 1, d, ncols // d, spgemm_span(d),
        _lib.stream_of(a_vals))
    _lib.check(code, "spgemm_bsr")
    spgemm_bsr.launches += 1
    if err.item():                       # waits for the kernel
        raise ValueError(_NOT_IN_PLAN)
    return c_vals if order is None else bsr_uncut(c_vals, order)


spgemm_bsr.launches = 0
