"""BSR (block-CSR) storage + host-side converters (counterpart of
``repro.sparse.formats``, DESIGN.md §9).

The scalable form for matrices with *clustered* nonzeros is blocked
storage: dense ``bs×bs`` tiles, so the inner SpMM step is a dense block
product instead of an element gather.  ``BSR`` is CSR lifted to block
granularity:

    values  (nblocks, bs, bs)   the occupied dense tiles
    cols    (nblocks,)          int32 block-column index of each tile
    rowp    (nbrows+1,)         int32 block-row pointers

Construction is host-side numpy; the container holds tensors on the device
chosen by the ``bind`` rule (the card unless the caller passes
``device="cpu"``; float64 narrows to float32 unless a dtype is given).  It
re-exports the element formats so ``repro_torch.sparse`` is the one import
for all four layouts.  Every constructed BSR carries its
:class:`~repro_torch.sparse.stats.SparseStats` (advisory: excluded from
equality).

Not ported: the JAX container's ``out_sharding`` field, which only a
mesh-scoped SpGEMM sets (ROADMAP queue 1 item 11).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.containers import to_device
from repro_torch.numerics.sparse import (CSR, DIA, ELL,  # noqa: F401
                                         csr_from_dense, index_array)
from repro_torch.sparse.stats import DEFAULT_BLOCK, SparseStats, sparse_stats

__all__ = ["BSR", "block_pattern", "bsr_from_dense", "bsr_from_csr",
           "csr_from_bsr", "CSR", "ELL", "DIA"]


@dataclasses.dataclass(frozen=True)
class BSR:
    """Block-CSR: CSR over dense ``block×block`` tiles."""
    values: torch.Tensor         # (nblocks, block, block)
    cols: torch.Tensor           # (nblocks,) int32 block-column indices
    rowp: torch.Tensor           # (nbrows+1,) int32 block-row pointers
    shape: tuple[int, int]
    block: int
    stats: Optional[SparseStats] = dataclasses.field(
        default=None, compare=False)

    @property
    def nblocks(self) -> int:
        return self.values.shape[0]

    @property
    def nnz(self) -> int:
        """Stored entries (block-padded, explicit zeros included)."""
        return self.nblocks * self.block * self.block

    @property
    def device(self) -> torch.device:
        return self.values.device

    def cost_dims(self) -> dict[str, int]:
        """Calibration fingerprint (DESIGN.md §11): block edge + live-block
        count."""
        return {"block": int(self.block), "nnzb": int(self.cols.shape[0])}

    def todense(self) -> np.ndarray:
        vals = self.values.cpu().numpy()
        cols = self.cols.cpu().numpy()
        rowp = self.rowp.cpu().numpy()
        bs = self.block
        n, m = self.shape
        grid = np.zeros((n // bs, m // bs, bs, bs), dtype=vals.dtype)
        rows = np.repeat(np.arange(rowp.size - 1), np.diff(rowp))
        np.add.at(grid, (rows, cols[:rows.size]), vals[:rows.size])
        return grid.transpose(0, 2, 1, 3).reshape(n, m)


def block_pattern(occupied: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The CSR-style (cols, rowp) scan of a boolean block-occupancy grid,
    the one pattern extraction every BSR constructor and the SpGEMM
    symbolic phase share (DESIGN.md §15).

    ``occupied`` is (nbrows, nbcols) bool; returns ``cols`` (nblocks,) int32
    with block-column indices sorted within each row, and ``rowp``
    (nbrows+1,) int32 block-row pointers."""
    occupied = np.asarray(occupied, bool)
    nbrows = occupied.shape[0]
    rows, cols = np.nonzero(occupied)           # row-major: sorted per row
    rowp = np.zeros(nbrows + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=nbrows), out=rowp[1:])
    return cols.astype(np.int32), rowp


def _bsr(values: np.ndarray, cols: np.ndarray, rowp: np.ndarray,
         shape: tuple[int, int], block: int, stats: SparseStats,
         device: Any) -> BSR:
    vals = to_device(values, device=device)
    return BSR(values=vals, cols=index_array(cols, vals.device),
               rowp=index_array(rowp, vals.device), shape=tuple(shape),
               block=block, stats=stats)


def bsr_from_dense(a: np.ndarray, block: int = DEFAULT_BLOCK, dtype=None,
                   stats: Optional[SparseStats] = None, *,
                   device: Any = None) -> BSR:
    """Gather the occupied ``block×block`` tiles of ``a`` (both dims must
    tile evenly).  ``dtype`` is a numpy dtype applied to ``a`` first;
    ``stats`` skips the measurement when the caller already scanned the
    matrix (the selector did, to pick BSR)."""
    a = np.asarray(a)
    if dtype is not None:
        a = a.astype(dtype)
    n, m = a.shape
    if n % block or m % block:
        raise ValueError(f"shape {a.shape} does not tile by block={block}")
    nbrows, nbcols = n // block, m // block
    tiles = a.reshape(nbrows, block, nbcols, block).transpose(0, 2, 1, 3)
    occupied = np.any(tiles != 0, axis=(2, 3))          # (nbrows, nbcols)
    cols, rowp = block_pattern(occupied)
    brows = np.repeat(np.arange(nbrows), np.diff(rowp))
    values = (tiles[brows, cols] if cols.size
              else np.zeros((0, block, block), dtype=a.dtype))
    return _bsr(values, cols, rowp, (n, m), block,
                stats if stats is not None else sparse_stats(a, block=block),
                device)


def bsr_from_csr(csr: CSR, block: int = DEFAULT_BLOCK) -> BSR:
    """CSR -> BSR without dense staging, on the CSR's device: the block
    occupancy comes straight from the CSR coordinates through
    :func:`block_pattern`, then the nnz stream scatters into its tiles."""
    n, m = csr.shape
    if n % block or m % block:
        raise ValueError(f"shape {csr.shape} does not tile by block={block}")
    rowp_e = csr.rowp.cpu().numpy()
    indx = csr.indx.cpu().numpy()
    vals = csr.matvals.cpu().numpy()
    row_ids = np.repeat(np.arange(n), np.diff(rowp_e))
    nbrows, nbcols = n // block, m // block
    occupied = np.zeros((nbrows, nbcols), bool)
    occupied[row_ids // block, indx // block] = True
    cols, rowp = block_pattern(occupied)
    # (block-row, block-col) -> storage slot, then scatter the nnz stream
    slot = np.full((nbrows, nbcols), -1, np.int64)
    brows = np.repeat(np.arange(nbrows), np.diff(rowp))
    slot[brows, cols] = np.arange(cols.size)
    values = np.zeros((cols.size, block, block), vals.dtype)
    np.add.at(values, (slot[row_ids // block, indx // block],
                       row_ids % block, indx % block), vals)
    return _bsr(values, cols, rowp, (n, m), block,
                sparse_stats(csr.todense(), block=block), csr.device)


def csr_from_bsr(bsr: BSR) -> CSR:
    """BSR -> CSR on the BSR's device (drops the explicit zeros block
    padding introduced)."""
    return csr_from_dense(bsr.todense(), device=bsr.device)
