"""``SparseStats`` — the matrix-shape statistics that drive format selection
(counterpart of ``repro.sparse.stats``, a copy: the port imports nothing of
the JAX package).

``repro_torch.sparse.matrix(a)`` measures the matrix once, at construction,
and the selector picks the storage format (DIA / ELL / BSR / CSR) the shape
of the data admits: banded systems take the gather-free diagonal path,
uniform rows the rectangular ELL path, clustered blocks the BSR block-tile
path, without the call site naming any of them (DESIGN.md §9).

Everything here is host-side numpy: statistics are data-pipeline work
computed once per matrix, never kernel work.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SparseStats", "sparse_stats"]

#: Default probe block size for the block-fill statistic (BSR block edge).
DEFAULT_BLOCK = 8


@dataclasses.dataclass(frozen=True)
class SparseStats:
    """Shape statistics of one sparse matrix, computed at construction.

    Fill ratios are *storage efficiencies* in [0, 1]: nnz divided by the
    slots the candidate format would materialise.  1.0 means the format is
    padding-free for this matrix; the selector thresholds on them
    (:mod:`repro_torch.sparse.selector`).
    """
    shape: tuple[int, int]
    nnz: int
    density: float            # nnz / (n*m)
    row_nnz_mean: float
    row_nnz_max: int
    row_nnz_std: float
    bandwidth: int            # max |i - j| over the nonzeros
    ndiags: int               # number of non-empty diagonals
    dia_fill: float           # nnz / (ndiags * n)        — DIA efficiency
    ell_fill: float           # nnz / (nrows * row_max)   — ELL efficiency
    block: int                # probed block edge (BSR candidate)
    nblocks: int              # occupied block×block tiles
    block_fill: float         # nnz / (nblocks * block²)  — BSR efficiency
    # SpGEMM symbolic-phase inputs (DESIGN.md §15): how the live blocks
    # distribute over block-rows and block-columns, at the probed edge.
    # These are what sizes the Gustavson accumulator *before* the product's
    # pattern exists — see :meth:`product_block_bound`.
    block_row_counts: tuple[int, ...] = ()   # live blocks per block-row
    block_col_counts: tuple[int, ...] = ()   # live blocks per block-column

    @property
    def row_nnz_cv(self) -> float:
        """Coefficient of variation of nnz/row — 0 for perfectly uniform
        rows, large for ragged/power-law rows (the ELL-hostile shape)."""
        return self.row_nnz_std / self.row_nnz_mean if self.row_nnz_mean \
            else 0.0

    def product_block_bound(self, other: "SparseStats") -> int:
        """Upper bound on the live blocks (and Gustavson block products) of
        ``self @ other`` at this block edge: every pairing of a live block
        in our block-column ``k`` with a live block in ``other``'s
        block-row ``k`` yields at most one product — so the bound is
        ``Σ_k col_counts_A[k] · row_counts_B[k]``.  Exact on the *product
        count*; an over-count on the output pattern only where two products
        land on the same (i, j) tile.  The SpGEMM symbolic phase sizes its
        accumulator with this (DESIGN.md §15)."""
        if self.block != other.block:
            raise ValueError(
                f"block mismatch: {self.block} vs {other.block}")
        a = np.asarray(self.block_col_counts, np.int64)
        b = np.asarray(other.block_row_counts, np.int64)
        k = min(a.size, b.size)
        return int(a[:k] @ b[:k])

    def describe(self) -> str:
        return (f"n={self.shape[0]} nnz={self.nnz} density={self.density:.4f} "
                f"bw={self.bandwidth} ndiags={self.ndiags} "
                f"dia_fill={self.dia_fill:.2f} ell_fill={self.ell_fill:.2f} "
                f"block_fill={self.block_fill:.2f}@{self.block}")


def sparse_stats(a: np.ndarray, block: int = DEFAULT_BLOCK) -> SparseStats:
    """Measure ``a`` (dense host array) once; see :class:`SparseStats`.

    ``block`` is the BSR candidate block edge the block-fill statistic
    probes.  When the shape doesn't tile by ``block`` the trailing partial
    blocks still count as occupied-if-nonzero (the selector separately
    refuses BSR for non-divisible shapes).
    """
    a = np.asarray(a)
    n, m = a.shape
    mask = a != 0
    nnz = int(mask.sum())
    per_row = mask.sum(axis=1)
    rows, cols = np.nonzero(mask)
    if nnz:
        bandwidth = int(np.abs(rows - cols).max())
        ndiags = int(np.unique(cols.astype(np.int64) - rows).size)
    else:
        bandwidth, ndiags = 0, 0
    row_max = int(per_row.max()) if n else 0
    # occupied block×block tiles (ceil-divided edges), plus how they
    # distribute over block-rows/-columns — the SpGEMM symbolic inputs
    nbrows, nbcols = -(-n // block), -(-m // block)
    if nnz:
        blk_ids = np.unique((rows // block) * nbcols + (cols // block))
        nb = int(blk_ids.size)
        brc = np.bincount(blk_ids // nbcols, minlength=nbrows)
        bcc = np.bincount(blk_ids % nbcols, minlength=nbcols)
    else:
        nb = 0
        brc = np.zeros(nbrows, np.int64)
        bcc = np.zeros(nbcols, np.int64)
    return SparseStats(
        shape=(n, m), nnz=nnz,
        density=nnz / (n * m) if n * m else 0.0,
        row_nnz_mean=float(per_row.mean()) if n else 0.0,
        row_nnz_max=row_max,
        row_nnz_std=float(per_row.std()) if n else 0.0,
        bandwidth=bandwidth, ndiags=ndiags,
        dia_fill=nnz / (ndiags * n) if ndiags else 0.0,
        ell_fill=nnz / (n * row_max) if row_max else 0.0,
        block=block, nblocks=nb,
        block_fill=nnz / (nb * block * block) if nb else 0.0,
        block_row_counts=tuple(int(c) for c in brc),
        block_col_counts=tuple(int(c) for c in bcc),
    )
