"""repro_torch.sparse — the blocked-sparse plane (counterpart of
``repro.sparse``, DESIGN.md §9).

One import for the four storage formats (CSR / ELL / DIA / BSR), the
construction-time statistics, the statistics-driven format auto-selector,
SpMM and SpGEMM:

    A = sparse.matrix(a_dense)        # stats measured once; format chosen
    Y = sparse.spmm(A, X)             # retargets by layout and device
    C = sparse.spgemm(A, B)           # sparse x sparse, two-phase (§15)

Banded inputs run the gather-free DIA path, clustered blocks the BSR CUDA
kernel, uniform rows the ELL CUDA kernel, everything else the CSR oracle.

The attention mask compiler (``MaskSpec`` -> ``TileLayout``, DESIGN.md §12)
lowers attention masks to the same rowptr/packed-column layout; the
tile-skipping flash kernel walks it.
"""
from repro_torch.sparse.formats import (BSR, CSR, DIA, ELL, block_pattern,
                                        bsr_from_csr, bsr_from_dense,
                                        csr_from_bsr)
from repro_torch.sparse.maskcompiler import (MaskSpec, TileLayout,
                                             causal_layout, compile_layout,
                                             dense_mask, dense_masked_layout)
from repro_torch.sparse.selector import (BLOCKSPARSE_MAX_DENSITY, FORMATS,
                                         autotune_block, format_of, matrix,
                                         select_format)
from repro_torch.sparse.spgemm import SpgemmPlan, spgemm, spgemm_symbolic
from repro_torch.sparse.spmm import spmm
from repro_torch.sparse.stats import SparseStats, sparse_stats

__all__ = [
    "BSR", "CSR", "DIA", "ELL",
    "block_pattern", "bsr_from_dense", "bsr_from_csr", "csr_from_bsr",
    "SparseStats", "sparse_stats",
    "FORMATS", "select_format", "autotune_block", "matrix", "format_of",
    "BLOCKSPARSE_MAX_DENSITY",
    "spmm", "spgemm", "spgemm_symbolic", "SpgemmPlan",
    "MaskSpec", "TileLayout", "dense_mask", "compile_layout",
    "causal_layout", "dense_masked_layout",
]
