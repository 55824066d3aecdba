"""Sparse-matrix storage for mod2as / CG (counterpart of
``repro.numerics.sparse``).

CSR is the paper's 3-array format (§3.2: matvals / indx / rowp) and the
oracle format; ELL (fixed entries per row, padded with value 0 and column 0)
and DIA (diagonal storage for the banded CG systems of Table 2) derive from
it.  Construction is host-side numpy; the containers hold tensors on the
device chosen by the same rule as ``bind``: the card unless the caller asks
for ``device="cpu"``, float64 narrowed to float32 unless a dtype is given.

The paper's input generators (:func:`random_sparse`, :func:`banded_spd`)
return the same float64 numpy arrays as the JAX package for the same seed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.containers import to_device

__all__ = ["CSR", "ELL", "DIA", "random_sparse", "banded_spd",
           "csr_from_dense", "ell_from_csr", "dia_from_dense",
           "csr_row_ids", "index_array", "MOD2AS_TABLE1", "CG_TABLE2"]


def index_array(a: Any, device: Any) -> torch.Tensor:
    """An int32 index tensor (columns, row pointers) on ``device``."""
    return to_device(np.asarray(a, dtype=np.int32), device=device)


def csr_row_ids(rowp: torch.Tensor, count: int) -> torch.Tensor:
    """Row id per stored entry: entry ``p`` belongs to the row ``i`` with
    ``rowp[i] <= p < rowp[i+1]``."""
    return torch.searchsorted(
        rowp[1:], torch.arange(count, dtype=rowp.dtype, device=rowp.device),
        right=True)


@dataclasses.dataclass(frozen=True)
class CSR:
    """3-array CSR exactly as the paper describes it."""
    matvals: torch.Tensor   # (nnz,) non-zero values
    indx: torch.Tensor      # (nnz,) int32 column of each value
    rowp: torch.Tensor      # (nrows+1,) int32 row pointers
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.matvals.shape[0]

    @property
    def device(self) -> torch.device:
        return self.matvals.device

    def todense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.matvals.cpu().numpy().dtype)
        rowp = self.rowp.cpu().numpy()
        rows = np.repeat(np.arange(self.shape[0]), np.diff(rowp))
        np.add.at(out, (rows, self.indx.cpu().numpy()),
                  self.matvals.cpu().numpy())
        return out


@dataclasses.dataclass(frozen=True)
class ELL:
    """Padded fixed-width rows: values/cols are (nrows, width).  Padding
    entries have value 0 and column 0, harmless under multiply-add."""
    values: torch.Tensor    # (nrows, width)
    cols: torch.Tensor      # (nrows, width) int32
    shape: tuple[int, int]

    @property
    def width(self) -> int:
        return self.values.shape[1]

    @property
    def device(self) -> torch.device:
        return self.values.device


@dataclasses.dataclass(frozen=True)
class DIA:
    """Diagonal storage: ``diags[d][i]`` holds ``A[i, i + offsets[d]]``, so
    ``y += diags[d] * shift(x, -offsets[d])`` accumulates the SpMV."""
    diags: torch.Tensor             # (ndiags, n)
    offsets: tuple[int, ...]        # Python ints
    shape: tuple[int, int]

    @property
    def device(self) -> torch.device:
        return self.diags.device


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------

def csr_from_dense(a: np.ndarray, dtype=None, *, device: Any = None) -> CSR:
    """CSR of a host matrix, rows in order and columns ascending within a
    row (the JAX package's order)."""
    a = np.asarray(a)
    rows, cols = np.nonzero(a)
    rowp = np.zeros(a.shape[0] + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=a.shape[0]), out=rowp[1:])
    matvals = to_device(a[rows, cols], dtype, device)
    return CSR(matvals=matvals, indx=index_array(cols, matvals.device),
               rowp=index_array(rowp, matvals.device), shape=tuple(a.shape))


def ell_from_csr(csr: CSR, width: int | None = None, pad_to: int = 1) -> ELL:
    """ELL of a CSR matrix, on the CSR's device."""
    rowp = csr.rowp.cpu().numpy().astype(np.int64)
    indx = csr.indx.cpu().numpy()
    vals = csr.matvals.cpu().numpy()
    nrows = csr.shape[0]
    per_row = rowp[1:] - rowp[:-1]
    w = int(per_row.max()) if width is None else width
    w = max(1, -(-w // pad_to) * pad_to)
    if nrows and per_row.max() > w:
        i = int(np.argmax(per_row))
        raise ValueError(f"row {i} has {per_row[i]} nnz > ELL width {w}")
    rows = np.repeat(np.arange(nrows), per_row)
    slot = np.arange(rowp[-1]) - rowp[rows]
    values = np.zeros((nrows, w), dtype=vals.dtype)
    cols = np.zeros((nrows, w), dtype=np.int32)
    values[rows, slot] = vals
    cols[rows, slot] = indx
    return ELL(values=torch.as_tensor(values, device=csr.device),
               cols=torch.as_tensor(cols, device=csr.device),
               shape=csr.shape)


def dia_from_dense(a: np.ndarray, *, dtype=None, device: Any = None) -> DIA:
    """DIA of a host matrix: one stored row per diagonal with a nonzero."""
    a = np.asarray(a)
    n = a.shape[0]
    offsets = []
    diags = []
    for off in range(-(n - 1), n):
        d = np.diagonal(a, off)
        if np.any(d != 0):
            offsets.append(off)
            full = np.zeros(n, dtype=a.dtype)
            if off >= 0:
                full[: n - off] = d
            else:
                full[-off:] = d
            diags.append(full)
    return DIA(diags=to_device(np.stack(diags), dtype, device),
               offsets=tuple(offsets), shape=tuple(a.shape))


# ---------------------------------------------------------------------------
# paper input generators
# ---------------------------------------------------------------------------

# mod2as input list (paper Table 1): (n, fill %)
MOD2AS_TABLE1: Sequence[tuple[int, float]] = (
    (100, 3.50), (200, 3.75), (256, 5.0), (400, 4.38), (500, 5.00),
    (512, 4.00), (960, 4.50), (1000, 5.00), (1024, 5.50), (2000, 7.50),
    (4096, 3.50), (4992, 4.00), (5000, 4.00), (9984, 4.50), (10000, 5.00),
    (10240, 5.72),
)

# CG configs (paper Table 2): (n, bandwidth)
CG_TABLE2: Sequence[tuple[int, int]] = (
    (128, 3), (128, 31), (128, 63),
    (256, 3), (256, 31), (256, 63), (256, 127),
    (512, 3), (512, 31), (512, 63), (512, 127), (512, 255),
    (1024, 3), (1024, 31), (1024, 63), (1024, 127), (1024, 255), (1024, 511),
)


def random_sparse(n: int, fill_percent: float, seed: int = 0,
                  dtype=np.float64) -> np.ndarray:
    """Random square sparse matrix with the given fill ratio (mod2as inputs)."""
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n), dtype=dtype)
    nnz = max(1, int(round(n * n * fill_percent / 100.0)))
    pos = rng.choice(n * n, size=nnz, replace=False)
    a.flat[pos] = rng.standard_normal(nnz)
    return a


def banded_spd(n: int, bw: int, seed: int = 0, dtype=np.float64) -> np.ndarray:
    """Symmetric positive-definite banded matrix with half-bandwidth ``bw``
    (CG inputs, paper Table 2).  Diagonal dominance guarantees SPD."""
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n), dtype=dtype)
    for off in range(1, bw + 1):
        d = rng.standard_normal(n - off) * 0.5
        a[np.arange(n - off), np.arange(off, n)] = d
        a[np.arange(off, n), np.arange(n - off)] = d
    # strictly diagonally dominant diagonal
    a[np.arange(n), np.arange(n)] = np.abs(a).sum(axis=1) + 1.0
    return a
