"""SpMM kernel wrappers: a sparse matrix (ELL or BSR) times a dense
multi-RHS panel X (n, k).

``spmm_ell`` replaces the Pallas TPU kernel ``repro/kernels/spmm.py:41``
(``spmm_ell_kernel``); ``spmm_bsr`` replaces ``repro/kernels/spmm.py:91``
(``spmm_bsr_kernel``).  Both CUDA kernels live in ``csrc/spmm.cu``; that
file's header says what bounds them and how they are laid out.  They mask
ragged rows and k themselves, so no operand is padded here.

On host tensors the wrappers compute the plain versions; on CUDA tensors
they launch their kernel or raise.  They take f32 values and X and int32
indices, and refuse any other dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import spmm_bsr_ref, spmm_ell_ref

__all__ = ["spmm_ell", "spmm_bsr", "spmm_ell_plain", "spmm_bsr_plain",
           "BSR_BLOCKS"]

#: The plain PyTorch versions the kernels are held against.
spmm_ell_plain = spmm_ell_ref
spmm_bsr_plain = spmm_bsr_ref

#: Block edges the BSR kernels are compiled for (the selector's ladder).
BSR_BLOCKS = (8, 16, 32)


def spmm_ell(values: torch.Tensor, cols: torch.Tensor, x: torch.Tensor
             ) -> torch.Tensor:
    """``y[i, :] = sum_w values[i, w] * x[cols[i, w], :]``."""
    if _lib.on_host(values, cols, x):
        return spmm_ell_plain(values, cols, x)
    _lib.require_cuda("spmm_ell", values, cols, x)
    if values.ndim != 2 or cols.shape != values.shape or x.ndim != 2:
        raise ValueError(f"spmm_ell: values {tuple(values.shape)}, cols "
                         f"{tuple(cols.shape)}, x {tuple(x.shape)}")
    _lib.require_dtypes("spmm_ell", (values, x), (cols,))
    nrows, width = values.shape
    k = x.shape[1]
    y = torch.empty((nrows, k), dtype=torch.float32, device=values.device)
    if nrows == 0 or k == 0:
        return y
    code = _lib.lib().spmm_ell_launch(
        values.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
        nrows, width, k, _lib.stream_of(values))
    _lib.check(code, "spmm_ell")
    spmm_ell.launches += 1
    return y


spmm_ell.launches = 0


def spmm_bsr(values: torch.Tensor, cols: torch.Tensor, rowp: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """``y[I*bs:(I+1)*bs, :] = sum_{p in rowp[I]..rowp[I+1]} values[p] @
    x[cols[p]*bs : +bs, :]``; an empty matrix gives zeros."""
    if _lib.on_host(values, cols, rowp, x):
        return spmm_bsr_plain(values, cols, rowp, x)
    _lib.require_cuda("spmm_bsr", values, cols, rowp, x)
    if values.ndim != 3 or values.shape[1] != values.shape[2] \
            or cols.shape != values.shape[:1] or rowp.ndim != 1 \
            or x.ndim != 2 or x.shape[0] % max(values.shape[1], 1):
        raise ValueError(f"spmm_bsr: values {tuple(values.shape)}, cols "
                         f"{tuple(cols.shape)}, rowp {tuple(rowp.shape)}, "
                         f"x {tuple(x.shape)}")
    nblocks, bs, _ = values.shape
    if bs not in BSR_BLOCKS:
        raise ValueError(f"spmm_bsr: block {bs} not in {BSR_BLOCKS}")
    _lib.require_dtypes("spmm_bsr", (values, x), (cols, rowp))
    nbrows = rowp.shape[0] - 1
    k = x.shape[1]
    if nblocks == 0:
        return torch.zeros((nbrows * bs, k), dtype=torch.float32,
                           device=values.device)
    y = torch.empty((nbrows * bs, k), dtype=torch.float32,
                    device=values.device)
    if nbrows == 0 or k == 0:
        return y
    code = _lib.lib().spmm_bsr_launch(
        values.data_ptr(), cols.data_ptr(), rowp.data_ptr(), x.data_ptr(),
        y.data_ptr(), nbrows, bs, k, _lib.stream_of(values))
    _lib.check(code, "spmm_bsr")
    spmm_bsr.launches += 1
    return y


spmm_bsr.launches = 0
