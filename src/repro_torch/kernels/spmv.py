"""SpMV kernel wrappers: padded ELL (mod2as) and DIA (banded systems).

``spmv_ell`` replaces the Pallas TPU kernel ``repro/kernels/spmv.py:42``
(``spmv_ell_kernel``); ``spmv_dia`` replaces ``repro/kernels/spmv.py:88``
(``spmv_dia_kernel``).  Both CUDA kernels live in ``csrc/spmv.cu`` and are
bounded by bytes: ELL reads 8 bytes per stored entry with one warp per row;
DIA runs one thread per row over the diagonals, with out-of-range reads of
x giving 0 instead of a padded copy of x.

On host tensors the wrappers compute the plain versions; on CUDA tensors
they launch their kernel or raise.
"""
from __future__ import annotations

import functools
from typing import Sequence

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import spmv_dia_ref, spmv_ell_ref

__all__ = ["spmv_ell", "spmv_dia", "spmv_ell_plain", "spmv_dia_plain"]

#: The plain PyTorch versions the kernels are held against.
spmv_ell_plain = spmv_ell_ref
spmv_dia_plain = spmv_dia_ref


def spmv_ell(values: torch.Tensor, cols: torch.Tensor, x: torch.Tensor
             ) -> torch.Tensor:
    """``y[i] = sum_w values[i, w] * x[cols[i, w]]`` (f32 values and x,
    int32 cols)."""
    if _lib.on_host(values, cols, x):
        return spmv_ell_plain(values, cols, x)
    _lib.require_cuda("spmv_ell", values, cols, x)
    if values.ndim != 2 or cols.shape != values.shape or x.ndim != 1:
        raise ValueError(f"spmv_ell: values {tuple(values.shape)}, cols "
                         f"{tuple(cols.shape)}, x {tuple(x.shape)}")
    if values.dtype != torch.float32 or x.dtype != torch.float32 \
            or cols.dtype != torch.int32:
        raise ValueError(f"spmv_ell: takes f32 values/x and int32 cols, got "
                         f"{values.dtype}, {cols.dtype}, {x.dtype}")
    nrows, width = values.shape
    y = torch.empty(nrows, dtype=torch.float32, device=values.device)
    if nrows == 0:
        return y
    code = _lib.lib().spmv_ell_launch(
        values.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
        nrows, width, _lib.stream_of(values))
    _lib.check(code, "spmv_ell")
    spmv_ell.launches += 1
    return y


spmv_ell.launches = 0


@functools.lru_cache(maxsize=64)
def _offsets_on(offsets: tuple[int, ...], device: torch.device
                ) -> torch.Tensor:
    """The offsets as an int32 device array, copied once per (offsets,
    device) so that a solver loop does not copy them every step."""
    return torch.tensor(offsets, dtype=torch.int32, device=device)


def spmv_dia(diags: torch.Tensor, offsets: Sequence[int], x: torch.Tensor
             ) -> torch.Tensor:
    """``y[i] = sum_d diags[d, i] * x[i + offsets[d]]`` (f32), reads outside
    [0, n) giving 0."""
    offsets = tuple(int(o) for o in offsets)
    if _lib.on_host(diags, x):
        return spmv_dia_plain(diags, offsets, x)
    _lib.require_cuda("spmv_dia", diags, x)
    if diags.ndim != 2 or diags.shape[0] != len(offsets) \
            or x.shape != (diags.shape[1],):
        raise ValueError(f"spmv_dia: diags {tuple(diags.shape)}, "
                         f"{len(offsets)} offsets, x {tuple(x.shape)}")
    if diags.dtype != torch.float32 or x.dtype != torch.float32:
        raise ValueError(f"spmv_dia: takes f32, got {diags.dtype}, {x.dtype}")
    ndiags, n = diags.shape
    y = torch.empty(n, dtype=torch.float32, device=diags.device)
    if n == 0:
        return y
    offs = _offsets_on(offsets, diags.device)
    code = _lib.lib().spmv_dia_launch(
        diags.data_ptr(), offs.data_ptr(), x.data_ptr(), y.data_ptr(),
        n, ndiags, _lib.stream_of(diags))
    _lib.check(code, "spmv_dia")
    spmv_dia.launches += 1
    return y


spmv_dia.launches = 0
