"""Plain PyTorch oracles for the paper's four kernels and the blocked-sparse
plane (counterpart of all but the attention half of ``repro.kernels.ref``).

Each is the transparent formulation: the 'torch' plane of the main path,
the plain version each CUDA kernel is held against, and the oracle of the
tests.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.numerics.sparse import csr_row_ids

__all__ = ["matmul_ref", "spmv_ell_ref", "spmv_dia_ref", "spmm_ell_ref",
           "spmm_bsr_ref", "bsr_todense_ref", "spgemm_bsr_ref",
           "fft_stage_ref", "fft_ref"]


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None
               ) -> torch.Tensor:
    """``a @ b`` in float32 (full precision, never TF32), cast to
    ``out_dtype`` (default: a's dtype)."""
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def spmv_ell_ref(values: torch.Tensor, cols: torch.Tensor, x: torch.Tensor
                 ) -> torch.Tensor:
    """``y[i] = sum_w values[i, w] * x[cols[i, w]]``."""
    return torch.sum(values * x[cols], dim=1)


def spmv_dia_ref(diags: torch.Tensor, offsets: Sequence[int],
                 x: torch.Tensor) -> torch.Tensor:
    """``y[i] = sum_d diags[d, i] * x[i + offsets[d]]``, out-of-range reads
    giving 0."""
    n = diags.shape[1]
    y = torch.zeros(n, dtype=diags.dtype, device=diags.device)
    idx = torch.arange(n, device=diags.device)
    for d, off in enumerate(offsets):
        src = idx + off
        valid = (src >= 0) & (src < n)
        y = y + diags[d] * torch.where(valid, x[src.clamp(0, n - 1)],
                                       torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
    return y


def spmm_ell_ref(values: torch.Tensor, cols: torch.Tensor, x: torch.Tensor
                 ) -> torch.Tensor:
    """ELL x dense panel: ``y[i, :] = sum_w values[i, w] * x[cols[i, w], :]``."""
    return torch.einsum("iw,iwk->ik", values, x[cols])


def spmm_bsr_ref(values: torch.Tensor, cols: torch.Tensor, rowp: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """BSR x dense panel: per-block dense products + a block-row segment-sum
    (``index_add_``)."""
    nblocks, bs, _ = values.shape
    n, k = x.shape
    nbrows = rowp.shape[0] - 1
    out = torch.zeros((nbrows, bs, k), dtype=values.dtype,
                      device=values.device)
    if nblocks == 0:
        return out.reshape(nbrows * bs, k)
    xb = x.reshape(n // bs, bs, k)
    prod = torch.bmm(values, xb[cols])                   # (nblocks, bs, k)
    out.index_add_(0, csr_row_ids(rowp, nblocks), prod)
    return out.reshape(nbrows * bs, k)


def bsr_todense_ref(values: torch.Tensor, cols: torch.Tensor,
                    rowp: torch.Tensor, shape: tuple[int, int]
                    ) -> torch.Tensor:
    """BSR -> dense, a scatter-add over the block grid (the device-side dual
    of the container's host ``todense``)."""
    n, m = shape
    nblocks, bs, _ = values.shape
    grid = torch.zeros((n // bs, m // bs, bs, bs), dtype=values.dtype,
                       device=values.device)
    if nblocks:
        rows = csr_row_ids(rowp, nblocks)
        grid.index_put_((rows, cols.long()), values, accumulate=True)
    return grid.permute(0, 2, 1, 3).reshape(n, m)


def spgemm_bsr_ref(a_values, a_cols, a_rowp, b_values, b_cols, b_rowp,
                   a_shape: tuple[int, int], b_shape: tuple[int, int]
                   ) -> torch.Tensor:
    """SpGEMM dense oracle: densify both BSR operands and multiply in f32.
    Returns the *dense* (n, m) product."""
    ad = bsr_todense_ref(a_values, a_cols, a_rowp, a_shape)
    bd = bsr_todense_ref(b_values, b_cols, b_rowp, b_shape)
    return torch.matmul(ad.float(), bd.float()).to(a_values.dtype)


def fft_stage_ref(data_re, data_im, tw_re, tw_im):
    """(n/2, 2) re/im -> (2, n/2) re/im: up row 0, down row 1.  ``tw`` is
    the stage's twiddle row, already tiled to n/2."""
    er, orr = data_re[:, 0], data_re[:, 1]
    ei, oi = data_im[:, 0], data_im[:, 1]
    up_re, up_im = er + orr, ei + oi
    dr, di = er - orr, ei - oi
    down_re = dr * tw_re - di * tw_im
    down_im = dr * tw_im + di * tw_re
    return (torch.stack([up_re, down_re]), torch.stack([up_im, down_im]))


def fft_ref(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.fft(x)
