"""Plain PyTorch oracles for the paper's four kernels (counterpart of the
paper half of ``repro.kernels.ref``).

Each is the transparent formulation: the 'torch' plane of the main path,
the plain version each CUDA kernel is held against, and the oracle of the
tests.
"""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["matmul_ref", "spmv_ell_ref", "spmv_dia_ref", "fft_stage_ref",
           "fft_ref"]


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
