"""Split-stream FFT stage kernel wrapper (mod2f).

Replaces the Pallas TPU kernel ``repro/kernels/fft.py:36``
(``fft_stage_kernel``).  The CUDA kernel (``csrc/fft.cu``) computes one
butterfly per thread on the (n/2, 2) re/im view and reads the stage's
twiddle as ``tw[u % m]`` from the untiled table, where the TPU code
materialised ``tile(tw[:m], i)`` before every stage.  It is bounded by
bytes; :func:`repro_torch.kernels.ops.fft` launches it log2 n times per
transform.

On host tensors the wrapper computes :func:`fft_stage_plain`; on CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import fft_stage_ref

__all__ = ["fft_stage", "fft_stage_plain"]

_DTYPE_CODE = {torch.float32: 0, torch.float64: 2}


def fft_stage_plain(data_re, data_im, tw_re, tw_im, m: int):
    """The plain version: tile the twiddle prefix ``tw[:m]`` to n/2 entries
    and apply :func:`repro_torch.kernels.ref.fft_stage_ref`."""
    half = data_re.shape[0]
    reps = half // m
    return fft_stage_ref(data_re, data_im, tw_re[:m].repeat(reps),
                         tw_im[:m].repeat(reps))


def fft_stage(data_re: torch.Tensor, data_im: torch.Tensor,
              tw_re: torch.Tensor, tw_im: torch.Tensor, m: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One split-stream stage.  ``data_*`` are (n/2, 2) (column 0 even,
    column 1 odd), ``tw_*`` the untiled twiddle table (at least ``m``
    entries), and ``m`` divides n/2.  Returns (out_re, out_im), each
    (2, n/2): row 0 up, row 1 down."""
    half = data_re.shape[0]
    if m < 1 or half % m != 0:
        raise ValueError(f"fft_stage: m={m} must divide n/2={half}")
    if _lib.on_host(data_re, data_im, tw_re, tw_im):
        return fft_stage_plain(data_re, data_im, tw_re, tw_im, m)
    _lib.require_cuda("fft_stage", data_re, data_im, tw_re, tw_im)
    if data_re.shape != (half, 2) or data_im.shape != (half, 2) \
            or tw_re.ndim != 1 or tw_re.shape != tw_im.shape \
            or tw_re.shape[0] < m:
        raise ValueError(f"fft_stage: data {tuple(data_re.shape)}/"
                         f"{tuple(data_im.shape)}, twiddles "
                         f"{tuple(tw_re.shape)}/{tuple(tw_im.shape)}, m={m}")
    dtype = data_re.dtype
    if dtype not in _DTYPE_CODE or any(t.dtype != dtype
                                       for t in (data_im, tw_re, tw_im)):
        raise ValueError("fft_stage: takes one real dtype, f32 or f64")
    out_re = torch.empty((2, half), dtype=dtype, device=data_re.device)
    out_im = torch.empty((2, half), dtype=dtype, device=data_re.device)
    if half == 0:
        return out_re, out_im
    code = _lib.lib().fft_stage_launch(
        data_re.data_ptr(), data_im.data_ptr(), tw_re.data_ptr(),
        tw_im.data_ptr(), out_re.data_ptr(), out_im.data_ptr(), half, m,
        _DTYPE_CODE[dtype], _lib.stream_of(data_re))
    _lib.check(code, "fft_stage")
    fft_stage.launches += 1
    return out_re, out_im


fft_stage.launches = 0
