"""Public entry points of the paper's four kernels (counterpart of the paper
half of ``repro.kernels.ops``).

Variant selection flows through :mod:`repro_torch.core.registry`; this
module registers one variant per plane for each op:

    'cuda'   the hand-written kernel (kernels/matmul.py, spmv.py, fft.py)
    'torch'  the plain PyTorch version (kernels/ref.py)

CUDA operands select 'cuda', host operands 'torch'; ``backend('torch')``
asks for the plain version on the card explicitly.
"""
from __future__ import annotations

import functools
from typing import Callable, Sequence

import torch

from repro_torch.core import registry
from repro_torch.core.registry import (use_backend as backend,   # noqa: F401
                                       Cost,
                                       resolve_backend as current_backend)
from repro_torch.kernels import fft as fft_k
from repro_torch.kernels import matmul as mm_k
from repro_torch.kernels import ref
from repro_torch.kernels import spmv as spmv_k
from repro_torch.numerics.fft import bitrev_permutation, split_stream_twiddles

__all__ = ["backend", "current_backend", "matmul", "spmv_ell", "spmv_dia",
           "fft", "fft_plan", "stage_loop"]


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------

@registry.register("matmul", "cuda", plane="cuda", cost=Cost.CUDA,
                   doc="tiled f32-accumulating CUDA kernel (csrc/matmul.cu)")
def _matmul_cuda(a, b):
    return mm_k.matmul(a.contiguous(), b.contiguous())


@registry.register("matmul", "torch", plane="torch", cost=Cost.TORCH,
                   doc="plain torch.matmul in f32")
def _matmul_torch(a, b):
    return ref.matmul_ref(a, b)


def matmul(a, b):
    """``a @ b`` with f32 accumulation, output in a's dtype."""
    return registry.dispatch("matmul", a, b)


# ---------------------------------------------------------------------------
# SpMV (ELL + DIA layouts)
# ---------------------------------------------------------------------------

@registry.register("spmv_ell", "cuda", plane="cuda", cost=Cost.CUDA,
                   doc="warp-per-row ELL kernel (csrc/spmv.cu)")
def _spmv_ell_cuda(values, cols, x):
    return spmv_k.spmv_ell(values.contiguous(), cols.contiguous(),
                           x.contiguous())


@registry.register("spmv_ell", "torch", plane="torch", cost=Cost.TORCH,
                   doc="gather + row-reduce reference")
def _spmv_ell_torch(values, cols, x):
    return ref.spmv_ell_ref(values, cols, x)


def spmv_ell(values, cols, x):
    return registry.dispatch("spmv_ell", values, cols, x)


@registry.register("spmv_dia", "cuda", plane="cuda", cost=Cost.CUDA,
                   doc="thread-per-row banded kernel (csrc/spmv.cu)")
def _spmv_dia_cuda(diags, offsets, x):
    return spmv_k.spmv_dia(diags.contiguous(), offsets, x.contiguous())


@registry.register("spmv_dia", "torch", plane="torch", cost=Cost.TORCH)
def _spmv_dia_torch(diags, offsets, x):
    return ref.spmv_dia_ref(diags, offsets, x)


def spmv_dia(diags, offsets: Sequence[int], x):
    return registry.dispatch("spmv_dia", diags, tuple(offsets), x)


# ---------------------------------------------------------------------------
# FFT (full transform = tangle + log2(n) stages)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def fft_plan(n: int, rdtype: torch.dtype, device: torch.device):
    """Bit-reversal permutation and bit-reversed twiddle table for n, made
    once per (n, dtype, device) and kept on the device."""
    perm = torch.as_tensor(bitrev_permutation(n), device=device)
    tw = split_stream_twiddles(n)
    return (perm,
            torch.as_tensor(tw.real, dtype=rdtype, device=device),
            torch.as_tensor(tw.imag, dtype=rdtype, device=device))


def stage_loop(re: torch.Tensor, im: torch.Tensor, tw_re: torch.Tensor,
               tw_im: torch.Tensor, stage: Callable
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The log2 n split-stream stages over tangled re/im data of length n.
    ``stage`` is the kernel wrapper or its plain version; stage s reads the
    first ``m = n / 2^(s+1)`` entries of the untiled twiddle table."""
    n = re.shape[0]
    m, i = n // 2, 1
    while i < n:
        ore, oim = stage(re.view(n // 2, 2), im.view(n // 2, 2),
                         tw_re, tw_im, m)
        re, im = ore.view(n), oim.view(n)
        m >>= 1
        i <<= 1
    return re, im


def _fft_stages(x: torch.Tensor, stage: Callable) -> torch.Tensor:
    """The split-stream transform: tangle, then :func:`stage_loop`."""
    n = x.shape[0]
    rdtype = torch.float64 if x.dtype == torch.complex128 else torch.float32
    perm, tw_re, tw_im = fft_plan(n, rdtype, x.device)
    data = x[perm]
    re, im = stage_loop(data.real.to(rdtype).contiguous(),
                        data.imag.to(rdtype).contiguous(), tw_re, tw_im,
                        stage)
    return torch.complex(re, im).to(x.dtype)


def _pow2(n: int) -> bool:
    return n >= 2 and (n & (n - 1)) == 0


def _fft_accepts(x):
    return x.ndim == 1 and _pow2(x.shape[0])


@registry.register("fft", "cuda", plane="cuda", cost=Cost.CUDA,
                   accepts=_fft_accepts,
                   doc="split-stream stage kernel (csrc/fft.cu)")
def _fft_cuda(x):
    return _fft_stages(x, fft_k.fft_stage)


@registry.register("fft", "torch", plane="torch", cost=Cost.TORCH,
                   accepts=_fft_accepts,
                   doc="the same stage loop with the plain stage")
def _fft_torch(x):
    return _fft_stages(x, fft_k.fft_stage_plain)


def fft(x):
    """1-D complex FFT by split-stream stages (power-of-two length)."""
    x = x if x.dtype == torch.complex128 else x.to(torch.complex64)
    return registry.dispatch("fft", x)
