"""Dense matmul kernel wrapper (mod2am's hot spot).

Replaces the Pallas TPU kernel ``repro/kernels/matmul.py:35``
(``matmul_kernel``).  The CUDA kernel (``csrc/matmul.cu``) computes one
64x64 output tile per block with the K loop inside the block and an f32
FMA accumulator; it masks ragged edges itself, so no caller pads.  It is
bounded by operations: f32 runs at IEEE precision on the FMA units (never
TF32).

On a host tensor the wrapper computes :func:`matmul_plain` instead; on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import matmul_ref

__all__ = ["matmul", "matmul_plain"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: The plain PyTorch version the kernel is held against.
matmul_plain = matmul_ref


def matmul(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """``a @ b`` for 2-D f32 or bf16 operands, f32 accumulation, output in
    ``out_dtype`` (f32 or bf16; default a's dtype)."""
    out_dtype = out_dtype or a.dtype
    if _lib.on_host(a, b):
        return matmul_plain(a, b, out_dtype)
    _lib.require_cuda("matmul", a, b)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE \
            or out_dtype not in _DTYPE_CODE:
        raise ValueError(f"matmul: takes f32 or bf16 in and out, got "
                         f"{a.dtype}, {b.dtype} -> {out_dtype}")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    code = _lib.lib().matmul_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
        _DTYPE_CODE[a.dtype], _DTYPE_CODE[out_dtype], _lib.stream_of(a))
    _lib.check(code, "matmul")
    matmul.launches += 1
    return out


matmul.launches = 0
