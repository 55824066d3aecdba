"""mod2f — 1-D complex FFT, split-stream radix-2 (counterpart of
``repro.numerics.fft``).

The paper's stage loop::

    _for (u32 i = 1, i < n, i <<= 1) {
        even = section(data, 0, n/2, 2);
        odd  = section(data, 1, n/2, 2);
        up   = even + odd;
        down = (even - odd) * repeat(section(twiddles, 0, m), i);
        data = cat(up, down);
        m >>= 1;
    } _end_for;

after tangling the input by the bit-reversal permutation, with the twiddles
W_n^k stored in bit-reversed order so that the prefix of each stage's table
is the next stage's table.  Every stage is sections, element-wise ops and a
cat: no gather, and the output comes out in natural order.

``stockham_fft`` is the optimised comparator; ``naive_radix2_fft`` the
paper's simple serial radix-2; ``dft_ref`` the O(n^2) definition.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import Dense, call, cat, repeat, section, unwrap, wrap

__all__ = ["bitrev_permutation", "split_stream_twiddles", "arbb_fft",
           "split_stream_fft", "stockham_fft", "naive_radix2_fft", "dft_ref"]


def bitrev_permutation(n: int) -> np.ndarray:
    """Bit-reversal permutation of [0, n) (the 'tangling' of §3.3)."""
    if n & (n - 1):
        raise ValueError(f"n={n} is not a power of two")
    bits = max(0, n.bit_length() - 1)
    idx = np.arange(n, dtype=np.int64)
    perm = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        perm |= ((idx >> b) & 1) << (bits - 1 - b)
    return perm


def split_stream_twiddles(n: int, dtype=np.complex128) -> np.ndarray:
    """W_n^k for k < n/2, stored in bit-reversed order."""
    br = bitrev_permutation(n // 2) if n >= 4 else np.zeros(max(n // 2, 1), np.int64)
    return np.exp(-2j * np.pi * br / n).astype(dtype)


def arbb_fft(data: Dense, twiddles: Dense) -> Dense:
    """The paper's stage loop, verbatim in the DSL.  ``data`` must already
    be tangled; ``twiddles`` from :func:`split_stream_twiddles`."""
    data = wrap(data)
    twiddles = wrap(twiddles)
    n = data.shape[0]
    m = n // 2
    i = 1
    while i < n:
        even = section(data, 0, n // 2, 2)
        odd = section(data, 1, n // 2, 2)
        up = even + odd
        down = (even - odd) * repeat(section(twiddles, 0, m), i)
        data = cat(up, down)
        m >>= 1
        i <<= 1
    return data


def _complex_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype in (torch.float64, torch.complex128) \
        else torch.complex64


def split_stream_fft(x, twiddles=None) -> Dense:
    """Tangle and run the split-stream stages.  Oracle: torch.fft.fft."""
    x = wrap(x)
    data = unwrap(x)
    n = x.shape[0]
    perm = torch.as_tensor(bitrev_permutation(n), device=data.device)
    if twiddles is None:
        ctype = _complex_dtype(data.dtype)
        tw = split_stream_twiddles(
            n, dtype=np.complex128 if ctype == torch.complex128
            else np.complex64)
        twiddles = Dense(torch.as_tensor(tw, device=data.device))
    return arbb_fft(Dense(data[perm]), wrap(twiddles))


def stockham_fft(x) -> Dense:
    """Stockham autosort radix-2 FFT, the optimised comparator: each stage
    is a reshape and a broadcast butterfly."""
    x = unwrap(wrap(x))
    n = x.shape[0]
    if n & (n - 1):
        raise ValueError("power-of-two sizes only")
    ctype = _complex_dtype(x.dtype)
    y = x.to(ctype).reshape(1, n)
    for _ in range(n.bit_length() - 1):
        rows, cols = y.shape
        half = cols // 2
        a, b = y[:, :half], y[:, half:]
        k = torch.arange(half, device=x.device, dtype=torch.float64)
        w = torch.exp(-2j * math.pi * k / cols).to(ctype)
        y = torch.stack([a + b, (a - b) * w[None, :]], dim=1).reshape(
            rows * 2, half)
    perm = torch.as_tensor(bitrev_permutation(n), device=x.device)
    return wrap(y.reshape(n)[perm])


def naive_radix2_fft(x) -> Dense:
    """Recursive radix-2 Cooley-Tukey (the paper's 'simple serial radix-2')."""
    x = unwrap(wrap(x))
    ctype = _complex_dtype(x.dtype)

    def rec(v):
        m = v.shape[0]
        if m == 1:
            return v
        e = rec(v[0::2])
        o = rec(v[1::2])
        k = torch.arange(m // 2, device=v.device, dtype=torch.float64)
        w = torch.exp(-2j * math.pi * k / m).to(ctype)
        return torch.cat([e + w * o, e - w * o])

    return wrap(rec(x.to(ctype)))


def dft_ref(x) -> Dense:
    """O(n^2) DFT by definition, the oracle for tiny sizes."""
    x = unwrap(wrap(x))
    n = x.shape[0]
    k = torch.arange(n, device=x.device, dtype=torch.float64)
    mat = torch.exp(-2j * math.pi * torch.outer(k, k) / n).to(
        _complex_dtype(x.dtype))
    return wrap(mat @ x.to(mat.dtype))


fft = call(lambda d, t: arbb_fft(d, t))
