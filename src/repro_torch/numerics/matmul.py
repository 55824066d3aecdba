"""mod2am — dense matrix-matrix multiplication, the paper's four ArBB variants
(counterpart of ``repro.numerics.matmul``).

All variants compute ``c = a @ b`` and are written line for line as in the
JAX package:

    mxm0   naive: 2-D loop nest, scalar add_reduce per element
    mxm1   one loop over columns; whole-matrix ops + axis reduce
    mxm2a  rank-1 update form: c += repeat_col(a.col(i)) * repeat_row(b.row(i))
    mxm2b  mxm2a with the paper's unrolled regular loop inside (u = 8)

``mxm_torch`` is the library comparator (the JAX package's ``mxm_xla``).
In eager PyTorch every DSL step is one or more launches, so mxm0 costs
O(n^2) host steps; the benchmarks run it only at n <= 256, as the JAX
package does.
"""
from __future__ import annotations

import torch

from repro_torch.core import (
    Dense,
    add_reduce,
    arbb_for,
    call,
    repeat_col,
    repeat_row,
    replace_col,
    unwrap,
    wrap,
)

__all__ = ["mxm0", "mxm1", "mxm2a", "mxm2b", "mxm_torch",
           "arbb_mxm0", "arbb_mxm1", "arbb_mxm2a", "arbb_mxm2b"]


def arbb_mxm0(a: Dense, b: Dense) -> Dense:
    """Naive 3-loop port (paper §3.1 arbb_mxm0)."""
    a, b = wrap(a), wrap(b)
    n, m = a.shape[0], b.shape[1]
    c = Dense.zeros((n, m), a.dtype, device=a.device)

    def outer(i, c):
        def inner(j, c):
            return c.set((i, j), add_reduce(a.row(i) * b.col(j)))
        return arbb_for(0, m, inner, c)

    return arbb_for(0, n, outer, c)


def arbb_mxm1(a: Dense, b: Dense) -> Dense:
    """One loop over columns; 2-D container ops per iteration."""
    a, b = wrap(a), wrap(b)
    n, m = a.shape[0], b.shape[1]
    c = Dense.zeros((n, m), a.dtype, device=a.device)

    def body(i, c):
        t = repeat_row(b.col(i), n)          # t_mn = b_ni
        d = a * t                            # d_mn = a_mn * b_ni
        return replace_col(c, i, add_reduce(d, 0))  # c_mi = sum_n d_mn

    return arbb_for(0, m, body, c)


def arbb_mxm2a(a: Dense, b: Dense) -> Dense:
    """Rank-1 update form without add_reduce (paper arbb_mxm2a)."""
    a, b = wrap(a), wrap(b)
    n = a.shape[0]
    k = a.shape[1]
    c = Dense.zeros((n, b.shape[1]), a.dtype, device=a.device)

    def body(i, c):
        return c + repeat_col(a.col(i), b.shape[1]) * repeat_row(b.row(i), n)

    return arbb_for(0, k, body, c)


def arbb_mxm2b(a: Dense, b: Dense, u: int = 8) -> Dense:
    """mxm2a with the Intel unrolling trick (paper arbb_mxm2b), including
    the remainder loop of the paper's lines 21-23."""
    a, b = wrap(a), wrap(b)
    n = a.shape[0]
    k = a.shape[1]
    c = Dense.zeros((n, b.shape[1]), a.dtype, device=a.device)

    def body(i, c):
        return c + repeat_col(a.col(i), b.shape[1]) * repeat_row(b.row(i), n)

    return arbb_for(0, k, body, c, unroll=u)


def _mxm_torch(a, b):
    """The library comparator: one torch.matmul."""
    return Dense(torch.matmul(unwrap(a), unwrap(b)))


mxm0 = call(arbb_mxm0)
mxm1 = call(arbb_mxm1)
mxm2a = call(arbb_mxm2a)
mxm2b = call(arbb_mxm2b)
mxm_torch = call(_mxm_torch)
