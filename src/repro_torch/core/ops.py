"""ArBB operator vocabulary on Dense containers (counterpart of
``repro.core.ops``).

    add_reduce      - sum-reduction (scalar or along an axis)    [mod2am, CG]
    section         - strided sub-view                            [mod2as, FFT]
    repeat_row/col  - broadcast a vector into a matrix            [mod2am]
    replace_col/row - functional column/row update                [mod2am]
    cat             - concatenation                               [FFT]
    repeat          - tile a vector                               [FFT]

plus ``max_reduce``, ``shift``, ``gather`` and ``dot``.  All take and return
``Dense`` (or plain tensors, transparently).  PyTorch runs eagerly, so a
``start`` given as a 0-d tensor is read on the host.
"""
from __future__ import annotations

import torch

from repro_torch.core.containers import Dense, unwrap, wrap

__all__ = [
    "add_reduce",
    "max_reduce",
    "min_reduce",
    "mul_reduce",
    "section",
    "repeat",
    "repeat_row",
    "repeat_col",
    "replace_col",
    "replace_row",
    "cat",
    "shift",
    "gather",
    "dot",
]


def _reduce(x, axis, fn) -> Dense:
    data = unwrap(x)
    if axis is None:
        return Dense(fn(data))
    # ArBB direction d counts from the fastest-moving index: for a 2-D
    # container direction 0 reduces along each row.
    return Dense(fn(data, dim=data.ndim - 1 - axis))


def add_reduce(x, axis: int | None = None) -> Dense:
    """ArBB ``add_reduce``: to a scalar with ``axis=None``; with ``axis=0``
    the paper's ``v_m = sum_n d_mn`` (reduce the last axis)."""
    return _reduce(x, axis, torch.sum)


def max_reduce(x, axis: int | None = None) -> Dense:
    return _reduce(x, axis, torch.amax)


def min_reduce(x, axis: int | None = None) -> Dense:
    return _reduce(x, axis, torch.amin)


def mul_reduce(x, axis: int | None = None) -> Dense:
    data = unwrap(x)
    if axis is None:
        return Dense(torch.prod(data))
    return Dense(torch.prod(data, dim=data.ndim - 1 - axis))


def section(x, start, length: int, stride: int = 1) -> Dense:
    """ArBB ``section(v, start, length[, stride])``: strided 1-D sub-view
    (a slice, never a gather)."""
    data = unwrap(x)
    s = int(unwrap(start))
    return Dense(data[s:s + (length - 1) * stride + 1:stride])


def repeat(x, times: int) -> Dense:
    """Tile a 1-D container ``times`` times (FFT twiddle repetition)."""
    return Dense(unwrap(x).repeat(times))


def repeat_row(v, n: int) -> Dense:
    """Matrix whose rows are all copies of v: ``t_mn = v_n``."""
    data = unwrap(v)
    return Dense(data[None, :].expand(n, data.shape[0]))


def repeat_col(v, n: int) -> Dense:
    """Matrix whose columns are all copies of v: ``t_mn = v_m``."""
    data = unwrap(v)
    return Dense(data[:, None].expand(data.shape[0], n))


def replace_col(m, j, v) -> Dense:
    """Functional update of column j (paper mxm1 line 7)."""
    out = unwrap(m).clone()
    out[:, int(unwrap(j))] = unwrap(v)
    return Dense(out)


def replace_row(m, i, v) -> Dense:
    out = unwrap(m).clone()
    out[int(unwrap(i)), :] = unwrap(v)
    return Dense(out)


def cat(a, b, axis: int = 0) -> Dense:
    """Concatenate two containers (FFT: ``data = cat(up, down)``)."""
    return Dense(torch.cat([unwrap(a), unwrap(b)], dim=axis))


def shift(x, offset: int, fill=0) -> Dense:
    """Shift a 1-D container by ``offset``, filling vacated slots (DIA
    SpMV): a roll plus a mask, as in the JAX package."""
    data = unwrap(x)
    n = data.shape[0]
    rolled = torch.roll(data, offset)
    idx = torch.arange(n, device=data.device)
    mask = idx >= offset if offset >= 0 else idx < n + offset
    return Dense(torch.where(mask, rolled,
                             torch.as_tensor(fill, dtype=data.dtype,
                                             device=data.device)))


def gather(x, idx) -> Dense:
    """Element gather ``x[idx]`` (mod2as: ``invec[indx[i]]``)."""
    return Dense(unwrap(x)[unwrap(idx)])


def dot(a, b) -> Dense:
    """Inner product as add_reduce(a*b), CG's BLAS-1 core."""
    return add_reduce(wrap(a) * wrap(b))
