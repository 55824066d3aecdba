"""SpMV kernel wrappers: padded ELL (mod2as) and DIA (banded systems).

``spmv_ell`` replaces the Pallas TPU kernel ``repro/kernels/spmv.py:42``
(``spmv_ell_kernel``); ``spmv_dia`` replaces ``repro/kernels/spmv.py:88``
(``spmv_dia_kernel``).  Both CUDA kernels live in ``csrc/spmv.cu`` and are
bounded by bytes: ELL reads 8 bytes per stored entry with one warp per row;
DIA cuts the band into row tiles x diagonal chunks (:func:`dia_partition`),
stages each CTA's zero-padded window of x in shared memory and adds the
chunks' partial sums in a fixed order (no float atomics).

On host tensors the wrappers compute the plain versions; on CUDA tensors
they launch their kernel or raise.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import spmv_dia_ref, spmv_ell_ref

__all__ = ["spmv_ell", "spmv_dia", "spmv_ell_plain", "spmv_dia_plain",
           "DiaPartition", "dia_partition", "dia_live_rows", "dia_window"]

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


#: The DIA kernel's CTA (csrc/spmv.cu): 256 threads, each owning 4
#: consecutive rows; ``dw`` threads share a group of rows and split the
#: chunk's diagonals (tiles of 1024 / dw rows).
DIA_THREADS, DIA_ROWS_PER_THREAD, DIA_MAX_LANES = 256, 4, 8
#: Each of a row group's dw threads walks at least this many diagonals of
#: a chunk: one per independent accumulator.
DIA_MIN_DIAGS_PER_LANE = 4
#: The partition aims at this many CTAs per SM (16 warps).
DIA_CTAS_PER_SM = 2
#: The most floats of x a CTA stages (64 KB); a wider window reads x from
#: global memory with a bounds test instead.
DIA_WINDOW_MAX = 16384


class DiaPartition(NamedTuple):
    """How the DIA kernel cuts ``y = A x``: tile ``t`` owns rows
    ``[t * rows, min(n, (t + 1) * rows))``, chunk ``c`` diagonals
    ``[c * per_chunk, min(ndiags, (c + 1) * per_chunk))``, and one CTA runs
    each (tile, chunk).  Within it, thread ``(g, q)`` owns rows
    ``4g .. 4g + 3`` of the tile and walks the chunk's diagonals
    ``q, q + dw, ...``."""
    dw: int
    rows: int
    ntiles: int
    per_chunk: int
    nchunks: int

    def tiles(self, n: int) -> list[tuple[int, int]]:
        return [(t * self.rows, min(n, (t + 1) * self.rows))
                for t in range(self.ntiles)]

    def chunks(self, ndiags: int) -> list[tuple[int, int]]:
        return [(c * self.per_chunk, min(ndiags, (c + 1) * self.per_chunk))
                for c in range(self.nchunks)]


def dia_partition(n: int, ndiags: int, sms: int) -> DiaPartition:
    """The kernel's grid for an ``n``-row band of ``ndiags`` diagonals on a
    card of ``sms`` SMs.  Diagonals fill a CTA's threads first (``dw`` up
    to 8 while each thread keeps :data:`DIA_MIN_DIAGS_PER_LANE` of them),
    then chunks of diagonals multiply the row tiles until about
    :data:`DIA_CTAS_PER_SM` CTAs run per SM: a tridiagonal system at large
    n gets many row tiles and one chunk, a wide band at small n few row
    tiles and many chunks."""
    dw = 1
    while dw < DIA_MAX_LANES and 2 * dw * DIA_MIN_DIAGS_PER_LANE <= ndiags:
        dw *= 2
    rows = DIA_ROWS_PER_THREAD * DIA_THREADS // dw
    ntiles = -(-n // rows)
    want = -(-DIA_CTAS_PER_SM * sms // max(ntiles, 1))
    per_chunk = max(dw * DIA_MIN_DIAGS_PER_LANE, -(-ndiags // want))
    return DiaPartition(dw, rows, ntiles, per_chunk,
                        max(1, -(-ndiags // per_chunk)))


def dia_live_rows(n: int, offset: int, r0: int, r1: int) -> tuple[int, int]:
    """The rows of ``[r0, r1)`` where the diagonal at ``offset`` is live
    (its column ``i + offset`` lies in ``[0, n)``); empty when ``lo >=
    hi``.  ``dia_from_dense`` stores zeros outside that range.  Takes
    arrays too (broadcast)."""
    return np.maximum(r0, -offset), np.minimum(r1, n - offset)


def dia_window(part: DiaPartition, offsets: Sequence[int]) -> int:
    """Floats of x the kernel's dynamic shared memory must hold: a tile's
    rows plus the widest chunk's offset span, or 0 (x read from global
    memory) above :data:`DIA_WINDOW_MAX`."""
    span = max((max(offsets[d0:d1]) - min(offsets[d0:d1])
                for d0, d1 in part.chunks(len(offsets)) if d1 > d0),
               default=0)
    window = part.rows + span
    return window if window <= DIA_WINDOW_MAX else 0


@functools.lru_cache(maxsize=64)
def _dia_plan(offsets: tuple[int, ...], n: int, device: torch.device
              ) -> tuple[DiaPartition, int, torch.Tensor]:
    """The partition, the window and the offsets as an int32 device array,
    made once per (offsets, n, device) so that a solver loop pays one cache
    lookup a call."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    part = dia_partition(n, len(offsets), sms)
    return (part, dia_window(part, offsets),
            torch.tensor(offsets, dtype=torch.int32, device=device))


def spmv_dia(diags: torch.Tensor, offsets: Sequence[int], x: torch.Tensor
             ) -> torch.Tensor:
    """``y[i] = sum_d diags[d, i] * x[i + offsets[d]]`` (f32), reads outside
    [0, n) giving 0."""
    if not isinstance(offsets, tuple):   # a 1023-diagonal band: ~0.1 ms
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
    part, window, offs = _dia_plan(offsets, n, diags.device)
    stream = _lib.stream_of(diags)
    partial = tickets = None
    if part.nchunks > 1:
        partial, tickets = _lib.split_scratch(diags.device, stream,
                                              part.nchunks * n, part.ntiles)
    code = _lib.lib().spmv_dia_launch(
        diags.data_ptr(), offs.data_ptr(), x.data_ptr(), y.data_ptr(),
        None if partial is None else partial.data_ptr(),
        None if tickets is None else tickets.data_ptr(),
        n, ndiags, part.dw, part.per_chunk, part.nchunks, window, stream)
    _lib.check(code, "spmv_dia")
    spmv_dia.launches += 1
    return y


spmv_dia.launches = 0
