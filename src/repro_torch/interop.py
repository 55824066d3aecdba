"""Carries the JAX package's objects across to this package's.

The JAX package's containers are ``Dense(data)``, ``CSR(matvals, indx,
rowp, shape)``, ``ELL(values, cols, shape)``, ``DIA(diags, offsets,
shape)`` and ``BSR(values, cols, rowp, shape, block, stats)``.
:func:`carry` takes any object with those fields holding arrays (numpy
arrays, or anything ``numpy.asarray`` reads) and returns the counterpart
here, on the device chosen by the ``bind`` rule.  It reads the fields by
name and imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from repro_torch.core.containers import Dense, resolve_device, to_device
from repro_torch.numerics.sparse import CSR, DIA, ELL, index_array
from repro_torch.sparse.formats import BSR
from repro_torch.sparse.stats import SparseStats

__all__ = ["carry"]


def _carry_stats(src: Any) -> Optional[SparseStats]:
    """The port's :class:`SparseStats` with ``src``'s fields, read by name
    (None when the source has none)."""
    if src is None:
        return None
    fields = {}
    for f in dataclasses.fields(SparseStats):
        v = getattr(src, f.name)
        fields[f.name] = tuple(int(c) for c in v) if isinstance(v, tuple) \
            else v
    return SparseStats(**fields)


def carry(obj: Any, *, device: Any = None, dtype: Any = None):
    """The counterpart of ``obj``: a BSR, CSR, ELL, DIA or Dense by the
    fields it has, and a bare array becomes a Dense.  ``dtype`` applies to
    values (float64 narrows to float32 when it is None); indices become
    int32.  A BSR is recognised before an ELL, whose fields it also has."""
    dev = resolve_device(device)
    if all(hasattr(obj, f) for f in ("values", "cols", "rowp", "block",
                                     "shape")):
        return BSR(values=to_device(obj.values, dtype, dev),
                   cols=index_array(obj.cols, dev),
                   rowp=index_array(obj.rowp, dev),
                   shape=tuple(int(s) for s in obj.shape),
                   block=int(obj.block),
                   stats=_carry_stats(getattr(obj, "stats", None)))
    if all(hasattr(obj, f) for f in ("matvals", "indx", "rowp", "shape")):
        return CSR(matvals=to_device(obj.matvals, dtype, dev),
                   indx=index_array(obj.indx, dev),
                   rowp=index_array(obj.rowp, dev),
                   shape=tuple(int(s) for s in obj.shape))
    if all(hasattr(obj, f) for f in ("values", "cols", "shape")):
        return ELL(values=to_device(obj.values, dtype, dev),
                   cols=index_array(obj.cols, dev),
                   shape=tuple(int(s) for s in obj.shape))
    if all(hasattr(obj, f) for f in ("diags", "offsets", "shape")):
        return DIA(diags=to_device(obj.diags, dtype, dev),
                   offsets=tuple(int(o) for o in obj.offsets),
                   shape=tuple(int(s) for s in obj.shape))
    if hasattr(obj, "data") and not isinstance(obj, np.ndarray):
        return Dense(to_device(obj.data, dtype, dev))
    return Dense(to_device(obj, dtype, dev))
