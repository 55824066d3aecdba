"""Carries the JAX package's objects across to this package's.

The JAX package's containers are ``Dense(data)``, ``CSR(matvals, indx,
rowp, shape)``, ``ELL(values, cols, shape)`` and ``DIA(diags, offsets,
shape)``.  :func:`carry` takes any object with those fields holding arrays
(numpy arrays, or anything ``numpy.asarray`` reads) and returns the
counterpart here, on the device chosen by the ``bind`` rule.  It reads the
fields by name and imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.core.containers import Dense, resolve_device, to_device
from repro_torch.numerics.sparse import CSR, DIA, ELL, index_array

__all__ = ["carry"]


def carry(obj: Any, *, device: Any = None, dtype: Any = None):
    """The counterpart of ``obj``: a CSR, ELL, DIA or Dense by the fields it
    has, and a bare array becomes a Dense.  ``dtype`` applies to values
    (float64 narrows to float32 when it is None); indices become int32."""
    dev = resolve_device(device)
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
