"""Carries the JAX package's objects across to this package's.

The JAX package's containers are ``Dense(data)``, ``CSR(matvals, indx,
rowp, shape)``, ``ELL(values, cols, shape)``, ``DIA(diags, offsets,
shape)`` and ``BSR(values, cols, rowp, shape, block, stats)``.
:func:`carry` takes any object with those fields holding arrays (numpy
arrays, or anything ``numpy.asarray`` reads) and returns the counterpart
here, on the device chosen by the ``bind`` rule.  It reads the fields by
name and imports neither ``jax`` nor ``repro``.

:func:`carry_params` turns the JAX LM's parameter pytree (as numpy) into
the port's LM parameters, so that both compute the same function;
:func:`carry_train_state` carries a whole JAX ``TrainState`` (step,
parameters and AdamW state), so that both take the same training steps.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.containers import Dense, resolve_device, to_device
from repro_torch.numerics.sparse import CSR, DIA, ELL, index_array
from repro_torch.sparse.formats import BSR
from repro_torch.sparse.stats import SparseStats

__all__ = ["carry", "carry_params", "carry_train_state"]


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


def _leaf(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    # through f32: numpy has no bfloat16 that torch reads, and bf16 -> f32
    # -> bf16 is exact
    return torch.as_tensor(np.array(x, np.float32), device=device).to(dtype)


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    return fn(x)


def carry_params(params: dict, cfg, *, device: Any = None) -> dict:
    """The port's LM parameters from the JAX LM's pytree ``params`` (leaves
    as numpy arrays or anything ``numpy.asarray`` reads), in ``cfg.pdtype``
    on the device chosen by the ``bind`` rule.  Layer-stacked
    ``(num_layers, ...)`` leaves of ``params["layers"]`` become a list of
    per-layer dicts; every weight keeps its layout (``linear`` weights are
    (in, out) in both packages)."""
    dev = resolve_device(device)
    dtype = cfg.pdtype
    out = {k: _tree(v, lambda a: _leaf(a, dtype, dev))
           for k, v in params.items() if k != "layers"}
    stacked = params["layers"]
    out["layers"] = [_tree(stacked, lambda a, i=i: _leaf(np.asarray(a)[i],
                                                         dtype, dev))
                     for i in range(cfg.num_layers)]
    return out


def _dtype_of(x) -> torch.dtype:
    """The torch dtype of a numpy array's (``bfloat16`` by name: numpy has
    no such type of its own)."""
    name = str(np.asarray(x).dtype)
    return torch.bfloat16 if name == "bfloat16" else getattr(torch, name)


def carry_train_state(state: Any, cfg, *, device: Any = None):
    """The port's :class:`~repro_torch.train.TrainState` from the JAX
    package's ``TrainState`` (fields ``step``, ``params`` and
    ``opt_state`` = ``AdamState(count, mu, nu)``, read by name; leaves as
    numpy arrays).  Parameters go through :func:`carry_params`; the
    moments keep their own dtype (f32, or bf16 for ``moment_dtype``
    bf16) and the counters are int32."""
    from repro_torch.optim import AdamState
    from repro_torch.train import TrainState

    dev = resolve_device(device)
    opt = state.opt_state

    def moments(tree):
        out = {k: _tree(v, lambda a: _leaf(a, _dtype_of(a), dev))
               for k, v in tree.items() if k != "layers"}
        out["layers"] = [_tree(tree["layers"],
                               lambda a, i=i: _leaf(np.asarray(a)[i],
                                                    _dtype_of(a), dev))
                         for i in range(cfg.num_layers)]
        return out

    def count(x):
        return torch.as_tensor(np.array(x, np.int32), device=dev)

    return TrainState(
        step=count(state.step), params=carry_params(state.params, cfg,
                                                    device=dev),
        opt_state=AdamState(count=count(opt.count), mu=moments(opt.mu),
                            nu=moments(opt.nu)))

