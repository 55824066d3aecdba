"""call / capture / map, the ArBB execution trio in eager PyTorch
(counterpart of ``repro.core.closure``).

    call(f)      -> CallClosure: runs ``f`` at the current execution level
                    (chip scope, O2, in this package).
    capture(f)   -> Closure: the inspectable record of one run of ``f``,
                    the ATen operators it issued.  ``op_counts()`` and
                    ``gather_free()`` answer the questions the JAX package
                    asks of its jaxpr.
    emap(f, in_axes) -> ArBB map(): apply a scalar function across all
                    elements of one or more containers.  As ``jax.vmap``
                    does, the batch dimension is written out: the mapped
                    arguments reach ``f`` as whole vectors, and ``f``'s
                    element-wise arithmetic runs on all elements at once.
                    A recorded ``_for`` with per-element bounds inside ``f``
                    becomes one masked loop over all elements (see
                    ``repro_torch.numerics.spmv.arbb_for_dynamic``), never a
                    Python loop per element.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import execlevel
from repro_torch.core.containers import Dense, unwrap

__all__ = ["call", "capture", "emap", "Closure", "CallClosure"]

# ATen operators that read or write through an index tensor.
_GATHER_OPS = ("index", "index_select", "gather", "take", "scatter",
               "index_put", "index_add", "scatter_add", "embedding")


class _OpRecorder(TorchDispatchMode):
    def __init__(self) -> None:
        super().__init__()
        self.counts: collections.Counter[str] = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


class Closure:
    """A captured computation: the ATen operators one run issued."""

    def __init__(self, fn: Callable, counts: dict[str, int], out: Any):
        self.fn = fn
        self._counts = dict(counts)
        self.out = out

    def op_counts(self) -> dict[str, int]:
        """ATen operator name -> number of calls in the captured run."""
        return dict(self._counts)

    def gather_free(self) -> bool:
        """True if the run issued no gather or scatter, the structural
        property the split-stream FFT (paper §3.3) is designed to have."""
        return not any(k.startswith(_GATHER_OPS) for k in self._counts)


def capture(fn: Callable, *example_args: Any) -> Closure:
    """Run ``fn`` once on ``example_args`` and record what it issued."""
    rec = _OpRecorder()
    with rec:
        out = fn(*example_args)
    return Closure(fn, rec.counts, out)


class CallClosure:
    """The object returned by ``call(f)``: invocation runs ``f`` eagerly at
    the current execution level (O2; O3/O4 raise in ``execlevel``)."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, *args: Any):
        execlevel.current()
        return self.fn(*args)

    def closure(self, *example_args: Any) -> Closure:
        return capture(self.fn, *example_args)


def call(fn: Callable) -> CallClosure:
    """ArBB ``call()``: wrap a kernel function for execution."""
    return CallClosure(fn)


def emap(fn: Callable, in_axes: Sequence[Optional[int]]):
    """ArBB ``map()``: invoke a scalar function across container elements.

    ``in_axes[i] == 0``    -> argument i is consumed element-wise.
    ``in_axes[i] is None`` -> argument i is captured whole (uniform).

    Only axis 0 is mapped.  ``fn`` receives the mapped arguments as whole
    tensors, so it must be written with element-wise operations (as every
    paper use-site is)."""
    axes = tuple(in_axes)
    if any(a not in (0, None) for a in axes):
        raise ValueError(f"emap maps axis 0 or nothing, got in_axes={axes}")

    def mapped(*args):
        if len(args) != len(axes):
            raise TypeError(f"emap expected {len(axes)} args, got {len(args)}")
        out = fn(*(unwrap(a) if ax == 0 else a for a, ax in zip(args, axes)))
        return out if isinstance(out, Dense) else Dense(
            torch.as_tensor(unwrap(out)))

    return mapped
