"""TrainState: params + optimizer state + step counter, as one tree
(counterpart of ``repro.train.state``).

A NamedTuple of trees, as in the JAX package, so that the checkpointer
writes it under the JAX package's leaf paths.  :func:`abstract_state` is
the JAX package's ``jax.eval_shape`` of :func:`create`: the same tree on
the ``meta`` device, shapes and dtypes with no storage, which the mesh
trainer's partition specs and the tests read.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.containers import resolve_device

Pytree = Any

__all__ = ["TrainState", "create", "abstract_state"]


class TrainState(NamedTuple):
    step: torch.Tensor       # () int32
    params: Pytree
    opt_state: Any


def create(lm, opt, seed: int = 0, *, device=None) -> TrainState:
    """Seeded random parameters (``lm.init(seed)``), the optimizer's state
    and step 0, on ``device`` (the card unless the caller names another)."""
    dev = resolve_device(device)
    params = lm.init(seed, device=dev)
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      params=params, opt_state=opt.init(params))


def abstract_state(lm, opt) -> TrainState:
    """The state's tree of ``meta`` tensors: every leaf's shape and dtype,
    no allocation (arctic-480b's 480 B parameters included)."""
    return create(lm, opt, device="meta")
