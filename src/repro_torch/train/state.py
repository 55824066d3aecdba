"""TrainState: params + optimizer state + step counter, as one tree
(counterpart of ``repro.train.state``).

A NamedTuple of trees, as in the JAX package, so that the checkpointer
writes it under the JAX package's leaf paths.  ``abstract_state`` (the
JAX package's ``jax.eval_shape`` of :func:`create`) serves its dry-run and
mesh shardings, mesh scope here, and is not ported.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.containers import resolve_device

Pytree = Any

__all__ = ["TrainState", "create"]


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
