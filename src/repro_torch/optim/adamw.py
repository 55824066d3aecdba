"""AdamW from scratch (a pure transform of parameter trees), with
global-norm clipping and a configurable moment dtype (counterpart of
``repro.optim.adamw``).

The API is the JAX package's (the optax convention)::

    opt = adamw(schedule, b1=.9, b2=.95, weight_decay=.1, clip=1.0)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Trees are those of :mod:`repro_torch.utils.tree`.  The update math is the
JAX package's, in f32.  Gradients are cast to f32 and clipped one leaf at
a time inside ``update`` (the JAX package casts the whole tree first; the
values are the same), so the f32 copies of a whole model's gradients never
exist at once.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.utils.tree import tree_leaves, tree_map

__all__ = ["adamw", "apply_updates", "global_norm", "AdamState", "Optimizer"]

Pytree = Any


def global_norm(tree: Pytree) -> torch.Tensor:
    """sqrt of the sum over leaves of their squares, in f32."""
    total = None
    for leaf in tree_leaves(tree):
        sq = torch.sum(torch.square(leaf.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def apply_updates(params: Pytree, updates: Pytree) -> Pytree:
    """``(p.float() + u)`` rounded once to ``p.dtype``, leaf by leaf; new
    tensors (the inputs are left as they are)."""
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params,
                    updates)


class AdamState(NamedTuple):
    count: torch.Tensor      # () int32
    mu: Pytree
    nu: Pytree


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Pytree], Any]
    update: Callable[..., tuple[Pytree, Any]]


def adamw(schedule: Callable, *, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          clip: Optional[float] = 1.0,
          moment_dtype: torch.dtype = torch.float32) -> Optimizer:

    def init(params):
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        z = lambda p: torch.zeros_like(p, dtype=moment_dtype)
        return AdamState(count=torch.zeros((), dtype=torch.int32,
                                           device=device),
                         mu=tree_map(z, params), nu=tree_map(z, params))

    def update(grads, state: AdamState, params):
        scale = None
        if clip is not None:
            gn = global_norm(grads)
            scale = torch.clamp(clip / torch.clamp(gn, min=1e-12), max=1.0)

        count = state.count + 1
        lr = schedule(count)
        b1c = 1 - b1 ** count.float()
        b2c = 1 - b2 ** count.float()

        def upd(g, m, v, p):
            g = g.float()
            if scale is not None:
                g = g * scale
            m32, v32 = m.float(), v.float()
            m_new = b1 * m32 + (1 - b1) * g
            v_new = b2 * v32 + (1 - b2) * g * g
            mhat = m_new / b1c
            vhat = v_new / b2c
            step = mhat / (torch.sqrt(vhat) + eps)
            if weight_decay:
                step = step + weight_decay * p.float()
            return (-lr * step, m_new.to(moment_dtype),
                    v_new.to(moment_dtype))

        out = tree_map(upd, grads, state.mu, state.nu, params)
        return _pick(out, 0), AdamState(count=count, mu=_pick(out, 1),
                                        nu=_pick(out, 2))

    return Optimizer(init=init, update=update)


def _pick(tree, i):
    """The ``i``-th element of every (update, mu, nu) leaf triple of a tree
    of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]
