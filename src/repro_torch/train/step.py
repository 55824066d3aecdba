"""train_step / eval_step factories: loss + grad + optimizer update, with
microbatched gradient accumulation (counterpart of ``repro.train.step``,
chip scope).

``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)``.  Gradients come from ``torch.autograd.grad`` of ``loss_fn``
(``lm.loss`` by default), which on CUDA tensors runs the attention
backward kernels.  Microbatches run in a Python loop that sums gradients
in f32, as the JAX package's ``lax.scan`` does, then scales the sums by
``1 / microbatches``.  The returned state holds new tensors; the input
state is left as it is.

``shard_batch`` places a batch on a mesh: the LM half of mesh scope
(ROADMAP queue 1 item 10b), it raises.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.optim import apply_updates, global_norm
from repro_torch.train.state import TrainState
from repro_torch.utils.tree import tree_leaves, tree_map

Pytree = Any

__all__ = ["make_train_step", "make_eval_step", "value_and_grad",
           "shard_batch"]


def _microbatch(batch: dict, n: int, i: int) -> dict:
    """Microbatch ``i`` of ``n``: rows ``[i * B/n, (i + 1) * B/n)``."""
    def split(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by microbatches {n}")
        return x[i * (b // n):(i + 1) * (b // n)]
    return {k: split(v) for k, v in batch.items()}


def value_and_grad(loss_fn, params, batch):
    """``(loss, metrics), grads`` of ``loss_fn(params, batch) -> (loss,
    metrics)``, with grads in the structure of params (what
    ``jax.value_and_grad(loss_fn, has_aux=True)`` gives in the JAX
    package).  The parameters are left as they are."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return (loss.detach(), metrics), tree_map(lambda _: next(it), params)


def make_train_step(lm, opt, *, microbatches: int = 1,
                    loss_fn: Optional[Callable] = None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    hold ``loss`` and ``grad_norm`` (f32, the norm before clipping)."""
    loss_fn = loss_fn or lm.loss

    def compute_grads(params, batch):
        if microbatches == 1:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
            return grads, loss, metrics
        g_sum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        l_sum = None
        for i in range(microbatches):
            (loss, _), g = value_and_grad(loss_fn, params,
                                           _microbatch(batch, microbatches,
                                                       i))
            g_sum = tree_map(torch.add, g_sum, g)
            l_sum = loss if l_sum is None else l_sum + loss
        inv = 1.0 / microbatches
        grads = tree_map(lambda g: g * inv, g_sum)
        loss = l_sum * inv
        return grads, loss, {"loss": loss}

    def train_step(state: TrainState, batch: dict
                   ) -> tuple[TrainState, dict]:
        grads, loss, metrics = compute_grads(state.params, batch)
        with torch.no_grad():
            updates, opt_state = opt.update(grads, state.opt_state,
                                            state.params)
            params = apply_updates(state.params, updates)
            metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                       for k, v in metrics.items()}
            metrics["loss"] = loss
            metrics["grad_norm"] = global_norm(grads)
        return TrainState(step=state.step + 1, params=params,
                          opt_state=opt_state), metrics

    return train_step


def make_eval_step(lm, loss_fn: Optional[Callable] = None) -> Callable:
    loss_fn = loss_fn or lm.loss

    def eval_step(params: Pytree, batch: dict) -> dict:
        with torch.no_grad():
            _, metrics = loss_fn(params, batch)
        return metrics

    return eval_step


def shard_batch(mesh, batch: Pytree) -> Pytree:
    raise NotImplementedError(
        "shard_batch places a batch on a mesh: the LM half of mesh scope, "
        "not ported yet (ROADMAP queue 1 item 10b)")
