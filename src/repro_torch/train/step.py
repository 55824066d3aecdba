"""train_step / eval_step factories: loss + grad + optimizer update, with
microbatched gradient accumulation (counterpart of ``repro.train.step``).

``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)``.  Gradients come from ``torch.autograd.grad`` of ``loss_fn``
(``lm.loss`` by default), which on CUDA tensors runs the attention
backward kernels.  Microbatches run in a Python loop that sums gradients
in f32, as the JAX package's ``lax.scan`` does, then scales the sums by
``1 / microbatches``.  The returned state holds new tensors; the input
state is left as it is.

At mesh scope over the data axes (pod x data, the model axis of size 1),
``make_mesh_train_step`` is the schedule GSPMD derives for the reference's
jitted step from its shardings, written out: every rank holds the
parameters whole and its slice of the AdamW moments (``zero1_specs``);
per step it takes its rows of the global batch (:func:`shard_batch`, per
microbatch), differentiates its piece of the global loss, reduce-scatters
each gradient onto its moment slice, clips by the norm summed over
every rank's slices, updates its slices and all-gathers the parameters,
every collective through the mesh's :class:`~repro_torch.distributed.
collectives.ReducePlan`.  Every rank ends the step with the same bits in
every parameter.

On a mesh whose ``model`` axis is wider than 1 the layers run split over
it (``distributed.model_split``, the Megatron products, the vocab-parallel
logits and expert parallelism): the state holds each rank's shard of
every leaf the spec splits over ``model`` (``partition.model_dims``), and
the ZeRO-1 moments tile that shard over the data axes.  A gradient is
reduced over the data axes only (the plan's groups are one per model
coordinate): a split leaf's is its shard's, and a leaf the spec
replicates ends the backward whole and the same on every rank of the
model group, since a rank that uses part of one takes it through
``model_split.into``, whose backward sums the parts.  The clip's norm
counts each element once over the whole mesh: the split leaves' squares
summed over ``model`` as well.  Ranks at the same model coordinate end
the step with the same bits.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.distributed import model_split, sharding
from repro_torch.optim import apply_updates, global_norm
from repro_torch.train.state import TrainState
from repro_torch.utils.tree import tree_leaves, tree_map

Pytree = Any

__all__ = ["make_train_step", "make_eval_step", "value_and_grad",
           "shard_batch", "make_mesh_train_step", "mesh_loss",
           "moment_dims", "mesh_state", "whole_state", "model_shard"]


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


def _batch_shard(mesh) -> tuple[int, int]:
    """(this rank's flat index over the mesh's batch axes, pod-major; their
    width)."""
    from repro_torch.distributed.collectives import reduce_plan

    plan = reduce_plan(mesh)
    return (plan.shard_index() if plan.width > 1 else 0), plan.width


def shard_batch(mesh, batch: dict) -> dict:
    """This rank's rows of a global batch, the batch dim split over the
    mesh's (pod, data) axes as ``batch_spec`` names it: rows ``[i B / W,
    (i + 1) B / W)``, ``i`` the rank's pod-major index over the W of them.
    Each entry stays what it was (a host array or a tensor)."""
    i, w = _batch_shard(mesh)

    def rows(x):
        b = x.shape[0]
        if b % w:
            raise ValueError(f"batch {b} does not split over the {w} "
                             f"ranks of the data axes")
        return x[i * (b // w):(i + 1) * (b // w)]
    return {k: rows(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# mesh scope: data parallelism with ZeRO-1 moments
# ---------------------------------------------------------------------------

def _dim_of(spec, axes: tuple[str, ...]) -> Optional[int]:
    """The dim ``spec`` shards over the batch axes ``axes``, or None."""
    for i, e in enumerate(spec):
        names = e if isinstance(e, tuple) else (e,)
        if any(a in axes for a in names):
            return i
    return None


def moment_dims(specs: Pytree, params: Pytree, plan) -> Pytree:
    """Per parameter leaf, the dim its moments shard over the plan's batch
    axes (from ``zero1_specs``), or None where they stay whole."""
    return tree_map(lambda p, s: _dim_of(s, plan.batch_axes), params, specs)


def _tile(x: torch.Tensor, dim: Optional[int], plan) -> torch.Tensor:
    """This rank's tile of ``dim`` (pod-major), ``x`` itself for None."""
    if dim is None:
        return x
    n = x.shape[dim] // plan.width
    return x.narrow(dim, plan.shard_index() * n, n)


def model_shard(x: torch.Tensor, dim: Optional[int], split
                 ) -> torch.Tensor:
    """This rank's shard of ``dim`` over the model axis, in storage of its
    own (the whole leaf can go); ``x`` for None."""
    if dim is None or split is None:
        return x
    return split.tile(x, dim).clone(memory_format=torch.contiguous_format)


def mesh_state(params: Pytree, opt, plan, dims: Pytree, split=None,
               mdims: Pytree = None) -> TrainState:
    """The mesh state of whole parameters: step 0, the parameters whole
    (with a model ``split``, this rank's shard of each leaf split over
    ``model``, ``mdims`` from ``partition.model_dims``), the optimizer's
    state over this rank's tiles (:func:`moment_dims`)."""
    if split is not None:
        params = tree_map(lambda p, m: model_shard(p, m, split), params,
                          mdims)
    tiles = tree_map(lambda p, d: _tile(p, d, plan), params, dims)
    dev = tree_leaves(params)[0].device
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      params=params, opt_state=opt.init(tiles))


def whole_state(state: TrainState, plan, dims: Pytree, split=None,
                mdims: Pytree = None) -> TrainState:
    """The state with the moments gathered whole over the batch axes, and
    with a model ``split`` the parameters and moments gathered over
    ``model`` too (what the checkpointer writes); collective, every rank
    calls it."""
    def over_model(tree):
        if split is None:
            return tree
        return tree_map(lambda x, m: x if m is None else
                        split.all_gather(x, m), tree, mdims)

    def whole(tree):
        return over_model(tree_map(lambda m, d: m if d is None else
                                   plan.zero_gather(m, d), tree, dims))
    opt = state.opt_state
    return state._replace(params=over_model(state.params),
                          opt_state=opt._replace(mu=whole(opt.mu),
                                                 nu=whole(opt.nu)))


def mesh_loss(loss_fn: Callable, plan) -> Callable:
    """``piece(params, local_batch) -> (loss, metrics)``: this rank's piece
    of the global loss of ``loss_fn`` over the plan's batch axes, its cross
    entropy's share of the global count of counted tokens (the metrics'
    ``"tokens"``, summed over the ranks) plus ``1 / W`` of the rest of the
    loss (the MoE family's aux terms, whose expert load is a global mean
    inside ``sharded_rows``).  The pieces, and their gradients, summed over
    the ranks are the global loss's.  A loss without those metrics counts
    ``1 / W`` of itself."""
    W = plan.width

    def piece(params, batch):
        loss, metrics = loss_fn(params, batch)
        ce, n = metrics.get("loss"), metrics.get("tokens")
        if ce is None or n is None:
            return loss / W, metrics
        total = plan.psum_all(n.detach().reshape(1)).clamp_min(1)[0]
        return ce * (n / total) + (loss - ce) / W, metrics
    return piece


def _clip_norm(grads: Pytree, dims: Pytree, mdims: Pytree, plan, split,
               device) -> torch.Tensor:
    """The global norm of the reduced gradients, each element counted once
    over the mesh: sums of squares by (split over ``model``?, tiled over
    the data axes?), the tiled ones summed over the data ranks, the split
    ones over the model ranks."""
    sums = {(m, t): torch.zeros((), device=device) for m in (0, 1)
            for t in (0, 1)}
    mdims = mdims if mdims is not None else tree_map(lambda g: None, grads)

    def add(g, d, m):
        key = (int(m is not None), int(d is not None))
        sums[key] = sums[key] + torch.sum(torch.square(g))
    tree_map(add, grads, dims, mdims)
    tiled = plan.psum_all(torch.stack([sums[0, 1], sums[1, 1]]))
    split_sq = tiled[1] + sums[1, 0]
    if split is not None:
        split_sq = split.all_reduce(split_sq.reshape(1))[0]
    return torch.sqrt(tiled[0] + sums[0, 0] + split_sq)


def make_mesh_train_step(lm, opt, plan, dims: Pytree, *,
                         microbatches: int = 1,
                         loss_fn: Optional[Callable] = None, split=None,
                         mdims: Pytree = None) -> Callable:
    """``train_step(state, batch) -> (state, metrics)`` at mesh scope over
    ``plan``'s batch axes (module docstring).  ``batch`` is the global
    batch; ``state`` holds whole parameters (with a model ``split``, the
    shards of the leaves ``mdims`` names) and the moments over this rank's
    tiles of ``dims`` (:func:`mesh_state`).

    The loss is the global token mean: each rank differentiates its piece
    (:func:`mesh_loss`).  Microbatch ``i`` is rows ``[i B / n,
    (i + 1) B / n)`` of the global batch, split over the ranks as the
    reference's sharded batch is.  metrics: ``loss`` (the global loss, the
    mean over microbatches) and ``grad_norm`` (f32, before clipping), the
    same on every rank."""
    piece = mesh_loss(loss_fn or lm.loss, plan)
    mesh = plan.mesh

    def train_step(state: TrainState, batch: dict
                   ) -> tuple[TrainState, dict]:
        g_sum, l_sum = None, None
        with sharding.sharded_rows(plan), model_split.splitting(split):
            for i in range(microbatches):
                local = shard_batch(mesh, _microbatch(batch, microbatches, i)
                                    if microbatches > 1 else batch)
                (loss, _), g = value_and_grad(piece, state.params, local)
                if microbatches > 1:        # summed in f32, as the JAX scan
                    g = tree_map(lambda x: x.float(), g)
                g_sum = g if g_sum is None else tree_map(torch.add, g_sum, g)
                l_sum = loss if l_sum is None else l_sum + loss
        with torch.no_grad():
            # each gradient reduced in its dtype (the parameters' for one
            # microbatch, as the reference's step reduces them; f32 sums
            # over several), then taken to f32 for the update
            inv = 1.0 / microbatches
            grads = tree_map(
                lambda g, d: (plan.psum_all(g) if d is None
                              else plan.zero_scatter(g, d)).float() * inv,
                g_sum, dims)
            # the unreduced gradients go before the update's peak
            del g_sum, g
            # the clip's norm: the tiles' squares summed over the data
            # ranks, the whole leaves' (the same on every data rank) once;
            # the model-split leaves' squares summed over ``model`` too
            norm = _clip_norm(grads, dims, mdims, plan, split,
                              l_sum.device)
            tiles = tree_map(lambda p, d: _tile(p, d, plan), state.params,
                             dims)
            updates, opt_state = opt.update(grads, state.opt_state, tiles,
                                            grad_norm=norm)
            new = apply_updates(tiles, updates)
            del grads, updates
            params = tree_map(lambda p, d: p if d is None else
                              plan.zero_gather(p, d), new, dims)
            loss = plan.psum_all(l_sum.reshape(1))[0] * inv
        return (TrainState(step=state.step + 1, params=params,
                           opt_state=opt_state),
                {"loss": loss, "grad_norm": norm})

    return train_step
