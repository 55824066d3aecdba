"""The model axis's compute split: Megatron's column and row products,
vocab-parallel logits and cross entropy, and expert parallelism, with
explicit collectives (counterpart of the schedule GSPMD derives for the
reference from ``repro/distributed/partition.py``'s rules and the
``constrain`` sites of ``repro/models/transformer.py``, ``models/moe.py``
and ``models/lm.py``).

Layout, Megatron's 1-D one: the residual stream is whole on every rank
of a model group.  A column product (``wq``, the MLP's ``wi_gate`` and
``wi_up``, the unembedding, the router) runs on the rank's columns with
no communication; a row product (``wo`` of attention and of the MLP, the
experts' combine, the embedding lookup) ends in one all-reduce over
``model``.  The reference constrains the residual d-sharded instead, and
GSPMD turns each all-reduce into an all-gather and a reduce-scatter of
the same bytes; the values are the same.

The conjugate pairs, as autograd Functions (every collective through the
mesh's groups and transport, a ``collective:<kind>`` span each):

    into(x)         identity forward, all-reduce backward: a replicated
                    activation or leaf entering a region where each rank
                    uses part of it (its gradient is each rank's part)
    out_of(x)       all-reduce forward, identity backward: the partial
                    sums of a row product leaving the region
    gather(x, dim)  all-gather forward, this rank's tile of the gradient
                    backward: the router's logits over E, the logits over
                    the vocabulary, and a leaf gathered whole at use by a
                    block every rank runs whole on the same input
    whole(leaf, dim, partial=True)
                    the gather, reduce-scatter backward: a leaf gathered
                    whole at use of which each rank uses part

The convention that makes these compose: the gradient of anything that
is replicated over ``model`` is whole, and the same bits, on every rank
of the group.  So a leaf the spec replicates needs no reduction over
``model`` in the trainer: where a rank uses all of it on the input every
rank has (the block norms, ``final_norm``), its gradient is already
whole; where a rank uses part (the lane floor's ``wk`` / ``wv``, sliced
to the rank's kv heads; ``q_norm`` / ``k_norm``, applied to the rank's
heads), it enters through :func:`into`, whose backward sums the parts.
A leaf the spec splits ends with the gradient of this rank's shard.

A :class:`ModelSplit` is active inside :func:`splitting` (thread-local,
like ``sharding.sharded_rows``; the remat recompute re-enters it,
``models/transformer.py``).  ``held`` says how model-split leaves come:
as this rank's shards (the trainer's state) or whole (the ``Engine``'s
parameters, where :func:`local` yields a view of the rank's tile).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Iterator, Optional

import torch

from repro_torch.core.topology import LocalMesh, topology_of
from repro_torch.distributed import collectives

__all__ = ["ModelSplit", "split_of", "splitting", "current", "local",
           "whole", "into", "out_of", "gather", "heads_split", "heads",
           "vocab_cross_entropy", "AXIS"]

#: The model axis's name (the mesh's model-role axis).
AXIS = "model"


@dataclasses.dataclass(frozen=True)
class ModelSplit:
    """The model axis of a mesh, from this rank: ``size`` ranks, this one
    at ``index``.  ``held``: model-split leaves are held as this rank's
    shards (True) or whole (False)."""
    mesh: object
    size: int
    index: int
    held: bool

    def _g(self):
        g = collectives.mesh_groups(self.mesh)
        return g.axis[AXIS], g.transport

    def all_reduce(self, x: torch.Tensor, op=None) -> torch.Tensor:
        group, transport = self._g()
        return collectives.all_reduce(x, group, transport, op)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        return self.all_reduce(x, dist.ReduceOp.MAX)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        group, transport = self._g()
        return collectives.all_gather(x, group, self.size, transport,
                                      dim % x.dim())

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        group, transport = self._g()
        return collectives.reduce_scatter(x, group, self.size, transport,
                                          dim % x.dim())

    def tile(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's tile of ``dim`` of a whole tensor (a view)."""
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.index * n, n)


def split_of(mesh, *, held: bool) -> Optional[ModelSplit]:
    """The :class:`ModelSplit` of ``mesh``, or None where its model axis is
    one rank wide (or there is no mesh).  A one-process mesh
    (``LocalMesh``) with a wider model axis raises: each shard needs a
    rank of a process group."""
    if mesh is None:
        return None
    topo = topology_of(mesh)
    width = topo.extent("model")
    if width <= 1:
        return None
    if isinstance(mesh, LocalMesh):
        raise ValueError(
            f"{topo.describe()}: a model axis of {width} splits each layer "
            f"over {width} ranks, and this mesh has no process group; start "
            f"a world of ranks (torch.distributed) and make the mesh over it")
    axes = topo.axes("model")
    if axes != (AXIS,):
        raise ValueError(f"{topo.describe()}: one model axis named "
                         f"{AXIS!r} splits the layers, not {axes}")
    index = collectives.mesh_groups(mesh).coords[AXIS]
    return ModelSplit(mesh=mesh, size=width, index=index, held=held)


_state = threading.local()


@contextlib.contextmanager
def splitting(split: Optional[ModelSplit]) -> Iterator[Any]:
    """Within the block the layers run split over ``split`` (None: whole,
    as on one card)."""
    prev = getattr(_state, "split", None)
    _state.split = split
    try:
        yield split
    finally:
        _state.split = prev


def current() -> Optional[ModelSplit]:
    """The split of the enclosing :func:`splitting`, or None."""
    return getattr(_state, "split", None)


# ---------------------------------------------------------------------------
# the conjugate pairs
# ---------------------------------------------------------------------------

class _Into(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.split.all_reduce(g.contiguous()), None


class _OutOf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        return split.all_reduce(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather forward; backward this rank's tile of the gradient
    (``partial=False``: the gradient is whole on every rank) or the tiles'
    sum (``partial=True``: each rank holds its part)."""

    @staticmethod
    def forward(ctx, x, split, dim, partial):
        ctx.args = (split, dim, partial)
        return split.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        split, dim, partial = ctx.args
        if partial:
            return split.reduce_scatter(g.contiguous(), dim), None, None, \
                None
        return split.tile(g, dim), None, None, None


def into(x: torch.Tensor) -> torch.Tensor:
    """``x`` entering the split region (module docstring); ``x`` itself
    outside a split."""
    s = current()
    return x if s is None else _Into.apply(x, s)


def out_of(x: torch.Tensor) -> torch.Tensor:
    """The partial sums ``x`` leaving the split region: summed over the
    model axis; ``x`` itself outside a split."""
    s = current()
    return x if s is None else _OutOf.apply(x, s)


def gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model ranks' tiles of ``dim`` concatenated (an activation whose
    gradient is whole on every rank); ``x`` outside a split."""
    s = current()
    return x if s is None else _Gather.apply(x, s, dim, False)


def local(leaf: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's shard of a leaf the spec splits along ``dim``: the leaf
    itself where it is held as the shard, a view of its tile where it is
    handed whole; the leaf outside a split."""
    s = current()
    if s is None or s.held:
        return leaf
    return s.tile(leaf, dim)


def whole(leaf: torch.Tensor, dim: int, *, partial: bool = False
          ) -> torch.Tensor:
    """A leaf the spec splits along ``dim``, whole at use: gathered where
    it is held as shards (backward: this rank's tile of the gradient, or,
    with ``partial``, the sum of the ranks' parts), the leaf itself where
    it is handed whole or outside a split."""
    s = current()
    if s is None or not s.held:
        return leaf
    return _Gather.apply(leaf, s, dim, partial)


# ---------------------------------------------------------------------------
# attention heads
# ---------------------------------------------------------------------------

def heads_split(cfg, size: int) -> bool:
    """Whether attention splits by heads over ``size`` model ranks: the q
    heads divide, and each rank's q heads read a whole number of kv heads
    with one GQA group (the kv heads divide, or each kv head serves a
    whole number of ranks).  Otherwise the attention block runs whole on
    every rank of the group (the reference's ``_replicate_attention``)."""
    hq, hk = cfg.num_heads, cfg.num_kv_heads
    return hq % size == 0 and (hk % size == 0 or size % hk == 0)


def heads(cfg) -> tuple[int, int, int, int]:
    """(q heads, kv heads, first q head, first kv head) this rank runs:
    the config's all outside a split or where :func:`heads_split` is
    false."""
    s = current()
    hq, hk = cfg.num_heads, cfg.num_kv_heads
    if s is None or not heads_split(cfg, s.size):
        return hq, hk, 0, 0
    hq_l = hq // s.size
    q0 = s.index * hq_l
    group = hq // hk
    k0 = q0 // group
    return hq_l, max(1, hq_l // group), q0, k0


# ---------------------------------------------------------------------------
# vocab-parallel cross entropy
# ---------------------------------------------------------------------------

class _VocabCE(torch.autograd.Function):
    """Token-mean cross entropy over logits split along the vocabulary:
    the max, the sum of exps and the label's logit all-reduced over the
    model axis; padded columns (global index >= ``vocab``) masked out of
    the softmax.  Returns (loss, counted tokens)."""

    @staticmethod
    def forward(ctx, logits, labels, split, vocab, ignore_index):
        lf = logits.float()
        vl = lf.shape[-1]
        off = split.index * vl
        cols = torch.arange(off, off + vl, device=lf.device)
        lf = torch.where(cols < vocab, lf, float("-inf"))
        m = split.pmax(lf.amax(dim=-1))
        e = torch.exp(lf - m[..., None])
        mask = labels != ignore_index
        safe = torch.where(mask, labels, 0).long() - off
        mine = (safe >= 0) & (safe < vl)
        ll = torch.gather(lf, -1, safe.clamp(0, vl - 1)[..., None])[..., 0]
        sums = split.all_reduce(torch.stack(
            [e.sum(dim=-1), torch.where(mine, ll, 0.0)]))
        lse = torch.log(sums[0]) + m
        nll = (lse - sums[1]) * mask
        n = torch.clamp(torch.sum(mask), min=1)
        ctx.save_for_backward(e, sums[0], safe, mine, mask, n)
        ctx.dtype = logits.dtype
        return torch.sum(nll) / n, n

    @staticmethod
    def backward(ctx, dloss, _dn):
        e, total, safe, mine, mask, n = ctx.saved_tensors
        g = e / total[..., None]                  # the softmax's columns
        idx = safe.clamp(0, g.shape[-1] - 1)[..., None]
        g.scatter_add_(-1, idx, -mine[..., None].to(g.dtype))
        g.mul_(mask[..., None] * (dloss / n))
        return g.to(ctx.dtype), None, None, None, None


def vocab_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                        vocab: int, ignore_index: int = -1
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss, n_tokens) of this rank's vocabulary columns ``logits`` (B,
    S, V / M) of the padded vocabulary, whose first ``vocab`` entries are
    real, under the active split; ``lm.cross_entropy_loss``'s values."""
    return _VocabCE.apply(logits, labels, current(), vocab, ignore_index)
