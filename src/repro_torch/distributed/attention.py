"""Sequence-parallel (ring) attention and decode over the ring-striped page
pool: the mesh-scoped attention variants (counterpart of
``repro.distributed.attention``, DESIGN.md §10 and §13).

Partitioning: Q, K and V shard over the **sequence** dimension on the ring
axes (pod x data, :func:`repro_torch.distributed.collectives.ring_plan`: a
flat ring on O3, pod-major on O4).  Each hop rotates the K/V panels one
neighbour around the ring (:meth:`RingPlan.shift`) while every rank folds
the visiting panel into its online-softmax state ``(m, l, acc)``.  The
per-hop compute is a per-shard registry dispatch of
``flash_attention_state`` with the plane pinned at entry: on the card the
hand-written state kernels (causal calls walk the tiles kernel's banded
layout, full calls the dense grid), on the host their plain versions.

Where the reference runs one ``shard_map`` program, the port runs the same
schedule eagerly on every rank at once (SPMD over ``torch.distributed``):
every rank holds Q, K and V whole, slices its own shard, meets the other
ranks only through the plan's collectives, and ends with the output
gathered whole over the ring, so the caller gets a plain tensor of the chip
variant's shape and call sites never change.  Under the mesh trainer
(``distributed.sharding.sharded_rows``) each rank holds its own batch rows
instead, and two all-to-alls stand for the gathers GSPMD inserts around
the reference's ring.  The reference's ``lax.cond`` on the ring index is a
plain Python ``if`` on this rank's :meth:`RingPlan.ring_index`.

Causal masking is **zig-zag balanced**: :func:`zigzag_perm` deals each rank
the half-blocks ``(s, 2W-1-s)``, so every rank owns one early and one late
slice.  Per hop the visiting panel classifies statically per half-block
pair:

    hop 0 (own panel)    q_lo x k_lo causal, q_hi x k_lo full,
                         q_hi x k_hi causal
    source ring-before   both q halves x k_lo full (k_hi entirely masked)
    source ring-after    q_hi x whole panel full (q_lo entirely masked)

so a layer's ring prefill launches, per rank, 2 tiles-state kernels and W
dense-grid state kernels.

The backward (the reference differentiates its scan over
``RingPlan.shift``) is a ``torch.autograd.Function`` in the global-lse
form: the forward keeps this rank's shards, its output rows and their
log-sum-exp over every key; the backward takes ``D = rowsum(dO o)`` once
(``fa_bwd_delta``) and, per hop, ``fa_bwd_dkdv`` and ``fa_bwd_dq`` over the
pieces the forward walked, each against the global lse, so the pieces'
gradients add up exactly.  dQ accumulates locally in f32; dK and dV travel
with their panel and come home after the last hop, one more rotation.  A
zig-zag layer launches per rank one delta kernel and W + 2 of each of the
other two; on host tensors the pieces take the plain backward.

The variant registers as ``flash_attention``/``ring`` with
``scope='mesh'`` and degrades to the chip kernel as the reference's does:
no ambient mesh, a 1-wide ring, or a length the ring does not divide all
select the chip variant, and an explicit ``variant=`` still pins.  Rich
``MaskSpec`` masks stay chip-scoped.

Decode (:func:`paged_ring_attention`, ``paged_attention``/``ring``)
inverts the movement: the page pool stays pinned, striped over the ring
(its layout is ``serve/kvcache.py``'s; this module reads a shard's view
through :func:`~repro_torch.serve.kvcache.shard_view`), and only the
one-token ``(o, m, l)`` partials travel: one all-gather over the ring,
then every rank merges them in ring order (the reference's ``pmax`` and
``psum`` as one collective).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.distributed import sharding
from repro_torch.distributed.collectives import (RingPlan, ambient_ring_plan,
                                                 ring_plan)
from repro_torch.kernels import _lib
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.serve.kvcache import shard_view

__all__ = ["ring_attention", "paged_ring_attention", "zigzag_perm"]


@functools.lru_cache(maxsize=None)
def zigzag_perm(length: int, ring: int):
    """(order, inverse) reordering the sequence so ring shard ``s`` holds
    the half-blocks ``(s, 2 ring - 1 - s)``: ``x[..., order]`` lays the
    sequence out for sharding, ``out[..., inverse]`` restores global order.
    None when ``length`` does not split into ``2 ring`` half-blocks."""
    if ring <= 1 or length % (2 * ring) != 0:
        return None
    h = length // (2 * ring)
    order = np.concatenate([
        np.r_[s * h:(s + 1) * h,
              (2 * ring - 1 - s) * h:(2 * ring - s) * h]
        for s in range(ring)])
    inv = np.argsort(order)
    return order, inv


@functools.lru_cache(maxsize=64)
def _perm_index(length: int, ring: int, device: torch.device):
    order, inv = zigzag_perm(length, ring)
    return (torch.as_tensor(order, device=device),
            torch.as_tensor(inv, device=device))


# ---------------------------------------------------------------------------
# online-softmax state algebra (the merge the flash kernel does per K tile,
# lifted to whole per-hop states), in f32
# ---------------------------------------------------------------------------

def _as_state(o, m, l):
    """(normalised o, m, l) -> the unnormalised (m, l, acc) carry."""
    return m, l, o.float() * l[..., None]


def _merge(carry, upd):
    m, l, acc = carry
    mu, lu, accu = upd
    m_new = torch.maximum(m, mu)
    a = torch.exp(m - m_new)
    b = torch.exp(mu - m_new)
    return (m_new, l * a + lu * b,
            acc * a[..., None] + accu * b[..., None])


def _state_fn(plane: str, block_q, block_k):
    """Per-shard flash dispatch with the chip plane pinned."""
    def state(q, k, v, *, causal):
        o, m, l = registry.dispatch("flash_attention_state", q, k, v,
                                    causal=causal, block_q=block_q,
                                    block_k=block_k, variant=plane)
        return _as_state(o, m, l)
    return state


def _hop_pieces(h: int, r: int, n: int, *, causal: bool, zigzag: bool):
    """The (q rows, visiting keys, causal) pieces rank ``r`` computes at
    hop ``h``, as slices of its ``n`` rows and of the visiting panel's
    ``n`` keys (the panel started on rank ``(r - h) mod W``; ``h <= r`` is
    an earlier one).  The forward and the backward walk the same pieces."""
    every, lo, hi = slice(0, n), slice(0, n // 2), slice(n // 2, n)
    if not causal:
        return [(every, every, False)]
    if not zigzag:
        if h == 0:
            return [(every, every, True)]
        return [(every, every, False)] if h <= r else []
    if h == 0:
        return [(lo, lo, True), (hi, lo, False), (hi, hi, True)]
    if h <= r:                      # k_lo visible to every row
        return [(every, lo, False)]
    return [(hi, every, False)]     # q_hi sees the whole panel


def _merge_rows(carry, upd, rows: slice, n: int):
    """``upd`` merged into rows ``rows`` of the (m, l, acc) carry of ``n``
    rows; a fresh carry is empty (m = NEG_INF, l = 0), which the first
    merge into a row replaces bit for bit."""
    if carry is None:
        m, l, acc = upd
        shape = m.shape[:2] + (n,)
        carry = (torch.full(shape, fa_k.NEG_INF, device=m.device),
                 torch.zeros(shape, device=m.device),
                 acc.new_zeros(shape + acc.shape[3:]))
    part = _merge(tuple(x[:, :, rows] for x in carry), upd)
    for x, y in zip(carry, part):
        x[:, :, rows] = y
    return carry


def _ring_forward(plan: RingPlan, ql, kl, vl, *, causal: bool,
                  zigzag: bool, state):
    """This rank's output rows and their log-sum-exp over every key: hop 0
    on its own panel, then ``W - 1`` rotations, normalised at the end."""
    W, r, n = plan.size, plan.ring_index(), ql.shape[2]
    carry = None
    kv = torch.stack((kl, vl))          # K and V travel together
    for h in range(W):
        if h:
            kv = plan.shift(kv)
        for rows, keys, c in _hop_pieces(h, r, n, causal=causal,
                                         zigzag=zigzag):
            st = state(ql[:, :, rows], kv[0][:, :, keys], kv[1][:, :, keys],
                       causal=c)
            carry = _merge_rows(carry, st, rows, n)
    m, l, acc = carry
    o = (acc / l.clamp_min(1e-30)[..., None]).to(ql.dtype)
    return o, fa_k.softmax_lse(m, l)


def _piece_grads(q, k, v, o, do, lse, delta, *, causal: bool, block_q,
                 block_k, kernels: bool):
    """(dq, dk, dv) of one piece from the global ``lse`` and ``delta`` of
    its rows: the backward kernels over the layout the piece's forward
    walked (a causal half-block pair over ``causal_layout``, a full pair
    over the all-live grid), or their plain version."""
    from repro_torch.kernels.ops import _fa_blocks
    from repro_torch.sparse.maskcompiler import causal_layout, grid_layout

    lq, lk = q.shape[2], k.shape[2]
    bq, bk = _fa_blocks(lq, lk, block_q, block_k)
    layout = causal_layout(lq, lk, bq, bk) if causal \
        else grid_layout(lq, lk, bq, bk, False)
    scale = q.shape[3] ** -0.5
    if not kernels:
        return fa_k.flash_attention_tiles_bwd_plain(q, k, v, o, lse, do,
                                                    layout, scale=scale)
    q, k, v, do, lse, delta = (t.contiguous()
                               for t in (q, k, v, do, lse, delta))
    dk, dv = fa_k.fa_bwd_dkdv(q, k, v, do, lse, delta, layout, scale)
    return fa_k.fa_bwd_dq(q, k, v, do, lse, delta, layout, scale), dk, dv


def _ring_backward(plan: RingPlan, ql, kl, vl, o, lse, do, *, causal: bool,
                   zigzag: bool, block_q, block_k, kernels: bool):
    """dq, dk, dv of this rank's shards in the global-lse form: ``D =
    rowsum(dO o)`` once, then per hop the pieces the forward walked, each
    from the global ``lse``.  dQ accumulates here in f32; dK and dV (f32)
    travel with their panel and come home after the last hop, one more
    rotation (the transpose of the forward's)."""
    W, r, n = plan.size, plan.ring_index(), ql.shape[2]
    delta = fa_k.fa_bwd_delta(o, do) if kernels else None
    dq = torch.zeros(ql.shape, dtype=torch.float32, device=ql.device)
    kv = torch.stack((kl, vl))
    dkv = torch.zeros(kv.shape, dtype=torch.float32, device=kv.device)
    for h in range(W):
        if h:
            kv, dkv = plan.shift(kv), plan.shift(dkv)
        for rows, keys, c in _hop_pieces(h, r, n, causal=causal,
                                         zigzag=zigzag):
            gq, gk, gv = _piece_grads(
                ql[:, :, rows], kv[0][:, :, keys], kv[1][:, :, keys],
                o[:, :, rows], do[:, :, rows], lse[:, :, rows],
                None if delta is None else delta[:, :, rows], causal=c,
                block_q=block_q, block_k=block_k, kernels=kernels)
            dq[:, :, rows] += gq.float()
            dkv[0][:, :, keys] += gk.float()
            dkv[1][:, :, keys] += gv.float()
    dkv = plan.shift(dkv)               # home: this rank's own panel
    return dq.to(ql.dtype), dkv[0].to(kl.dtype), dkv[1].to(vl.dtype)


class _RingAttention(torch.autograd.Function):
    """The ring over this rank's shards (q rows, its K/V panel), with the
    backward of :func:`_ring_backward`; saves the shards, o and the global
    lse."""

    @staticmethod
    def forward(ctx, ql, kl, vl, plan, causal, zigzag, plane, block_q,
                block_k):
        o, lse = _ring_forward(plan, ql, kl, vl, causal=causal,
                               zigzag=zigzag,
                               state=_state_fn(plane, block_q, block_k))
        ctx.save_for_backward(ql, kl, vl, o, lse)
        ctx.args = (plan, causal, zigzag, block_q, block_k,
                    plane == "cuda" and not _lib.on_host(ql, kl, vl))
        return o

    @staticmethod
    def backward(ctx, do):
        ql, kl, vl, o, lse = ctx.saved_tensors
        plan, causal, zigzag, block_q, block_k, kernels = ctx.args
        dq, dk, dv = _ring_backward(plan, ql, kl, vl, o, lse, do,
                                    causal=causal, zigzag=zigzag,
                                    block_q=block_q, block_k=block_k,
                                    kernels=kernels)
        return dq, dk, dv, None, None, None, None, None, None


class _AllToAll(torch.autograd.Function):
    """The ring's tiled all-to-all; its transpose swaps the dims."""

    @staticmethod
    def forward(ctx, x, plan, split_dim, concat_dim):
        ctx.args = (plan, split_dim, concat_dim)
        return plan.all_to_all(x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        plan, split_dim, concat_dim = ctx.args
        return plan.all_to_all(g, concat_dim, split_dim), None, None, None


class _OwnTile(torch.autograd.Function):
    """This ring position's tile of ``dim`` of a tensor every rank holds
    whole; its transpose all-gathers the tiles' gradients, so the whole
    tensor's gradient is whole on every rank."""

    @staticmethod
    def forward(ctx, x, plan, dim):
        ctx.args = (plan, dim)
        n = x.shape[dim] // plan.size
        return x.narrow(dim, plan.ring_index() * n, n)

    @staticmethod
    def backward(ctx, g):
        plan, dim = ctx.args
        return plan.all_gather(g.contiguous(), dim), None, None


class _Gather(torch.autograd.Function):
    """The ring's tiles of ``dim`` concatenated on every rank; its
    transpose keeps this position's tile of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, plan, dim):
        ctx.args = (plan, dim)
        return plan.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        plan, dim = ctx.args
        n = g.shape[dim] // plan.size
        return g.narrow(dim, plan.ring_index() * n, n), None, None


def ring_attention(q, k, v, *, causal: bool = True, mask=None, block_q=None,
                   block_k=None, order: Optional[str] = None):
    """Sequence-parallel attention over the ambient mesh's ring.

    ``order`` picks the sequence-block layout: 'zigzag' (default for
    causal: balanced masking) or 'contiguous' (default for full attention,
    which has no mask to balance).  ``block_q``/``block_k`` pin the
    per-shard kernel tiles, as on chip.  ``mask`` is honoured only when
    trivially dense (it lowers to the causal flag).

    Outside :func:`~repro_torch.distributed.sharding.sharded_rows` every
    rank of the ring calls it with the same whole q, k and v and gets the
    whole output (and, differentiated, the whole gradients).  Inside it
    (the mesh trainer), each rank holds its own rows of the batch, as the
    reference's batch sharding over the same pod x data axes: one
    all-to-all hands every rank all rows of its sequence shard (the
    reference's gather of B before the ring), and one more hands each rank
    back its own rows (the scatter after it); each is the other's
    transpose in the backward."""
    if mask is not None:
        if not mask.trivial_dense:
            raise ValueError(
                "ring attention only takes trivially-dense masks (plain "
                "causal); window/global/block specs run the chip "
                "block-sparse kernel")
        causal = mask.causal
    plan = ambient_ring_plan()
    if plan is None:
        raise RuntimeError(
            "ring attention invoked without an ambient O3/O4 mesh carrying "
            "a batch-role (pod/data) axis; enter use_level(O3) first")
    W = plan.size
    L = q.shape[2]
    if order is None:
        order = "zigzag" if causal else "contiguous"
    if order not in ("zigzag", "contiguous"):
        raise ValueError(f"unknown ring ordering {order!r}; choose "
                         "'zigzag' or 'contiguous'")
    zigzag = order == "zigzag" and causal   # full attention: no imbalance
    need = 2 * W if zigzag else W
    if L % need != 0:
        raise ValueError(
            f"sequence length {L} does not split into {need} "
            f"{'half-' if zigzag else ''}blocks for a ring of {W}")
    rows = sharding.rows_plan()
    if rows is not None and (rows.mesh is not plan.mesh
                             or rows.batch_axes != plan.axes):
        raise ValueError(
            f"ring attention over {plan.axes} with the rows sharded over "
            f"{rows.batch_axes} of another mesh: run the step under "
            f"use_level on the trainer's mesh")
    plane = registry.resolve_backend(q, k, v)
    hq, hk = q.shape[1], k.shape[1]
    qkv = torch.cat([q, k, v], dim=1)   # one collective for the three
    if zigzag:
        order_t, inv_t = _perm_index(L, W, q.device)
        qkv = qkv.index_select(2, order_t)
    if rows is None:
        mine = _OwnTile.apply(qkv, plan, 2)
    else:
        mine = _AllToAll.apply(qkv, plan, 2, 0)
    ql, kl, vl = mine.split([hq, hk, hk], dim=1)
    out = _RingAttention.apply(ql, kl, vl, plan, causal, zigzag, plane,
                               block_q, block_k)
    if rows is None:
        out = _Gather.apply(out, plan, 2)
    else:
        out = _AllToAll.apply(out, plan, 0, 2)
    return out.index_select(2, inv_t) if zigzag else out


# ---------------------------------------------------------------------------
# registration: the mesh-scoped flash variant
# ---------------------------------------------------------------------------

def _ring_available(ctx: registry.SelectContext) -> bool:
    return (ctx.topology is not None and
            ring_plan(ctx.mesh, ctx.topology).size > 1)


def _ring_accepts(q, k, v, *, causal=True, mask=None, block_q=None,
                  block_k=None):
    """Self-attention panels whose length the ring divides: 2W half-blocks
    when causal (the zig-zag layout), W blocks when full.  Rich masks are
    chip-scoped; trivially-dense ones lower to the causal flag."""
    if mask is not None:
        if not mask.trivial_dense:
            return False
        causal = mask.causal
    plan = ambient_ring_plan()
    if plan is None or plan.size <= 1:
        return False
    if getattr(q, "ndim", 0) != 4 or getattr(k, "ndim", 0) != 4:
        return False
    if q.shape[2] != k.shape[2] or q.shape[1] % k.shape[1] != 0:
        return False
    need = 2 * plan.size if causal else plan.size
    return q.shape[2] % need == 0


registry.register(
    "flash_attention", "ring", ring_attention, scope="mesh", cost=1.0,
    available=_ring_available, accepts=_ring_accepts,
    doc="sequence-parallel ring attention: Q/K/V shard L over pod x data, "
        "K/V panels rotate one neighbour a hop, per-shard flash state "
        "merges across hops; zig-zag causal balancing")


# ---------------------------------------------------------------------------
# decode over the ring-striped page pool (DESIGN.md §13; the pool's layout
# is serve/kvcache.py's)
# ---------------------------------------------------------------------------

def paged_ring_attention(q, kpages, vpages, table, lens):
    """Decode attention over the ring-striped page pool.  ``kpages`` /
    ``vpages`` are this rank's shard of the pool (``P / W`` pages, global
    ids from ``r P / W``); ``q`` (B, H, 1, d), ``table`` (B, n) of global
    page ids and ``lens`` (B,) are whole on every rank.  Per-shard
    prefix-masked flash partials merge after one all-gather: allclose (not
    bitwise) to the chip gather variant, since the merge reassociates the
    sums, and the same bits on every rank."""
    plan = ambient_ring_plan()
    if plan is None:
        raise RuntimeError(
            "paged ring attention invoked without an ambient O3/O4 mesh "
            "carrying a batch-role (pod/data) axis; enter use_level(O3) "
            "first")
    plane = registry.resolve_backend(q)
    kg, vg, llen = shard_view(kpages, vpages, table, lens,
                              plan.ring_index(), plan.size)
    o, m, l = registry.dispatch("flash_attention_state", q, kg, vg,
                                causal=False, kv_len=llen, variant=plane)
    # The reference's pmax, then psum, written as one all-gather of every
    # shard's (m, l, o) and the same merge on every rank, in ring order:
    # one collective in place of two, and the same bits on every rank by
    # construction.  A shard with no live key carries m == NEG_INF, and its
    # weight exp(m - mg) underflows to exactly 0.
    st = torch.cat([m[..., None], l[..., None], o.float()], dim=-1)
    every = plan.all_gather(st[None], dim=0)         # (W, B, H, 1, 2 + d)
    m_all, l_all, o_all = every[..., 0], every[..., 1], every[..., 2:]
    w = torch.exp(m_all - m_all.amax(dim=0)) * l_all
    out = (o_all * w[..., None]).sum(dim=0) \
        / w.sum(dim=0).clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


def _paged_ring_accepts(q, kpages, vpages, table, lens):
    plan = ambient_ring_plan()
    if plan is None or plan.size <= 1:
        return False
    return (table.shape[1] % plan.size == 0
            and q.shape[1] % kpages.shape[1] == 0)


registry.register(
    "paged_attention", "ring", paged_ring_attention, scope="mesh", cost=1.0,
    available=_ring_available, accepts=_paged_ring_accepts,
    doc="decode over the ring-striped page pool: each rank holds its P/W "
        "pages, per-shard prefix-masked flash state, merged after one "
        "all-gather (the rotation schedule's reduction dual, DESIGN.md "
        "§13)")
