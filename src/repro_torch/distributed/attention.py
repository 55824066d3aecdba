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
variant's shape and call sites never change.  The reference's ``lax.cond``
on the ring index is a plain Python ``if`` on this rank's
:meth:`RingPlan.ring_index`.

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

The variant registers as ``flash_attention``/``ring`` with
``scope='mesh'`` and degrades to the chip kernel as the reference's does:
no ambient mesh, a 1-wide ring, or a length the ring does not divide all
select the chip variant, and an explicit ``variant=`` still pins.  Rich
``MaskSpec`` masks stay chip-scoped.  The port's state kernels have no
backward through ``(m, l)``, so ring attention on tensors that require
grad raises (ROADMAP queue 1 item 10b-ii).

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
from repro_torch.distributed.collectives import (RingPlan, ambient_ring_plan,
                                                 ring_plan)
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


def _concat(lo, hi):
    """Concatenate two half-block states along the sequence axis."""
    return tuple(torch.cat([a, b], dim=2) for a, b in zip(lo, hi))


def _split(st, half: int):
    return (tuple(x[:, :, :half] for x in st),
            tuple(x[:, :, half:] for x in st))


def _state_fn(plane: str, block_q, block_k):
    """Per-shard flash dispatch with the chip plane pinned."""
    def state(q, k, v, *, causal):
        o, m, l = registry.dispatch("flash_attention_state", q, k, v,
                                    causal=causal, block_q=block_q,
                                    block_k=block_k, variant=plane)
        return _as_state(o, m, l)
    return state


def _ring_run(plan: RingPlan, ql, kl, vl, *, causal: bool, zigzag: bool,
              state) -> torch.Tensor:
    """This rank's output rows: hop 0 on its own panel, then ``W - 1``
    rotations, normalised at the end."""
    W, r = plan.size, plan.ring_index()
    half = ql.shape[2] // 2
    if not causal:
        st = state(ql, kl, vl, causal=False)
    elif not zigzag:
        st = state(ql, kl, vl, causal=True)
    else:
        q_lo, q_hi = ql[:, :, :half], ql[:, :, half:]
        k_lo, k_hi = kl[:, :, :half], kl[:, :, half:]
        v_lo, v_hi = vl[:, :, :half], vl[:, :, half:]
        st_lo = state(q_lo, k_lo, v_lo, causal=True)
        st_hi = _merge(state(q_hi, k_lo, v_lo, causal=False),
                       state(q_hi, k_hi, v_hi, causal=True))
        st = _concat(st_lo, st_hi)

    kv = torch.stack((kl, vl))
    for h in range(1, W):
        # K and V travel together: one rotation a hop
        kv = plan.shift(kv)
        kl, vl = kv[0], kv[1]
        # the visiting panel started on rank j = (r - h) mod W; h <= r
        # is j < r
        if not causal:
            st = _merge(st, state(ql, kl, vl, causal=False))
        elif not zigzag:
            if h <= r:              # earlier blocks are wholly visible
                st = _merge(st, state(ql, kl, vl, causal=False))
        elif h <= r:                # k_lo visible to every row
            st = _merge(st, state(ql, kl[:, :, :half], vl[:, :, :half],
                                  causal=False))
        else:                       # q_hi sees the whole panel
            lo, hi = _split(st, half)
            hi = _merge(hi, state(ql[:, :, half:], kl, vl, causal=False))
            st = _concat(lo, hi)

    m, l, acc = st
    return (acc / l.clamp_min(1e-30)[..., None]).to(ql.dtype)


def ring_attention(q, k, v, *, causal: bool = True, mask=None, block_q=None,
                   block_k=None, order: Optional[str] = None):
    """Sequence-parallel attention over the ambient mesh's ring.

    ``order`` picks the sequence-block layout: 'zigzag' (default for
    causal: balanced masking) or 'contiguous' (default for full attention,
    which has no mask to balance).  ``block_q``/``block_k`` pin the
    per-shard kernel tiles, as on chip.  ``mask`` is honoured only when
    trivially dense (it lowers to the causal flag).  Every rank of the
    ring calls it with the same whole q, k and v and gets the whole
    output."""
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "ring attention has no backward: the port's state kernels do "
            "not differentiate through (m, l) (ROADMAP queue 1 item "
            "10b-ii); call it under torch.no_grad()")
    plane = registry.resolve_backend(q, k, v)
    n, r = L // W, plan.ring_index()
    if zigzag:
        order_t, inv_t = _perm_index(L, W, q.device)
        mine = order_t[r * n:(r + 1) * n]
        ql, kl, vl = (t.index_select(2, mine) for t in (q, k, v))
    else:
        ql, kl, vl = (t.narrow(2, r * n, n) for t in (q, k, v))
    out = _ring_run(plan, ql, kl, vl, causal=causal, zigzag=zigzag,
                    state=_state_fn(plane, block_q, block_k))
    out = plan.all_gather(out, dim=2)
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
