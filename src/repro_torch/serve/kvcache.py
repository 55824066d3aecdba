"""Paged KV cache for the continuous-batching serve tier (counterpart of
``repro.serve.kvcache``; DESIGN.md §13).

The fixed-slot engine gives every slot its worst-case ``max_len`` K/V
strip, so one long request sizes the whole batch.  Here the cache is one
pool of fixed-size **pages** (``(num_layers, num_pages, kv_heads,
page_size, head_dim)``) and each slot owns a row of a device-side **page
table** (``(num_slots, pages_per_slot)`` int32 of global page ids).  A
finished slot's pages return to the free list and the next request is
admitted by rewriting table/lens *contents*, never shapes, so the decode
step's inputs keep their shapes and buffers for the life of an engine.

Global page 0 is the reserved **trash page**: table value 0 means
"unallocated", and every masked write (frozen slots, prefill padding)
targets page 0, keeping the decode step branch-free.

Under an O3/O4 mesh the pool is **striped over the ring** (the ring plan's
W ranks): table position ``p`` is owned by ring shard ``p % W``, shard
``r`` holds global page ids ``[r P/W, (r+1) P/W)``, and each rank
allocates only its own ``P / W`` pages (:func:`init_cache_state`), with the
table and lens whole on every rank.  This module alone knows that layout:
:func:`local_pages` and :func:`shard_positions` map global ids to a shard's
local ones, :func:`write` lands K/V only in the pages this rank owns,
:func:`gather_row` assembles one slot's row over the ring, and
:func:`shard_view` is a shard's prefix-valid view of every slot for decode.
On one card ``ring = 1`` and every position is residue 0.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.containers import resolve_device

__all__ = ["PagedCacheSpec", "make_spec", "init_cache_state", "local_pages",
           "shard_positions", "pool_ring", "write", "gather_row",
           "shard_view"]


@dataclasses.dataclass(frozen=True)
class PagedCacheSpec:
    """Static shape of a paged cache (hashable)."""
    num_slots: int           # decode batch width B
    page_size: int           # tokens per page
    pages_per_slot: int      # table row width n (slot capacity = n · ps)
    num_pages: int           # pool size P, including the trash page
    ring: int                # ring width W the pool is striped over

    @property
    def slot_capacity(self) -> int:
        """Max tokens one slot can hold."""
        return self.pages_per_slot * self.page_size

    @property
    def pages_per_shard(self) -> int:
        return self.num_pages // self.ring

    def pages_for(self, tokens: int) -> int:
        """Pages a request of ``tokens`` total length needs."""
        return -(-tokens // self.page_size)

    def owner(self, position: int) -> int:
        """The ring shard owning table position ``position`` (striped)."""
        return position % self.ring

    def shard_range(self, r: int) -> tuple[int, int]:
        """Global page-id range [lo, hi) owned by ring shard ``r``."""
        return r * self.pages_per_shard, (r + 1) * self.pages_per_shard


def make_spec(cfg, *, num_slots: int, max_tokens: int,
              num_pages: int | None = None, ring: int = 1) -> PagedCacheSpec:
    """Build the cache spec for ``cfg`` (page size from
    ``cfg.serve_page_size``, clamped to ``max_tokens``).

    ``max_tokens`` bounds one slot (prompt + generation) and sizes the
    table row; ``num_pages`` defaults to enough pages for every slot at
    full capacity plus the trash page — callers shrink it to oversubscribe
    the pool (that is the point of paging).  Both ``pages_per_slot`` and
    ``num_pages`` round up to ring multiples so the striped table reshape
    and the pool sharding stay exact."""
    ps = min(cfg.serve_page_size, max_tokens)
    n = -(-max_tokens // ps)
    n = -(-n // ring) * ring                        # table row: ring multiple
    if num_pages is None:
        num_pages = num_slots * n + 1               # full capacity + trash
    p = -(-num_pages // ring) * ring                # pool: ring multiple
    if p // ring < 1 + n // ring:
        # shard 0 loses one page to trash; every residue class must still
        # be able to serve at least one full slot
        p = ring * (1 + n // ring + 1)
    return PagedCacheSpec(num_slots=num_slots, page_size=ps,
                          pages_per_slot=n, num_pages=p, ring=ring)


def init_cache_state(cfg, spec: PagedCacheSpec, dtype=None, *,
                     device=None) -> dict:
    """Tensors of the paged decode state on ``device`` (the card unless the
    caller names another): the per-layer page pools, the page table
    (all-trash), and the per-slot lengths (all zero).  The pools hold this
    rank's ``spec.pages_per_shard`` pages (all ``num_pages`` at ring 1)."""
    dev = resolve_device(device)
    dtype = dtype or cfg.act_dtype
    shape = (cfg.num_layers, spec.pages_per_shard, cfg.num_kv_heads,
             spec.page_size, cfg.head_dim)
    return {
        "kpages": torch.zeros(shape, dtype=dtype, device=dev),
        "vpages": torch.zeros(shape, dtype=dtype, device=dev),
        "table": torch.zeros((spec.num_slots, spec.pages_per_slot),
                             dtype=torch.int32, device=dev),
        "lens": torch.zeros((spec.num_slots,), dtype=torch.int32,
                            device=dev),
    }


def local_pages(ids: torch.Tensor, rank: int, pages_per_shard: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(local, mine)`` for global page ids ``ids`` on ring shard ``rank``
    of a striped pool: ``mine`` marks the ids this shard holds, and
    ``local`` their index in its pool (foreign ids clamped into range, so
    that a gather stays in bounds; callers mask those off)."""
    loc = ids.long() - rank * pages_per_shard
    mine = (loc >= 0) & (loc < pages_per_shard)
    return loc.clamp(0, pages_per_shard - 1), mine


def shard_positions(table: torch.Tensor, rank: int, ring: int,
                    pages_per_shard: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`local_pages` of the table positions ring shard ``rank`` owns
    (``p % ring == rank``), in ascending order: ``table`` (..., n) of
    global ids gives (..., n / ring)."""
    ids = table.reshape(*table.shape[:-1], table.shape[-1] // ring,
                        ring)[..., rank]
    return local_pages(ids, rank, pages_per_shard)


def pool_ring():
    """The ambient ring plan when the page pools are striped over the ranks
    of an O3/O4 mesh, else None (one card)."""
    from repro_torch.core import execlevel

    if not execlevel.current().is_distributed:
        return None
    from repro_torch.distributed.collectives import ambient_ring_plan

    return ambient_ring_plan()


def write(kpages, vpages, page, off, k_new, v_new, plan=None) -> None:
    """Write ``k_new``/``v_new`` (N, hk, hd) at global pages ``page`` (N,),
    offsets ``off`` (N,), in place: with no ``plan`` (one card) as is; on
    the pool striped over ``plan``'s ring only the entries whose page this
    rank owns."""
    page, off = page.long(), off.long()
    if plan is None:
        kpages[page, :, off, :] = k_new.to(kpages.dtype)
        vpages[page, :, off, :] = v_new.to(vpages.dtype)
        return
    loc, mine = local_pages(page, plan.ring_index(), kpages.shape[0])
    # The write keeps its entry count, without a host sync (every index is
    # a tensor): each entry this rank does not own repeats the first owned
    # entry's write (same place, same value), so no two writes to one place
    # differ; with none owned, every entry writes back what is there.
    j = torch.argmax(mine.to(torch.int32)).reshape(1)
    at_page = torch.where(mine, loc, loc[j])
    at_off = torch.where(mine, off, off[j])
    for pool, new in ((kpages, k_new), (vpages, v_new)):
        new = new.to(pool.dtype)
        first = torch.where(mine[j][:, None, None], new[j],
                            pool[loc[j], :, off[j], :])    # (1, hk, hd)
        pool[at_page, :, at_off, :] = torch.where(mine[:, None, None], new,
                                                  first)


def gather_row(pools: tuple, row: torch.Tensor, plan) -> tuple:
    """One slot's dense views (hk, n ps, d) of ``pools`` (this rank's
    shards of pools striped over ``plan``'s ring, gathered together) over
    its table row ``row`` (n,) of global ids, in table-position order:
    each rank takes the positions it owns, and one all-gather over the
    ring assembles the row, as the reference's partitioner gathers
    ``pages[table]`` on a sharded pool.  Unallocated positions hold
    garbage; the caller masks them off."""
    W, r = plan.size, plan.ring_index()
    n = row.shape[0]
    local, _ = shard_positions(row, r, W, pools[0].shape[0])
    mine = torch.stack([p[local] for p in pools])   # (k, n/W, hk, ps, d)
    every = plan.all_gather(mine[None], dim=0)      # (W, k, n/W, ...)
    _, hk, ps, d = pools[0].shape
    # position j W + r' comes from rank r' at local index j
    views = every.permute(1, 2, 0, 3, 4, 5).reshape(len(pools), n, hk, ps, d)
    return tuple(views.transpose(1, 2).reshape(len(pools), hk, n * ps, d))


def shard_view(kpages, vpages, table, lens, rank: int, ring: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ring shard ``rank``'s view of every slot for decode: ``(k, v,
    kv_len)`` with k, v (B, hk, n / ring * ps, d) gathered from this
    shard's pools over the table positions it owns, and kv_len (B,) int32
    the valid keys among them.  Position ``j ring + rank`` holds tokens
    ``[pos ps, pos ps + ps)``; allocation fills positions in order, so the
    view is prefix-valid.  Trash-0 and foreign entries clip into range and
    lie past kv_len."""
    b, n = table.shape
    ps, nloc = kpages.shape[2], n // ring
    local, _ = shard_positions(table, rank, ring, kpages.shape[0])
    pstart = (torch.arange(nloc, device=lens.device) * ring + rank) * ps
    fill = (lens.long()[:, None] - pstart[None, :]).clamp(0, ps)
    hk, d = kpages.shape[1], kpages.shape[3]
    return (kpages[local].transpose(1, 2).reshape(b, hk, nloc * ps, d),
            vpages[local].transpose(1, 2).reshape(b, hk, nloc * ps, d),
            fill.sum(dim=1).to(torch.int32))
