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

The spec keeps the JAX package's ring striping fields (table position
``p`` owned by ring shard ``p % ring``); on one chip ``ring = 1`` and every
position is residue 0.  Ring-sharded decode is the LM half of mesh scope
(ROADMAP queue 1 item 10b).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.containers import resolve_device

__all__ = ["PagedCacheSpec", "make_spec", "init_cache_state"]


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
    (all-trash), and the per-slot lengths (all zero)."""
    dev = resolve_device(device)
    dtype = dtype or cfg.act_dtype
    shape = (cfg.num_layers, spec.num_pages, cfg.num_kv_heads,
             spec.page_size, cfg.head_dim)
    return {
        "kpages": torch.zeros(shape, dtype=dtype, device=dev),
        "vpages": torch.zeros(shape, dtype=dtype, device=dev),
        "table": torch.zeros((spec.num_slots, spec.pages_per_slot),
                             dtype=torch.int32, device=dev),
        "lens": torch.zeros((spec.num_slots,), dtype=torch.int32,
                            device=dev),
    }
