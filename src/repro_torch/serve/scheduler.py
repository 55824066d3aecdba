"""Admission + page accounting for the continuous-batching engine
(counterpart of ``repro.serve.scheduler``, without its metrics; DESIGN.md
§13).

The scheduler is pure host-side bookkeeping: a bounded FIFO admission
queue, the slot free list, and per-residue page free lists mirroring the
device-side page table.  Its state machine per request:

    QUEUED    submitted, waiting for a slot + pages
    PREFILL   admitted; prompt streams into the paged cache one chunk per
              engine iteration, interleaved with decode
    DECODE    prompt done; generates one token per decode step
    DONE      hit EOS or its token budget — recycle() returns the pages

Admission reserves a request's **full page span up front** —
``ceil((prompt + max_new) / page_size)`` pages — so decode never allocates
mid-stream and a slot can never strand half-generated work on an empty
pool (eviction/restart is future work; the reservation makes it
unnecessary).  Pages are drawn per residue class: table position ``p``
must hold a page owned by ring shard ``p % ring`` (the striped layout in
``kvcache.py``), so the free list is ``ring`` independent pools and
``can_admit`` checks each class it needs.

The scheduler's ``table``/``lens`` numpy arrays mirror the device tensors
in lockstep: the engine copies them into the same device buffers after
admit/recycle events (contents only, never shapes) and advances ``lens``
host-side with the same integer updates the device applies.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.serve.kvcache import PagedCacheSpec

__all__ = ["Request", "Scheduler"]


@dataclasses.dataclass
class Request:
    """One generation request and its host-side progress."""
    rid: int
    prompt: np.ndarray               # (S,) int32
    max_new: int
    # runtime (engine-managed)
    slot: int = -1
    prefilled: int = 0               # prompt tokens already in the cache
    generated: Optional[list] = None
    submit_t: float = 0.0            # wall-clock bookkeeping
    first_token_t: float = 0.0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def total_tokens(self) -> int:
        return self.prompt_len + self.max_new


class Scheduler:
    def __init__(self, spec: PagedCacheSpec, queue_depth: int):
        self.spec = spec
        self.queue_depth = queue_depth
        self.queue: deque[Request] = deque()
        self.free_slots = list(range(spec.num_slots))
        # per-residue free pools; global page 0 (trash) is never handed out
        self.free_pages: list[list[int]] = []
        for r in range(spec.ring):
            lo, hi = spec.shard_range(r)
            ids = [g for g in range(lo, hi) if g != 0]
            self.free_pages.append(ids)
        self.table = np.zeros((spec.num_slots, spec.pages_per_slot),
                              np.int32)
        self.lens = np.zeros((spec.num_slots,), np.int32)
        self.running: dict[int, Request] = {}      # slot -> request

    # -- queue --------------------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Enqueue; False when the admission queue is at depth."""
        if len(self.queue) >= self.queue_depth:
            return False
        if req.total_tokens > self.spec.slot_capacity:
            raise ValueError(
                f"request {req.rid}: {req.total_tokens} tokens exceed the "
                f"slot capacity {self.spec.slot_capacity}")
        self.queue.append(req)
        return True

    def _pages_by_residue(self, npages: int) -> list[int]:
        """How many pages of each residue class positions [0, npages) use."""
        w = self.spec.ring
        return [npages // w + (1 if r < npages % w else 0) for r in range(w)]

    def can_admit(self, req: Request) -> bool:
        if not self.free_slots:
            return False
        need = self._pages_by_residue(self.spec.pages_for(req.total_tokens))
        return all(len(pool) >= n
                   for pool, n in zip(self.free_pages, need))

    def admit_next(self) -> Optional[Request]:
        """Admit the queue head if a slot + its full page span are free.
        FIFO — a large head request blocks the queue rather than starving
        forever behind later small ones."""
        if not self.queue or not self.can_admit(self.queue[0]):
            return None
        req = self.queue.popleft()
        slot = self.free_slots.pop(0)
        npages = self.spec.pages_for(req.total_tokens)
        for p in range(npages):
            r = self.spec.owner(p)
            self.table[slot, p] = self.free_pages[r].pop()
        self.lens[slot] = 0
        req.slot = slot
        req.prefilled = 0
        req.generated = []
        self.running[slot] = req
        return req

    def recycle(self, slot: int) -> Request:
        """Return a finished slot's pages to the free pools and free the
        slot; the engine re-uploads table/lens after this (contents only —
        the next admission reuses the same device buffers)."""
        req = self.running.pop(slot)
        for p in range(self.spec.pages_per_slot):
            g = int(self.table[slot, p])
            if g == 0:
                break                 # allocation is a prefix of the row
            self.free_pages[self.spec.owner(p)].append(g)
            self.table[slot, p] = 0
        self.lens[slot] = 0
        self.free_slots.append(slot)
        return req

    # -- introspection ------------------------------------------------------

    @property
    def num_free_pages(self) -> int:
        return sum(len(p) for p in self.free_pages)

    @property
    def occupancy(self) -> float:
        return len(self.running) / self.spec.num_slots
