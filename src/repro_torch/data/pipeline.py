"""Data pipeline: deterministic, shardable, restart-safe token streams
(counterpart of ``repro.data.pipeline``).

Two sources:
  * ``SyntheticLM``   — seeded random tokens (benchmarks, smoke tests);
  * ``ByteCorpus``    — any bytes blob tokenized at the byte level.

Batch ``i`` is a pure function of ``(seed, i)``, drawn with numpy exactly
as the JAX package draws it (``_seed_for`` is a copy of its), so batch
``i`` is the same array in both packages and a restarted job resumes
mid-epoch with no state beyond the step counter.  ``host_slice`` takes
one data-loading host's rows; ``prefetch`` keeps ``size`` batches on
their way to the device ahead of the consumer.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Any, Iterator, Optional

import numpy as np
import torch

from repro_torch.core.containers import resolve_device

__all__ = ["SyntheticLM", "ByteCorpus", "host_slice", "prefetch"]

Pytree = Any


def _seed_for(seed: int, index: int) -> np.random.Generator:
    # stable across python versions/hosts (unlike hash())
    h = hashlib.blake2b(f"{seed}:{index}".encode(), digest_size=8)
    return np.random.default_rng(int.from_bytes(h.digest(), "little"))


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """Random-token LM batches; batch i is a pure function of (seed, i)."""
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_len: int = 0
    d_model: int = 0            # only used when frontend_len > 0

    def batch(self, index: int) -> dict[str, np.ndarray]:
        rng = _seed_for(self.seed, index)
        text_len = self.seq_len - self.frontend_len
        toks = rng.integers(0, self.vocab_size,
                            (self.global_batch, text_len + 1), dtype=np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.frontend_len:
            out["frontend_embeds"] = rng.standard_normal(
                (self.global_batch, self.frontend_len, self.d_model)
            ).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1


@dataclasses.dataclass(frozen=True)
class ByteCorpus:
    """Byte-level LM over an in-memory blob; random crops per index."""
    blob: bytes
    seq_len: int
    global_batch: int
    seed: int = 0

    @property
    def vocab_size(self) -> int:
        return 256

    def batch(self, index: int) -> dict[str, np.ndarray]:
        rng = _seed_for(self.seed, index)
        data = np.frombuffer(self.blob, dtype=np.uint8)
        n = len(data) - self.seq_len - 1
        if n <= 0:
            raise ValueError("corpus shorter than seq_len")
        starts = rng.integers(0, n, self.global_batch)
        rows = np.stack([data[s:s + self.seq_len + 1] for s in starts])
        rows = rows.astype(np.int32)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1


def host_slice(batch: dict, host_id: int, num_hosts: int) -> dict:
    """Rows this host is responsible for (strided so reshards are cheap)."""
    return {k: v[host_id::num_hosts] for k, v in batch.items()}


def prefetch(it: Iterator[dict], *, size: int = 2, device_put=None,
             device=None) -> Iterator[dict]:
    """Keeps ``size`` batches in flight.  ``device_put`` moves a batch to
    the device (by default each array becomes a tensor on ``device``, the
    card unless the caller names another)."""
    if device_put is None:
        dev = resolve_device(device)

        def device_put(batch):
            return {k: torch.as_tensor(v).to(dev, non_blocking=True)
                    for k, v in batch.items()}
    buf: collections.deque = collections.deque()
    for batch in it:
        buf.append(device_put(batch))
        if len(buf) >= size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
