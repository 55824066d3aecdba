"""Measured block sizes: a persistent per-(op, shape, dtype) cache of the
blocks a kernel runs at (counterpart of ``repro.core.blocking``, chip
scope).

Block sizes come from, in priority order: explicit per-call pins, the
cache (``results/torch/autotune.json``, path override via
``REPRO_TORCH_AUTOTUNE_CACHE``), and the defaults.  When
``REPRO_TORCH_AUTOTUNE=1`` and the cache has no entry for (op, shape,
dtype), the candidates are measured on the spot with the real arguments
and the winner is persisted: ArBB's "optimise for the target detected at
runtime", made sticky.  Both variables are read once
(:mod:`repro_torch.core.settings`; a change after import takes effect at
``settings.reload()``), so a resolve reads no environment.

The port's own rules (DESIGN.md §11, ROADMAP queue 1 item 8):

* **A block outside the kernel's domain is excluded by rule, never by a
  caught failure.**  ``resolve_blocks`` takes the kernel's stated domain
  (``takes``); candidates outside it are never run, a candidate inside it
  that fails to build or launch raises, and a cache entry outside it
  raises ``ValueError`` naming the file and the key (the reference's
  ``results/autotune.json`` holds Pallas blocks for a TPU, which is why the
  port keeps files of its own).
* **Nothing is measured while a CUDA graph is being captured.**  There a
  resolve of an uncached key returns the defaults and, with autotune on,
  caches them *marked* (``_default``), so that a later resolve outside the
  capture, or :func:`premeasure`, upgrades the entry with a real
  measurement (the reference's "under a trace" case).
* **A cache hit is one dictionary lookup** once its entry has been checked
  against the domain, and so is a miss with autotune off once its defaults
  have been resolved: the serve loop resolves attention blocks on every
  prefill.

Keys carry the scope and mesh, as the reference's do::

    op|dims|dtype|scope|mesh      e.g. flash_attention|b=4,d=128,h=16,
                                       lk=512,lq=512|bfloat16|chip|-

``ambient_scope_key()`` is ``("chip", "-")`` on one card and
``("mesh", <topology.describe()>)`` under an O3/O4 mesh; the memo of
settled answers is keyed by it too.  The port's files hold only five-part
keys, so
the reference's legacy-key upgrade is not ported, nor are
``parse_key``/``pending_defaults``, whose caller (a sweep that upgrades the
entries a capture default-marked) comes with the captured decode step
(ROADMAP queue 1 item 2).  The reference's ``blocked()`` pad-to-block
combinator is not ported either: its Pallas kernels demand block-aligned
shapes, the port's kernels run a short last tile.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable, Hashable, Mapping, Optional, Sequence

import torch

from repro_torch.core import execlevel, settings
from repro_torch.core.topology import topology_of
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

__all__ = ["round_up", "AutotuneCache", "get_cache", "autotune_enabled",
           "ambient_scope_key", "resolve_blocks", "settled", "premeasure",
           "capturing", "PREMEASURE",
           "DEFAULT_CACHE_PATH"]

DEFAULT_CACHE_PATH = settings.DEFAULT_CACHE_PATH


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def ambient_scope_key() -> tuple[str, str]:
    """The (scope, mesh) components of the key right now: ``("chip",
    "-")`` on one card, ``("mesh", "pod2xdata2xmodel1")`` under an ambient
    O3/O4 mesh, so per-shard tuning never aliases chip entries of the same
    local shape."""
    ctx = execlevel.current()
    if not ctx.is_distributed:
        return _CHIP
    return "mesh", topology_of(ctx.mesh).describe()


_CHIP = ("chip", "-")


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (never on a
    host without a card)."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


class AutotuneCache:
    """JSON-backed block-size cache: key -> {dim: block, '_seconds': t}."""

    def __init__(self, path: Optional[str] = None) -> None:
        self.path = path or settings.AUTOTUNE_CACHE
        self._data: Optional[dict[str, dict]] = None
        #: memo (a caller's key for one (op, dims, dtype)) -> blocks of an
        #: entry already checked against its kernel's domain (the hit
        #: path's one lookup, before any key string is built); cleared by
        #: :meth:`put`.
        self._checked: dict[Hashable, dict[str, int]] = {}
        #: memo -> the defaults a key without an entry resolved to with
        #: autotune off (that path's one lookup); cleared by :meth:`put`.
        self._untuned: dict[Hashable, dict[str, int]] = {}
        self._lock = threading.Lock()

    @staticmethod
    def key(op: str, dims: Mapping[str, int], dtype: str,
            scope: str = "chip", mesh: str = "-") -> str:
        shape = ",".join(f"{k}={v}" for k, v in sorted(dims.items()))
        return f"{op}|{shape}|{dtype}|{scope}|{mesh}"

    def _load(self) -> dict[str, dict]:
        if self._data is None:
            try:
                with open(self.path) as f:
                    self._data = json.load(f)
            except (FileNotFoundError, json.JSONDecodeError):
                self._data = {}
        return self._data

    def __len__(self) -> int:
        return len(self._load())

    def lookup(self, key: str) -> Optional[dict[str, int]]:
        """The cached blocks for ``key`` (measurement metadata stripped)."""
        entry = self._load().get(key)
        if entry is None:
            return None
        return {k: int(v) for k, v in entry.items() if not k.startswith("_")}

    def entry(self, key: str) -> Optional[dict]:
        """The raw entry including metadata (``_seconds``, ``_default``)."""
        entry = self._load().get(key)
        return dict(entry) if entry is not None else None

    def put(self, key: str, blocks: Mapping[str, int],
            seconds: Optional[float] = None, default: bool = False) -> None:
        with self._lock:
            data = self._load()
            entry: dict[str, Any] = {k: int(v) for k, v in blocks.items()}
            if seconds is not None:
                entry["_seconds"] = round(seconds, 9)
            if default:
                entry["_default"] = True
            data[key] = entry
            self._checked.clear()
            self._untuned.clear()
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            tmp = f"{self.path}.tmp"
            with open(tmp, "w") as f:
                json.dump(data, f, indent=2, sort_keys=True)
            os.replace(tmp, self.path)


_cache: Optional[AutotuneCache] = None


def get_cache() -> AutotuneCache:
    """The process cache, re-opened if ``REPRO_TORCH_AUTOTUNE_CACHE``
    changed at the last ``settings.reload()`` (lets tests point it at a
    temp file)."""
    global _cache
    path = settings.AUTOTUNE_CACHE
    if _cache is None or _cache.path != path:
        _cache = AutotuneCache(path)
    return _cache


def autotune_enabled() -> bool:
    """``REPRO_TORCH_AUTOTUNE`` as the last ``settings.reload()`` read it."""
    return settings.AUTOTUNE


def settled(op: str, memo: Hashable) -> Optional[dict[str, int]]:
    """The blocks :func:`resolve_blocks` settled for ``memo`` (the
    caller's cheap key for one (op, dims, dtype), as it passed it there)
    when answering again needs no lookup: a cache entry already checked
    against the kernel's domain or, with autotune off, the defaults of a
    key the cache holds no entry for.  Else None.  A caller that resolves
    on every call tries this first and builds its dims only on a None."""
    cache = get_cache()
    if execlevel.current().mesh is not None:    # O3/O4: keyed by the mesh
        sk = ambient_scope_key()
        if sk is not _CHIP:
            memo = (memo, sk)
    hit = cache._checked.get(memo)
    if hit is not None:
        obs_metrics.METRICS.counter(f"blocking.cache_hit.{op}").inc()
        return dict(hit)
    if not autotune_enabled():
        hit = cache._untuned.get(memo)
        if hit is not None:
            obs_metrics.METRICS.counter(f"blocking.cache_miss.{op}").inc()
            return dict(hit)
    return None


def resolve_blocks(
    op: str,
    dims: Mapping[str, int],
    dtype: str,
    defaults: Mapping[str, int],
    candidates: Sequence[Mapping[str, int]] = (),
    measure: Optional[Callable[[Mapping[str, int]], float]] = None,
    takes: Optional[Callable[[Mapping[str, int]], bool]] = None,
    memo: Optional[Hashable] = None,
) -> dict[str, int]:
    """Cache hit > fresh measurement (when enabled and possible) > defaults.

    ``measure(blocks) -> seconds`` runs one candidate; None when timing is
    impossible.  ``takes(blocks) -> bool`` is the kernel's stated domain:
    candidates outside it are never measured, and a cached entry outside
    it raises ``ValueError``.  A measurement that raises propagates: no
    candidate inside the domain is dropped for failing.  ``memo`` is the
    caller's key for :func:`settled` (default: built from the arguments).

    While a CUDA graph is being captured nothing is measured; with
    autotune on, an uncached key then caches the defaults marked
    (``_default``), which a later resolve outside the capture upgrades."""
    if memo is None:
        memo = (op, tuple(dims.items()), dtype)
    hit = settled(op, memo)
    if hit is not None:
        return hit
    cache = get_cache()
    tune = autotune_enabled()
    sk = ambient_scope_key()
    if sk is not _CHIP:
        memo = (memo, sk)
    key = AutotuneCache.key(op, dims, dtype, *sk)
    raw = cache.entry(key)
    can_measure = bool(tune and candidates and measure is not None
                       and not capturing())
    if raw is not None and not (raw.get("_default") and can_measure):
        blocks = {**defaults, **{k: int(v) for k, v in raw.items()
                                 if not k.startswith("_")}}
        if takes is not None and not takes(blocks):
            raise ValueError(
                f"{cache.path}: entry {key!r} holds blocks {blocks} that "
                f"the {op} kernels do not take; delete the entry (or the "
                f"file) and re-measure")
        if not raw.get("_default"):
            cache._checked[memo] = blocks
        obs_metrics.METRICS.counter(f"blocking.cache_hit.{op}").inc()
        return dict(blocks)
    obs_metrics.METRICS.counter(f"blocking.cache_miss.{op}").inc()
    if can_measure:
        best: Optional[dict[str, int]] = None
        best_t = float("inf")
        seen = []
        with obs_trace.TRACER.span(f"blocking.autotune:{op}", cat="blocking",
                                   op=op, key=key):
            for cand in (defaults, *candidates):
                merged = {**defaults, **cand}
                if merged in seen or (takes is not None
                                      and not takes(merged)):
                    continue
                seen.append(merged)
                t = measure(merged)
                if t < best_t:
                    best, best_t = merged, t
        if best is not None:
            cache.put(key, best, seconds=best_t)
            obs_trace.TRACER.event("blocking.measured", cat="blocking",
                                   op=op, key=key, seconds=best_t)
            return dict(best)
    if tune and not can_measure and candidates and raw is None:
        cache.put(key, defaults, default=True)
        obs_trace.TRACER.event("blocking.default_marked", cat="blocking",
                               op=op, key=key)
    elif not tune and raw is None:
        cache._untuned[memo] = dict(defaults)
    return dict(defaults)


#: op -> eager premeasure hook, registered beside the op's variants
#: (``flash_attention`` in kernels/ops.py): how the calibration sweep
#: measures a block entry outside any capture, with concrete arguments.
PREMEASURE: dict[str, Callable] = {}


def premeasure(op: str, *args: Any, **kwargs: Any) -> dict[str, int]:
    """Measure op's block candidates on ``args`` now (autotune on),
    upgrading a default-marked entry; returns the blocks."""
    if op not in PREMEASURE:
        raise LookupError(f"op {op!r} has no premeasure hook; "
                          f"premeasurable: {sorted(PREMEASURE)}")
    return PREMEASURE[op](*args, **kwargs)
