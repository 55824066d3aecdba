"""Counters, gauges, and log2-bucketed histograms with dict snapshot
export (counterpart of ``repro.obs.metrics``, a copy in behaviour; DESIGN.md
§14).

The aggregate half of the observability plane: where :mod:`repro_torch.obs.
trace` answers "what happened, when", this module answers "how often and
how much" — per-op variant-selection counts and degradation fall-offs at
the registry, queue depth / slot occupancy / TTFT / per-token latency /
page-pool headroom at the serve tier.

Everything is always-on and deliberately cheap: a counter increment is a
dict hit plus a float add, a histogram record is one ``frexp``.  There
is no export thread and no I/O — callers pull :meth:`MetricsRegistry.
snapshot` (a plain JSON-able dict) when they want numbers, e.g.
``chip_smoke.py`` holding the serve loop's counts against the requests it
served.

Histograms bucket by the binary exponent of the value (``frexp``): value
``v`` lands in bucket ``e`` with ``2**(e-1) < v <= 2**e``.  Latencies
spanning microseconds to seconds need ~20 buckets, and bucket merging
across snapshots is trivial (same key = same bound).  Mean/min/max/sum
ride along exactly, so the coarse buckets only limit quantile precision.
"""
from __future__ import annotations

import math
import threading
from typing import Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "METRICS"]


class Counter:
    """Monotonically increasing count (float increments allowed — the
    serve tier accumulates idle-sleep *seconds* on one)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Log2-bucketed distribution: bucket ``e`` holds values in
    ``(2**(e-1), 2**e]``; non-positive values land in the ``zero``
    count (occupancy fractions and latencies are both non-negative)."""

    __slots__ = ("buckets", "zero", "count", "total", "min", "max")

    def __init__(self) -> None:
        self.buckets: dict[int, int] = {}
        self.zero = 0
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def record(self, value: float, n: int = 1) -> None:
        """Record ``value`` ``n`` times (a serve iteration records its
        wall time once per token it emitted)."""
        self.count += n
        self.total += value * n
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        if value <= 0.0:
            self.zero += n
            return
        m, e = math.frexp(value)              # v = m * 2**e, m in [0.5, 1)
        if m == 0.5:                          # exact power of two: (.., 2**e]
            e -= 1
        self.buckets[e] = self.buckets.get(e, 0) + n

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Coarse quantile: the upper bound ``2**e`` of the bucket where
        the cumulative count crosses ``q`` (within 2x of the true value —
        enough for dashboards; exact percentiles come from raw samples)."""
        if not self.count:
            return 0.0
        target = q * self.count
        seen = self.zero
        if seen >= target:
            return 0.0
        for e in sorted(self.buckets):
            seen += self.buckets[e]
            if seen >= target:
                return math.ldexp(1.0, e)
        return self.max

    def snapshot(self) -> dict:
        return {"type": "histogram", "count": self.count,
                "sum": self.total, "mean": self.mean,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "zero": self.zero,
                "buckets": {str(e): n
                            for e, n in sorted(self.buckets.items())}}


class MetricsRegistry:
    """Name -> instrument table.  Get-or-create is lock-guarded only on
    the miss path; the hit path is a plain dict get (the hot case — every
    dispatch bumps a counter)."""

    def __init__(self) -> None:
        self._table: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls):
        inst = self._table.get(name)
        if inst is None:
            with self._lock:
                inst = self._table.setdefault(name, cls())
        if not isinstance(inst, cls):
            raise TypeError(f"metric {name!r} is {type(inst).__name__}, "
                            f"not {cls.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self, prefix: Optional[str] = None) -> dict[str, dict]:
        """All instruments (optionally name-filtered) as a JSON-able dict."""
        with self._lock:
            items = list(self._table.items())
        return {name: inst.snapshot() for name, inst in sorted(items)
                if prefix is None or name.startswith(prefix)}

    def reset(self, prefix: Optional[str] = None) -> None:
        """Drop instruments (optionally only those under ``prefix``) — how
        a benchmark scopes a snapshot to one timed region."""
        with self._lock:
            if prefix is None:
                self._table.clear()
            else:
                for name in [n for n in self._table
                             if n.startswith(prefix)]:
                    del self._table[name]


#: Process-global metrics registry — the one every instrumentation site
#: writes to and every snapshot reader pulls from.
METRICS = MetricsRegistry()
