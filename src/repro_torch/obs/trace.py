"""Zero-dependency span/event tracer with Chrome-trace export
(counterpart of ``repro.obs.trace``, a copy in behaviour; DESIGN.md §14).

This module is the span half of the observability plane:
:mod:`repro_torch.obs.metrics` is the aggregate half,
:mod:`repro_torch.obs.drift` the calibration-staleness check.  It answers
which variant won a dispatch, what the serve loop spent an iteration on,
and where a block measurement ran.

Design constraints (all load-bearing):

* **off-by-default, negligible when off** — ``TRACER.span(...)`` on a
  disabled tracer is one attribute read and a shared no-op context
  manager; nothing allocates, nothing locks.  The serve loop is host-bound
  (PERF.md §5), so a disabled span must cost nothing it can feel.
* **ring-buffered** — events land in a ``deque(maxlen=capacity)``; a
  long serve run keeps the most recent window instead of growing without
  bound.
* **host values only** — span/event attrs are plain host values
  (strings, ints, floats) supplied by the instrumentation sites; the
  tracer never receives or stores a tensor, so recording a span never
  reads the card and never synchronises it.  A span times the host's
  work: the kernels it enqueues may finish after it closes.
* **monotonic clocks** — spans time with ``time.perf_counter_ns``;
  :func:`clock` is the interval-timing helper the launchers use in place
  of ``time.time()`` (not monotonic: step timings go negative under
  clock adjustment).

Export is the Chrome trace-event JSON format (``{"traceEvents": [...]}``,
``ph: "X"`` complete events + ``ph: "i"`` instants, microsecond
timestamps), loadable in Perfetto / ``chrome://tracing`` as-is.

    from repro_torch.obs import trace
    trace.TRACER.enable()
    with trace.TRACER.span("serve.decode", active=3):
        ...
    trace.TRACER.save("trace.json")

Enable at import with ``REPRO_TORCH_TRACE=1`` (capacity override:
``REPRO_TORCH_TRACE_CAPACITY``).
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Any, Iterator, Optional

__all__ = ["Tracer", "TRACER", "clock", "DEFAULT_CAPACITY"]

DEFAULT_CAPACITY = 65536


#: This process's id, read once (and again in a forked child): on some
#: hosts ``os.getpid()`` is a system call of microseconds to hundreds of
#: microseconds, and every event records it.
_PID = [os.getpid()]
os.register_at_fork(after_in_child=lambda: _PID.__setitem__(0, os.getpid()))


def clock() -> float:
    """Monotonic seconds for interval timing — the drop-in replacement for
    ``time.time()`` pairs in step loops (``time.time()`` is wall clock and
    not monotonic; an NTP adjustment mid-run makes step timings negative).
    Only differences are meaningful."""
    return time.perf_counter()


class _NullSpan:
    """The shared disabled-tracer span: a no-op context manager."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records itself into the tracer's ring on exit."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: dict) -> None:
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self) -> "_Span":
        self._tracer._stack().append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc: Any) -> bool:
        dur = time.perf_counter_ns() - self._t0
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        parent = stack[-1].name if stack else None
        self._tracer._emit(self.name, "X", self._t0, cat=self.cat,
                           dur=dur, args=self.args, parent=parent)
        return False


class Tracer:
    """Thread-safe span/event recorder with a bounded ring buffer.

    ``enabled`` is the single hot-path knob: every instrumentation site
    checks it (directly or via :meth:`span` returning the shared no-op)
    before doing any work."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self.enabled = False
        self._events: deque = deque(maxlen=capacity)
        self._epoch = time.perf_counter_ns()
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.dropped = 0          # events displaced by the ring bound

    # -- lifecycle ----------------------------------------------------------

    def enable(self, capacity: Optional[int] = None) -> None:
        if capacity is not None and capacity != self._events.maxlen:
            with self._lock:
                self._events = deque(self._events, maxlen=capacity)
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0
            self._epoch = time.perf_counter_ns()

    @contextlib.contextmanager
    def tracing(self, capacity: Optional[int] = None) -> Iterator["Tracer"]:
        """Scoped enable (tests, one-shot benchmark captures)."""
        prev = self.enabled
        self.enable(capacity)
        try:
            yield self
        finally:
            self.enabled = prev

    # -- recording ----------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _emit(self, name: str, ph: str, t0_ns: int, *, cat: str = "",
              dur: Optional[int] = None, args: Optional[dict] = None,
              parent: Optional[str] = None) -> None:
        ev: dict[str, Any] = {"name": name, "ph": ph,
                              "ts": (t0_ns - self._epoch) / 1e3,
                              "pid": _PID[0],
                              "tid": threading.get_ident() & 0xFFFFFFFF}
        if cat:
            ev["cat"] = cat
        if dur is not None:
            ev["dur"] = dur / 1e3
        a = dict(args) if args else {}
        if parent:
            a["parent"] = parent
        if a:
            ev["args"] = a
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)

    def span(self, name: str, cat: str = "", **args: Any):
        """A timed span context manager — the no-op singleton when the
        tracer is disabled, so call sites never branch themselves."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args)

    def event(self, name: str, cat: str = "", **args: Any) -> None:
        """An instant event (Chrome ``ph: "i"``)."""
        if not self.enabled:
            return
        self._emit(name, "i", time.perf_counter_ns(), cat=cat, args=args)

    def counter(self, name: str, **values: float) -> None:
        """A Chrome counter sample (``ph: "C"``) — renders as a track."""
        if not self.enabled:
            return
        self._emit(name, "C", time.perf_counter_ns(), args=values)

    # -- export -------------------------------------------------------------

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        return len(self._events)

    def chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object (Perfetto-loadable)."""
        evs = self.events()
        for ev in evs:
            if ev["ph"] == "i":
                ev.setdefault("s", "t")       # thread-scoped instant
        return {"traceEvents": evs, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def save(self, path: str) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


#: Process-global tracer — the one every instrumentation site posts to.
TRACER = Tracer(int(os.environ.get("REPRO_TORCH_TRACE_CAPACITY",
                                   DEFAULT_CAPACITY)))
if os.environ.get("REPRO_TORCH_TRACE", "") in ("1", "true"):
    TRACER.enable()
