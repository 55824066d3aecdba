"""Cost-model drift detection: live dispatch timings against the
calibrated store (counterpart of ``repro.obs.drift``; DESIGN.md §14).

The measured cost model (:mod:`repro_torch.core.costmodel`) re-ranks
dispatch by whole-call seconds recorded by an *offline* sweep
(:mod:`repro_torch.launch.calibrate`), and nothing else checks whether
those numbers still describe this card.  While collection is on, the
registry times each dispatched call and hands the observation here;
:meth:`DriftDetector.report` compares the running mean per (op, variant,
key) against the model's stored seconds and flags entries whose ratio
falls outside ``[1/r, r]`` (``r`` = ``REPRO_TORCH_DRIFT_RATIO``, default 4:
generous, because live calls see cache effects the sweep's steady-state
timing did not).

Collection is **off by default** and explicitly scoped: timing a
dispatch on the card means ``torch.cuda.synchronize()`` after it, which
drains the stream — the host sync the serve loop must never pay.  The
registry only observes when :func:`collecting` is true, and never while
a CUDA graph is being captured.

    with drift.collect():
        run_workload()
    stale = drift.DETECTOR.flagged()       # [] when the model still holds

``REPRO_TORCH_DRIFT=1`` at import turns collection on process-wide.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Iterator, Mapping, Optional, Sequence

__all__ = ["DriftDetector", "DETECTOR", "collect", "collecting",
           "threshold", "DEFAULT_RATIO"]

#: Flag when mean observed seconds leave [stored/r, stored*r].
DEFAULT_RATIO = 4.0

_state = threading.local()


def threshold() -> float:
    """The configured stale-ratio bound (``REPRO_TORCH_DRIFT_RATIO`` env,
    else :data:`DEFAULT_RATIO`)."""
    try:
        return float(os.environ.get("REPRO_TORCH_DRIFT_RATIO",
                                    DEFAULT_RATIO))
    except ValueError:
        return DEFAULT_RATIO


#: ``REPRO_TORCH_DRIFT=1``: collection on process-wide, read at import (as
#: the tracer reads ``REPRO_TORCH_TRACE``): every dispatch asks.
_PROCESS_WIDE = os.environ.get("REPRO_TORCH_DRIFT", "") in ("1", "true")


def collecting() -> bool:
    """Whether the registry should time dispatches right now."""
    return _PROCESS_WIDE or bool(getattr(_state, "on", 0))


@contextlib.contextmanager
def collect() -> Iterator["DriftDetector"]:
    """Scoped collection — nestable; restores the previous state."""
    prev = getattr(_state, "on", 0)
    _state.on = prev + 1
    try:
        yield DETECTOR
    finally:
        _state.on = prev


class DriftDetector:
    """Accumulates live whole-call timings keyed the cost model's way and
    compares them to the stored calibration."""

    def __init__(self) -> None:
        self._obs: dict[tuple, dict] = {}
        self._lock = threading.Lock()
        self.unmatched = 0        # observations with no stored calibration

    def clear(self) -> None:
        with self._lock:
            self._obs.clear()
            self.unmatched = 0

    def observe(self, op: str, variant: str, seconds: float,
                args: Sequence[Any] = (),
                kwargs: Optional[Mapping[str, Any]] = None, *,
                scope: str = "chip", mesh: str = "-") -> None:
        """Record one live dispatched-call timing.  Looks up the stored
        calibration for the same (op, shape, scope, mesh) — exact key
        first, shape-class fallback, same as selection — and keeps a
        running mean per (op, variant, key).  The key is the store entry
        that actually matched, so a flagged row names a re-sweepable
        calibration, not a key the file may never have held."""
        from repro_torch.core import costmodel      # lazy: keep import graph thin

        model = costmodel.get_model()
        key, stored_all = model.lookup(op, args, kwargs,
                                       scope=scope, mesh=mesh)
        stored = stored_all.get(variant)
        if key is None or stored is None:
            self.unmatched += 1
            return
        with self._lock:
            rec = self._obs.setdefault((op, variant, key), {
                "n": 0, "total": 0.0, "stored": float(stored)})
            rec["n"] += 1
            rec["total"] += float(seconds)
            rec["stored"] = float(stored)     # latest calibration wins

    def report(self, ratio: Optional[float] = None) -> list[dict]:
        """Every observed (op, variant, key) with its live-vs-stored
        ratio, worst first.  ``stale`` marks ratios outside [1/r, r]."""
        r = ratio if ratio is not None else threshold()
        with self._lock:
            items = [(k, dict(v)) for k, v in self._obs.items()]
        rows = []
        for (op, variant, key), rec in items:
            mean = rec["total"] / rec["n"]
            ratio_v = mean / max(rec["stored"], 1e-30)
            rows.append({
                "op": op, "variant": variant, "key": key,
                "calls": rec["n"],
                "stored_seconds": rec["stored"],
                "observed_seconds": round(mean, 9),
                "ratio": round(ratio_v, 4),
                "stale": bool(ratio_v > r or ratio_v < 1.0 / r),
            })
        rows.sort(key=lambda row: max(row["ratio"],
                                      1.0 / max(row["ratio"], 1e-30)),
                  reverse=True)
        return rows

    def flagged(self, ratio: Optional[float] = None) -> list[dict]:
        """Only the stale rows — the calibrations to re-sweep."""
        return [row for row in self.report(ratio) if row["stale"]]


#: Process-global detector — the registry's observation sink.
DETECTOR = DriftDetector()
