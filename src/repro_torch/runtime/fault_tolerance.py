"""Fault tolerance: heartbeat-based failure/straggler detection + restart
policy.  Pure-python control plane (counterpart of
``repro.runtime.fault_tolerance``), testable on CPU, designed for the
checkpoint/restart loop a 1000-node job actually runs.

The model is the standard one for synchronous SPMD training:

  * every worker (host) posts a heartbeat (step, wall_time) to a shared
    store (here: in-process dict or a directory of files — same protocol a
    GCS/etcd-backed deployment uses);
  * the coordinator marks a worker DEAD after ``dead_after`` seconds of
    silence and STRAGGLER when its step lags the median by more than
    ``straggler_lag`` steps *and* its heartbeat age exceeds the p90 age by
    ``straggler_factor``;
  * on any DEAD verdict the policy is restart-from-checkpoint with the
    survivor set (elastic re-mesh: mesh scope, not ported) — the
    cheapest sound recovery for synchronous data-parallel training;
  * STRAGGLER verdicts feed mitigation: the launcher can re-schedule that
    host's shard or shrink the mesh at the next checkpoint boundary.

``TrainingSupervisor`` wraps a train loop with crash-save + resume
(exercised by the integration tests: kill mid-run, restart, bit-exact
continuation).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from enum import Enum
from typing import Callable, Optional

__all__ = ["WorkerState", "Heartbeat", "HeartbeatStore", "FileHeartbeatStore",
           "Monitor", "TrainingSupervisor"]


class WorkerState(str, Enum):
    HEALTHY = "healthy"
    STRAGGLER = "straggler"
    DEAD = "dead"


@dataclasses.dataclass
class Heartbeat:
    worker: int
    step: int
    time: float
    #: Optional load signal: the serve tier posts its slot-occupancy
    #: fraction per host-loop iteration (DESIGN.md §14), so the elastic
    #: re-mesh policy can distinguish an idle worker from a dead one.
    occupancy: Optional[float] = None


class HeartbeatStore:
    """In-process store (tests / single-host)."""

    def __init__(self) -> None:
        self._beats: dict[int, Heartbeat] = {}

    def post(self, worker: int, step: int, now: Optional[float] = None,
             occupancy: Optional[float] = None) -> None:
        self._beats[worker] = Heartbeat(worker, step, now or time.time(),
                                        occupancy)

    def all(self) -> dict[int, Heartbeat]:
        return dict(self._beats)


class FileHeartbeatStore(HeartbeatStore):
    """Directory-backed store — the multi-host protocol (one file/worker,
    atomic rename), what a GCS-bucket deployment maps onto."""

    def __init__(self, directory: str) -> None:
        super().__init__()
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def post(self, worker: int, step: int, now: Optional[float] = None,
             occupancy: Optional[float] = None) -> None:
        beat = {"worker": worker, "step": step, "time": now or time.time()}
        if occupancy is not None:
            beat["occupancy"] = occupancy
        tmp = os.path.join(self.dir, f".hb{worker}.tmp")
        with open(tmp, "w") as f:
            json.dump(beat, f)
        os.rename(tmp, os.path.join(self.dir, f"hb{worker}.json"))

    def all(self) -> dict[int, Heartbeat]:
        out: dict[int, Heartbeat] = {}
        for name in os.listdir(self.dir):
            if name.startswith("hb") and name.endswith(".json"):
                with open(os.path.join(self.dir, name)) as f:
                    d = json.load(f)
                out[d["worker"]] = Heartbeat(d["worker"], d["step"],
                                             d["time"], d.get("occupancy"))
        return out


@dataclasses.dataclass
class Monitor:
    store: HeartbeatStore
    dead_after: float = 60.0          # seconds of silence
    straggler_lag: int = 3            # steps behind median
    straggler_factor: float = 2.0     # heartbeat age vs p90

    def verdicts(self, now: Optional[float] = None) -> dict[int, WorkerState]:
        now = now or time.time()
        beats = self.store.all()
        if not beats:
            return {}
        steps = sorted(b.step for b in beats.values())
        median_step = steps[len(steps) // 2]
        out = {}
        for w, b in beats.items():
            age = now - b.time
            if age > self.dead_after:
                out[w] = WorkerState.DEAD
                continue
            # baseline: p90 heartbeat age of the *other* live workers (dead
            # ones would inflate it; including self would mask stragglers)
            peer_ages = sorted(now - p.time for pw, p in beats.items()
                               if pw != w and now - p.time <= self.dead_after)
            p90_age = (peer_ages[min(len(peer_ages) - 1,
                                     int(0.9 * len(peer_ages)))]
                       if peer_ages else 0.0)
            if (median_step - b.step > self.straggler_lag
                    and age > self.straggler_factor * max(p90_age, 1e-9)):
                out[w] = WorkerState.STRAGGLER
            else:
                out[w] = WorkerState.HEALTHY
        return out

    def survivors(self, now: Optional[float] = None) -> list[int]:
        return sorted(w for w, s in self.verdicts(now).items()
                      if s != WorkerState.DEAD)


class TrainingSupervisor:
    """Checkpoint/restart harness around a step function.

    run(n_steps) executes, saving every ``save_every``; on construction it
    resumes from the newest checkpoint if one exists.  Crash-inject with
    ``fail_at`` (tests) — the next run() picks up from the last save.
    """

    def __init__(self, checkpointer, state, *, save_every: int = 10,
                 specs=None) -> None:
        self.ckpt = checkpointer
        self.save_every = save_every
        self.specs = specs
        latest = checkpointer.latest_step()
        if latest is not None:
            state = checkpointer.restore(state, step=latest)
        self.state = state

    def run(self, step_fn: Callable, batches, n_steps: int,
            *, fail_at: Optional[int] = None):
        start = int(self.state.step)
        metrics = None
        for i in range(start, n_steps):
            if fail_at is not None and i == fail_at:
                raise RuntimeError(f"injected failure at step {i}")
            self.state, metrics = step_fn(self.state, batches.batch(i))
            done = i + 1
            if done % self.save_every == 0 or done == n_steps:
                self.ckpt.save(done, self.state, specs=self.specs)
        return self.state, metrics
