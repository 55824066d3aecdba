"""A world of ranks on this host: spawn ``n`` processes, give each its
``torch.distributed`` process group, run one function on every rank and
bring the results back.

    results = run_world(fn, 4, args=(...,), backend="gloo", timeout=120)

``start_world`` returns at once with a handle whose ``join()`` waits for
the same results, so that the caller can work while the ranks run.

``fn(rank, world_size, *args)`` runs on every rank after
``init_process_group`` (through a TCP store on localhost that this
process serves on a port the system picks, so two worlds never race for
one; the world size and the rank given explicitly; an ``init_timeout``
of at most 60 s); its
return values, one per rank, come back in rank order (they must pickle;
``fn`` must be importable by name, a module-level function).  A rank that
raises fails the whole world with that rank's traceback; a world that is
not done by ``timeout`` seconds fails too.  Either way every process is
killed and joined before the error propagates, so no rank outlives the
call.  Meant for the mesh tests on the CPU (gloo) and for
``chip_smoke.py``'s ranks on the card.
"""
from __future__ import annotations

import datetime
import queue
import time
import traceback
from typing import Any, Callable, Sequence

__all__ = ["run_world", "start_world", "World", "WorldError"]


class WorldError(RuntimeError):
    """A rank raised, or the world did not finish in time."""


def _rank_main(rank: int, world: int, port: int, backend: str,
               init_timeout: float, fn: Callable, args: tuple, out) -> None:
    import torch.distributed as dist

    try:
        timeout = datetime.timedelta(seconds=init_timeout)
        store = dist.TCPStore("localhost", port, is_master=False,
                              timeout=timeout)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world, timeout=timeout)
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:                   # report, then let the world end
        out.put((rank, False, traceback.format_exc()))


class World:
    """A started world (:func:`start_world`); :meth:`join` waits for its
    results.  The caller may work meanwhile."""

    def __init__(self, procs, out, nprocs: int, timeout: float, store):
        self.procs, self.out, self.nprocs = procs, out, nprocs
        self.store = store             # served here until the world ends
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout

    def join(self) -> list:
        """The results in rank order; raises :class:`WorldError` (after
        killing and joining every rank) if a rank raised or the deadline
        passed."""
        procs, nprocs = self.procs, self.nprocs
        results: dict[int, Any] = {}
        failure = None
        try:
            while len(results) < nprocs and failure is None:
                left = self.deadline - time.monotonic()
                if left <= 0:
                    failure = (f"the world of {nprocs} ranks did not finish "
                               f"in {self.timeout} s (done: "
                               f"{sorted(results)})")
                    break
                try:
                    rank, ok, payload = self.out.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in results and not p.is_alive()
                            and p.exitcode not in (None, 0)]
                    if dead and self.out.empty():
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} and no result")
                    continue
                if ok:
                    results[rank] = payload
                else:
                    failure = f"rank {rank} raised:\n{payload}"
        finally:
            for p in procs:
                if failure is not None and p.is_alive():
                    p.kill()
                p.join(timeout=10 if failure is None else 5)
                if p.is_alive():
                    p.kill()
                    p.join()
            self.out.close()
            self.store = None
        if failure is not None:
            raise WorldError(failure)
        return [results[r] for r in range(nprocs)]


def start_world(fn: Callable, nprocs: int, *, args: Sequence[Any] = (),
                backend: str = "gloo", timeout: float = 120.0,
                init_timeout: float = 60.0) -> World:
    """Spawn the ranks of ``fn`` (see :func:`run_world`) and return at
    once; ``timeout`` counts from now."""
    import multiprocessing as mp

    import torch.distributed as dist

    if init_timeout > 60:
        raise ValueError("init_timeout is at most 60 s")
    store = dist.TCPStore("localhost", 0, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=init_timeout))
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = store.port
    procs = [ctx.Process(target=_rank_main,
                         args=(r, nprocs, port, backend, init_timeout, fn,
                               tuple(args), out), daemon=True)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    return World(procs, out, nprocs, timeout, store)


def run_world(fn: Callable, nprocs: int, *, args: Sequence[Any] = (),
              backend: str = "gloo", timeout: float = 120.0,
              init_timeout: float = 60.0) -> list:
    """Run ``fn(rank, nprocs, *args)`` on ``nprocs`` spawned ranks; the
    results in rank order (see the module docstring)."""
    return start_world(fn, nprocs, args=args, backend=backend,
                       timeout=timeout, init_timeout=init_timeout).join()
