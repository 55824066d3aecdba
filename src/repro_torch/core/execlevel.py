"""Execution levels: the ArBB runtime-retargeting story, scaled out
(counterpart of ``repro.core.execlevel``).

Paper §3: ``ARBB_OPT_LEVEL`` selects O2 (one core, vectorised) or O3
(multiple cores), and ``ARBB_NUM_CORES`` the number of threads.  The
program text never changes, only the level does; the ladder goes past the
paper's shared-memory ceiling:

    O2  — one card.
    O3  — one mesh: ``(data, model)`` over the ranks of the initialised
          ``torch.distributed`` world (the world size plays the role of
          ARBB_NUM_CORES, and ARBB_NUM_CORES caps it).
    O4  — multi-pod: ``(pod, data, model)``; reductions become
          hierarchical (the data stage first, the pod stage last).

Without an initialised process group, ``use_level(O3|O4)`` builds the
degenerate one-process mesh (:class:`~repro_torch.core.topology.LocalMesh`,
``(1, 1)`` or ``(1, 1, 1)``), as the reference builds a ``(1, 1)`` mesh on
one device: scope is 'mesh', but no collective plan has an axis to run
over, so every mesh variant degrades to its chip formulation, and nothing
waits for a peer or reads ``MASTER_ADDR``.

Levels are thread-local context, consumed by the registry's scope rule.
``ARBB_OPT_LEVEL`` / ``ARBB_NUM_CORES`` are honoured as in the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import enum
import os
import threading
from typing import Any, Iterator, Optional

from repro_torch.core.topology import LocalMesh, mesh_of_shape

__all__ = ["ExecLevel", "ExecContext", "use_level", "current",
           "default_mesh_for"]


class ExecLevel(enum.IntEnum):
    O2 = 2  # one card
    O3 = 3  # one mesh, (data, model)
    O4 = 4  # multi-pod mesh, (pod, data, model)


@dataclasses.dataclass(frozen=True)
class ExecContext:
    level: ExecLevel
    #: a ``DeviceMesh`` or a ``LocalMesh`` at O3/O4; None at O2
    mesh: Optional[Any] = None

    @property
    def is_distributed(self) -> bool:
        return self.level >= ExecLevel.O3 and self.mesh is not None


_state = threading.local()


def _default_level() -> ExecLevel:
    env = os.environ.get("ARBB_OPT_LEVEL", "O2").upper().lstrip("O")
    try:
        return ExecLevel(int(env))
    except ValueError:
        return ExecLevel.O2


def current() -> ExecContext:
    ctx = getattr(_state, "ctx", None)
    if ctx is None:
        level = _default_level()
        ctx = ExecContext(level, default_mesh_for(level))
        _state.ctx = ctx
    return ctx


def _world_size() -> int:
    """The initialised process group's world size, 0 without one."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        return 0
    return dist.get_world_size()


def default_mesh_for(level: ExecLevel):
    """The mesh a level runs on when the caller names none: ``(n, 1)``
    ``(data, model)`` for O3 and ``(pods, n / pods, 1)`` for O4 (two pods
    when n is even), n the world size capped by ``ARBB_NUM_CORES``; a
    :class:`LocalMesh` of the same axes without a process group."""
    if level == ExecLevel.O2:
        return None
    world = _world_size()
    n = world or 1
    n = max(1, min(int(os.environ.get("ARBB_NUM_CORES", n)), n))
    if level == ExecLevel.O3:
        shape, names = (n, 1), ("data", "model")
    else:
        pods = 2 if n % 2 == 0 and n >= 2 else 1
        shape, names = (pods, n // pods, 1), ("pod", "data", "model")
    if not world:
        return LocalMesh(mesh_dim_names=names, shape=shape)
    return mesh_of_shape(shape, names)


@contextlib.contextmanager
def use_level(level: ExecLevel, mesh=None) -> Iterator[ExecContext]:
    """Scoped execution level (the ArBB env-var knob, made composable)."""
    level = ExecLevel(level)
    if mesh is None and level >= ExecLevel.O3:
        mesh = default_mesh_for(level)
    prev = getattr(_state, "ctx", None)
    ctx = ExecContext(level, mesh)
    _state.ctx = ctx
    try:
        yield ctx
    finally:
        _state.ctx = prev
