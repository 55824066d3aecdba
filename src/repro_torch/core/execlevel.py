"""Execution levels (counterpart of ``repro.core.execlevel``), chip scope.

Paper §3: ``ARBB_OPT_LEVEL`` selects O2 (one core, vectorised) or O3
(multiple cores); the JAX package extends the ladder to O3 = one mesh and
O4 = multi-pod.  This package runs O2 only: one card.  O3 and O4 raise
``NotImplementedError`` until the mesh-scope slice of the port (ROADMAP
queue 1 item 11) lands.  ``ARBB_OPT_LEVEL`` is honoured as in the JAX
package, so asking for O3 there raises here too.
"""
from __future__ import annotations

import contextlib
import dataclasses
import enum
import os
import threading
from typing import Iterator

__all__ = ["ExecLevel", "ExecContext", "use_level", "current"]


class ExecLevel(enum.IntEnum):
    O2 = 2  # single chip
    O3 = 3  # one mesh (not ported yet)
    O4 = 4  # multi-pod mesh (not ported yet)


@dataclasses.dataclass(frozen=True)
class ExecContext:
    level: ExecLevel

    @property
    def is_distributed(self) -> bool:
        return False


_state = threading.local()


def _check(level: ExecLevel) -> ExecLevel:
    if level != ExecLevel.O2:
        raise NotImplementedError(
            f"ExecLevel {level.name} needs mesh scope, which the PyTorch "
            f"port does not have yet (ROADMAP queue 1 item 11, the "
            f"mesh-scope slice); only O2 runs")
    return level


def _default_level() -> ExecLevel:
    env = os.environ.get("ARBB_OPT_LEVEL", "O2").upper().lstrip("O")
    try:
        return ExecLevel(int(env))
    except ValueError:
        return ExecLevel.O2


def current() -> ExecContext:
    ctx = getattr(_state, "ctx", None)
    if ctx is None:
        ctx = ExecContext(_check(_default_level()))
        _state.ctx = ctx
    return ctx


@contextlib.contextmanager
def use_level(level: ExecLevel) -> Iterator[ExecContext]:
    """Scoped execution level; only O2 is accepted."""
    ctx = ExecContext(_check(ExecLevel(level)))
    prev = getattr(_state, "ctx", None)
    _state.ctx = ctx
    try:
        yield ctx
    finally:
        _state.ctx = prev
