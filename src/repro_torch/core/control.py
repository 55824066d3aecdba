"""ArBB control-flow constructs in eager PyTorch (counterpart of
``repro.core.control``).

    _for / _end_for     ->  arbb_for    (a Python loop, serial)
    _while / _end_while ->  arbb_while
    _if                 ->  arbb_if
    C++ for inside      ->  unrolled()

PyTorch runs eagerly, so a recorded loop and a regular loop both execute
immediately; the functions keep the JAX package's loop structure (blocks of
``unroll`` steps, then the static remainder) so that both packages take the
same steps in the same order.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, TypeVar

from repro_torch.core.containers import unwrap

T = TypeVar("T")

__all__ = ["arbb_for", "arbb_while", "arbb_if", "unrolled"]


def _host_bool(x: Any) -> bool:
    v = unwrap(x)
    return bool(v.reshape(()).item()) if hasattr(v, "reshape") else bool(v)


def arbb_for(
    start: int,
    stop: int,
    body: Callable[[int, T], T],
    init: T,
    *,
    step: int = 1,
    unroll: int = 1,
) -> T:
    """Serial loop ``_for (i = start, i != stop, i += step)``.

    ``unroll > 1`` reproduces the paper's arbb_mxm2b structure: blocks of
    ``unroll`` steps, then ``trip_count % unroll`` remainder steps (the
    paper's lines 21-23)."""
    if step <= 0:
        raise ValueError("arbb_for requires a positive step")
    if unroll < 1:
        raise ValueError("unroll must be >= 1")
    trip = max(0, -(-(stop - start) // step))
    blocks, rem = divmod(trip, unroll)
    state = init
    for b in range(blocks):
        base = start + b * unroll * step
        for j in range(unroll):
            state = body(base + j * step, state)
    for j in range(rem):
        state = body(start + (blocks * unroll + j) * step, state)
    return state


def arbb_while(
    cond: Callable[[T], Any],
    body: Callable[[T], T],
    init: T,
) -> T:
    """``_while`` loop: runs ``body`` while ``cond(state)`` holds.

    ``cond`` may return a device scalar; it is read on the host once per
    iteration, which costs one device synchronisation per step (one per CG
    iteration).  Capturing the loop in a CUDA graph would remove it."""
    state = init
    while _host_bool(cond(state)):
        state = body(state)
    return state


def arbb_if(pred, then_fn: Callable[..., T], else_fn: Callable[..., T],
            *operands) -> T:
    """Conditional (``_if``); the predicate is read on the host."""
    return then_fn(*operands) if _host_bool(pred) else else_fn(*operands)


def unrolled(n: int) -> Iterable[int]:
    """A regular loop range (ArBB's C++ loop inside a recorded function)."""
    return range(n)
