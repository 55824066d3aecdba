"""Operator registry: one retargeting plane per op (counterpart of
``repro.core.registry``), chip scope only.

Every operator (``matmul``, ``spmv_ell``, ``spmv_dia``, ``fft``, the solver
SpMV formulations, the blocked-sparse ``spmm`` and ``spgemm``, and the
attention ops) registers variants, and :func:`dispatch` picks one.

    plane     how a variant executes:
              'cuda'  a hand-written kernel (``repro_torch/kernels/csrc``),
                      which needs its operands on a CUDA device;
              'torch' the plain eager PyTorch version, the dual of the JAX
                      package's 'xla' plane.
              DSL-level variants (the solver SpMV formulations) have
              ``plane=None``: they are tensor programs and run anywhere.
    variant   (op, name, impl, plane, cost, accepts): one implementation.
    accepts   per-call predicate over the concrete arguments.
    cost      static preference; lower wins among admissible variants.

Selection rules (DESIGN.md §6, with the device rule of the port):

    1. ``dispatch(op, ..., variant=name)`` is always honoured, except that a
       'cuda' variant pinned on host operands raises.
    2. The operands' device selects the plane: CUDA tensors select 'cuda',
       host tensors select 'torch'.  Variants are ordered (requested plane
       first, cost, name) and the first admissible one that accepts the
       arguments wins.
    3. ``use_backend('cuda')`` with host operands raises.
       ``use_backend('torch')`` on CUDA operands is an explicit request for
       the plain version and is honoured.  Without that request a 'torch'
       variant is never admissible on CUDA operands, so nothing falls from
       a kernel to the plain version; a kernel that fails to build or
       launch raises.

Providers register lazily: ops are declared here by module path and imported
on first dispatch, so upper layers depend only on this module.

Not ported yet: the measured cost model, observability (``explain``, spans,
counters) and mesh topology (ROADMAP queue 1 items 10 and 11).
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import threading
from typing import Any, Callable, Iterator, Optional

import torch

from repro_torch.core import execlevel

__all__ = ["Variant", "SelectContext", "OperatorRegistry", "REGISTRY",
           "Cost", "register", "unregister", "dispatch", "select",
           "variants", "ops", "use_backend", "requested_backend",
           "resolve_backend", "device_type_of", "PLANES"]

#: The kernel retargeting planes.
PLANES = ("cuda", "torch")


class Cost:
    """Named static cost tiers (DESIGN.md §6).

    Plane tiers: ``BLOCKSPARSE`` (the tile-skipping attention kernel,
    admissible only when its density gate passes) < ``CUDA`` (hand-written
    kernel) < ``TORCH_CHUNKED`` (streamed plain schedule) < ``TORCH``
    (plain eager version) < ``ORACLE``.  Sparse-layout ranks (``DIA`` <
    ``BSR`` < ``ELL`` < ``CSR``) mirror the format selector's
    strongest-first ordering."""

    BLOCKSPARSE = 0.75
    CUDA = 1.0
    TORCH_CHUNKED = 1.5
    TORCH = 2.0
    ORACLE = 20.0

    DIA = 4.0
    BSR = 5.0
    ELL = 6.0
    CSR = ORACLE


#: op name -> modules that register its variants on import.
_PROVIDERS = {
    "matmul": ("repro_torch.kernels.ops",),
    "spmv_ell": ("repro_torch.kernels.ops",),
    "spmv_dia": ("repro_torch.kernels.ops",),
    "fft": ("repro_torch.kernels.ops",),
    "solver_spmv": ("repro_torch.numerics.spmv", "repro_torch.sparse.spmm"),
    "spmm": ("repro_torch.sparse.spmm",),
    "spgemm": ("repro_torch.sparse.spgemm",),
    "flash_attention": ("repro_torch.kernels.ops",),
    "flash_attention_state": ("repro_torch.kernels.ops",),
    "paged_attention": ("repro_torch.kernels.ops",),
    "chunk_attention": ("repro_torch.kernels.ops",),
}

_loaded_providers: set = set()


def device_type_of(*operands: Any) -> str:
    """'cuda' if any operand (a tensor, a container with ``data`` or
    ``device``, or a tuple of them) lies on a CUDA device, else 'cpu'."""
    for x in operands:
        if isinstance(x, torch.Tensor):
            dev = x.device
        elif isinstance(x, (tuple, list)):
            if device_type_of(*x) == "cuda":
                return "cuda"
            continue
        else:
            dev = getattr(x, "device", None)
        if isinstance(dev, torch.device) and dev.type == "cuda":
            return "cuda"
    return "cpu"


@dataclasses.dataclass(frozen=True)
class SelectContext:
    """What variant selection may look at: the level and the operands'
    device type ('cuda' or 'cpu')."""
    level: execlevel.ExecLevel
    device: str
    requested: Optional[str] = None


def _select_context(args: tuple, kwargs: dict) -> SelectContext:
    return SelectContext(level=execlevel.current().level,
                         device=device_type_of(*args, *kwargs.values()),
                         requested=requested_backend())


@dataclasses.dataclass(frozen=True)
class Variant:
    op: str
    name: str
    impl: Callable
    plane: Optional[str] = None
    cost: float = 10.0
    accepts: Optional[Callable[..., bool]] = None
    doc: str = ""

    def is_available(self, ctx: SelectContext) -> bool:
        if self.plane == "cuda":
            return ctx.device == "cuda"
        if self.plane == "torch":
            return ctx.device == "cpu" or ctx.requested == "torch"
        return True

    def matches(self, *args: Any, **kwargs: Any) -> bool:
        return self.accepts(*args, **kwargs) if self.accepts is not None \
            else True


# ---------------------------------------------------------------------------
# requested backend plane
# ---------------------------------------------------------------------------

_state = threading.local()


def requested_backend() -> Optional[str]:
    """The plane requested by an enclosing :func:`use_backend`, if any."""
    return getattr(_state, "plane", None)


@contextlib.contextmanager
def use_backend(name: str) -> Iterator[str]:
    """Scoped plane request.  ``repro_torch.kernels.ops.backend`` is this."""
    if name not in PLANES:
        raise ValueError(f"unknown backend plane {name!r}; choose from {PLANES}")
    prev = getattr(_state, "plane", None)
    _state.plane = name
    try:
        yield name
    finally:
        _state.plane = prev


def resolve_backend(*operands: Any) -> str:
    """The plane dispatch favours for these operands: the requested plane,
    else 'cuda' for CUDA operands and 'torch' for host ones.  A 'cuda'
    request with host operands raises."""
    req = requested_backend()
    dev = device_type_of(*operands)
    if req == "cuda" and dev != "cuda":
        raise RuntimeError("the 'cuda' plane was requested but the operands "
                           "lie on the host; move them to the card")
    if req is not None:
        return req
    return "cuda" if dev == "cuda" else "torch"


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

class OperatorRegistry:
    def __init__(self) -> None:
        self._ops: dict[str, dict[str, Variant]] = {}
        self._lock = threading.Lock()

    def register(self, op: str, name: str, impl: Optional[Callable] = None,
                 *, plane: Optional[str] = None, cost: float = 10.0,
                 accepts: Optional[Callable[..., bool]] = None,
                 doc: str = ""):
        """Register a variant.  Usable directly or as a decorator."""
        if impl is None:
            def deco(fn: Callable) -> Callable:
                self.register(op, name, fn, plane=plane, cost=cost,
                              accepts=accepts, doc=doc)
                return fn
            return deco
        if plane is not None and plane not in PLANES:
            raise ValueError(f"unknown plane {plane!r} for {op}/{name}")
        with self._lock:
            table = self._ops.setdefault(op, {})
            if name in table:
                raise ValueError(
                    f"duplicate variant {name!r} for op {op!r}; "
                    f"unregister it first to replace")
            table[name] = Variant(op=op, name=name, impl=impl, plane=plane,
                                  cost=cost, accepts=accepts,
                                  doc=doc or impl.__doc__ or "")
        return impl

    def unregister(self, op: str, name: Optional[str] = None) -> None:
        """Drop one variant, or the whole op when ``name`` is None."""
        with self._lock:
            if name is None:
                self._ops.pop(op, None)
            else:
                self._ops.get(op, {}).pop(name, None)

    def _table(self, op: str) -> dict[str, Variant]:
        for module in _PROVIDERS.get(op, ()):
            if module not in _loaded_providers:
                importlib.import_module(module)
                _loaded_providers.add(module)
        if op not in self._ops:
            raise LookupError(f"unknown op {op!r}; registered: "
                              f"{sorted(self._ops)}")
        return self._ops[op]

    def ops(self) -> list[str]:
        return sorted(set(self._ops) | set(_PROVIDERS))

    def variants(self, op: str) -> tuple[Variant, ...]:
        return tuple(sorted(self._table(op).values(),
                            key=lambda v: (v.cost, v.name)))

    def get(self, op: str, name: str) -> Variant:
        table = self._table(op)
        if name not in table:
            raise ValueError(f"op {op!r} has no variant {name!r}; "
                             f"registered: {sorted(table)}")
        return table[name]

    @staticmethod
    def _ranked(ctx: SelectContext, table: dict[str, Variant]
                ) -> list[Variant]:
        """All variants in selection order: requested plane, cost, name."""
        req = ctx.requested
        return sorted(table.values(),
                      key=lambda v: (0 if req is not None and v.plane == req
                                     else 1, v.cost, v.name))

    def _select(self, op: str, args: tuple, kwargs: dict) -> Variant:
        ctx = _select_context(args, kwargs)
        if ctx.requested == "cuda" and ctx.device != "cuda":
            raise RuntimeError(f"{op}: the 'cuda' plane was requested but "
                               f"the operands lie on the host")
        for v in self._ranked(ctx, self._table(op)):
            if v.is_available(ctx) and v.matches(*args, **kwargs):
                return v
        raise LookupError(
            f"no variant of op {op!r} takes these arguments on "
            f"{ctx.device!r}; registered: {sorted(self._table(op))}")

    def select(self, op: str, *args: Any, variant: Optional[str] = None,
               **kwargs: Any) -> Variant:
        """The variant :func:`dispatch` would run, without running it."""
        if variant is not None:
            v = self.get(op, variant)
            if v.plane == "cuda" and \
                    device_type_of(*args, *kwargs.values()) != "cuda":
                raise RuntimeError(f"{op}: variant {variant!r} is a CUDA "
                                   f"kernel but the operands lie on the host")
            return v
        return self._select(op, args, kwargs)

    def dispatch(self, op: str, *args: Any, variant: Optional[str] = None,
                 **kwargs: Any) -> Any:
        """Select (per the module docstring's rules) and invoke."""
        v = self.select(op, *args, variant=variant, **kwargs)
        return v.impl(*args, **kwargs)


#: Process-global registry instance.
REGISTRY = OperatorRegistry()

register = REGISTRY.register
unregister = REGISTRY.unregister
dispatch = REGISTRY.dispatch
select = REGISTRY.select
variants = REGISTRY.variants
ops = REGISTRY.ops
