"""Operator registry: one retargeting plane per op (counterpart of
``repro.core.registry``).

Every operator (``matmul``, ``spmv_ell``, ``spmv_dia``, ``fft``, the solver
SpMV formulations, the blocked-sparse ``spmm`` and ``spgemm``, and the
attention ops) registers variants, and :func:`dispatch` picks one.

    scope     how far a variant reaches: 'chip' (one card: every kernel
              and DSL formulation) or 'mesh' (a program over the ranks of
              the ambient O3/O4 mesh, :mod:`repro_torch.distributed.
              numerics`).  Mesh variants are admissible only under such a
              mesh, and then they are *preferred*.
    plane     how a variant executes:
              'cuda'  a hand-written kernel (``repro_torch/kernels/csrc``),
                      which needs its operands on a CUDA device;
              'torch' the plain eager PyTorch version, the dual of the JAX
                      package's 'xla' plane.
              DSL-level variants (the solver SpMV formulations) have
              ``plane=None``: they are tensor programs and run anywhere.
    variant   (op, name, impl, plane, scope, cost, available, accepts,
              out_sharding): one implementation.
    available capability predicate over the selection context (level,
              mesh topology): ``mesh_psum_2d`` needs a real model axis.
    accepts   per-call predicate over the concrete arguments.
    cost      static preference; lower wins among admissible variants.

Selection rules (DESIGN.md §6, with the device rule of the port):

    1. ``dispatch(op, ..., variant=name)`` is always honoured, except that a
       'cuda' variant pinned on host operands raises.
    2. The operands' device selects the plane: CUDA tensors select 'cuda',
       host tensors select 'torch'.  Variants are ordered (requested plane
       first, cost, name) and the first admissible one that accepts the
       arguments wins; calibrated seconds, below, come before the cost.
    3. ``use_backend('cuda')`` with host operands raises.
       ``use_backend('torch')`` on CUDA operands is an explicit request for
       the plain version and is honoured.  Without that request a 'torch'
       variant is never admissible on CUDA operands, so nothing falls from
       a kernel to the plain version; a kernel that fails to build or
       launch raises.
    4. Scope ranks first: under an ambient O3/O4 mesh a mesh variant beats
       any chip one, ahead of the plane request (ArBB's O3 beats O2
       without the program text changing).  A mesh variant whose shapes
       do not divide the mesh, or whose mesh has no axis to run over,
       degrades to the chip formulation.

Calibration (DESIGN.md §11): when the measured cost model
(:mod:`repro_torch.core.costmodel`) holds whole-call seconds for this call's
shape class for at least two variants admissible on the operands' device
('cuda' and the DSL formulations of ``plane=None`` on CUDA operands,
'torch' and ``plane=None`` on the host), those variants rank first,
fastest first; but a measurement reorders two of them only when they
differ by more than :data:`CALIBRATION_MARGIN` of the faster and by more
than either's recorded spread, and variants closer than that keep their
static order.  Calibration never crosses the device rule: a 'torch'
variant's seconds never promote it on CUDA operands, neither do an
oracle's (``oracle=True``: a plane-free variant whose body is the plain
reference, such as spgemm's ``dense``), and an explicit ``use_backend``
request disables it (the knob is an instruction, the model a
measurement).  With no model file
nothing is re-ranked and a dispatch costs two counter bumps more than an
uninstrumented one; a loaded model's ranking is memoised per (op,
signature, dtype, device, requested plane) and dropped by the model's next
``record``.

Observability (DESIGN.md §14): :func:`explain` returns the ranked
candidate table with a reason on every loser, from the same ranking and
predicates :func:`select` uses; :func:`dispatch` counts
``dispatch.<op>.<variant>`` and ``dispatch.falloff.<op>`` always, records a
span only while the tracer is on, and times whole calls (with a
``torch.cuda.synchronize``) only under :func:`repro_torch.obs.drift.collect`.

Providers register lazily: ops are declared here by module path and imported
on first dispatch, so upper layers depend only on this module.

Cost-model and drift keys end in the ambient ``scope|mesh``: ``chip|-``
on one card, ``mesh|<topology.describe()>`` under an O3/O4 mesh (e.g.
``mesh|pod2xdata2xmodel1``), so mesh and chip measurements never alias.
A mesh variant may declare the layout it leaves its result in
(``out_sharding``); dispatch attaches it to the result and explain shows
it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import threading
import time
from typing import Any, Callable, Iterator, NamedTuple, Optional

import torch

from repro_torch.core import blocking, costmodel, execlevel
from repro_torch.core.topology import MeshTopology, topology_of
from repro_torch.obs import drift as obs_drift
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

__all__ = ["calibration_ranks", "Variant", "SelectContext",
           "OperatorRegistry", "REGISTRY",
           "Cost", "register", "unregister", "dispatch", "select",
           "explain", "select_context", "variants", "ops", "use_backend",
           "requested_backend", "resolve_backend", "device_type_of",
           "PLANES", "SCOPES"]

#: The kernel retargeting planes.
PLANES = ("cuda", "torch")

#: The selection scopes: one card, or the ambient O3/O4 mesh.
SCOPES = ("chip", "mesh")

#: A measurement reorders two calibrated variants only when the slower
#: one's seconds exceed the faster one's by more than this fraction of the
#: faster (and by more than either's recorded spread): closer than that, a
#: whole-call difference is within the host clock's movement between runs.
CALIBRATION_MARGIN = 0.05


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


#: op name -> modules that register its variants on import (chip kernels
#: first, then the mesh-scoped formulations).
_PROVIDERS = {
    "matmul": ("repro_torch.kernels.ops",
               "repro_torch.distributed.numerics"),
    "spmv_ell": ("repro_torch.kernels.ops",),
    "spmv_dia": ("repro_torch.kernels.ops",),
    "fft": ("repro_torch.kernels.ops", "repro_torch.distributed.numerics"),
    "solver_spmv": ("repro_torch.numerics.spmv",
                    "repro_torch.distributed.numerics",
                    "repro_torch.sparse.spmm"),
    "spmm": ("repro_torch.sparse.spmm", "repro_torch.distributed.numerics"),
    "spgemm": ("repro_torch.sparse.spgemm",
               "repro_torch.distributed.numerics"),
    "flash_attention": ("repro_torch.kernels.ops",
                        "repro_torch.distributed.attention"),
    "flash_attention_state": ("repro_torch.kernels.ops",),
    "paged_attention": ("repro_torch.kernels.ops",
                        "repro_torch.distributed.attention"),
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


class SelectContext(NamedTuple):
    """What variant selection may look at: the level, the operands' device
    type ('cuda' or 'cpu'), the requested plane, and under an O3/O4 mesh
    the mesh, the scope ('mesh') and the mesh's topology (axis names,
    sizes, roles), so a variant can predicate on mesh rank and axis roles.
    (A named tuple: every dispatch makes one.)"""
    level: execlevel.ExecLevel
    device: str
    requested: Optional[str] = None
    mesh: Any = None
    scope: str = "chip"
    topology: Optional[MeshTopology] = None

    @property
    def mesh_rank(self) -> int:
        """Non-degenerate mesh axes (0 with no mesh)."""
        return self.topology.rank if self.topology is not None else 0


def select_context(*operands: Any) -> SelectContext:
    """The context variant selection sees right now for these operands
    (a call's positional and keyword argument values)."""
    ctx = execlevel.current()
    if ctx.mesh is None:
        return SelectContext(level=ctx.level,
                             device=device_type_of(*operands),
                             requested=requested_backend())
    return SelectContext(level=ctx.level, device=device_type_of(*operands),
                         requested=requested_backend(), mesh=ctx.mesh,
                         scope="mesh" if ctx.is_distributed else "chip",
                         topology=topology_of(ctx.mesh))


def scope_key(ctx: SelectContext) -> tuple[str, str]:
    """The (scope, mesh) key components of a context: the cost model's and
    the drift detector's shared vocabulary."""
    if ctx.scope == "mesh" and ctx.topology is not None:
        return "mesh", ctx.topology.describe()
    return "chip", "-"


def _attach_out_sharding(v: "Variant", ctx: Optional[SelectContext],
                         args: tuple, kwargs: dict, out: Any) -> Any:
    """Attach the layout ``v`` (a variant that declares an
    ``out_sharding``; dispatch tests that before calling) decided for its
    result as an advisory ``out_sharding`` attribute.  A hook that raises
    fails the dispatch; a result type without settable attributes returns
    unannotated."""
    sh = v.decide_out_sharding(ctx or select_context(*args,
                                                     *kwargs.values()),
                               args, kwargs)
    if sh is not None:
        try:
            object.__setattr__(out, "out_sharding", sh)
        except (AttributeError, TypeError):
            pass
    return out


@dataclasses.dataclass(frozen=True)
class Variant:
    op: str
    name: str
    impl: Callable
    plane: Optional[str] = None
    cost: float = 10.0
    accepts: Optional[Callable[..., bool]] = None
    doc: str = ""
    #: a plane-free variant whose body is the plain reference: admissible
    #: everywhere, but its seconds never re-rank it on CUDA operands
    oracle: bool = False
    scope: str = "chip"
    available: Optional[Callable[[SelectContext], bool]] = None
    #: ``out_sharding(ctx, *args, **kwargs) -> NamedSharding | None``: the
    #: layout this variant leaves its result in (mesh SpGEMM's block-row
    #: sharding); dispatch attaches it to the result
    out_sharding: Optional[Callable[..., Any]] = None

    def decide_out_sharding(self, ctx: SelectContext, args: tuple,
                            kwargs: dict) -> Optional[Any]:
        """The layout this variant would leave the output in for this
        call, or None (no declaration, or the hook declined).  A hook that
        raises raises here: a bug in a layout decision is not hidden
        behind a result with no layout (explain reports it instead,
        :func:`_out_sharding_row`)."""
        if self.out_sharding is None:
            return None
        return self.out_sharding(ctx, *args, **kwargs)

    def _plane_available(self, ctx: SelectContext) -> bool:
        if self.plane == "cuda":
            return ctx.device == "cuda"
        if self.plane == "torch":
            return ctx.device == "cpu" or ctx.requested == "torch"
        return True

    def is_available(self, ctx: SelectContext) -> bool:
        if not self._plane_available(ctx):
            return False
        if self.scope == "mesh" and ctx.scope != "mesh":
            return False
        return self.available(ctx) if self.available is not None else True

    def unavailable_reason(self, ctx: SelectContext) -> str:
        """Why :meth:`is_available` says no (explain's wording)."""
        if self._plane_available(ctx):
            if self.scope == "mesh" and ctx.scope != "mesh":
                return ("scope-mismatch: mesh-scoped variant without an "
                        "ambient O3/O4 mesh")
            _, mesh = scope_key(ctx)
            return (f"available-predicate: rejected this context "
                    f"(level={ctx.level.name}, mesh={mesh})")
        if self.plane == "cuda":
            return ("plane-unavailable: 'cuda' needs CUDA operands; these "
                    "lie on the host")
        return ("plane-unavailable: 'torch' runs on CUDA operands only "
                "under use_backend('torch')")

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

#: Memoised rankings a registry keeps before it starts over.
RANK_MEMO = 4096


class OperatorRegistry:
    def __init__(self) -> None:
        self._ops: dict[str, dict[str, Variant]] = {}
        self._lock = threading.Lock()
        #: bumped by register/unregister; part of every memo key
        self._version = 0
        #: (op, dims, dtype, device, model path, model version, registry
        #: version) -> (ranked variants, calibrated (seconds, rank), the
        #: ranked variants admissible on the context's device)
        self._memo: dict[tuple, tuple[list, dict, list]] = {}

    def register(self, op: str, name: str, impl: Optional[Callable] = None,
                 *, plane: Optional[str] = None, cost: float = 10.0,
                 accepts: Optional[Callable[..., bool]] = None,
                 doc: str = "", oracle: bool = False, scope: str = "chip",
                 available: Optional[Callable[[SelectContext], bool]] = None,
                 out_sharding: Optional[Callable[..., Any]] = None):
        """Register a variant.  Usable directly or as a decorator."""
        if impl is None:
            def deco(fn: Callable) -> Callable:
                self.register(op, name, fn, plane=plane, cost=cost,
                              accepts=accepts, doc=doc, oracle=oracle,
                              scope=scope, available=available,
                              out_sharding=out_sharding)
                return fn
            return deco
        if plane is not None and plane not in PLANES:
            raise ValueError(f"unknown plane {plane!r} for {op}/{name}")
        if scope not in SCOPES:
            raise ValueError(f"unknown scope {scope!r} for {op}/{name}; "
                             f"choose from {SCOPES}")
        if oracle and plane is not None:
            raise ValueError(f"{op}/{name}: an oracle is plane-free")
        with self._lock:
            table = self._ops.setdefault(op, {})
            if name in table:
                raise ValueError(
                    f"duplicate variant {name!r} for op {op!r}; "
                    f"unregister it first to replace")
            table[name] = Variant(op=op, name=name, impl=impl, plane=plane,
                                  cost=cost, accepts=accepts,
                                  doc=doc or impl.__doc__ or "",
                                  oracle=oracle, scope=scope,
                                  available=available,
                                  out_sharding=out_sharding)
            self._version += 1
        return impl

    def unregister(self, op: str, name: Optional[str] = None) -> None:
        """Drop one variant, or the whole op when ``name`` is None."""
        with self._lock:
            if name is None:
                self._ops.pop(op, None)
            else:
                self._ops.get(op, {}).pop(name, None)
            self._version += 1

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
    def _calibrated(op: str, args: tuple, kwargs: dict,
                    ctx: SelectContext, table: dict[str, Variant],
                    model: "costmodel.CostModel"
                    ) -> dict[str, tuple[float, float]]:
        """Measured whole-call seconds of the variants admissible on the
        operands' device, from the cost model, as ``{name: (seconds,
        rank)}`` — ``{}`` when the model holds fewer than two of them for
        this shape class (a singleton measurement must not promote the one
        variant that happened to be measured, and a variant of another
        plane, or an oracle on CUDA operands, is never counted).  ``rank``
        is 0 for every variant no slower than the fastest by more than the
        margin (:data:`CALIBRATION_MARGIN`, or either's spread): those
        keep their static order.  A slower one ranks by its seconds."""
        scope, mesh = scope_key(ctx)
        records = model.records_for(op, args, kwargs, scope=scope, mesh=mesh)
        on_card = ctx.device == "cuda"
        counted = {name: rec for name, rec in records.items()
                   if name in table and table[name].is_available(ctx)
                   and not (on_card and table[name].oracle)}
        if len(counted) < 2:
            return {}
        return calibration_ranks(counted)

    @staticmethod
    def _ranked(ctx: SelectContext, table: dict[str, Variant],
                measured: Optional[dict[str, tuple[float, float]]] = None
                ) -> list[Variant]:
        """All variants in selection order: calibrated (by rank), scope
        match, requested plane, cost, name.  Under a mesh the mesh
        variants rank ahead of every chip one, whatever plane was
        requested; without one they are unavailable and the chip order is
        what it always was."""
        measured = measured or {}
        req = ctx.requested
        return sorted(
            table.values(),
            key=lambda v: ((0, measured[v.name][1]) if v.name in measured
                           else (1, 0.0),
                           0 if v.scope == ctx.scope else 1,
                           0 if req is not None and v.plane == req else 1,
                           v.cost, v.name))

    def _ranking(self, op: str, args: tuple, kwargs: dict,
                 ctx: SelectContext, table: dict[str, Variant]
                 ) -> tuple[list[Variant], dict[str, tuple[float, float]],
                            list[Variant]]:
        """:meth:`_ranked` for this call, the calibrated (seconds, rank)
        that shaped the order, and the ranked variants admissible on the
        operands' device — the one ranking both :meth:`select` and
        :meth:`explain` consume, so they cannot diverge.  An explicit
        plane request disables calibration; an empty model costs one
        length check; every ranking is memoised."""
        req = ctx.requested
        model = costmodel.get_model()
        calibrate = req is None and len(model) > 0
        if calibrate:
            memo_key = (op, _call_key(args, kwargs), ctx.device, model.path,
                        model.version, self._version, ctx.scope,
                        ctx.topology)
        else:
            memo_key = (op, req, ctx.device, self._version, ctx.scope,
                        ctx.topology)
        hit = self._memo.get(memo_key)
        if hit is not None:
            return hit
        measured = self._calibrated(op, args, kwargs, ctx, table, model) \
            if calibrate else {}
        ranked = self._ranked(ctx, table, measured)
        out = (ranked, measured, [v for v in ranked if v.is_available(ctx)])
        if len(self._memo) >= RANK_MEMO:
            self._memo.clear()
        self._memo[memo_key] = out
        return out

    def _select(self, op: str, args: tuple, kwargs: dict
                ) -> tuple[Variant, SelectContext, int]:
        """The winner, its context, and how many admissible variants
        ranked ahead of it were rejected by their ``accepts`` (> 0 is a
        fall-off: a higher-ranked kernel of this plane refused the
        arguments)."""
        ctx = select_context(*args, *kwargs.values())
        if ctx.requested == "cuda" and ctx.device != "cuda":
            raise RuntimeError(f"{op}: the 'cuda' plane was requested but "
                               f"the operands lie on the host")
        table = self._table(op)
        for rejected, v in enumerate(
                self._ranking(op, args, kwargs, ctx, table)[2]):
            if v.matches(*args, **kwargs):
                return v, ctx, rejected
        raise LookupError(
            f"no variant of op {op!r} takes these arguments on "
            f"{ctx.device!r}; registered: {sorted(table)}")

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
        return self._select(op, args, kwargs)[0]

    def explain(self, op: str, *args: Any, variant: Optional[str] = None,
                **kwargs: Any) -> list[dict]:
        """The full ranked candidate table for this call, without
        executing or measuring anything (DESIGN.md §14).

        One row per variant in selection order.  Each carries the ranking
        inputs (``cost``, ``calibrated_seconds``, ``source``) and the
        verdict: ``selected`` on exactly one row (the variant
        :meth:`dispatch` would run — same ranking, same predicates), and
        on every loser a ``reason``:

            plane-unavailable       a 'cuda' variant on host operands, or
                                    a 'torch' variant on CUDA operands
                                    without use_backend('torch')
            accepts-predicate       ``accepts(*args)`` said no (includes
                                    the block-sparse density gate)
            outranked-by-calibration  admissible, but a measured variant
                                    ranked ahead
            outranked               admissible, beaten on static order

        When every candidate is rejected (the error dispatch would raise),
        every row carries ``no_variant_selected``.  A predicate that
        *raises* is reported as a rejection with the exception inline —
        explain is a diagnostic and must survive what it diagnoses."""
        ctx = select_context(*args, *kwargs.values())
        table = self._table(op)
        ambient, mesh = scope_key(ctx)
        base = {"op": op, "level": ctx.level.name, "ambient_scope": ambient,
                "mesh": mesh, "device": ctx.device}
        if variant is not None:
            pin = self.get(op, variant)
            ok = not (pin.plane == "cuda" and ctx.device != "cuda")
            return [{**base, "rank": 0, "variant": pin.name,
                     "plane": pin.plane, "scope": pin.scope,
                     "out_sharding": _out_sharding_row(pin, ctx, args,
                                                       kwargs),
                     "cost": pin.cost,
                     "calibrated_seconds": None, "source": "pinned",
                     "selected": ok, "no_variant_selected": not ok,
                     "reason": "selected: explicit variant= pin" if ok
                     else pin.unavailable_reason(ctx)}]
        ranked, measured, _ = self._ranking(op, args, kwargs, ctx, table)
        bad_request = ctx.requested == "cuda" and ctx.device != "cuda"
        rows: list[dict] = []
        winner_calibrated = False
        have_winner = False
        for i, v in enumerate(ranked):
            row = {**base, "rank": i, "variant": v.name, "plane": v.plane,
                   "scope": v.scope,
                   "out_sharding": _out_sharding_row(v, ctx, args, kwargs),
                   "cost": v.cost,
                   "calibrated_seconds": measured[v.name][0]
                   if v.name in measured else None,
                   "source": "calibrated" if v.name in measured
                   else "static", "selected": False}
            if bad_request:
                row["reason"] = ("plane-unavailable: the 'cuda' plane was "
                                 "requested but the operands lie on the "
                                 "host")
            elif _available(v, ctx, row):
                try:
                    ok = v.matches(*args, **kwargs)
                    why = "accepts-predicate: rejected these arguments" \
                        + (f" — {v.doc}" if v.doc else "")
                except Exception as e:          # diagnose, don't die
                    ok, why = False, ("accepts-predicate raised "
                                      f"{type(e).__name__}: {e}")
                if not ok:
                    row["reason"] = why
                elif not have_winner:
                    have_winner = True
                    winner_calibrated = v.name in measured
                    row["selected"] = True
                    row["reason"] = "selected: first admissible in rank " \
                        "order" + (" (calibrated)" if winner_calibrated
                                   else "")
                else:
                    row["reason"] = ("outranked-by-calibration: admissible,"
                                     " but a measured variant ranked ahead"
                                     if winner_calibrated and
                                     v.name not in measured
                                     else "outranked: admissible, beaten "
                                     "on rank order")
            rows.append(row)
        if not have_winner:
            for row in rows:
                row["no_variant_selected"] = True
        return rows

    def dispatch(self, op: str, *args: Any, variant: Optional[str] = None,
                 **kwargs: Any) -> Any:
        """Select (per the module docstring's rules) and invoke.

        Instrumented (DESIGN.md §14): per-(op, variant) selection counts
        and fall-off counts are always on (two dict bumps); a span per
        dispatch while the tracer is enabled; a hand-written kernel's call
        reckoned while a counting pass (:func:`costmodel.counting`) is
        open; whole-call drift timing
        only under :func:`repro_torch.obs.drift.collect`, where a call on
        CUDA operands is bracketed by ``torch.cuda.synchronize()`` — a
        host sync no default path pays — and never while a CUDA graph is
        being captured."""
        metrics = obs_metrics.METRICS
        if variant is not None:
            v = self.select(op, *args, variant=variant, **kwargs)
            metrics.counter(f"dispatch.{op}.{v.name}").inc()
            out = v.impl(*args, **kwargs)
            return out if v.out_sharding is None else \
                _attach_out_sharding(v, None, args, kwargs, out)
        v, ctx, rejected = self._select(op, args, kwargs)
        metrics.counter(f"dispatch.{op}.{v.name}").inc()
        if rejected:
            metrics.counter(f"dispatch.falloff.{op}").inc()
        tracer = obs_trace.TRACER
        if not (tracer.enabled or obs_drift.collecting()):
            out = v.impl(*args, **kwargs)
            if costmodel.COUNTING is not None and v.plane == "cuda":
                costmodel.count_call(op, args, kwargs, out)
            return out if v.out_sharding is None else \
                _attach_out_sharding(v, ctx, args, kwargs, out)
        if rejected:
            tracer.event("dispatch.falloff", cat="dispatch", op=op,
                         variant=v.name, rejected=rejected)
        scope, mesh = scope_key(ctx)
        with tracer.span(f"dispatch:{op}", cat="dispatch", op=op,
                         variant=v.name, plane=str(v.plane), scope=v.scope,
                         level=ctx.level.name, mesh=mesh):
            if not obs_drift.collecting() or (ctx.device == "cuda"
                                              and blocking.capturing()):
                out = v.impl(*args, **kwargs)
                return out if v.out_sharding is None else \
                    _attach_out_sharding(v, ctx, args, kwargs, out)
            on_card = ctx.device == "cuda"
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = v.impl(*args, **kwargs)
            if on_card:
                torch.cuda.synchronize()
            obs_drift.DETECTOR.observe(op, v.name, time.perf_counter() - t0,
                                       args, kwargs, scope=scope, mesh=mesh)
            return out if v.out_sharding is None else \
                _attach_out_sharding(v, ctx, args, kwargs, out)


def calibration_ranks(records: dict[str, dict]
                      ) -> dict[str, tuple[float, float]]:
    """The reorder rule of calibration: ``{name: (seconds, rank)}`` of
    measured records ``{name: {"seconds", "spread"?}}``.  ``rank`` is 0 for
    every variant no slower than the fastest by more than the margin (the
    larger of :data:`CALIBRATION_MARGIN` of the fastest's seconds and
    either's spread): those keep their static order.  A slower one ranks
    by its seconds."""
    fast = min(records.values(), key=lambda r: r["seconds"])
    out = {}
    for name, rec in records.items():
        margin = max(CALIBRATION_MARGIN * fast["seconds"],
                     fast.get("spread", 0.0), rec.get("spread", 0.0))
        behind = rec["seconds"] - fast["seconds"] > margin
        out[name] = (rec["seconds"], rec["seconds"] if behind else 0.0)
    return out


def _out_sharding_row(v: Variant, ctx: SelectContext, args: tuple,
                      kwargs: dict) -> Optional[str]:
    """Explain's ``out_sharding`` entry: the layout ``v`` would leave, or
    None, or the exception its hook raised (explain survives what it
    diagnoses)."""
    try:
        sh = v.decide_out_sharding(ctx, args, kwargs)
    except Exception as e:                  # diagnose, don't die
        return f"out_sharding hook raised {type(e).__name__}: {e}"
    return str(sh) if sh is not None else None


def _available(v: Variant, ctx: SelectContext, row: dict) -> bool:
    """``v.is_available(ctx)`` for explain: a no (or a predicate that
    raises) writes its reason into ``row``."""
    try:
        if v.is_available(ctx):
            return True
        row["reason"] = v.unavailable_reason(ctx)
    except Exception as e:                  # diagnose, don't die
        row["reason"] = (f"available-predicate raised {type(e).__name__}: "
                         f"{e}")
    return False


def _call_key(args: tuple, kwargs: dict) -> tuple:
    """What the cost model's lookup reads of a call (each argument's shape
    and dtype, structured arguments' ``cost_dims``, int and bool keywords),
    as a hashable key: the memoised ranking's, cheaper than the
    signature's strings."""
    key = []
    for a in args:
        key.append((getattr(a, "shape", None), getattr(a, "dtype", None)))
        if callable(getattr(a, "cost_dims", None)):
            key.append(tuple(a.cost_dims().items()))
    for k, v in kwargs.items():
        if isinstance(v, (bool, int)):
            key.append((k, v))
        elif callable(getattr(v, "cost_dims", None)):
            key.append((k, tuple(v.cost_dims().items())))
    return tuple(key)


#: Process-global registry instance.
REGISTRY = OperatorRegistry()

register = REGISTRY.register
unregister = REGISTRY.unregister
dispatch = REGISTRY.dispatch
select = REGISTRY.select
explain = REGISTRY.explain
variants = REGISTRY.variants
ops = REGISTRY.ops
