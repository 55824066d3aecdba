"""Measured cost model: the calibrated half of the dispatch brain
(counterpart of ``repro.core.costmodel``, chip scope).

The paper's core result is a *measured* comparison (ArBB against MKL and
OpenMP, GFLOP/s per kernel, Figs. 1-7), yet dispatch ranked variants by
hand-written ``cost=`` priors.  This module holds what the calibration
sweep (:mod:`repro_torch.launch.calibrate`) measured on the card — whole
dispatched-call seconds per variant — beside the roofline-predicted time
for the same call on the H100 (:data:`repro_torch.utils.roofline.H100`,
at the operands' dtype), and feeds it back into
:meth:`repro_torch.core.registry.OperatorRegistry.select`.

Keys reuse the block cache's scheme (``op|dims|dtype|scope|mesh``,
:meth:`repro_torch.core.blocking.AutotuneCache.key`) with a *generic*
argument signature, and mean the same thing in both packages: for the
same shapes the port's exact and class keys equal the reference's letter
for letter (dtypes are numpy-style names, ``float32``, not
``torch.float32``)::

    matmul|a0.0=256,a0.1=256,a1.0=256,a1.1=256|float32|chip|-

Every measurement is stored twice: under the exact key and under a *shape
class* key (``~``-prefixed op, every dim bucketed to the next power of
two), so one sweep point covers the whole class.  The port writes only
five-part keys, into files of its own, so it merges no legacy three-part
keys (the reference's ``upgrade_legacy_keys`` has nothing to read here).

Entry format (one dict per key, one record per variant)::

    {"cuda": {"seconds": 3.1e-5, "spread": 4e-7, "gflops": 108.2,
              "predicted_seconds": 1.7e-5, "hw": "NVIDIA H100 80GB HBM3"}}

``seconds`` is the median of the timed calls, ``spread`` (where the sweep
recorded one) their interquartile range, and ``hw`` names the device the
seconds were measured on.  The file lives
beside the block cache (``results/torch/costmodel.json``; path override
via ``REPRO_TORCH_COSTMODEL``, read once by
:mod:`repro_torch.core.settings`).  Precedence at dispatch is ``variant=``
pin > requested plane > calibrated cost > static prior; a singleton
measurement never re-ranks, only variants admissible on the operands'
device count, and a difference within the margin or the spread reorders
nothing (the registry's ``_calibrated``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import json
import os
import threading
from typing import Any, Iterator, Mapping, Optional, Sequence

import torch

from repro_torch.core import settings
from repro_torch.core.blocking import AutotuneCache
from repro_torch.utils.roofline import H100, HW

__all__ = ["CostModel", "get_model", "signature", "shape_class", "dtype_of",
           "dtype_name", "arg_bytes", "predicted_seconds", "call_flops",
           "counting", "count_call", "KernelCount", "DEFAULT_MODEL_PATH"]

DEFAULT_MODEL_PATH = settings.DEFAULT_MODEL_PATH

#: shape-class keys prefix the op with this marker so exact and class
#: entries can never collide (op names never start with it).
CLASS_MARK = "~"

#: Versions are unique across every model of the process, so a ranking
#: memoised against one model's state never answers for another's.
_versions = itertools.count(1)


# ---------------------------------------------------------------------------
# argument signatures
# ---------------------------------------------------------------------------

def signature(args: Sequence[Any],
              kwargs: Optional[Mapping[str, Any]] = None) -> dict[str, int]:
    """Generic dims of a call: every axis of every shaped positional arg
    (``a<i>.<axis>``) plus int/bool kwargs (``causal=1``).  Shapeless args
    (offset tuples, configs) contribute nothing; an all-shapeless call has
    an empty signature and is never calibrated.

    Structured arguments — positional or keyword — may expose
    ``cost_dims() -> {str: int}`` to contribute a fingerprint
    (``mask.window=128``, ``a0.nnzb=96``): how a
    :class:`~repro_torch.sparse.maskcompiler.MaskSpec` keeps differently
    masked calls of the same shapes in different shape classes, and how a
    :class:`~repro_torch.sparse.formats.BSR` operand keys SpGEMM per block
    density and edge, not per dense shape."""
    dims: dict[str, int] = {}
    for i, a in enumerate(args):
        shape = getattr(a, "shape", None)
        if shape is None:
            continue
        try:
            for ax, s in enumerate(shape):
                dims[f"a{i}.{ax}"] = int(s)
        except TypeError:
            continue
        if callable(getattr(a, "cost_dims", None)):
            for sk, sv in a.cost_dims().items():
                dims[f"a{i}.{sk}"] = int(sv)
    for k, v in (kwargs or {}).items():
        if isinstance(v, bool) or (isinstance(v, int)
                                   and not hasattr(v, "shape")):
            dims[k] = int(v)
        elif callable(getattr(v, "cost_dims", None)):
            for sk, sv in v.cost_dims().items():
                dims[f"{k}.{sk}"] = int(sv)
    return dims


def shape_class(dims: Mapping[str, int]) -> dict[str, int]:
    """Bucket every dim to the next power of two — the shape class one
    sweep measurement speaks for (256 and 250 land in the same class; 257
    does not)."""
    return {k: (1 << (int(v) - 1).bit_length()) if v > 0 else 0
            for k, v in dims.items()}


def dtype_name(dt: Any) -> str:
    """A dtype as numpy spells it: ``torch.float32`` -> ``"float32"``."""
    if isinstance(dt, torch.dtype):
        return str(dt).rpartition(".")[2]
    return str(dt)


def dtype_of(args: Sequence[Any]) -> str:
    """The numpy-style dtype name of the first argument that has one."""
    for a in args:
        dt = getattr(a, "dtype", None)
        if dt is not None:
            return dtype_name(dt)
    return "-"


def arg_bytes(args: Sequence[Any]) -> int:
    """Bytes of every tensor in ``args`` — tensors, containers whose fields
    hold tensors (``Dense``, ``CSR``, ``BSR``, ...), tuples of either —
    each counted once: the memory-term numerator of the roofline
    prediction (a lower bound: each operand read once).  Unlike the
    reference's, it counts the arrays inside a sparse container."""
    seen: set = set()
    total = 0

    def walk(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            if x.data_ptr() not in seen:
                seen.add(x.data_ptr())
                total += x.nbytes
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))

    walk(args)
    return total


def predicted_seconds(flops: Optional[float], bytes_moved: Optional[float],
                      hw: HW = H100, dtype: str = "float32"
                      ) -> Optional[float]:
    """Two-term roofline prediction for one call: max(compute term at the
    peak for ``dtype``, memory term) on ``hw``."""
    terms = []
    if flops:
        terms.append(float(flops) / hw.peak_for(dtype))
    if bytes_moved:
        terms.append(float(bytes_moved) / hw.hbm_bw)
    return max(terms) if terms else None


def _device_name() -> str:
    return torch.cuda.get_device_name() if torch.cuda.is_available() \
        else "cpu"


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class CostModel:
    """JSON-backed per-variant measurement store: key -> {variant: record}.

    ``version`` changes with every load and :meth:`record`, so a ranking
    memoised against it is dropped by the next :meth:`record`."""

    def __init__(self, path: Optional[str] = None) -> None:
        self.path = path or settings.COSTMODEL
        self._data: Optional[dict[str, dict]] = None
        self.version = 0
        self._lock = threading.Lock()

    # -- keys ---------------------------------------------------------------

    @staticmethod
    def key(op: str, dims: Mapping[str, int], dtype: str,
            scope: str = "chip", mesh: str = "-") -> str:
        return AutotuneCache.key(op, dims, dtype, scope, mesh)

    @staticmethod
    def class_key(op: str, dims: Mapping[str, int], dtype: str,
                  scope: str = "chip", mesh: str = "-") -> str:
        return AutotuneCache.key(f"{CLASS_MARK}{op}", shape_class(dims),
                                 dtype, scope, mesh)

    # -- storage ------------------------------------------------------------

    def _load(self) -> dict[str, dict]:
        if self._data is None:
            try:
                with open(self.path) as f:
                    raw = json.load(f)
            except (FileNotFoundError, json.JSONDecodeError):
                raw = {}
            self._data = raw
            self.version = next(_versions)
        return self._data

    def _flush(self, data: dict) -> None:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=2, sort_keys=True)
        os.replace(tmp, self.path)

    def __len__(self) -> int:
        return len(self._load())

    # -- recording ----------------------------------------------------------

    def record(self, op: str, variant: str, *, seconds: float,
               spread: Optional[float] = None,
               args: Sequence[Any] = (),
               kwargs: Optional[Mapping[str, Any]] = None,
               dims: Optional[Mapping[str, int]] = None,
               dtype: Optional[str] = None,
               scope: str = "chip", mesh: str = "-",
               flops: Optional[float] = None,
               bytes_moved: Optional[float] = None,
               hw: HW = H100, device: Optional[str] = None) -> dict:
        """Store one measured (variant, shape, scope, mesh) point under both
        the exact and the shape-class key; latest measurement wins.
        ``spread`` is how far the timed calls scattered (their
        interquartile range).  ``device`` names where ``seconds`` was
        measured (default: the card when one is present, else ``"cpu"``)."""
        dims = dict(dims) if dims is not None else signature(args, kwargs)
        dtype = dtype or dtype_of(args)
        rec: dict[str, Any] = {"seconds": round(float(seconds), 9)}
        if spread is not None:
            rec["spread"] = round(float(spread), 9)
        if flops:
            rec["gflops"] = round(flops / seconds / 1e9, 6)
        pred = predicted_seconds(flops, bytes_moved, hw, dtype)
        if pred is not None:
            rec["predicted_seconds"] = round(pred, 12)
            rec["hw"] = device or _device_name()
        with self._lock:
            data = self._load()
            for key in (self.key(op, dims, dtype, scope, mesh),
                        self.class_key(op, dims, dtype, scope, mesh)):
                data.setdefault(key, {})[variant] = rec
            self._flush(data)
            self.version = next(_versions)
        return rec

    # -- lookup -------------------------------------------------------------

    def _entry(self, op: str, args: Sequence[Any],
               kwargs: Optional[Mapping[str, Any]], scope: str, mesh: str
               ) -> tuple[Optional[str], dict[str, dict]]:
        """The store entry for this call shape and its key — exact key
        first, shape-class fallback, ``(None, {})`` when uncalibrated."""
        dims = signature(args, kwargs)
        if not dims:
            return None, {}
        dtype = dtype_of(args)
        data = self._load()
        for key in (self.key(op, dims, dtype, scope, mesh),
                    self.class_key(op, dims, dtype, scope, mesh)):
            entry = data.get(key)
            if entry:
                return key, {name: rec for name, rec in entry.items()
                             if "seconds" in rec}
        return None, {}

    def lookup(self, op: str, args: Sequence[Any] = (),
               kwargs: Optional[Mapping[str, Any]] = None, *,
               scope: str = "chip", mesh: str = "-",
               ) -> tuple[Optional[str], dict[str, float]]:
        """``(matched_key, {variant: seconds})`` for this call shape —
        exact key first, shape-class fallback, ``(None, {})`` when
        uncalibrated.  The matched key is the store entry that answered,
        which is what drift reporting must name."""
        key, entry = self._entry(op, args, kwargs, scope, mesh)
        return key, {name: float(rec["seconds"])
                     for name, rec in entry.items()}

    def seconds_for(self, op: str, args: Sequence[Any] = (),
                    kwargs: Optional[Mapping[str, Any]] = None, *,
                    scope: str = "chip", mesh: str = "-") -> dict[str, float]:
        """Measured whole-call seconds per variant for this call shape —
        exact key first, shape-class fallback, ``{}`` when uncalibrated."""
        return self.lookup(op, args, kwargs, scope=scope, mesh=mesh)[1]

    def records_for(self, op: str, args: Sequence[Any] = (),
                    kwargs: Optional[Mapping[str, Any]] = None, *,
                    scope: str = "chip", mesh: str = "-"
                    ) -> dict[str, dict[str, float]]:
        """``{variant: {"seconds": s, "spread": r}}`` for this call shape
        (``spread`` only where the sweep recorded one) — what the
        registry's calibration ranks by."""
        entry = self._entry(op, args, kwargs, scope, mesh)[1]
        return {name: {k: float(rec[k]) for k in ("seconds", "spread")
                       if k in rec} for name, rec in entry.items()}

    def agreement(self, op: Optional[str] = None) -> list[dict]:
        """(measured, predicted) pairs for every exact-key record carrying
        both — how far measured seconds sit from the H100 prediction."""
        rows = []
        for key, entry in sorted(self._load().items()):
            kop = key.split("|", 1)[0]
            if kop.startswith(CLASS_MARK):
                continue
            if op is not None and kop != op:
                continue
            for variant, rec in sorted(entry.items()):
                if "seconds" in rec and "predicted_seconds" in rec:
                    rows.append({
                        "op": kop, "key": key, "variant": variant,
                        "measured_seconds": float(rec["seconds"]),
                        "predicted_seconds": float(rec["predicted_seconds"]),
                        "ratio": float(rec["seconds"])
                        / max(float(rec["predicted_seconds"]), 1e-30),
                        "hw": rec.get("hw"),
                    })
        return rows


_model: Optional[CostModel] = None


def get_model() -> CostModel:
    """The process cost model, re-opened if ``REPRO_TORCH_COSTMODEL``
    changed at the last ``settings.reload()`` (lets tests point it at a
    temp file, as the block cache)."""
    global _model
    path = settings.COSTMODEL
    if _model is None or _model.path != path:
        _model = CostModel(path)
    return _model


# ---------------------------------------------------------------------------
# the hand-written kernels' per-call reckoning (the roofline's counting pass)
# ---------------------------------------------------------------------------

def _attention_pairs(q, k, causal: bool, mask=None) -> int:
    """Live (query, key) pairs of one head: every pair, or the causal band
    (top-left aligned, as the kernels), or a mask's live tiles."""
    lq, lk = q.shape[2], k.shape[2]
    if mask is not None and not getattr(mask, "trivial_dense", True):
        return lq * lk
    if mask is not None:
        causal = mask.causal
    if not causal:
        return lq * lk
    m = min(lq, lk)
    return m * (m + 1) // 2 + max(lq - lk, 0) * lk


def call_flops(op: str, args: Sequence[Any],
               kwargs: Optional[Mapping[str, Any]] = None) -> float:
    """The floating-point operations one call of ``op`` needs (its useful
    work: a multiply-add is two), for the ops whose 'cuda' variants are
    hand-written kernels; 0 where the count is not reckoned (SpGEMM's
    depends on the symbolic phase)."""
    kwargs = kwargs or {}
    if op == "matmul":
        a, b = args[:2]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if op in ("spmv_ell", "spmv_dia"):
        return 2.0 * args[0].numel()
    if op == "fft":
        n = args[0].shape[0]
        return 5.0 * n * math.log2(max(n, 2))
    if op in ("flash_attention", "flash_attention_state"):
        q, k = args[0], args[1]
        pairs = _attention_pairs(q, k, kwargs.get("causal", True),
                                 kwargs.get("mask"))
        return 4.0 * q.shape[0] * q.shape[1] * q.shape[3] * pairs
    if op == "spmm":
        a, x = args[0], args[1]
        stored = getattr(a, "nnz", 0)
        if callable(stored):
            stored = stored()
        return 2.0 * int(stored) * getattr(x, "shape", (0, 1))[-1]
    return 0.0


@dataclasses.dataclass
class KernelCount:
    """What a counting pass saw the hand-written kernels do: FLOPs and
    bytes (each operand read once, each result written once), in all and
    per op."""
    flops: float = 0.0
    bytes: float = 0.0
    calls: dict = dataclasses.field(default_factory=dict)

    def add(self, op: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes
        n, f, b = self.calls.get(op, (0, 0.0, 0.0))
        self.calls[op] = (n + 1, f + flops, b + nbytes)


#: The open counting pass, or None (the registry and the attention
#: backward look here after every kernel call; nothing is reckoned while
#: it is None).
COUNTING: Optional[KernelCount] = None


@contextlib.contextmanager
def counting() -> Iterator[KernelCount]:
    """Reckon every hand-written kernel call made inside (the registry's
    'cuda' variants, and the attention backward): the part of a step that
    launches through ctypes, which no dispatch mode sees."""
    global COUNTING
    prev, COUNTING = COUNTING, KernelCount()
    try:
        yield COUNTING
    finally:
        COUNTING = prev


def count_call(op: str, args: Sequence[Any], kwargs: Optional[Mapping[
        str, Any]], out: Any, flops: Optional[float] = None) -> None:
    """Add one kernel call to the open counting pass (if any): its
    :func:`call_flops` (or ``flops``) and the bytes of its operands and
    results."""
    if COUNTING is None:
        return
    COUNTING.add(op, call_flops(op, args, kwargs) if flops is None
                 else flops, arg_bytes((args, out)))
