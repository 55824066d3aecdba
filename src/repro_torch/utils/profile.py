"""Trace introspection: the counterpart of ``repro.utils.hlo``.

The reference reads optimized HLO text; the port reads a
``torch.profiler`` trace recorded with ``record_shapes=True``:

    collective_bytes(prof)   operand bytes per collective kind, under the
                             reference's :data:`COLLECTIVE_KINDS`, plus
                             'total' (what the roofline's collective term
                             divides by the link rate)
    count_ops(prof, name)    how many events of that name the trace holds
    result_bytes(prof)       bytes each collective left on this rank

Each ``torch.distributed`` collective shows as one ``c10d::`` op (whose
recorded shapes give its tensors: the output first, then the input, for
the ``_base_`` forms) and one backend op (``gloo:all_reduce``,
``nccl:...``), the only place a tensor-list collective (``allreduce_``,
``send``) shows its shape; each ``c10d::`` op is paired with the first
unclaimed backend op that starts after it.  A point-to-point exchange
counts once, as a collective-permute of what this rank sends.  Element
sizes come from the recorded dtypes where the profiler keeps them, else
``itemsize``.

Also here, for ``chip_smoke.py`` and anything that profiles the card:
:func:`device_breakdown`, which sums a run's CUDA kernel time by
:func:`kernel_group`.
"""
from __future__ import annotations

import contextlib
import importlib
import math
import time
from collections import defaultdict
from typing import Any, Callable, Optional

import torch

__all__ = ["collective_bytes", "count_ops", "result_bytes",
           "COLLECTIVE_KINDS", "kernel_group", "device_breakdown",
           "fmt_breakdown", "ranged", "RANGES", "MATMUL_GROUP"]

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

#: c10d op name (without its namespace) -> (kind, index of the operand
#: among the recorded shapes, index of the result; None: the backend op's)
_C10D = {
    "allreduce_": ("all-reduce", None, None),
    "allreduce_coalesced_": ("all-reduce", None, None),
    "_reduce_scatter_base_": ("reduce-scatter", 1, 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1, 0),
    "reduce_scatter_": ("reduce-scatter", None, None),
    "_allgather_base_": ("all-gather", 1, 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 1, 0),
    "allgather_": ("all-gather", None, None),
    "alltoall_base_": ("all-to-all", 1, 0),
    "alltoall_": ("all-to-all", None, None),
    "send": ("collective-permute", None, None),
    "recv_": (None, None, None),            # a send's other end
    "recv_any_source_": (None, None, None),
}

_BACKENDS = ("gloo:", "nccl:")

_DTYPE_BYTES = {"float": 4, "float32": 4, "double": 8, "float64": 8,
                "c10::Half": 2, "c10::BFloat16": 2, "half": 2,
                "bfloat16": 2, "int": 4, "long int": 8, "int64": 8,
                "c10::complex<float>": 8, "c10::complex<double>": 16,
                "unsigned char": 1, "signed char": 1, "bool": 1}


def _bytes(shape, dtype: Optional[str], itemsize: int) -> int:
    if not shape:
        return 0
    size = _DTYPE_BYTES.get(dtype, itemsize) if dtype else itemsize
    return math.prod(shape) * size


def _events(prof) -> list:
    return sorted(prof.events(), key=lambda e: e.time_range.start)


def _nested(e) -> bool:
    """Whether an enclosing event has ``e``'s name: the same op again
    under a dispatch mode (a counting pass records each op once a mode)."""
    p = e.cpu_parent
    while p is not None:
        if p.name == e.name:
            return True
        p = p.cpu_parent
    return False


def _collectives(prof, itemsize: int) -> list[tuple[str, str, int, int]]:
    """(c10d op name, kind, operand bytes, result bytes) per collective."""
    events = _events(prof)
    backend = [e for e in events if e.name.startswith(_BACKENDS)]
    claimed = [False] * len(backend)
    out = []
    for e in events:
        if not e.name.startswith("c10d::"):
            continue
        name = e.name[len("c10d::"):]
        if name not in _C10D or _nested(e):
            continue
        kind, i_in, i_out = _C10D[name]
        mine = None
        for j, b in enumerate(backend):
            if not claimed[j] and b.time_range.start >= e.time_range.start:
                claimed[j] = True
                mine = b
                break
        shapes = e.input_shapes or []
        dtypes = getattr(e, "input_dtypes", None) or [None] * len(shapes)
        if i_in is not None and len(shapes) > i_in:
            operand = _bytes(shapes[i_in], dtypes[i_in], itemsize)
            result = _bytes(shapes[i_out], dtypes[i_out], itemsize)
        elif mine is not None and mine.input_shapes:
            bd = getattr(mine, "input_dtypes", None) or [None]
            operand = result = _bytes(mine.input_shapes[0], bd[0], itemsize)
        else:
            operand = result = 0
        out.append((e.name, kind, operand, result))
    return out


def collective_bytes(prof, itemsize: int = 4) -> dict[str, int]:
    """Total *operand* bytes per collective kind (plus 'total') of the
    ``torch.distributed`` collectives in a trace, as the reference counts
    them in HLO: an all-gather's is the local shard, a reduce-scatter's
    the whole partial."""
    totals: dict[str, int] = defaultdict(int)
    for _, kind, operand, _ in _collectives(prof, itemsize):
        if kind is None:
            continue
        totals[kind] += operand
        totals["total"] += operand
    return dict(totals)


def result_bytes(prof, itemsize: int = 4) -> dict[str, int]:
    """c10d op name -> the bytes its calls left on this rank (an
    all-gather's gathered tensor, a reduce-scatter's shard), summed."""
    out: dict[str, int] = defaultdict(int)
    for name, _, _, result in _collectives(prof, itemsize):
        out[name] += result
    return dict(out)


def count_ops(prof, name: str) -> int:
    """How many events named ``name`` the trace holds (an aten op, a
    ``c10d::`` collective, a kernel)."""
    return sum(1 for e in prof.events() if e.name == name)


# ---------------------------------------------------------------------------
# device time by group
# ---------------------------------------------------------------------------

MATMUL_GROUP = "matmul (cuBLAS)"


def kernel_group(name: str) -> str:
    """The group a CUDA kernel's device time is counted under, by name."""
    low = name.lower()
    if "fa_bwd_" in name:
        return "flash-attention backward"
    if "flash_attention_lens_decode" in name:
        return "flash_attention_lens (decode)"
    if "flash_attention_lens_prefix" in name:
        return "flash_attention_lens (prefix)"
    if "flash_attention_tiles_" in name:
        return "flash_attention_tiles"
    if "flash_attention_kernel" in name:
        return "flash_attention"
    if any(t in low for t in ("gemm", "gemv", "cutlass", "xmma", "nvjet",
                              "cublas", "splitk")):
        return MATMUL_GROUP
    if any(t in low for t in ("index", "gather", "scatter")):
        return "gather/scatter"
    if "copy" in low or "cat" in low:
        return "copies"
    return "elementwise/reduce"


#: The profiler ranges device_breakdown(..., group=label) can split out:
#: label -> (module of repro_torch.models, the functions that run under a
#: range of that label).  The transformer and the LM call them through the
#: module attribute, so wrapping the attribute covers every call.
RANGES = {"moe": ("moe", ("moe_apply",)),
          "ssm": ("ssm", ("mamba2_apply_state", "mamba2_decode"))}


@contextlib.contextmanager
def ranged(label: str):
    """Run every call of the functions of :data:`RANGES` [label] under a
    profiler range named ``label``, so that a trace can tell their kernels
    apart."""
    mod_name, names = RANGES[label]
    mod = importlib.import_module(f"repro_torch.models.{mod_name}")
    origs = {n: getattr(mod, n) for n in names}

    def wrap(orig):
        def run(*args, **kwargs):
            with torch.profiler.record_function(label):
                return orig(*args, **kwargs)
        return run

    for n, orig in origs.items():
        setattr(mod, n, wrap(orig))
    try:
        yield
    finally:
        for n, orig in origs.items():
            setattr(mod, n, orig)


def range_kernel_s(prof, label: str) -> dict:
    """Device seconds of the kernels launched under the ranges named
    ``label`` of a trace with CPU activity, by :func:`kernel_group` (the
    profiler hangs each kernel on the CPU op that launched it)."""
    out: dict = {}

    def walk(ev):
        for k in ev.kernels:
            g = kernel_group(k.name)
            out[g] = out.get(g, 0.0) + k.duration / 1e6
        for ch in ev.cpu_children:
            walk(ch)

    for ev in prof.events():
        if ev.name == label:
            walk(ev)
    return out


def device_breakdown(fn: Callable[[], Any], group: Optional[str] = None
                     ) -> dict:
    """Run ``fn`` once unprofiled (host clock, synchronised), then once
    under torch.profiler (CUDA activity only, which keeps its host cost
    low), and sum the device time of the run's CUDA kernels by group.  The
    busy share is that sum over the unprofiled wall time; one stream, so
    kernels do not overlap.  With ``group`` (a label of :data:`RANGES`)
    the profiled run also records CPU activity and runs that label's
    functions under :func:`ranged`: the kernels they launch move to a
    group of that name, except their matrix products, which stay under
    cuBLAS (``in_range`` keeps the range's device time by name group,
    cuBLAS included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if group
                                      else [])
    with ranged(group) if group else contextlib.nullcontext(), \
            profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    groups: dict = {}
    top = []
    averages = prof.key_averages()
    for e in averages:
        # the ranges' own device spans are not kernels
        if e.device_type != DeviceType.CUDA or e.device_time_total <= 0 \
                or e.key in RANGES:
            continue
        g = kernel_group(e.key)
        t_s = e.device_time_total / 1e6
        groups[g] = groups.get(g, 0.0) + t_s
        top.append((t_s, e.key[:70]))
    host_top, in_range = [], {}
    if group:
        groups[group] = 0.0
        in_range = range_kernel_s(prof, group)
        for g, t_s in in_range.items():
            if g != MATMUL_GROUP and g in groups:
                groups[g] -= t_s
                groups[group] += t_s
        host_top = sorted(((e.self_cpu_time_total / 1e6, e.count, e.key)
                           for e in averages
                           if e.device_type == DeviceType.CPU),
                          reverse=True)[:8]
    busy = sum(groups.values())
    return {"wall_s": wall, "busy_s": busy, "idle_share": 1.0 - busy / wall,
            "groups": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "top": sorted(top, reverse=True)[:6], "host_top": host_top,
            "in_range": in_range}


def fmt_breakdown(b: dict) -> str:
    """One log line (and its continuations) of a :func:`device_breakdown`."""
    if not b["groups"]:
        return "no device time in the trace"
    parts = ", ".join(f"{g} {t * 1e3:.1f} ms ({t / b['busy_s']:.0%})"
                      for g, t in b["groups"].items())
    top = "; ".join(f"{n} {t * 1e3:.1f} ms" for t, n in b["top"])
    host = "; ".join(f"{n} {t * 1e3:.1f} ms ({c} calls)"
                     for t, c, n in b.get("host_top", ()))
    in_range = ", ".join(f"{g} {t * 1e3:.1f} ms"
                         for g, t in b.get("in_range", {}).items())
    return (f"wall {b['wall_s'] * 1e3:.1f} ms, device busy "
            f"{b['busy_s'] * 1e3:.1f} ms, idle share {b['idle_share']:.0%}: "
            f"{parts}\n    top kernels: {top}"
            + (f"\n    under the ranges, by name group: {in_range}"
               if in_range else "")
            + (f"\n    host ops by self time (profiled run): {host}"
               if host else ""))
