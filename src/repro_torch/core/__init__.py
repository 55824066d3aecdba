"""repro_torch.core — the ArBB data-parallel programming model on PyTorch.

The counterpart of ``repro.core``:

    Dense, bind                      containers + host interop
    add_reduce, section, repeat_row, repeat_col, replace_col, cat, ...
    arbb_for, arbb_while, arbb_if, unrolled
    call, capture, emap
    ExecLevel, use_level             O2 one card; O3, O4 a mesh of ranks
    axis_roles, MeshTopology         mesh topology (core/topology.py)
    registry (dispatch, register, use_backend)
"""
from repro_torch.core.containers import (
    Dense,
    bind,
    f32,
    f64,
    i32,
    i64,
    usize,
    is_dense,
    unwrap,
    wrap,
)
from repro_torch.core.ops import (
    add_reduce,
    max_reduce,
    min_reduce,
    mul_reduce,
    section,
    repeat,
    repeat_row,
    repeat_col,
    replace_col,
    replace_row,
    cat,
    shift,
    gather,
    dot,
)
from repro_torch.core.control import arbb_for, arbb_while, arbb_if, unrolled
from repro_torch.core.closure import call, capture, emap, Closure, CallClosure
from repro_torch.core.execlevel import ExecLevel, ExecContext, use_level, current
from repro_torch.core.topology import MeshTopology, axis_roles, topology_of
from repro_torch.core import registry
from repro_torch.core.registry import (dispatch, register, use_backend,
                                       resolve_backend)

__all__ = [
    "Dense", "bind", "f32", "f64", "i32", "i64", "usize", "is_dense",
    "unwrap", "wrap",
    "add_reduce", "max_reduce", "min_reduce", "mul_reduce", "section",
    "repeat", "repeat_row", "repeat_col", "replace_col", "replace_row",
    "cat", "shift", "gather", "dot",
    "arbb_for", "arbb_while", "arbb_if", "unrolled",
    "call", "capture", "emap", "Closure", "CallClosure",
    "ExecLevel", "ExecContext", "use_level", "current",
    "MeshTopology", "axis_roles", "topology_of",
    "registry", "dispatch", "register", "use_backend", "resolve_backend",
]
