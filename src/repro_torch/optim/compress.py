"""Gradient compression with error feedback (counterpart of
``repro.optim.compress``).

``quantize_int8`` / ``dequantize_int8`` and ``compressed``, an optimizer
transform: gradients pass through int8 quantisation before the inner
update, and the quantisation error is carried in the state and re-added
next step, so information is delayed, not lost (Seide et al. 1-bit SGD
lineage).  ``compressed_psum``: the int8-quantised exchange over a named
axis of the ambient mesh.  As in the JAX package, its sum runs on int32
accumulators and no trainer calls it.
"""
from __future__ import annotations

import torch

from repro_torch.utils.tree import tree_map

__all__ = ["quantize_int8", "dequantize_int8", "compressed",
           "compressed_psum"]


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed(optimizer):
    """Wrap an Optimizer: grads pass through int8 quantisation with error
    feedback before the inner update."""
    from repro_torch.optim.adamw import Optimizer, _pick

    def init(params):
        ef = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params)
        return {"inner": optimizer.init(params), "ef": ef}

    def update(grads, state, params):
        def q(g, e):
            g32 = g.float() + e
            qv, s = quantize_int8(g32)
            deq = dequantize_int8(qv, s)
            return deq, g32 - deq

        pairs = tree_map(q, grads, state["ef"])
        updates, inner = optimizer.update(_pick(pairs, 0), state["inner"],
                                          params)
        return updates, {"inner": inner, "ef": _pick(pairs, 1)}

    return Optimizer(init=init, update=update)


def compressed_psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """int8-quantised all-reduce of ``x`` over the ambient mesh's axis
    ``axis_name`` (``use_level(O3|O4)``): each rank quantises locally, the
    scales are max-combined, each rank re-quantises against the shared
    scale so the sum is coherent, the int8 values are summed in int32 (no
    overflow for up to 2^23 participants) and the sum dequantised.  On an
    axis of one rank it is the quantisation round trip."""
    import torch.distributed as dist

    from repro_torch.core import execlevel
    from repro_torch.distributed.collectives import all_reduce, mesh_groups

    mesh = execlevel.current().mesh
    if mesh is None or axis_name not in mesh.mesh_dim_names:
        raise ValueError(f"compressed_psum over {axis_name!r}: the ambient "
                         f"mesh has no such axis; enter use_level(O3|O4) "
                         f"on a mesh that has it")
    size = int(mesh.shape[list(mesh.mesh_dim_names).index(axis_name)])
    groups = mesh_groups(mesh) if size > 1 else None
    q, scale = quantize_int8(x)
    if groups is not None:              # a common upper bound of the scales
        scale = all_reduce(scale, groups.axis[axis_name], groups.transport,
                           dist.ReduceOp.MAX)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    total = q.to(torch.int32)
    if groups is not None:
        total = all_reduce(total, groups.axis[axis_name], groups.transport)
    return total.to(torch.float32) * scale
