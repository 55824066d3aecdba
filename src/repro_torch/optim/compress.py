"""Gradient compression with error feedback (counterpart of
``repro.optim.compress``, chip scope).

``quantize_int8`` / ``dequantize_int8`` and ``compressed``, an optimizer
transform: gradients pass through int8 quantisation before the inner
update, and the quantisation error is carried in the state and re-added
next step, so information is delayed, not lost (Seide et al. 1-bit SGD
lineage).  ``compressed_psum``, the int8 exchange over a mesh axis, is
the LM half of mesh scope (ROADMAP queue 1 item 10b-ii) and raises.
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
    raise NotImplementedError(
        "compressed_psum exchanges over a mesh axis: the LM half of mesh "
        "scope, not ported yet (ROADMAP queue 1 item 10b-ii)")
