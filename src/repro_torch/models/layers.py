"""Shared model layers: norms, rotary embeddings, gated MLPs, initialisers
(counterpart of ``repro.models.layers``).

Parameters are plain dicts of tensors, as the JAX package keeps pytrees.
dtype policy: parameters are stored in ``cfg.pdtype``, activations in
``cfg.act_dtype``; norm variance, rope trig and the MLP activation run in
f32.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "rms_norm_init", "rope", "mrope_positions",
           "apply_rope", "mlp", "mlp_init", "dense_init", "linear"]

Params = dict[str, Any]


#: A leaf of more elements than this is drawn slice by slice along its
#: first dim, so that init holds one slice in f32 beside the result, not
#: the whole leaf (an arctic-480b expert leaf is 4.5 G elements, 17.8 GB in
#: f32).  Every leaf of the other configs is drawn whole.
DRAW_WHOLE_ELEMENTS = 1 << 30


def dense_init(gen: torch.Generator, shape, scale: float | None = None,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) fan-in init, drawn in f32 from ``gen``
    on ``device`` (the generator's device), then cast to ``dtype``.  On the
    ``meta`` device nothing is drawn: an empty tensor of the shape."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    dev = device or gen.device
    if torch.device(dev).type == "meta":        # shapes only (abstract_state)
        return torch.empty(shape, dtype=dtype, device=dev)

    def draw(s):
        w = torch.empty(s, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return w.mul_(scale).to(dtype)

    if math.prod(shape) <= DRAW_WHOLE_ELEMENTS:
        return draw(shape)
    out = torch.empty(shape, dtype=dtype, device=dev)
    for i in range(shape[0]):
        out[i] = draw(shape[1:])
    return out


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for ``w`` (in, out) in x's dtype.  The products accumulate
    in f32 (cuBLAS does for bf16 operands; f32 stays f32) and the result is
    rounded once to x's dtype, as ``dot_general(preferred_element_type=f32)
    .astype(x.dtype)`` does."""
    return torch.matmul(x, w.to(x.dtype))


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rms_norm_init(d: int, dtype=torch.float32, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rms_norm(x: torch.Tensor, p: Params, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (RoPE + qwen2-vl's M-RoPE)
# ---------------------------------------------------------------------------

def rope(positions: torch.Tensor, head_dim: int, theta: float
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., L) int positions -> cos/sin of shape (..., L, head_dim/2), f32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def mrope_positions(seq_len: int, frontend_len: int, grid_hw: int,
                    device=None) -> torch.Tensor:
    """M-RoPE (qwen2-vl): 3 position streams (temporal, height, width).

    Patch positions (first ``frontend_len`` slots): t = 0, (h, w) from a
    square ``grid_hw`` raster.  Text positions: all three streams advance
    together, offset past the visual block.  Returns (3, seq_len) int32.
    """
    idx = torch.arange(seq_len, dtype=torch.int32, device=device)
    vis = idx < frontend_len
    zero = torch.zeros_like(idx)
    text = (idx - frontend_len).clamp_min(0) \
        + frontend_len // max(grid_hw, 1)
    return torch.stack([
        torch.where(vis, zero, text),
        torch.where(vis, idx // grid_hw, text),
        torch.where(vis, idx % grid_hw, text),
    ])


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               mrope_sections: tuple[int, ...] | None = None
               ) -> torch.Tensor:
    """Rotate pairs.  x: (B, H, L, D); cos/sin: (B, L, D/2), or (3, B, L,
    D/2) for M-RoPE, where ``mrope_sections`` splits D/2 across the 3
    streams."""
    if mrope_sections is not None:
        # stitch per-stream cos/sin along the feature dim
        bounds = [0]
        for sec in mrope_sections:
            bounds.append(bounds[-1] + sec)
        cos = torch.cat([cos[s, ..., a:b] for s, (a, b) in
                         enumerate(zip(bounds, bounds[1:]))], dim=-1)
        sin = torch.cat([sin[s, ..., a:b] for s, (a, b) in
                         enumerate(zip(bounds, bounds[1:]))], dim=-1)
    cos = cos[:, None, :, :]
    sin = sin[:, None, :, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLPs (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.float32) -> Params:
    return {
        "wi_gate": dense_init(gen, (d_model, d_ff), dtype=dtype),
        "wi_up": dense_init(gen, (d_model, d_ff), dtype=dtype),
        "wo": dense_init(gen, (d_ff, d_model), dtype=dtype),
    }


def mlp(x: torch.Tensor, p: Params, kind: str = "swiglu") -> torch.Tensor:
    gate = linear(x, p["wi_gate"])
    up = linear(x, p["wi_up"])
    if kind == "swiglu":
        act = F.silu(gate.float()).to(x.dtype)
    elif kind == "geglu":
        act = F.gelu(gate.float(), approximate="tanh").to(x.dtype)
    else:
        raise ValueError(kind)
    return linear(act * up, p["wo"])
