"""Shared model layers: norms, rotary embeddings, gated MLPs, initialisers
(counterpart of ``repro.models.layers``).

Parameters are plain dicts of tensors, as the JAX package keeps pytrees.
dtype policy: parameters are stored in ``cfg.pdtype``, activations in
``cfg.act_dtype``; norm variance, rope trig and the MLP activation run in
f32.  M-RoPE (qwen2-vl) is not ported yet (ROADMAP queue 1 item 7, the VLM family).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "rms_norm_init", "rope", "apply_rope", "mlp",
           "mlp_init", "dense_init", "linear"]

Params = dict[str, Any]


def dense_init(gen: torch.Generator, shape, scale: float | None = None,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) fan-in init, drawn in f32 from ``gen``
    on ``device`` (the generator's device), then cast to ``dtype``."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    w = torch.empty(shape, dtype=torch.float32, device=device or gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * scale).to(dtype)


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
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope(positions: torch.Tensor, head_dim: int, theta: float
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., L) int positions -> cos/sin of shape (..., L, head_dim/2), f32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Rotate pairs.  x: (B, H, L, D); cos/sin: (B, L, D/2)."""
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
