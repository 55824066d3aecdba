"""Mamba2 (SSD, state-space duality) layer: the chunked full-sequence path
and the recurrent decode path (counterpart of ``repro.models.ssm``).

Shapes (full sequence):  x (B, L, H, P)   dt (B, L, H)   B, C (B, L, G, N)
  intra-chunk:   Y_diag = (C_c B_c^T o decay-mask) . (dt o X_c)
  chunk states:  S_c    = sum_j exp(cum_last - cum_j) dt_j B_j (x) x_j
  inter-chunk:   S      = exp(cum_last) S_prev + S_c      (the carry)
  off-diagonal:  Y_off  = exp(cum) . C_c S_prev

Decode is the O(1) recurrence S <- a S + dt B (x) x, y = C . S + D x.  The
causal depthwise conv1d (width ``conv_width``) is shifted adds.

The JAX package computes all of this outside any Pallas kernel (einsums,
a ``lax.scan`` over the chunks, elementwise work), so here it is plain
torch: ``einsum`` products (cuBLAS on the card) and a Python loop over the
chunks.  Every dtype cast of the reference is mirrored: the mask math, the
chunk states and the recurrence run in f32, ``A_log``, ``D`` and
``dt_bias`` are f32 parameters whatever ``param_dtype`` is, and the
intra-chunk product and the conv run in the activation dtype.

A prompt longer than :data:`CHUNK` tokens must be a multiple of it (the
reference asserts so); :func:`ssd_chunked` raises ValueError otherwise,
and nothing is padded, since padding would change the final state.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (dense_init, linear, rms_norm,
                                       rms_norm_init)

Params = dict[str, Any]

__all__ = ["mamba2_init", "mamba2_apply", "mamba2_apply_state",
           "mamba2_decode", "mamba2_state_init", "ssd_chunked", "CHUNK",
           "SSM_PARAMS"]

CHUNK = 256

#: The parameters kept in f32 whatever ``param_dtype`` is (the reference
#: creates them so and reads them in f32).
SSM_PARAMS = ("A_log", "D", "dt_bias")


def mamba2_init(gen: torch.Generator, cfg) -> Params:
    d = cfg.d_model
    di = cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    dev = gen.device
    conv_ch = di + 2 * g * n
    # in_proj emits [z, x, B, C, dt]
    proj_out = 2 * di + 2 * g * n + h
    f32 = torch.float32
    return {
        "in_proj": dense_init(gen, (d, proj_out), dtype=cfg.pdtype),
        "conv_w": dense_init(gen, (cfg.conv_width, conv_ch),
                             scale=cfg.conv_width ** -0.5, dtype=cfg.pdtype),
        "conv_b": torch.zeros((conv_ch,), dtype=cfg.pdtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=f32,
                                          device=dev)),
        "D": torch.ones((h,), dtype=f32, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.linspace(
            1e-3, 1e-1, h, dtype=f32, device=dev))),
        "norm": rms_norm_init(di, cfg.pdtype, dev),
        "out_proj": dense_init(gen, (di, d), dtype=cfg.pdtype),
    }


def _split_proj(proj, cfg):
    di = cfg.d_inner
    g, n = cfg.ssm_groups, cfg.ssm_state
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * g * n]
    dt = proj[..., di + di + 2 * g * n:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """(B, L, C) depthwise causal conv via shifted adds (gather-free)."""
    width = w.shape[0]
    L = xbc.shape[1]
    out = xbc * w[-1]
    for i in range(1, width):
        shifted = F.pad(xbc, (0, 0, i, 0))[:, :L, :]
        out = out + shifted * w[width - 1 - i]
    return out + b


def _split_xbc(xbc, cfg):
    di = cfg.d_inner
    g, n = cfg.ssm_groups, cfg.ssm_state
    x = xbc[..., :di]
    bmat = xbc[..., di:di + g * n]
    cmat = xbc[..., di + g * n:]
    return x, bmat, cmat


def ssd_chunked(x, dt, a_log, bmat, cmat, cfg, chunk: int = CHUNK):
    """Chunked SSD.  x (B, L, H, P), dt (B, L, H), bmat / cmat (B, L, G, N).

    Returns y (B, L, H, P) in x's dtype and the final state (B, H, P, N)
    in f32.  Raises ValueError unless ``chunk`` divides L."""
    B, L, H, P = x.shape
    G, N = bmat.shape[2], bmat.shape[3]
    if L % chunk:
        raise ValueError(f"ssd_chunked: {L} tokens are not a multiple of "
                         f"the chunk {chunk} (a prompt longer than {CHUNK} "
                         f"tokens must be a multiple of {CHUNK})")
    nc = L // chunk
    rep = H // G

    f32 = torch.float32
    xc = x.reshape(B, nc, chunk, H, P)
    dtc = dt.reshape(B, nc, chunk, H).to(f32)
    bc = bmat.reshape(B, nc, chunk, G, N).to(f32)
    cc = cmat.reshape(B, nc, chunk, G, N).to(f32)

    A = -torch.exp(a_log)                                   # (H,) negative
    da = dtc * A                                            # (B, nc, Q, H)
    cum = torch.cumsum(da, dim=2)                           # within-chunk
    cum_last = cum[:, :, -1:, :]                            # (B, nc, 1, H)

    # --- intra-chunk (dual/attention form), f32 mask math ------------------
    # scores[b,c,h,i,j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j for i >= j
    cb = torch.einsum("bcqgn,bckgn->bcgqk", cc, bc)         # (B,nc,G,Q,Q)
    cb = cb.repeat_interleave(rep, dim=2)                   # (B,nc,H,Q,Q)
    cum_t = cum.transpose(2, 3)                             # (B,nc,H,Q)
    decay = cum_t[..., :, None] - cum_t[..., None, :]       # [i,j]=cum_i-cum_j
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    # zero the masked entries BEFORE exp: i < j gives decay > 0, where exp
    # overflows to inf (and a backward through the where() gets NaN)
    decay = torch.where(causal, decay, 0.0)
    mask = torch.where(causal, torch.exp(decay), 0.0)
    scores = cb * mask * dtc.transpose(2, 3)[:, :, :, None, :]
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores.to(x.dtype), xc)

    # --- chunk states -------------------------------------------------------
    # S_c = sum_j exp(cum_last - cum_j) dt_j B_j (x) x_j   -> (B,nc,H,P,N)
    w = torch.exp(cum_last - cum) * dtc                     # (B,nc,Q,H)
    xw = (xc.to(f32) * w[..., None]).reshape(B, nc, chunk, G, rep, P)
    bx = torch.einsum("bcqgn,bcqgrp->bcgrpn", bc, xw)
    bx = bx.reshape(B, nc, H, P, N)
    chunk_decay = torch.exp(cum_last[:, :, 0, :])           # (B,nc,H)

    # --- inter-chunk scan: each chunk sees the state before it -------------
    s = torch.zeros((B, H, P, N), dtype=f32, device=x.device)
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + bx[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)                   # (B,nc,H,P,N)

    # --- off-diagonal contribution ------------------------------------------
    s_prevs_g = s_prevs.reshape(B, nc, G, rep, P, N)
    y_off = torch.einsum("bcqgn,bcgrpn->bcqgrp", cc, s_prevs_g)
    y_off = y_off.reshape(B, nc, chunk, H, P) * torch.exp(cum)[..., None]
    y = y_diag.to(f32) + y_off
    return y.reshape(B, L, H, P).to(x.dtype), s


def mamba2_apply(x: torch.Tensor, p: Params, cfg) -> torch.Tensor:
    """Full mamba2 block: in_proj -> conv -> SSD -> gated norm -> out_proj."""
    return mamba2_apply_state(x, p, cfg)[0]


def mamba2_apply_state(x: torch.Tensor, p: Params, cfg
                       ) -> tuple[torch.Tensor, dict]:
    """Like :func:`mamba2_apply` but also returns the decode-continuation
    state ``{conv, ssm}``: the prefill path of the serving engine."""
    B, L, _ = x.shape
    H, P = cfg.ssm_heads, cfg.ssm_headdim
    G, N = cfg.ssm_groups, cfg.ssm_state
    f32 = torch.float32

    proj = linear(x, p["in_proj"])
    z, xbc_raw, dt = _split_proj(proj, cfg)
    xbc = _causal_conv(xbc_raw, p["conv_w"].to(x.dtype),
                       p["conv_b"].to(x.dtype))
    xbc = F.silu(xbc.to(f32)).to(x.dtype)
    xi, bmat, cmat = _split_xbc(xbc, cfg)

    dt = F.softplus(dt.to(f32) + p["dt_bias"])
    xi = xi.reshape(B, L, H, P)
    bmat = bmat.reshape(B, L, G, N)
    cmat = cmat.reshape(B, L, G, N)

    y, s_final = ssd_chunked(xi, dt, p["A_log"], bmat, cmat, cfg,
                             chunk=min(CHUNK, L))
    y = y + xi * p["D"][None, None, :, None].to(x.dtype)
    y = y.reshape(B, L, cfg.d_inner)

    gated = y * F.silu(z.to(f32)).to(x.dtype)
    out = linear(rms_norm(gated, p["norm"]), p["out_proj"])

    # conv shift register = the last (w - 1) *pre-conv* channel inputs,
    # left-padded with zeros when the prompt is shorter
    w = cfg.conv_width
    pad = max(0, (w - 1) - L)
    tail = xbc_raw[:, L - (w - 1 - pad):, :]
    if pad:
        tail = F.pad(tail, (0, 0, pad, 0))
    return out, {"conv": tail, "ssm": s_final}


# ---------------------------------------------------------------------------
# decode path (O(1) per token)
# ---------------------------------------------------------------------------

def mamba2_state_init(cfg, batch: int, dtype=torch.float32, *,
                      device=None) -> dict[str, torch.Tensor]:
    conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_ch),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_headdim,
                            cfg.ssm_state), dtype=torch.float32,
                           device=device),
    }


def mamba2_decode(x: torch.Tensor, p: Params, cfg, state: dict
                  ) -> tuple[torch.Tensor, dict]:
    """x: (B, 1, d) one token; returns (out (B, 1, d), new state)."""
    B = x.shape[0]
    H, P = cfg.ssm_heads, cfg.ssm_headdim
    G, N = cfg.ssm_groups, cfg.ssm_state
    rep = H // G
    f32 = torch.float32

    proj = linear(x[:, 0, :], p["in_proj"])                   # (B, .)
    z, xbc, dt = _split_proj(proj, cfg)

    # conv shift register
    window = torch.cat([state["conv"], xbc[:, None, :]], dim=1)  # (B, w, C)
    xbc = torch.einsum("bwc,wc->bc", window, p["conv_w"].to(x.dtype)) \
        + p["conv_b"].to(x.dtype)
    new_conv = window[:, 1:, :]
    xbc = F.silu(xbc.to(f32)).to(x.dtype)

    xi, bmat, cmat = _split_xbc(xbc, cfg)
    dt = F.softplus(dt.to(f32) + p["dt_bias"])                # (B, H)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A)                                     # (B, H)

    xi = xi.reshape(B, H, P).to(f32)
    b_h = bmat.reshape(B, G, N).to(f32).repeat_interleave(rep, dim=1)
    c_h = cmat.reshape(B, G, N).to(f32).repeat_interleave(rep, dim=1)

    s = state["ssm"] * a[:, :, None, None] \
        + (dt[:, :, None] * xi)[..., None] * b_h[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", s, c_h)
    y = y + xi * p["D"][None, :, None]
    y = y.reshape(B, cfg.d_inner).to(x.dtype)

    gated = y * F.silu(z.to(f32)).to(x.dtype)
    out = linear(rms_norm(gated, p["norm"]), p["out_proj"])
    return out[:, None, :], {"conv": new_conv, "ssm": s}
