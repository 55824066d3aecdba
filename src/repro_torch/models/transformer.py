"""Decoder stacks: the dense block (counterpart of the dense part of
``repro.models.transformer``).

The JAX package stacks every parameter leaf along a leading ``num_layers``
dim and scans over it; here the stack is a list of per-layer parameter
dicts and the layer loop is a Python loop.  The MoE and SSM blocks come
with their families' slices (ROADMAP queue 1 items 5 and 6); ``constrain``
(mesh sharding hints) is mesh scope and is left out.
"""
from __future__ import annotations

from typing import Any, Callable

import contextlib

import torch
import torch.utils.checkpoint

from repro_torch.core import registry
from repro_torch.models import attention as attn
from repro_torch.models.layers import mlp, mlp_init, rms_norm, rms_norm_init

Params = dict[str, Any]

__all__ = ["dense_block_init", "dense_block", "dense_block_kv", "stack_apply",
           "stack_init"]


def dense_block_init(gen: torch.Generator, cfg) -> Params:
    return {
        "attn_norm": rms_norm_init(cfg.d_model, cfg.pdtype, gen.device),
        "attn": attn.attention_init(gen, cfg),
        "mlp_norm": rms_norm_init(cfg.d_model, cfg.pdtype, gen.device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.pdtype),
    }


def dense_block(x, p: Params, cfg, cos, sin) -> torch.Tensor:
    h = x + attn.attention_apply(rms_norm(x, p["attn_norm"]), p["attn"], cfg,
                                 cos, sin)
    return h + mlp(rms_norm(h, p["mlp_norm"]), p["mlp"], cfg.mlp_kind)


def dense_block_kv(x, p: Params, cfg, cos, sin):
    """:func:`dense_block` that also returns the layer's rope-applied K/V
    (B, hk, L, hd): the prefill path."""
    a, k, v = attn.attention_apply_kv(rms_norm(x, p["attn_norm"]), p["attn"],
                                      cfg, cos, sin)
    h = x + a
    return h + mlp(rms_norm(h, p["mlp_norm"]), p["mlp"], cfg.mlp_kind), (k, v)


def stack_apply(x, layers: list[Params], block_fn: Callable, cfg, *,
                remat: bool | None = None) -> torch.Tensor:
    """Apply ``block_fn(x, layer_params) -> x`` over the layers in order.

    With remat (``cfg.remat`` unless given) and grad mode on, each block
    runs under ``torch.utils.checkpoint.checkpoint(..., use_reentrant=
    False)``: the backward recomputes the block's activations instead of
    keeping them.  Like the JAX package's ``REMAT_POLICY``, this decides
    what is kept, not what is computed, so the values do not change.  The
    dense family has no auxiliary losses, so only ``x`` is returned."""
    remat = cfg.remat if remat is None else remat
    ckpt = remat and torch.is_grad_enabled()
    for lp in layers:
        if ckpt:
            x = torch.utils.checkpoint.checkpoint(
                block_fn, x, lp, use_reentrant=False,
                context_fn=_recompute_on_this_plane)
        else:
            x = block_fn(x, lp)
    return x


def _recompute_on_this_plane():
    """checkpoint's (forward, recompute) contexts: the recompute runs under
    the plane requested now.  ``use_backend`` is thread-local, and the
    autograd engine runs a CUDA backward (and so the recompute) on a
    thread of its own, where the request would otherwise be lost."""
    plane = registry.requested_backend()
    return (contextlib.nullcontext(),
            registry.use_backend(plane) if plane is not None
            else contextlib.nullcontext())


def stack_init(gen: torch.Generator, cfg, block_init: Callable,
               num_layers: int) -> list[Params]:
    """Per-layer parameters, drawn layer after layer from ``gen``."""
    return [block_init(gen, cfg) for _ in range(num_layers)]
