"""Decoder stacks: the dense, MoE and mamba2 blocks (counterpart of
``repro.models.transformer``).

The JAX package stacks every parameter leaf along a leading ``num_layers``
dim and scans over it; here the stack is a list of per-layer parameter
dicts and the layer loop is a Python loop.  A block returns ``(x, aux)``,
the auxiliary losses ``{"aux_lb", "aux_z"}`` (zeros for the dense block),
and :func:`stack_apply` sums them over the layers.  The mamba2 blocks
call ``models.ssm`` through the module attribute (``ssm_mod.
mamba2_apply_state``), so that a profiler can wrap it; ``constrain`` (mesh
sharding hints) is mesh scope and is left out.
"""
from __future__ import annotations

from typing import Any, Callable

import contextlib

import torch
import torch.utils.checkpoint

from repro_torch.core import execlevel, registry
from repro_torch.distributed import sharding
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import mlp, mlp_init, rms_norm, rms_norm_init

Params = dict[str, Any]

__all__ = ["dense_block_init", "dense_block", "dense_block_kv",
           "moe_block_init", "moe_block", "moe_block_kv", "moe_ffn",
           "mamba_block_init", "mamba_block", "mamba_block_state",
           "stack_apply", "stack_init", "zero_aux"]


def zero_aux(device=None) -> dict[str, torch.Tensor]:
    return {"aux_lb": torch.zeros((), device=device),
            "aux_z": torch.zeros((), device=device)}


def dense_block_init(gen: torch.Generator, cfg) -> Params:
    return {
        "attn_norm": rms_norm_init(cfg.d_model, cfg.pdtype, gen.device),
        "attn": attn.attention_init(gen, cfg),
        "mlp_norm": rms_norm_init(cfg.d_model, cfg.pdtype, gen.device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.pdtype),
    }


def dense_block(x, p: Params, cfg, cos, sin):
    h = x + attn.attention_apply(rms_norm(x, p["attn_norm"]), p["attn"], cfg,
                                 cos, sin)
    return (h + mlp(rms_norm(h, p["mlp_norm"]), p["mlp"], cfg.mlp_kind),
            zero_aux(x.device))


def dense_block_kv(x, p: Params, cfg, cos, sin):
    """:func:`dense_block` that also returns the layer's rope-applied K/V
    (B, hk, L, hd): the prefill path."""
    a, k, v = attn.attention_apply_kv(rms_norm(x, p["attn_norm"]), p["attn"],
                                      cfg, cos, sin)
    h = x + a
    return h + mlp(rms_norm(h, p["mlp_norm"]), p["mlp"], cfg.mlp_kind), (k, v)


def moe_block_init(gen: torch.Generator, cfg) -> Params:
    p = {
        "attn_norm": rms_norm_init(cfg.d_model, cfg.pdtype, gen.device),
        "attn": attn.attention_init(gen, cfg),
        "moe_norm": rms_norm_init(cfg.d_model, cfg.pdtype, gen.device),
        "moe": moe_mod.moe_init(gen, cfg),
    }
    if cfg.dense_residual:
        p["dense_mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.pdtype)
    return p


def moe_ffn(h, p: Params, cfg, capacity_factor: float):
    """The MoE half of a block on the residual ``h``: the routed experts at
    ``capacity_factor`` (and arctic's parallel dense branch), returning
    ``(y, aux)`` for ``h + y``."""
    hn = rms_norm(h, p["moe_norm"])
    y, aux = moe_mod.moe_apply(hn, p["moe"], cfg,
                               capacity_factor=capacity_factor)
    if cfg.dense_residual:
        y = y + mlp(hn, p["dense_mlp"], cfg.mlp_kind)
    return y, aux


def moe_block(x, p: Params, cfg, cos, sin):
    h = x + attn.attention_apply(rms_norm(x, p["attn_norm"]), p["attn"], cfg,
                                 cos, sin)
    y, aux = moe_ffn(h, p, cfg, cfg.capacity_factor)
    return h + y, aux


def moe_block_kv(x, p: Params, cfg, cos, sin):
    """:func:`moe_block` that returns the layer's rope-applied K/V instead
    of its aux losses: the prefill path."""
    a, k, v = attn.attention_apply_kv(rms_norm(x, p["attn_norm"]), p["attn"],
                                      cfg, cos, sin)
    h = x + a
    y, _ = moe_ffn(h, p, cfg, cfg.capacity_factor)
    return h + y, (k, v)


def mamba_block_init(gen: torch.Generator, cfg) -> Params:
    return {
        "norm": rms_norm_init(cfg.d_model, cfg.pdtype, gen.device),
        "mamba": ssm_mod.mamba2_init(gen, cfg),
    }


def mamba_block(x, p: Params, cfg):
    return mamba_block_state(x, p, cfg)[0], zero_aux(x.device)


def mamba_block_state(x, p: Params, cfg):
    """:func:`mamba_block` that returns the layer's decode state ``{conv,
    ssm}`` instead of its (zero) aux losses: the prefill path."""
    y, st = ssm_mod.mamba2_apply_state(rms_norm(x, p["norm"]), p["mamba"],
                                       cfg)
    return x + y, st


def stack_apply(x, layers: list[Params], block_fn: Callable, cfg, *,
                remat: bool | None = None):
    """Apply ``block_fn(x, layer_params) -> (x, aux)`` over the layers in
    order; returns ``(x, aux)`` with each block's aux losses summed.

    With remat (``cfg.remat`` unless given) and grad mode on, each block
    runs under ``torch.utils.checkpoint.checkpoint(..., use_reentrant=
    False)``: the backward recomputes the block's activations instead of
    keeping them.  Like the JAX package's ``REMAT_POLICY``, this decides
    what is kept, not what is computed, so the values do not change."""
    remat = cfg.remat if remat is None else remat
    ckpt = remat and torch.is_grad_enabled()
    aux = zero_aux(x.device)
    for lp in layers:
        if ckpt:
            x, a = torch.utils.checkpoint.checkpoint(
                block_fn, x, lp, use_reentrant=False,
                context_fn=_recompute_on_this_plane)
        else:
            x, a = block_fn(x, lp)
        aux = {name: aux[name] + a[name] for name in aux}
    return x, aux


def _recompute_on_this_plane():
    """checkpoint's (forward, recompute) contexts: the recompute runs under
    the plane requested now, at the execution level and on the mesh of now,
    and with the rows sharded as now.  ``use_backend``, ``use_level`` and
    ``sharded_rows`` are thread-local, and the autograd engine runs a CUDA
    backward (and so the recompute) on a thread of its own, where they
    would otherwise be lost."""
    plane = registry.requested_backend()
    level = execlevel.current()
    rows = sharding.rows_plan()

    @contextlib.contextmanager
    def recompute():
        with contextlib.ExitStack() as stack:
            if plane is not None:
                stack.enter_context(registry.use_backend(plane))
            stack.enter_context(execlevel.use_level(level.level, level.mesh))
            stack.enter_context(sharding.sharded_rows(rows))
            yield
    return contextlib.nullcontext(), recompute()


def stack_init(gen: torch.Generator, cfg, block_init: Callable,
               num_layers: int) -> list[Params]:
    """Per-layer parameters, drawn layer after layer from ``gen``."""
    return [block_init(gen, cfg) for _ in range(num_layers)]
