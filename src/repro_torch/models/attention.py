"""GQA attention: the full-sequence path (flash kernels), the fixed-cache
decode, and the paged decode and chunked prefill of the continuous-batching
serve tier (counterpart of ``repro.models.attention``, chip scope).

qk_norm (qwen3): RMS-normalise q and k per head before RoPE.  The
full-sequence path dispatches ``flash_attention``; the paged paths dispatch
``paged_attention`` and ``chunk_attention`` (kernels/ops.py), so CUDA
tensors run the hand-written kernels.  The fixed-cache decode stays a plain
einsum, as in the JAX package.

The paged paths write this step's K/V into the page pools in place (the JAX
package returns updated copies); they return the same pool tensors.  Under
an O3/O4 mesh whose ring is wider than one rank, the pools are this rank's
shard of the ring-striped pool, whose layout ``serve/kvcache.py`` alone
knows: a write lands only in the pages this rank owns (``kvcache.write``),
a chunk's prefix is gathered over the ring (``kvcache.gather_row``) before
``chunk_attention``, so the chunk is bitwise the one-card chunk, and
decode's ``paged_attention`` dispatch selects the ring variant by scope.

Under the model axis's split (``distributed.model_split``) the
full-sequence path and the fixed-cache decode run on this rank's heads
(``_split_weights``): the q heads' columns of ``wq``, the kv heads they
read, the rows of ``wo``, whose product ends in one all-reduce; the
kernels see the local head counts.  The paged paths are not split.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.registry import dispatch
from repro_torch.distributed import model_split as ms
from repro_torch.distributed.partition import kv_split_at_rest
from repro_torch.kernels.flash_attention import NEG_INF
from repro_torch.models.layers import (apply_rope, dense_init, linear,
                                       rms_norm, rms_norm_init)

Params = dict[str, Any]

__all__ = ["attention_init", "attention_apply", "attention_apply_kv",
           "attention_decode", "attention_decode_paged", "attention_chunk"]


def attention_init(gen: torch.Generator, cfg) -> Params:
    d, h, hk, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, h * hd), dtype=cfg.pdtype),
        "wk": dense_init(gen, (d, hk * hd), dtype=cfg.pdtype),
        "wv": dense_init(gen, (d, hk * hd), dtype=cfg.pdtype),
        "wo": dense_init(gen, (h * hd, d), dtype=cfg.pdtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = rms_norm_init(hd, cfg.pdtype, gen.device)
        p["k_norm"] = rms_norm_init(hd, cfg.pdtype, gen.device)
    return p


def _split_weights(p: Params, cfg):
    """``(leaves, split)``: the attention leaves as this rank uses them, and
    whether the block runs split by heads.  Outside the model axis's split
    (``distributed.model_split``), ``p`` itself.  Split by heads
    (``model_split.heads_split``): the tiles of ``wq`` and ``wo`` (the
    rank's q heads); the columns of ``wk`` and ``wv`` of the kv heads those
    q heads read (the shard itself where the spec splits them by whole kv
    heads; where the lane floor replicates them, the leaf entering through
    ``into`` and then sliced, so that the ranks' parts of its gradient add
    up; where the spec cuts inside a kv head, gathered at use with the
    parts summed backward); ``q_norm`` and ``k_norm`` through ``into``
    (each rank normalises its own heads with them).  Heads that do not
    divide: every leaf whole at use (gathered where held as shards) and
    the block run whole on every rank, as the reference's
    ``_replicate_attention`` intends; its sequence split of that case
    (``repro/models/transformer.py:55-63``) is not taken."""
    s = ms.current()
    if s is None:
        return p, False
    kv_at_rest = kv_split_at_rest(cfg.num_kv_heads * cfg.head_dim)
    if not ms.heads_split(cfg, s.size):
        w = dict(p, wq=ms.whole(p["wq"], 1), wo=ms.whole(p["wo"], 0))
        if kv_at_rest:
            w.update(wk=ms.whole(p["wk"], 1), wv=ms.whole(p["wv"], 1))
        return w, False
    hd = cfg.head_dim
    _, hk_l, _, k0 = ms.heads(cfg)
    cols = slice(k0 * hd, (k0 + hk_l) * hd)
    w = dict(p, wq=ms.local(p["wq"], 1), wo=ms.local(p["wo"], 0))
    for name in ("wk", "wv"):
        if not kv_at_rest:
            w[name] = ms.into(p[name])[:, cols]
        elif cfg.num_kv_heads % s.size == 0:
            w[name] = ms.local(p[name], 1)
        else:
            w[name] = ms.whole(p[name], 1, partial=True)[:, cols]
    if cfg.qk_norm:
        w["q_norm"] = {"scale": ms.into(p["q_norm"]["scale"])}
        w["k_norm"] = {"scale": ms.into(p["k_norm"]["scale"])}
    return w, True


def _project_qkv(x, p, cfg):
    """q, k, v (B, L, heads, hd) at this rank's heads (``model_split.
    heads``), and ``out(o)``, the output product of o (B, L, heads * hd):
    ``wo``, ending in the all-reduce over ``model`` when split by
    heads."""
    B, L, _ = x.shape
    w, split = _split_weights(p, cfg)
    if split:
        x = ms.into(x)
    h, hk = ms.heads(cfg)[:2]
    hd = cfg.head_dim
    q = linear(x, w["wq"]).reshape(B, L, h, hd)
    k = linear(x, w["wk"]).reshape(B, L, hk, hd)
    v = linear(x, w["wv"]).reshape(B, L, hk, hd)
    if cfg.qk_norm:
        q = rms_norm(q, w["q_norm"])
        k = rms_norm(k, w["k_norm"])

    def out(o):
        y = linear(o, w["wo"])
        return ms.out_of(y) if split else y
    return q, k, v, out


def _rope_qk(q, k, cos, sin, cfg):
    # (B, L, H, D) -> (B, H, L, D); M-RoPE stitches its three streams
    sections = cfg.mrope_sections if cfg.m_rope else None
    q = apply_rope(q.transpose(1, 2), cos, sin, sections)
    k = apply_rope(k.transpose(1, 2), cos, sin, sections)
    return q, k


def attention_apply(x, p: Params, cfg, cos, sin) -> torch.Tensor:
    """Full-sequence causal attention (training / prefill)."""
    return attention_apply_kv(x, p, cfg, cos, sin)[0]


def attention_apply_kv(x, p: Params, cfg, cos, sin):
    """:func:`attention_apply` that also returns the rope-applied K/V in
    cache layout (B, hk, L, hd): the prefill path of the fixed engine."""
    B, L, _ = x.shape
    q, k, v, wo = _project_qkv(x, p, cfg)
    q, k = _rope_qk(q, k, cos, sin, cfg)
    v = v.transpose(1, 2)
    out = dispatch("flash_attention", q, k, v, causal=True,
                   mask=cfg.attn_mask_spec())                # (B, H, L, D)
    out = out.transpose(1, 2).reshape(B, L, q.shape[1] * cfg.head_dim)
    return wo(out), k, v


def attention_decode(x, p: Params, cfg, cache_k, cache_v, cur_len: int,
                     cos, sin):
    """One-token decode against a fixed-size cache (B, hk, S_max, hd):
    writes this token's K/V at ``cur_len`` in place and attends to
    positions ``<= cur_len``.  Returns (out, cache_k, cache_v)."""
    B = x.shape[0]
    hd = cfg.head_dim
    q, k, v, wo = _project_qkv(x, p, cfg)                 # (B, 1, ., hd)
    h, hk = q.shape[2], k.shape[2]
    q, k = _rope_qk(q, k, cos, sin, cfg)                  # (B, ., 1, hd)
    cache_k[:, :, cur_len] = k[:, :, 0].to(cache_k.dtype)
    cache_v[:, :, cur_len] = v[:, 0].to(cache_v.dtype)

    S = cache_k.shape[2]
    group = h // hk
    qg = q.reshape(B, hk, group, hd)
    s = torch.einsum("bkgd,bksd->bkgs", qg.float(),
                     cache_k.float()) * (hd ** -0.5)
    pos = torch.arange(S, device=x.device)
    mask = pos <= cur_len                                 # the current token
    if getattr(cfg, "attn_window", 0):
        recent = pos > cur_len - cfg.attn_window
        if cfg.attn_global_tokens:
            recent[list(cfg.attn_global_tokens)] = True
        mask = mask & recent
    s = torch.where(mask[None, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", w, cache_v.float())
    o = o.reshape(B, 1, h * hd).to(x.dtype)
    return wo(o), cache_k, cache_v


def attention_decode_paged(x, p: Params, cfg, kpages, vpages, table, lens,
                           write_page, write_off, active, cos, sin):
    """One-token decode over the paged KV cache.  The write targets come
    from the caller (frozen slots point at the trash page 0); the read
    dispatches ``paged_attention`` with ``lens + active`` live tokens, so
    the token just written is included."""
    from repro_torch.kernels.ops import paged_attention
    from repro_torch.serve import kvcache

    B = x.shape[0]
    h, hd = cfg.num_heads, cfg.head_dim
    q, k, v, wo = _project_qkv(x, p, cfg)                 # (B, 1, ., hd)
    q, k = _rope_qk(q, k, cos, sin, cfg)                  # (B, ., 1, hd)
    kvcache.write(kpages, vpages, write_page, write_off, k[:, :, 0],
                  v[:, 0], kvcache.pool_ring())           # (B, hk, hd)

    out = paged_attention(q, kpages, vpages, table, lens + active)
    out = out.transpose(1, 2).reshape(B, 1, h * hd).to(x.dtype)
    return wo(out), kpages, vpages


def attention_chunk(x, p: Params, cfg, kpages, vpages, table_row, start: int,
                    page_idx, write_off, cos, sin):
    """One chunked-prefill step of one slot: write the chunk's K/V into the
    slot's pages, then attend to the gathered prefix (masked at ``start``)
    and to the chunk itself (causal) through ``chunk_attention``.  Pad
    tokens past the chunk's valid length carry ``page_idx == 0`` (trash)."""
    from repro_torch.kernels.ops import chunk_attention, page_gather
    from repro_torch.serve import kvcache

    _, C, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q, k, v, wo = _project_qkv(x, p, cfg)                 # (1, C, ., hd)
    q, k = _rope_qk(q, k, cos, sin, cfg)                  # (1, ., C, hd)
    v = v.transpose(1, 2)
    plan = kvcache.pool_ring()
    kvcache.write(kpages, vpages, page_idx, write_off, k[0].transpose(0, 1),
                  v[0].transpose(0, 1), plan)

    # gathered after the write: the chunk's keys sit at positions >= start,
    # which the prefix mask keeps dead; the chunk is seen through kc / vc
    if plan is None:
        kp = page_gather(kpages, table_row[None])         # (1, hk, cap, hd)
        vp = page_gather(vpages, table_row[None])
    else:
        kp, vp = (t[None] for t in kvcache.gather_row((kpages, vpages),
                                                      table_row, plan))
    plen = torch.full((1,), start, dtype=torch.int32, device=x.device)
    out = chunk_attention(q, kp, vp, plen, k, v)          # (1, h, C, hd)
    out = out.transpose(1, 2).reshape(1, C, h * hd).to(x.dtype)
    return wo(out), kpages, vpages

