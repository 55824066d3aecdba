"""Flash attention with GQA: the kernel wrappers, their plain versions and
the state algebra (counterpart of ``repro.kernels.flash_attention``).

Three wrappers, one per CUDA kernel, each counting its launches:

    flash_attention        dense grid (csrc/flash_attention.cu,
                           ``flash_attention_kernel``); replaces the Pallas
                           kernels ``repro/kernels/flash_attention.py:154``
                           and ``:167``.  Causal calls route to the tiles
                           walk over ``causal_layout`` (as the JAX wrapper
                           does) unless ``row_extents=False``; calls with
                           ``kv_len`` route to :func:`flash_attention_lens`.
    flash_attention_lens   the same grid with the key-prefix mask
                           ``kpos < kv_len[b]``
                           (``flash_attention_lens_kernel``); replaces
                           ``:183`` and ``:201``.
    flash_attention_tiles  the tile-skipping walk over a compiled
                           :class:`~repro_torch.sparse.maskcompiler.TileLayout`
                           (csrc/flash_attention_tiles.cu: the f32 FMA fold,
                           or in bf16 a tensor-core kernel); replaces
                           ``:275`` and ``:290``.

Layouts: q (B, Hq, Lq, d), k / v (B, Hkv, Lk, d), q-head h reads kv-head
h // (Hq / Hkv); with ``return_state`` the wrappers also return the row
maxima ``m`` and denominators ``l``, (B, Hq, Lq) f32.

On host tensors each wrapper computes its plain version (the same blocked
online-softmax recurrence in torch, tile by tile); on CUDA tensors it
launches its kernel or raises.  The kernels take f32 or bf16, head_dim in
:data:`HEAD_DIMS` and K tiles of at most :data:`MAX_BLOCK_K` keys.  The
blocks need not divide the lengths: the last Q tile and the last K tile
are short.

A row whose keys are all masked keeps ``m == NEG_INF``; its ``o`` and
``l`` are garbage (the kernels and the plain versions may disagree on
them), and :func:`merge_states` weights such a state by exactly 0.
"""
from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import NEG_INF, _expand_kv

__all__ = ["NEG_INF", "merge_states", "flash_attention",
           "flash_attention_lens", "flash_attention_tiles",
           "flash_attention_plain", "flash_attention_tiles_plain",
           "HEAD_DIMS", "MAX_BLOCK_K"]

#: head_dim values the kernels are compiled for.
HEAD_DIMS = (32, 64, 128)
#: The largest K tile the kernels take.
MAX_BLOCK_K = 128

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def merge_states(a, b):
    """Merge two online-softmax states ``(o, m, l)`` over the same queries
    and disjoint key sets, exactly as two K tiles fold inside the kernel.
    A state whose keys were all masked (``m == NEG_INF``) gets weight
    ``exp(NEG_INF - m) == 0`` and drops out."""
    o_a, m_a, l_a = a
    o_b, m_b, l_b = b
    m = torch.maximum(m_a, m_b)
    w_a = torch.exp(m_a - m) * l_a
    w_b = torch.exp(m_b - m) * l_b
    l = w_a + w_b
    o = o_a.float() * w_a[..., None] + o_b.float() * w_b[..., None]
    o = o / l.clamp_min(1e-30)[..., None]
    return o.to(o_a.dtype), m, l


# ---------------------------------------------------------------------------
# plain versions: the blocked recurrence in torch, one K tile at a time
# ---------------------------------------------------------------------------

def _fold(carry, q, kb, vb, scale, live=None, bias=None):
    """Fold one K/V tile into ``carry = (m, l, acc)`` (the kernels'
    ``fa::fold_tile``); ``live`` masks scores to NEG_INF, ``bias`` adds."""
    m_prev, l_prev, acc = carry
    s = torch.matmul(q.float(), kb.float().transpose(-1, -2)) * scale
    if live is not None:
        s = torch.where(live, s, NEG_INF)
    if bias is not None:
        s = s + bias
    m_cur = torch.maximum(m_prev, s.amax(dim=-1))
    alpha = torch.exp(m_prev - m_cur)
    p = torch.exp(s - m_cur[..., None])
    l = l_prev * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.matmul(p.to(vb.dtype).float(),
                                                vb.float())
    return m_cur, l, acc


def _init_carry(q, rows: int):
    b, h, _, d = q.shape
    return (torch.full((b, h, rows), NEG_INF, device=q.device),
            torch.zeros((b, h, rows), device=q.device),
            torch.zeros((b, h, rows, d), device=q.device))


def _finish(q, outs, return_state):
    """Concatenate per-Q-tile carries into ``o`` (and ``m``, ``l``)."""
    m = torch.cat([c[0] for c in outs], dim=2)
    l = torch.cat([c[1] for c in outs], dim=2)
    acc = torch.cat([c[2] for c in outs], dim=2)
    o = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    return (o, m, l) if return_state else o


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          scale: Optional[float] = None, block_q: int = 128,
                          block_k: int = 128, kv_len=None,
                          return_state: bool = False):
    """The dense grid of the Pallas kernel in torch: every (Q tile, K tile)
    step the Pallas grid runs (above-diagonal tiles skipped when causal),
    masked by ``qpos >= kpos`` and ``kpos < kv_len[b]``."""
    b, hq, lq, d = q.shape
    lk = k.shape[2]
    bq, bk = min(block_q, lq), min(block_k, lk)
    scale = scale if scale is not None else d ** -0.5
    kk, vv = _expand_kv(k, v, hq)
    outs = []
    for q0 in range(0, lq, bq):
        qt = q[:, :, q0:q0 + bq]
        rows = qt.shape[2]
        carry = _init_carry(q, rows)
        qpos = q0 + torch.arange(rows, device=q.device)[:, None]
        for k0 in range(0, lk, bk):
            if causal and k0 > q0 + rows - 1:
                continue
            keys = min(bk, lk - k0)
            kpos = k0 + torch.arange(keys, device=q.device)[None, :]
            live = None
            if causal:
                live = qpos >= kpos
            if kv_len is not None:
                pre = kpos[None, None] < kv_len.to(q.device)[:, None, None,
                                                               None]
                live = pre if live is None else live & pre
            carry = _fold(carry, qt, kk[:, :, k0:k0 + bk],
                          vv[:, :, k0:k0 + bk], scale, live=live)
        outs.append(carry)
    return _finish(q, outs, return_state)


def flash_attention_tiles_plain(q, k, v, layout, *,
                                scale: Optional[float] = None,
                                return_state: bool = False):
    """The tiles walk in torch: per Q tile, its FULL tiles unmasked, then
    its PARTIAL tiles under the band compare or the stored bias tile."""
    b, hq, lq, d = q.shape
    lk = k.shape[2]
    bq, bk = layout.block_q, layout.block_k
    if layout.shape != (lq, lk):
        raise ValueError(f"layout {layout.shape} does not match "
                         f"({lq}, {lk})")
    scale = scale if scale is not None else d ** -0.5
    kk, vv = _expand_kv(k, v, hq)
    rowp, mid, prowp, cols = (layout.rowp.tolist(), layout.mid.tolist(),
                              layout.prowp.tolist(), layout.cols.tolist())
    outs = []
    for i in range(layout.nq):
        qt = q[:, :, i * bq:(i + 1) * bq]
        rows = qt.shape[2]
        carry = _init_carry(q, rows)
        for p in range(rowp[i], rowp[i + 1]):
            c = cols[p]
            keys = min(bk, lk - c * bk)
            live = bias = None
            if p >= mid[i]:
                if layout.band is not None:
                    causal, window, off = layout.band
                    qpos = (i * bq + off
                            + torch.arange(rows, device=q.device)[:, None])
                    kpos = c * bk + torch.arange(keys,
                                                 device=q.device)[None, :]
                    live = torch.ones((rows, keys), dtype=torch.bool,
                                      device=q.device)
                    if causal:
                        live = live & (qpos >= kpos)
                    if window is not None:
                        live = live & ((qpos - kpos) < window if causal
                                       else (qpos - kpos).abs() < window)
                else:
                    bias = torch.as_tensor(
                        layout.biases[prowp[i] + (p - mid[i])][:rows, :keys],
                        device=q.device)
            carry = _fold(carry, qt, kk[:, :, c * bk:(c + 1) * bk],
                          vv[:, :, c * bk:(c + 1) * bk], scale, live=live,
                          bias=bias)
        outs.append(carry)
    return _finish(q, outs, return_state)


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------

def _check(what, q, k, v, *ints):
    """Device, contiguity, dtype and shape checks shared by the wrappers."""
    _lib.require_cuda(what, q, k, v, *ints)
    _lib.require_dtypes(what, (q, k, v), ints,
                        allowed=tuple(_DTYPE_CODE))
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] \
            or q.shape[1] % k.shape[1]:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {q.shape[3]} not in {HEAD_DIMS}")


def _outputs(q, return_state):
    o = torch.empty_like(q)
    if not return_state:
        return o, None, None
    b, h, lq, _ = q.shape
    return (o, torch.empty((b, h, lq), device=q.device),
            torch.empty((b, h, lq), device=q.device))


def _launch_grid(what, q, k, v, kv_len, *, causal, scale, block_k,
                 return_state):
    """Launch the dense grid (kv_len None) or the lens kernel; returns the
    outputs and whether a kernel was launched (not for empty outputs)."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    ints = () if kv_len is None else (kv_len.contiguous(),)
    _check(what, q, k, v, *ints)
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    bk = min(block_k, lk)
    if bk > MAX_BLOCK_K:
        raise ValueError(f"{what}: block_k {bk} is above {MAX_BLOCK_K}")
    if ints and ints[0].shape != (b,):
        raise ValueError(f"{what}: kv_len {tuple(ints[0].shape)} is not "
                         f"({b},)")
    o, m, l = _outputs(q, return_state)
    launched = o.numel() > 0
    if launched:
        code = _lib.lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            ints[0].data_ptr() if ints else None, o.data_ptr(),
            m.data_ptr() if return_state else None,
            l.data_ptr() if return_state else None,
            b, hq, hkv, lq, lk, d, bk, float(scale), int(causal),
            int(return_state), _DTYPE_CODE[q.dtype], _lib.stream_of(q))
        _lib.check(code, what)
    return ((o, m, l) if return_state else o), launched


def flash_attention_lens(q, k, v, kv_len, *, causal: bool = False,
                         scale: Optional[float] = None, block_q: int = 128,
                         block_k: int = 128, return_state: bool = False):
    """Dense-grid attention over keys ``kpos < kv_len[b]`` (int32 (B,)):
    the paged-decode and chunked-prefill read path."""
    scale = scale if scale is not None else q.shape[3] ** -0.5
    kv_len = kv_len.to(torch.int32)
    if _lib.on_host(q, k, v, kv_len):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     block_q=block_q, block_k=block_k,
                                     kv_len=kv_len, return_state=return_state)
    out, launched = _launch_grid("flash_attention_lens", q, k, v, kv_len,
                                 causal=causal, scale=scale, block_k=block_k,
                                 return_state=return_state)
    flash_attention_lens.launches += launched
    return out


flash_attention_lens.launches = 0


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None, block_q: int = 128,
                    block_k: int = 128, return_state: bool = False,
                    row_extents: bool = True, kv_len=None):
    """Flash attention; with ``return_state`` returns ``(o, m, l)``.

    Causal calls without ``kv_len`` walk the banded ``causal_layout`` with
    :func:`flash_attention_tiles` (K tiles bounded per Q tile by compiled
    row extents); ``row_extents=False`` keeps the dense grid.  ``kv_len``
    routes to :func:`flash_attention_lens`.  Blocks clamp to the lengths;
    where they do not divide them the last tile is short."""
    lq, lk = q.shape[2], k.shape[2]
    block_q, block_k = min(block_q, lq), min(block_k, lk)
    scale = scale if scale is not None else q.shape[3] ** -0.5
    if kv_len is not None:
        return flash_attention_lens(q, k, v, kv_len, causal=causal,
                                    scale=scale, block_q=block_q,
                                    block_k=block_k,
                                    return_state=return_state)
    if causal and row_extents:
        from repro_torch.sparse.maskcompiler import causal_layout
        return flash_attention_tiles(
            q, k, v, causal_layout(lq, lk, block_q, block_k), scale=scale,
            return_state=return_state)
    if _lib.on_host(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     block_q=block_q, block_k=block_k,
                                     return_state=return_state)
    out, launched = _launch_grid("flash_attention", q, k, v, None,
                                 causal=causal, scale=scale,
                                 block_k=block_k, return_state=return_state)
    flash_attention.launches += launched
    return out


flash_attention.launches = 0

#: (id(layout), device) -> (layout, rowp, mid, prowp, cols, biases, order)
#: on the card, the most recently used :data:`LAYOUTS_ON_CARD` of them.
#: Holding the layout keeps its id from being reused while the entry lives.
_LAYOUT_ON_CARD: collections.OrderedDict = collections.OrderedDict()
LAYOUTS_ON_CARD = 256


def _walk_order(layout) -> np.ndarray:
    """The Q tiles by descending walk length (stable): the bf16 kernel
    starts the CTAs of the longest walks first."""
    return np.argsort(-np.diff(np.asarray(layout.rowp)),
                      kind="stable").astype(np.int32)


def _layout_tensors(layout, device):
    key = (id(layout), device)
    hit = _LAYOUT_ON_CARD.get(key)
    if hit is None:
        hit = (layout,) + tuple(
            torch.as_tensor(a, device=device) for a in
            (layout.rowp, layout.mid, layout.prowp, layout.cols,
             layout.biases, _walk_order(layout)))
        _LAYOUT_ON_CARD[key] = hit
        if len(_LAYOUT_ON_CARD) > LAYOUTS_ON_CARD:
            _LAYOUT_ON_CARD.popitem(last=False)
    else:
        _LAYOUT_ON_CARD.move_to_end(key)
    return hit[1:]


def flash_attention_tiles(q, k, v, layout, *, scale: Optional[float] = None,
                          return_state: bool = False):
    """Tile-skipping flash attention over a compiled mask layout: each Q
    tile walks only its live K tiles, full tiles first.  An empty layout
    returns zeros (and ``m = NEG_INF``, ``l = 0``) without a launch."""
    b, hq, lq, d = q.shape
    if layout.shape != (lq, k.shape[2]):
        raise ValueError(f"flash_attention_tiles: layout {layout.shape} "
                         f"does not match ({lq}, {k.shape[2]})")
    scale = scale if scale is not None else d ** -0.5
    if layout.ntiles == 0:
        o = torch.zeros_like(q)
        if return_state:
            return (o, torch.full((b, hq, lq), NEG_INF, device=q.device),
                    torch.zeros((b, hq, lq), device=q.device))
        return o
    if _lib.on_host(q, k, v):
        return flash_attention_tiles_plain(q, k, v, layout, scale=scale,
                                           return_state=return_state)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check("flash_attention_tiles", q, k, v)
    bq, bk = layout.block_q, layout.block_k
    if bk > MAX_BLOCK_K:
        raise ValueError(f"flash_attention_tiles: block_k {bk} is above "
                         f"{MAX_BLOCK_K}")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("flash_attention_tiles: bf16 q, k, v must be "
                         "16-byte aligned (the kernel copies 16-byte "
                         "chunks)")
    rowp, mid, prowp, cols, biases, order = _layout_tensors(layout,
                                                            q.device)
    o, m, l = _outputs(q, return_state)
    causal, window, off = layout.band if layout.band is not None \
        else (False, None, 0)
    code = _lib.lib().flash_attention_tiles_launch(
        rowp.data_ptr(), mid.data_ptr(), prowp.data_ptr(), cols.data_ptr(),
        biases.data_ptr(), order.data_ptr(), q.data_ptr(), k.data_ptr(),
        v.data_ptr(),
        o.data_ptr(), m.data_ptr() if return_state else None,
        l.data_ptr() if return_state else None,
        b, hq, k.shape[1], lq, k.shape[2], d, bq, bk,
        int(layout.band is not None), int(causal),
        -1 if window is None else int(window), int(off), float(scale),
        int(return_state), _DTYPE_CODE[q.dtype], _lib.stream_of(q))
    _lib.check(code, "flash_attention_tiles")
    flash_attention_tiles.launches += 1
    return (o, m, l) if return_state else o


flash_attention_tiles.launches = 0
