"""Flash attention with GQA: the kernel wrappers, their plain versions and
the state algebra (counterpart of ``repro.kernels.flash_attention``).

Three wrappers, each counting its launches:

    flash_attention        dense grid (csrc/flash_attention.cu); replaces
                           the Pallas kernels
                           ``repro/kernels/flash_attention.py:154`` and
                           ``:167``.  f32 runs ``flash_attention_kernel``
                           (the FMA fold), bf16
                           ``flash_attention_bf16_kernel`` (the tensor-core
                           fold it shares with the bf16 tiles kernel).
                           Causal calls route to the tiles walk over
                           ``causal_layout`` (as the JAX wrapper does)
                           unless ``row_extents=False``; calls with
                           ``kv_len`` route to :func:`flash_attention_lens`.
    flash_attention_lens   the key-prefix mask ``kpos < kv_len[b]``, split
                           over the keys (csrc/flash_attention_lens.cu);
                           replaces ``:183`` and ``:201``.  A CTA owns the
                           rows of every q-head of one kv-head and one key
                           range (:func:`lens_partition`); the last CTA of
                           a group merges the ranges' partials in a fixed
                           order, in the same launch.  :func:`lens_blocks`
                           picks the kernel: ``..._decode_kernel`` (the
                           FMA units, f32 and small bf16 groups) or
                           ``..._prefix_kernel`` (bf16 on the tensor
                           cores).
    flash_attention_tiles  the tile-skipping walk over a compiled
                           :class:`~repro_torch.sparse.maskcompiler.TileLayout`
                           (csrc/flash_attention_tiles.cu: f32 the FMA
                           fold, bf16 the tensor-core fold); replaces
                           ``:275`` and ``:290``; ``.kernels`` counts the
                           launches with and without state.

The two dense folds are each shared by two kernels, so over
``causal_layout`` the tiles walk is bitwise equal to the dense causal grid
in either dtype.  The dense and tiles tensor-core kernels need q, k and v
16-byte aligned and their wrappers raise otherwise; the lens kernels copy
16-byte chunks in both dtypes, so their wrapper copies a misaligned q, k
or v into a fresh (aligned) tensor on the card before the launch.

Layouts: q (B, Hq, Lq, d), k / v (B, Hkv, Lk, d), q-head h reads kv-head
h // (Hq / Hkv); with ``return_state`` the wrappers also return the row
maxima ``m`` and denominators ``l``, (B, Hq, Lq) f32.

On host tensors each wrapper computes its plain version (the same blocked
online-softmax recurrence in torch, tile by tile); on CUDA tensors it
launches its kernel or raises.  The kernels take f32 or bf16, head_dim in
:data:`HEAD_DIMS` (32, 64, 96, 112, 128 and 256) and K tiles of at most
:data:`MAX_BLOCK_K` keys.  The blocks need not divide the lengths: the
last Q tile and the last K tile are short.

A row whose keys are all masked keeps ``m == NEG_INF``, and
:func:`merge_states` weights such a state by exactly 0.  The two
differentiable walks, the dense grid and tiles, write ``o = 0`` on such a
row (the reference oracle's "fully-masked rows output exactly 0"), in the
kernels and in the plain versions alike, so that ``o`` is the function
whose derivative their backward computes; its ``l`` is garbage.  On the
lens walk both ``o`` and ``l`` of such a row are garbage (the kernels and
the plain version may disagree on them).

The backward (port-only: the JAX package differentiates through its XLA
plane).  Where grad mode is on and q, k or v requires grad,
``flash_attention`` (both walks) and ``flash_attention_tiles`` go through
one ``torch.autograd.Function`` (:class:`_Attention`): its forward runs
the kernel with state and saves q, k, v, o and ``lse = m + log l``
(:func:`softmax_lse`); its backward is :func:`flash_attention_tiles_bwd`
over the same layout (the dense grid's is :func:`~repro_torch.sparse.
maskcompiler.grid_layout`): three launches of csrc/flash_attention_bwd.cu
on CUDA tensors (:func:`fa_bwd_delta`, :func:`fa_bwd_dkdv`,
:func:`fa_bwd_dq`, each counting its launches), the plain
:func:`flash_attention_tiles_bwd_plain` on host tensors.  A row with no
live key gets no gradient, as its output is 0.  The backward kernels take
the head_dims of :data:`HEAD_DIMS`, as the forward ones do.
``flash_attention_lens`` (serving) has no backward and raises when asked
for one.
"""
from __future__ import annotations

import collections
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.ref import NEG_INF, _expand_kv

__all__ = ["NEG_INF", "merge_states", "flash_attention",
           "flash_attention_lens", "flash_attention_tiles",
           "flash_attention_plain", "flash_attention_tiles_plain",
           "flash_attention_tiles_bwd", "flash_attention_tiles_bwd_plain",
           "fa_bwd_delta", "fa_bwd_dkdv", "fa_bwd_dq", "softmax_lse",
           "column_walk", "CardLayout",
           "LensPartition", "lens_partition", "lens_blocks", "HEAD_DIMS",
           "MAX_BLOCK_K"]

#: head_dim values the kernels (dense grid, tiles, lens and the three
#: backward kernels) are compiled for.
HEAD_DIMS = (32, 64, 96, 112, 128, 256)
#: The largest K tile the kernels take.
MAX_BLOCK_K = 128
#: The lens decode kernel's largest row block; a bf16 group with more rows
#: (q-heads per kv-head times Lq) runs the prefix kernel.
LENS_DECODE_ROWS = 16
#: The lens partition aims at this many CTAs per SM, counted over the key
#: capacity: the live lengths stay on the card, and ranges past a slot's
#: kv_len exit at once.  At paged decode on an H100 twice as many (one
#: tile a range) was slower (PERF.md).
LENS_CTAS_PER_SM = 4
#: The most key ranges of one launch (the merge keeps a weight per range
#: and row in shared memory).
LENS_MAX_SPLITS = 64

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


def _finish(q, outs, return_state, zero_dead=True):
    """Concatenate per-Q-tile carries into ``o`` (and ``m``, ``l``); with
    ``zero_dead``, ``o = 0`` on rows with no live key (``m == NEG_INF``),
    where ``acc / l`` is the mean of the walked V rows."""
    m = torch.cat([c[0] for c in outs], dim=2)
    l = torch.cat([c[1] for c in outs], dim=2)
    acc = torch.cat([c[2] for c in outs], dim=2)
    o = acc / l.clamp_min(1e-30)[..., None]
    if zero_dead:
        o = torch.where((m <= NEG_INF)[..., None], 0.0, o)
    o = o.to(q.dtype)
    return (o, m, l) if return_state else o


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          scale: Optional[float] = None, block_q: int = 128,
                          block_k: int = 128, kv_len=None,
                          return_state: bool = False):
    """The dense grid of the Pallas kernel in torch: every (Q tile, K tile)
    step the Pallas grid runs (above-diagonal tiles skipped when causal),
    masked by ``qpos >= kpos`` and ``kpos < kv_len[b]``.  Without
    ``kv_len`` (the dense grid) a row with no live key gets ``o = 0``;
    with it (the lens walk's plain version) its ``o`` is left as folded."""
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
    return _finish(q, outs, return_state, zero_dead=kv_len is None)


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
            live, bias = _walk_mask(layout, i, p, c, rows, keys, mid, prowp,
                                    q.device)
            carry = _fold(carry, qt, kk[:, :, c * bk:(c + 1) * bk],
                          vv[:, :, c * bk:(c + 1) * bk], scale, live=live,
                          bias=bias)
        outs.append(carry)
    return _finish(q, outs, return_state)


def _walk_mask(layout, i, p, c, rows, keys, mid, prowp, device):
    """``(live, bias)`` of entry ``p`` (K tile ``c``) of Q tile ``i``'s
    walk, as the kernels mask it: none for a FULL tile; for a PARTIAL tile
    the band compare or the stored bias tile."""
    if p < mid[i]:
        return None, None
    bq, bk = layout.block_q, layout.block_k
    if layout.band is None:
        return None, torch.as_tensor(
            layout.biases[prowp[i] + (p - mid[i])][:rows, :keys],
            device=device)
    causal, window, off = layout.band
    qpos = i * bq + off + torch.arange(rows, device=device)[:, None]
    kpos = c * bk + torch.arange(keys, device=device)[None, :]
    live = torch.ones((rows, keys), dtype=torch.bool, device=device)
    if causal:
        live = live & (qpos >= kpos)
    if window is not None:
        live = live & ((qpos - kpos) < window if causal
                       else (qpos - kpos).abs() < window)
    return live, None


def softmax_lse(m, l):
    """The log-sum-exp ``m + log(l)`` of the forward's state (f32), and
    ``-inf`` on rows with no live key (``m == NEG_INF``), whose
    probabilities the backward takes as 0."""
    return torch.where(m <= NEG_INF, torch.full_like(m, float("-inf")),
                       m + torch.log(l))


def flash_attention_tiles_bwd_plain(q, k, v, o, lse, do, layout,
                                    scale: Optional[float] = None):
    """The backward of the tiles walk in torch, tile by tile, as the
    kernels run it: ``D = rowsum(dO * o)``; per walk entry ``P = exp(S -
    lse)`` (0 on dead rows), ``dV += P^T dO``, ``dP = dO V^T``, ``dS = P *
    (dP - D)``, ``dQ += dS K * scale``, ``dK += dS^T q * scale``, in f32;
    P and dS are rounded to the inputs' dtype before the dV, dK and dQ
    products, as the bf16 kernels hand them to the tensor cores (``_fold``
    rounds P before P V the same way; in f32 a no-op).  The GQA group's
    heads are summed into their kv head.  Returns ``(dq,
    dk, dv)`` in the inputs' dtypes."""
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    bq, bk = layout.block_q, layout.block_k
    scale = scale if scale is not None else d ** -0.5
    kk, vv = (t.float() for t in _expand_kv(k, v, hq))
    qf, dof = q.float(), do.float()
    delta = (dof * o.float()).sum(-1)
    dead = torch.isneginf(lse)
    lse0 = torch.where(dead, torch.zeros_like(lse), lse)
    dq = torch.zeros_like(qf)
    dk = torch.zeros((b, hq, lk, d), device=q.device)
    dv = torch.zeros_like(dk)
    rowp, mid, prowp, cols = (layout.rowp.tolist(), layout.mid.tolist(),
                              layout.prowp.tolist(), layout.cols.tolist())
    for i in range(layout.nq):
        rs = slice(i * bq, (i + 1) * bq)
        qt, dot = qf[:, :, rs], dof[:, :, rs]
        rows = qt.shape[2]
        for p in range(rowp[i], rowp[i + 1]):
            c = cols[p]
            ks = slice(c * bk, (c + 1) * bk)
            keys = min(bk, lk - c * bk)
            live, bias = _walk_mask(layout, i, p, c, rows, keys, mid, prowp,
                                    q.device)
            s = torch.matmul(qt, kk[:, :, ks].transpose(-1, -2)) * scale
            if live is not None:
                s = torch.where(live, s, NEG_INF)
            if bias is not None:
                s = s + bias
            pr = torch.exp(s - lse0[:, :, rs, None])
            pr = torch.where(dead[:, :, rs, None], 0.0, pr)
            dv[:, :, ks] += torch.matmul(
                pr.to(q.dtype).float().transpose(-1, -2), dot)
            dp = torch.matmul(dot, vv[:, :, ks].transpose(-1, -2))
            ds = (pr * (dp - delta[:, :, rs, None])).to(q.dtype).float()
            dq[:, :, rs] += torch.matmul(ds, kk[:, :, ks]) * scale
            dk[:, :, ks] += torch.matmul(ds.transpose(-1, -2), qt) * scale
    group = hq // hkv
    dk = dk.view(b, hkv, group, lk, d).sum(2)
    dv = dv.view(b, hkv, group, lk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------

def _check(what, q, k, v, *ints, aligned=()):
    """Device, contiguity, dtype and shape checks shared by the wrappers;
    q, k, v of a dtype in ``aligned`` must also be 16-byte aligned (the
    kernels that copy 16-byte chunks)."""
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
    if q.dtype in aligned and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{what}: {q.dtype} q, k, v must be 16-byte "
                         f"aligned (the kernel copies 16-byte chunks)")


def _outputs(q, return_state):
    o = torch.empty_like(q)
    if not return_state:
        return o, None, None
    b, h, lq, _ = q.shape
    return (o, torch.empty((b, h, lq), device=q.device),
            torch.empty((b, h, lq), device=q.device))


def _launch_grid(q, k, v, *, causal, scale, block_k, return_state):
    """Launch the dense grid; returns the outputs and whether a kernel was
    launched (not for empty outputs)."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check("flash_attention", q, k, v, aligned=(torch.bfloat16,))
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    bk = min(block_k, lk)
    if bk > MAX_BLOCK_K:
        raise ValueError(f"flash_attention: block_k {bk} is above "
                         f"{MAX_BLOCK_K}")
    o, m, l = _outputs(q, return_state)
    launched = o.numel() > 0
    if launched:
        code = _lib.lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            m.data_ptr() if return_state else None,
            l.data_ptr() if return_state else None,
            b, hq, hkv, lq, lk, d, bk, float(scale), int(causal),
            int(return_state), _DTYPE_CODE[q.dtype], _lib.stream_of(q))
        _lib.check(code, "flash_attention")
    return ((o, m, l) if return_state else o), launched


class LensPartition(NamedTuple):
    """How the lens kernels cut the keys of an Lk-key capacity: range ``s``
    holds K tiles ``[s * tps, min((s + 1) * tps, ntiles))`` of block_k keys
    each (the last tile may be short), and one CTA folds each (range, row
    block); a range's tiles at or past the keys its rows may see are not
    folded."""
    ntiles: int
    tps: int
    nsplit: int

    def splits(self) -> list[tuple[int, int]]:
        return [(s * self.tps, min((s + 1) * self.tps, self.ntiles))
                for s in range(self.nsplit)]


def lens_partition(lk: int, block_k: int, groups: int, sms: int
                   ) -> LensPartition:
    """The key ranges for ``groups`` (b, kv-head, row block) groups on a
    card of ``sms`` SMs: about :data:`LENS_CTAS_PER_SM` CTAs per SM over
    the capacity's ``ceil(lk / block_k)`` tiles, at most one range per tile
    and :data:`LENS_MAX_SPLITS` in all, every range whole tiles."""
    ntiles = -(-lk // block_k)
    want = -(-LENS_CTAS_PER_SM * sms // max(groups, 1))
    nsplit = max(1, min(want, ntiles, LENS_MAX_SPLITS))
    tps = max(1, -(-ntiles // nsplit))
    return LensPartition(ntiles, tps, max(1, -(-ntiles // tps)))


def lens_blocks(dtype: torch.dtype, rows: int) -> tuple[str, int]:
    """The lens kernel for a group of ``rows`` rows (q-heads per kv-head
    times Lq) and the rows a CTA owns: ``"decode"`` (the FMA units, 4 or 16
    rows) for f32 and for bf16 groups of at most :data:`LENS_DECODE_ROWS`
    rows, else ``"prefix"`` (bf16 on the tensor cores, 64 or 128 rows)."""
    if dtype == torch.bfloat16 and rows > LENS_DECODE_ROWS:
        return "prefix", 64 if rows <= 64 else 128
    return "decode", 4 if rows <= 4 else 16


@functools.lru_cache(maxsize=64)
def _lens_plan(dtype, b, hq, hkv, lq, lk, block_k, device):
    """(kernel, rows per CTA, groups, partition) for one shape on one
    card, made once: a decode loop pays one cache lookup a call."""
    rows = hq // hkv * lq
    kind, rows_blk = lens_blocks(dtype, rows)
    groups = b * hkv * -(-rows // rows_blk)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return kind, rows_blk, groups, lens_partition(lk, block_k, groups, sms)


def flash_attention_lens(q, k, v, kv_len, *, causal: bool = False,
                         scale: Optional[float] = None, block_q: int = 128,
                         block_k: int = 128, return_state: bool = False):
    """Attention over keys ``kpos < kv_len[b]`` (int32 (B,)), optionally
    causal: the paged-decode and chunked-prefill read path.  One launch a
    call, split over the keys; the result is the same bit for bit from run
    to run.  ``block_k`` fixes the tiles the online softmax folds;
    ``block_q`` only the plain version's Q tiles."""
    scale = scale if scale is not None else q.shape[3] ** -0.5
    if _wants_grad(q, k, v):
        raise NotImplementedError(
            "flash_attention_lens has no backward (it serves decode and "
            "chunk prefixes); call it under torch.no_grad() or on tensors "
            "that do not require grad")
    kv_len = kv_len.to(torch.int32)
    if _lib.on_host(q, k, v, kv_len):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     block_q=block_q, block_k=block_k,
                                     kv_len=kv_len, return_state=return_state)
    what = "flash_attention_lens"
    q, k, v, kv_len = (t.contiguous() for t in (q, k, v, kv_len))
    _check(what, q, k, v, kv_len)
    # the kernels copy 16-byte chunks; a fresh tensor from the caching
    # allocator is aligned
    q, k, v = (t.clone() if t.data_ptr() % 16 else t for t in (q, k, v))
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    bk = max(1, min(block_k, lk))
    if bk > MAX_BLOCK_K:
        raise ValueError(f"{what}: block_k {bk} is above {MAX_BLOCK_K}")
    if kv_len.shape != (b,):
        raise ValueError(f"{what}: kv_len {tuple(kv_len.shape)} is not "
                         f"({b},)")
    o, m, l = _outputs(q, return_state)
    out = (o, m, l) if return_state else o
    if o.numel() == 0:
        return out
    kind, rows_blk, groups, part = _lens_plan(q.dtype, b, hq, hkv, lq, lk,
                                              bk, q.device)
    stream = _lib.stream_of(q)
    scratch = tickets = None
    if part.nsplit > 1:
        scratch, tickets = _lib.split_scratch(
            q.device, stream, groups * part.nsplit * rows_blk * (d + 2),
            groups)
    code = _lib.lib().flash_attention_lens_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        o.data_ptr(), m.data_ptr() if return_state else None,
        l.data_ptr() if return_state else None,
        None if scratch is None else scratch.data_ptr(),
        None if tickets is None else tickets.data_ptr(),
        b, hq, hkv, lq, lk, d, bk, float(scale), int(causal),
        int(return_state), _DTYPE_CODE[q.dtype], int(kind == "prefix"),
        rows_blk, part.nsplit, part.tps, stream)
    _lib.check(code, what)
    flash_attention_lens.launches += 1
    flash_attention_lens.kernels[kind] += 1
    return out


flash_attention_lens.launches = 0
#: Launches by kernel ("decode", "prefix"), beside the wrapper's count.
flash_attention_lens.kernels = {"decode": 0, "prefix": 0}


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None, block_q: int = 128,
                    block_k: int = 128, return_state: bool = False,
                    row_extents: bool = True, kv_len=None):
    """Flash attention; with ``return_state`` returns ``(o, m, l)``.

    Causal calls without ``kv_len`` walk the banded ``causal_layout`` with
    :func:`flash_attention_tiles` (K tiles bounded per Q tile by compiled
    row extents); ``row_extents=False`` keeps the dense grid.  ``kv_len``
    routes to :func:`flash_attention_lens`.  Blocks clamp to the lengths;
    where they do not divide them the last tile is short.  Both walks are
    differentiable (the module docstring says how); ``kv_len`` is not."""
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
    fwd = functools.partial(_grid_forward, causal=causal, scale=scale,
                            block_q=block_q, block_k=block_k)
    if _wants_grad(q, k, v):
        from repro_torch.sparse.maskcompiler import grid_layout
        out = _Attention.apply(
            q, k, v, grid_layout(lq, lk, block_q, block_k, causal), scale,
            functools.partial(fwd, return_state=True))
        return out if return_state else out[0]
    return fwd(q, k, v, return_state=return_state)


flash_attention.launches = 0


def _grid_forward(q, k, v, *, causal, scale, block_q, block_k,
                  return_state):
    """The dense grid without autograd: the plain version on host tensors,
    else one launch of the dense kernel."""
    if _lib.on_host(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     block_q=block_q, block_k=block_k,
                                     return_state=return_state)
    out, launched = _launch_grid(q, k, v, causal=causal, scale=scale,
                                 block_k=block_k, return_state=return_state)
    flash_attention.launches += launched
    return out


#: (id(layout), device) -> (layout, its arrays on the card), the most
#: recently used :data:`LAYOUTS_ON_CARD` of them.  Holding the layout keeps
#: its id from being reused while the entry lives.
_LAYOUT_ON_CARD: collections.OrderedDict = collections.OrderedDict()
LAYOUTS_ON_CARD = 256


class CardLayout(NamedTuple):
    """A layout's arrays on the card: the forward's walk (``rowp``,
    ``mid``, ``prowp``, ``cols``, ``biases``, ``order``) and its transpose,
    which the dK/dV kernel walks (``colp``, ``colq``, ``colt``: see
    :func:`column_walk`; ``corder``: :func:`_column_order`)."""
    rowp: torch.Tensor
    mid: torch.Tensor
    prowp: torch.Tensor
    cols: torch.Tensor
    biases: torch.Tensor
    order: torch.Tensor
    colp: torch.Tensor
    colq: torch.Tensor
    colt: torch.Tensor
    corder: torch.Tensor


def _walk_order(layout) -> np.ndarray:
    """The Q tiles by descending walk length (stable): the bf16 kernels
    (the forward and dQ) start the CTAs of the longest walks first."""
    return np.argsort(-np.diff(np.asarray(layout.rowp)),
                      kind="stable").astype(np.int32)


def _column_order(colp: np.ndarray) -> np.ndarray:
    """The K tiles by descending column length (stable), from
    :func:`column_walk`'s ``colp``: the bf16 dK/dV kernel starts the CTAs
    of the longest columns first."""
    return np.argsort(-np.diff(colp), kind="stable").astype(np.int32)


def column_walk(layout) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The layout transposed: K tile ``c``'s entries are ``t`` in
    ``colp[c] .. colp[c+1]``, each the Q tile ``colq[t]`` that sees it and
    that tile's walk index ``colt[t]`` (so FULL iff ``colt[t] <
    mid[colq[t]]``), ascending in Q tile.  int32 arrays."""
    rowp = np.asarray(layout.rowp)
    cols = np.asarray(layout.cols, np.int64)
    qtile = np.repeat(np.arange(layout.nq), np.diff(rowp))
    colt = np.lexsort((qtile, cols))
    colp = np.zeros(layout.nk + 1, np.int64)
    np.cumsum(np.bincount(cols, minlength=layout.nk), out=colp[1:])
    return (colp.astype(np.int32), qtile[colt].astype(np.int32),
            colt.astype(np.int32))


def _layout_tensors(layout, device) -> CardLayout:
    key = (id(layout), device)
    hit = _LAYOUT_ON_CARD.get(key)
    if hit is None:
        walk = column_walk(layout)
        hit = (layout, CardLayout(*(
            torch.as_tensor(a, device=device) for a in
            (layout.rowp, layout.mid, layout.prowp, layout.cols,
             layout.biases, _walk_order(layout), *walk,
             _column_order(walk[0])))))
        _LAYOUT_ON_CARD[key] = hit
        if len(_LAYOUT_ON_CARD) > LAYOUTS_ON_CARD:
            _LAYOUT_ON_CARD.popitem(last=False)
    else:
        _LAYOUT_ON_CARD.move_to_end(key)
    return hit[1]


def _band_args(layout) -> tuple[int, int, int, int]:
    """(band, causal, window, offset) as the kernels take them."""
    causal, window, off = layout.band if layout.band is not None \
        else (False, None, 0)
    return (int(layout.band is not None), int(causal),
            -1 if window is None else int(window), int(off))


def _tiles_forward(q, k, v, layout, scale, return_state):
    """The tiles walk without autograd: the plain version on host tensors,
    else one launch of the tiles kernel."""
    b, hq, lq, d = q.shape
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
    _check("flash_attention_tiles", q, k, v, aligned=(torch.bfloat16,))
    bq, bk = layout.block_q, layout.block_k
    if bk > MAX_BLOCK_K:
        raise ValueError(f"flash_attention_tiles: block_k {bk} is above "
                         f"{MAX_BLOCK_K}")
    lay = _layout_tensors(layout, q.device)
    o, m, l = _outputs(q, return_state)
    code = _lib.lib().flash_attention_tiles_launch(
        lay.rowp.data_ptr(), lay.mid.data_ptr(), lay.prowp.data_ptr(),
        lay.cols.data_ptr(), lay.biases.data_ptr(), lay.order.data_ptr(),
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), m.data_ptr() if return_state else None,
        l.data_ptr() if return_state else None,
        b, hq, k.shape[1], lq, k.shape[2], d, bq, bk, *_band_args(layout),
        float(scale), int(return_state), _DTYPE_CODE[q.dtype],
        _lib.stream_of(q))
    _lib.check(code, "flash_attention_tiles")
    flash_attention_tiles.launches += 1
    flash_attention_tiles.kernels["state" if return_state else "o"] += 1
    return (o, m, l) if return_state else o


def flash_attention_tiles(q, k, v, layout, *, scale: Optional[float] = None,
                          return_state: bool = False):
    """Tile-skipping flash attention over a compiled mask layout: each Q
    tile walks only its live K tiles, full tiles first.  An empty layout
    returns zeros (and ``m = NEG_INF``, ``l = 0``) without a launch.

    Differentiable: where grad mode is on and q, k or v requires grad, the
    call goes through :class:`_Attention`, whose backward is
    :func:`flash_attention_tiles_bwd` over the same layout.  The state
    ``(m, l)`` carries no gradient (a backward through it raises)."""
    lq = q.shape[2]
    if layout.shape != (lq, k.shape[2]):
        raise ValueError(f"flash_attention_tiles: layout {layout.shape} "
                         f"does not match ({lq}, {k.shape[2]})")
    scale = scale if scale is not None else q.shape[3] ** -0.5
    if _wants_grad(q, k, v):
        out = _Attention.apply(q, k, v, layout, scale, functools.partial(
            _tiles_forward, layout=layout, scale=scale, return_state=True))
        return out if return_state else out[0]
    return _tiles_forward(q, k, v, layout, scale, return_state)


flash_attention_tiles.launches = 0
#: Launches by variant ("o", and "state" for the kernels that also write
#: m and l), beside the wrapper's count.
flash_attention_tiles.kernels = {"o": 0, "state": 0}


# ---------------------------------------------------------------------------
# the backward: three kernels over the forward's layout
# ---------------------------------------------------------------------------

def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _Attention(torch.autograd.Function):
    """Attention over a layout with a hand-written backward.  ``fwd(q, k,
    v)`` runs the forward without autograd and returns ``(o, m, l)``; the
    backward is :func:`flash_attention_tiles_bwd` over ``layout`` with
    ``lse`` from the forward's state, saved with q, k, v and o."""

    @staticmethod
    def forward(ctx, q, k, v, layout, scale, fwd):
        o, m, l = fwd(q, k, v)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, o, softmax_lse(m, l))
        ctx.layout, ctx.scale = layout, scale
        return o, m, l

    @staticmethod
    def backward(ctx, do, dm, dl):
        if dm is not None or dl is not None:
            raise NotImplementedError(
                "flash attention: the state (m, l) has no backward; "
                "differentiate through o only")
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            return None, None, None, None, None, None
        dq, dk, dv = flash_attention_tiles_bwd(q, k, v, o, lse, do,
                                               ctx.layout, scale=ctx.scale)
        return dq, dk, dv, None, None, None


def fa_bwd_delta(o, do):
    """``D = rowsum(dO * o)`` in f32, (B, Hq, Lq): one launch of
    ``fa_bwd_delta_kernel`` on CUDA tensors, the plain sum on host ones."""
    if _lib.on_host(o, do):
        return (do.float() * o.float()).sum(-1)
    o, do = o.contiguous(), do.contiguous()
    _lib.require_cuda("fa_bwd_delta", o, do)
    _lib.require_dtypes("fa_bwd_delta", (o, do), (),
                        allowed=tuple(_DTYPE_CODE))
    if o.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"fa_bwd_delta: head_dim {o.shape[-1]} not in "
                         f"{HEAD_DIMS}")
    if o.shape != do.shape:
        raise ValueError(f"fa_bwd_delta: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)}")
    delta = torch.empty(o.shape[:-1], device=o.device)
    if delta.numel() == 0:
        return delta
    code = _lib.lib().fa_bwd_delta_launch(
        o.data_ptr(), do.data_ptr(), delta.data_ptr(), delta.numel(),
        o.shape[-1], _DTYPE_CODE[o.dtype], _lib.stream_of(o))
    _lib.check(code, "fa_bwd_delta")
    fa_bwd_delta.launches += 1
    return delta


fa_bwd_delta.launches = 0


def _grad_args(what, q, k, v, do, lse, delta, layout):
    """Checks shared by the two gradient kernels; returns q, k, v and do
    16-byte aligned (the bf16 kernels copy 16-byte chunks; a misaligned
    one is copied into a fresh tensor, which the caching allocator
    aligns), the layout on the card and the launch's shape arguments."""
    _check(what, q, k, v)
    _lib.require_cuda(what, q, do, lse, delta)
    if do.shape != q.shape or do.dtype != q.dtype \
            or lse.shape != q.shape[:3] or delta.shape != q.shape[:3] \
            or lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError(f"{what}: do {tuple(do.shape)} {do.dtype}, lse "
                         f"{tuple(lse.shape)} {lse.dtype}, delta "
                         f"{tuple(delta.shape)} {delta.dtype}")
    if layout.block_k > MAX_BLOCK_K:
        raise ValueError(f"{what}: block_k {layout.block_k} is above "
                         f"{MAX_BLOCK_K}")
    b, hq, lq, d = q.shape
    dims = (b, hq, k.shape[1], lq, k.shape[2], d, layout.block_q,
            layout.block_k, *_band_args(layout))
    q, k, v, do = (t.clone() if t.data_ptr() % 16 else t
                   for t in (q, k, v, do))
    return (q, k, v, do), _layout_tensors(layout, q.device), dims


def fa_bwd_dkdv(q, k, v, do, lse, delta, layout, scale):
    """dK and dV over ``layout``'s columns: one launch of
    ``fa_bwd_dkdv_wgmma_kernel`` (bf16) or ``fa_bwd_dkdv_kernel`` (f32)
    (CUDA tensors only; contiguous inputs)."""
    (q, k, v, do), lay, dims = _grad_args("fa_bwd_dkdv", q, k, v, do, lse,
                                          delta, layout)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    code = _lib.lib().fa_bwd_dkdv_launch(
        lay.rowp.data_ptr(), lay.mid.data_ptr(), lay.prowp.data_ptr(),
        lay.cols.data_ptr(), lay.biases.data_ptr(), lay.colp.data_ptr(),
        lay.colq.data_ptr(), lay.colt.data_ptr(), lay.corder.data_ptr(),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *dims, float(scale), _DTYPE_CODE[q.dtype], _lib.stream_of(q))
    _lib.check(code, "fa_bwd_dkdv")
    fa_bwd_dkdv.launches += 1
    return dk, dv


fa_bwd_dkdv.launches = 0


def fa_bwd_dq(q, k, v, do, lse, delta, layout, scale):
    """dQ over ``layout``'s rows: one launch of ``fa_bwd_dq_wgmma_kernel``
    (bf16) or ``fa_bwd_dq_kernel`` (f32) (CUDA tensors only; contiguous
    inputs)."""
    (q, k, v, do), lay, dims = _grad_args("fa_bwd_dq", q, k, v, do, lse,
                                          delta, layout)
    dq = torch.empty_like(q)
    code = _lib.lib().fa_bwd_dq_launch(
        lay.rowp.data_ptr(), lay.mid.data_ptr(), lay.prowp.data_ptr(),
        lay.cols.data_ptr(), lay.biases.data_ptr(), lay.order.data_ptr(),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *dims,
        float(scale), _DTYPE_CODE[q.dtype], _lib.stream_of(q))
    _lib.check(code, "fa_bwd_dq")
    fa_bwd_dq.launches += 1
    return dq


fa_bwd_dq.launches = 0


def flash_attention_tiles_bwd(q, k, v, o, lse, do, layout, *,
                              scale: Optional[float] = None):
    """``(dq, dk, dv)`` of attention over ``layout`` given the forward's
    ``o`` and ``lse`` (:func:`softmax_lse`) and the output gradient ``do``.
    On host tensors the plain version; on CUDA tensors three launches
    (:func:`fa_bwd_delta`, :func:`fa_bwd_dkdv`, :func:`fa_bwd_dq`), or
    none for an empty layout, whose gradients are 0.  On the card the
    head_dim must be in :data:`HEAD_DIMS`."""
    scale = scale if scale is not None else q.shape[3] ** -0.5
    if layout.ntiles == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    if _lib.on_host(q, k, v, o, lse, do):
        return flash_attention_tiles_bwd_plain(q, k, v, o, lse, do, layout,
                                               scale=scale)
    q, k, v, o, do, lse = (t.contiguous() for t in (q, k, v, o, do, lse))
    delta = fa_bwd_delta(o, do)
    dk, dv = fa_bwd_dkdv(q, k, v, do, lse, delta, layout, scale)
    return fa_bwd_dq(q, k, v, do, lse, delta, layout, scale), dk, dv
