"""Public entry points of the paper's four kernels and of attention
(counterpart of ``repro.kernels.ops``).

Variant selection flows through :mod:`repro_torch.core.registry`; this
module registers one variant per plane for each op:

    'cuda'   the hand-written kernel (kernels/matmul.py, spmv.py, fft.py,
             flash_attention.py)
    'torch'  the plain PyTorch version (kernels/ref.py)

CUDA operands select 'cuda', host operands 'torch'; ``backend('torch')``
asks for the plain version on the card explicitly.

``flash_attention``'s 'cuda' and 'blocksparse' variants resolve their
blocks through :func:`repro_torch.core.blocking.resolve_blocks`, keyed
``b, h, lq, lk, d`` (plus the mask's fingerprint for the tile walk):
pinned blocks, else a cached measurement, else 128/128.  With
``REPRO_TORCH_AUTOTUNE=1`` an uncached call measures the reference's
candidates that the kernels take (:func:`fa_candidates`) and persists the
winner.  Their ``accepts`` predicates, ``explain`` and the other attention
entry points (``flash_attention_state``, hence the paged and chunked
serve paths) never measure: they run pinned or default blocks.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Sequence

import torch

from repro_torch.core import blocking, costmodel, registry
from repro_torch.core.registry import (use_backend as backend,   # noqa: F401
                                       Cost,
                                       resolve_backend as current_backend)
from repro_torch.kernels import fft as fft_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import matmul as mm_k
from repro_torch.kernels import ref
from repro_torch.kernels import spmv as spmv_k
from repro_torch.numerics.fft import bitrev_permutation, split_stream_twiddles
from repro_torch.sparse.maskcompiler import compile_layout, dense_mask
from repro_torch.sparse.selector import BLOCKSPARSE_MAX_DENSITY

__all__ = ["backend", "current_backend", "matmul", "spmv_ell", "spmv_dia",
           "fft", "fft_plan", "flash_attention",
           "flash_attention_state", "page_gather", "paged_attention",
           "chunk_attention", "fa_candidates"]


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------

@registry.register("matmul", "cuda", plane="cuda", cost=Cost.CUDA,
                   doc="tiled f32-accumulating CUDA kernel (csrc/matmul.cu)")
def _matmul_cuda(a, b, *, block_m=None, block_n=None, block_k=None):
    return mm_k.matmul(a.contiguous(), b.contiguous())


@registry.register("matmul", "torch", plane="torch", cost=Cost.TORCH,
                   doc="plain torch.matmul in f32")
def _matmul_torch(a, b, *, block_m=None, block_n=None, block_k=None):
    return ref.matmul_ref(a, b)


def matmul(a, b, *, block_m=None, block_n=None, block_k=None):
    """``a @ b`` with f32 accumulation, output in a's dtype.

    The block keywords are the reference's: there they pin a Pallas tile.
    Both planes here take and ignore them, and the result does not depend
    on them; the CUDA kernel's tile is its own (128 x 64, csrc/matmul.cu)."""
    return registry.dispatch("matmul", a, b, block_m=block_m,
                             block_n=block_n, block_k=block_k)


# ---------------------------------------------------------------------------
# SpMV (ELL + DIA layouts)
# ---------------------------------------------------------------------------

@registry.register("spmv_ell", "cuda", plane="cuda", cost=Cost.CUDA,
                   doc="warp-per-row ELL kernel (csrc/spmv.cu)")
def _spmv_ell_cuda(values, cols, x):
    return spmv_k.spmv_ell(values.contiguous(), cols.contiguous(),
                           x.contiguous())


@registry.register("spmv_ell", "torch", plane="torch", cost=Cost.TORCH,
                   doc="gather + row-reduce reference")
def _spmv_ell_torch(values, cols, x):
    return ref.spmv_ell_ref(values, cols, x)


def spmv_ell(values, cols, x):
    return registry.dispatch("spmv_ell", values, cols, x)


@registry.register("spmv_dia", "cuda", plane="cuda", cost=Cost.CUDA,
                   doc="thread-per-row banded kernel (csrc/spmv.cu)")
def _spmv_dia_cuda(diags, offsets, x):
    return spmv_k.spmv_dia(diags.contiguous(), offsets, x.contiguous())


@registry.register("spmv_dia", "torch", plane="torch", cost=Cost.TORCH)
def _spmv_dia_torch(diags, offsets, x):
    return ref.spmv_dia_ref(diags, offsets, x)


def spmv_dia(diags, offsets: Sequence[int], x):
    return registry.dispatch("spmv_dia", diags, tuple(offsets), x)


# ---------------------------------------------------------------------------
# FFT (full transform = tangle + log2(n) stages)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def fft_plan(n: int, rdtype: torch.dtype, device: torch.device):
    """Bit-reversal permutation and bit-reversed twiddle table for n, made
    once per (n, dtype, device) and kept on the device."""
    perm = torch.as_tensor(bitrev_permutation(n), device=device)
    tw = split_stream_twiddles(n)
    return (perm,
            torch.as_tensor(tw.real, dtype=rdtype, device=device),
            torch.as_tensor(tw.imag, dtype=rdtype, device=device))


def _fft_stages(x: torch.Tensor, stages: Callable) -> torch.Tensor:
    """The split-stream transform: tangle, then all log2 n stages through
    ``stages`` (:func:`~repro_torch.kernels.fft.fft_stages` or its plain
    version), reading the untiled bit-reversed twiddle table."""
    n = x.shape[0]
    rdtype = torch.float64 if x.dtype == torch.complex128 else torch.float32
    perm, tw_re, tw_im = fft_plan(n, rdtype, x.device)
    data = x[perm]
    re, im = stages(data.real.to(rdtype).contiguous(),
                    data.imag.to(rdtype).contiguous(), tw_re, tw_im, 0,
                    n.bit_length() - 1)
    return torch.complex(re, im).to(x.dtype)


def _pow2(n: int) -> bool:
    return n >= 2 and (n & (n - 1)) == 0


def _fft_accepts(x):
    return x.ndim == 1 and _pow2(x.shape[0])


@registry.register("fft", "cuda", plane="cuda", cost=Cost.CUDA,
                   accepts=_fft_accepts,
                   doc="multi-stage shared-memory kernel (csrc/fft.cu), "
                       "one host call per transform")
def _fft_cuda(x):
    return _fft_stages(x, fft_k.fft_stages)


@registry.register("fft", "torch", plane="torch", cost=Cost.TORCH,
                   accepts=_fft_accepts,
                   doc="the same stages, one plain stage at a time")
def _fft_torch(x):
    return _fft_stages(x, fft_k.fft_stages_plain)


def fft(x):
    """1-D complex FFT by split-stream stages (power-of-two length)."""
    x = x if x.dtype == torch.complex128 else x.to(torch.complex64)
    return registry.dispatch("fft", x)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

#: The blocks every attention variant runs at when none are pinned or
#: measured (the JAX package's defaults).
_FA_DEFAULTS = {"q": 128, "k": 128}
#: The reference's candidate blocks (``repro/kernels/ops.py``
#: ``_FA_CANDIDATES``).  The kernels' stated domain
#: (:func:`~repro_torch.kernels.flash_attention.takes_blocks`) filters them
#: before anything runs: ``{"k": 256}`` is out by rule.
_FA_CANDIDATES = ({"q": 256}, {"k": 256}, {"q": 256, "k": 256},
                  {"q": 64, "k": 64})
#: Timed runs per candidate block, after one warm-up.  At the training
#: shape a call is about 0.1 ms, host launch included, and 3 runs let the
#: winner between 128x128 and 256x128 flip from run to run on an H100
#: (PERF.md §6).
FA_MEASURE_ITERS = 10


def _fa_blocks(lq, lk, block_q, block_k):
    """The blocks of a call: given, else the defaults, clamped to the
    lengths (as the JAX package clamps them).  Where a block does not
    divide its length the kernels run a short last tile, so no length
    changes the tile size."""
    return (min(block_q or _FA_DEFAULTS["q"], lq),
            min(block_k or _FA_DEFAULTS["k"], lk))


def fa_candidates(head_dim: int) -> list[dict]:
    """The candidate blocks (defaults first) the kernels take at
    ``head_dim``: the reference's list filtered by the kernels' domain."""
    out = []
    for cand in ({}, *_FA_CANDIDATES):
        bl = {**_FA_DEFAULTS, **cand}
        if bl not in out and fa_k.takes_blocks(bl["q"], bl["k"], head_dim):
            out.append(bl)
    return out


def _fa_measure(run):
    """``measure(blocks) -> seconds`` for :func:`resolve_blocks`: one
    warm-up, then :data:`FA_MEASURE_ITERS` runs between two synchronises,
    under ``torch.no_grad()``."""
    def measure(bl):
        with torch.no_grad():
            out = run(bl)
            on_card = out.is_cuda
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(FA_MEASURE_ITERS):
                run(bl)
            if on_card:
                torch.cuda.synchronize()
        return (time.perf_counter() - t0) / FA_MEASURE_ITERS
    return measure


def _fa_resolve(op, q, k, mask, run, measure=True, extra=()):
    """Measured-or-cached-or-default blocks (q, k) for a call of ``op``
    (``flash_attention``, or ``flash_attention_state``; ``mask`` None or
    the call's mask; ``extra`` further (name, value) dims of the key, as
    the state op's ``causal``), clamped to the lengths.  A settled answer
    costs one lookup under a key of the call's shapes, dtype, non-trivial
    mask and extras; the dims and the measurement are built only when the
    cache must be read."""
    memo = (op, q.shape, k.shape[2], q.dtype,
            None if mask is None or mask.trivial_dense else mask, extra)
    bl = blocking.settled(op, memo)
    if bl is None:
        d = q.shape[3]
        bl = blocking.resolve_blocks(
            op, {**_fa_dims(q, k, mask), **dict(extra)},
            costmodel.dtype_name(q.dtype), _FA_DEFAULTS, _FA_CANDIDATES,
            _fa_measure(run) if measure else None,
            takes=lambda b: fa_k.takes_blocks(b["q"], b["k"], d), memo=memo)
    return _fa_blocks(q.shape[2], k.shape[2], bl["q"], bl["k"])


def _fa_dims(q, k, mask=None):
    dims = {"b": q.shape[0], "h": q.shape[1], "lq": q.shape[2],
            "lk": k.shape[2], "d": q.shape[3]}
    if mask is not None and not mask.trivial_dense:
        dims.update({f"mask.{n}": x for n, x in mask.cost_dims().items()})
    return dims


def _fa_accepts(q, k, v, *, causal=True, mask=None, block_q=None,
                block_k=None):
    """Grouped heads and K tiles the kernels take (at most
    ``MAX_BLOCK_K`` keys, at the pinned or default blocks: accepting
    measures nothing); masks only when trivially dense (plain causal or
    none)."""
    if mask is not None and not mask.trivial_dense:
        return False
    _, bk = _fa_blocks(q.shape[2], k.shape[2], block_q, block_k)
    return q.shape[1] % k.shape[1] == 0 and bk <= fa_k.MAX_BLOCK_K


def _attn_cuda_blocks(q, k, v, causal, block_q, block_k, measure=True):
    if block_q is not None and block_k is not None:       # fully pinned
        return _fa_blocks(q.shape[2], k.shape[2], block_q, block_k)

    def run(bl):
        return fa_k.flash_attention(q, k, v, causal=causal, block_q=bl["q"],
                                    block_k=bl["k"])
    bq, bk = _fa_resolve("flash_attention", q, k, None, run, measure)
    return _fa_blocks(q.shape[2], k.shape[2], block_q or bq, block_k or bk)


@registry.register("flash_attention", "cuda", plane="cuda", cost=Cost.CUDA,
                   accepts=_fa_accepts,
                   doc="online-softmax GQA kernels (kernels/flash_attention"
                       ".py; causal walks the banded tile layout)")
def _attn_cuda(q, k, v, *, causal=True, mask=None, block_q=None,
               block_k=None):
    if mask is not None:      # trivially dense: lower to the causal flag
        causal = mask.causal
    bq, bk = _attn_cuda_blocks(q, k, v, causal, block_q, block_k)
    return fa_k.flash_attention(q, k, v, causal=causal, block_q=bq,
                                block_k=bk)


def _bs_accepts(q, k, v, *, causal=True, mask=None, block_q=None,
                block_k=None):
    """Tile density drives the dense <-> block-sparse crossover: masks the
    dense kernel expresses natively take the tile walk only under
    ``BLOCKSPARSE_MAX_DENSITY``; richer masks always do.  Judged at the
    pinned or default blocks."""
    if mask is None or q.shape[1] % k.shape[1] != 0:
        return False
    lq, lk = q.shape[2], k.shape[2]
    bq, bk = _fa_blocks(lq, lk, block_q, block_k)
    if bk > fa_k.MAX_BLOCK_K:
        return False
    try:
        layout = compile_layout(mask, lq, lk, bq, bk)
    except ValueError:        # e.g. a block pattern that doesn't cover
        return False
    if mask.trivial_dense:
        return layout.density <= BLOCKSPARSE_MAX_DENSITY
    return True


def _bs_blocks(q, k, v, mask, block_q, block_k, measure=True):
    lq, lk = q.shape[2], k.shape[2]
    if block_q is not None and block_k is not None:       # fully pinned
        return _fa_blocks(lq, lk, block_q, block_k)

    def run(bl):
        bq, bk = _fa_blocks(lq, lk, bl["q"], bl["k"])
        return fa_k.flash_attention_tiles(
            q, k, v, compile_layout(mask, lq, lk, bq, bk))
    bq, bk = _fa_resolve("flash_attention", q, k, mask, run, measure)
    return _fa_blocks(lq, lk, block_q or bq, block_k or bk)


@registry.register("flash_attention", "blocksparse", plane="cuda",
                   cost=Cost.BLOCKSPARSE, accepts=_bs_accepts,
                   doc="tile-skipping kernel over a compiled mask layout")
def _attn_blocksparse(q, k, v, *, causal=True, mask=None, block_q=None,
                      block_k=None):
    lq, lk = q.shape[2], k.shape[2]
    bq, bk = _bs_blocks(q, k, v, mask, block_q, block_k)
    return fa_k.flash_attention_tiles(q, k, v,
                                      compile_layout(mask, lq, lk, bq, bk))


def _fa_premeasure(q, k, v, *, causal=True, mask=None):
    """The ``flash_attention`` premeasure hook: measure (autotune on) the
    blocks of the variant dispatch selects for these arguments, upgrading
    a default-marked entry; returns ``{"q": bq, "k": bk}``."""
    name = registry.select("flash_attention", q, k, v, causal=causal,
                           mask=mask).name
    if name == "cuda":
        bq, bk = _attn_cuda_blocks(q, k, v, mask.causal if mask is not None
                                   else causal, None, None)
    elif name == "blocksparse":
        bq, bk = _bs_blocks(q, k, v, mask, None, None)
    else:
        raise ValueError(f"flash_attention: the {name!r} variant runs no "
                         f"blocks to measure")
    return {"q": bq, "k": bk}


blocking.PREMEASURE["flash_attention"] = _fa_premeasure


@functools.lru_cache(maxsize=16)
def _dense_mask_arr(mask, lq, lk):
    return dense_mask(mask, lq, lk)


@registry.register("flash_attention", "torch", plane="torch",
                   cost=Cost.TORCH,
                   doc="materialising oracle (any mask)")
def _attn_torch(q, k, v, *, causal=True, mask=None, block_q=None,
                block_k=None):
    if mask is not None:
        if mask.trivial_dense:
            return ref.attention_ref(q, k, v, causal=mask.causal)
        return ref.attention_masked_ref(
            q, k, v, _dense_mask_arr(mask, q.shape[2], k.shape[2]))
    return ref.attention_ref(q, k, v, causal=causal)


def _chunked_accepts(q, k, v, *, causal=True, mask=None, block_q=None,
                     block_k=None):
    # long sequences stream over KV blocks instead of materialising scores
    if mask is not None and not mask.trivial_dense:
        return False
    return k.shape[2] >= 4096 and k.shape[2] % 1024 == 0


@registry.register("flash_attention", "torch_chunked", plane="torch",
                   cost=Cost.TORCH_CHUNKED, accepts=_chunked_accepts,
                   doc="KV-streamed plain schedule")
def _attn_torch_chunked(q, k, v, *, causal=True, mask=None, block_q=None,
                        block_k=None):
    if mask is not None:
        causal = mask.causal
    return ref.attention_chunked(q, k, v, causal=causal, block_kv=1024)


def flash_attention(q, k, v, *, causal=True, mask=None, block_q=None,
                    block_k=None):
    """Registry-dispatched attention.  ``mask`` (a
    :class:`~repro_torch.sparse.maskcompiler.MaskSpec`) when given fully
    specifies the masking and ``causal`` is ignored."""
    return registry.dispatch("flash_attention", q, k, v, causal=causal,
                             mask=mask, block_q=block_q, block_k=block_k)


# ---------------------------------------------------------------------------
# flash attention with state: (o, m, l)
# ---------------------------------------------------------------------------

def _fa_state_accepts(q, k, v, *, causal=True, kv_len=None, block_q=None,
                      block_k=None):
    return q.shape[1] % k.shape[1] == 0


def _state_blocks(q, k, v, causal, block_q, block_k):
    """The blocks of a ``flash_attention_state`` call without ``kv_len``:
    pinned, else resolved under the op's own key, whose dims carry
    ``causal`` (causal calls walk the tiles kernel, full ones the dense
    grid), in the ambient scope, so that a ring's per-shard calls read the
    entry :func:`_fa_state_premeasure` wrote under the same mesh."""
    if block_q is not None and block_k is not None:       # fully pinned
        return _fa_blocks(q.shape[2], k.shape[2], block_q, block_k)

    def run(bl):
        return fa_k.flash_attention(q, k, v, causal=causal,
                                    return_state=True, block_q=bl["q"],
                                    block_k=bl["k"])[0]
    bq, bk = _fa_resolve("flash_attention_state", q, k, None, run,
                         extra=(("causal", int(causal)),))
    return _fa_blocks(q.shape[2], k.shape[2], block_q or bq, block_k or bk)


@registry.register("flash_attention_state", "cuda", plane="cuda",
                   cost=Cost.CUDA, accepts=_fa_state_accepts,
                   doc="GQA flash kernels emitting the (m, l) state")
def _attn_state_cuda(q, k, v, *, causal=True, kv_len=None, block_q=None,
                     block_k=None):
    if kv_len is None:
        bq, bk = _state_blocks(q, k, v, causal, block_q, block_k)
    else:                     # decode and chunk prefixes: the lens kernel
        bq, bk = _fa_blocks(q.shape[2], k.shape[2], block_q, block_k)
    return fa_k.flash_attention(q, k, v, causal=causal, kv_len=kv_len,
                                return_state=True, block_q=bq, block_k=bk)


def _fa_state_premeasure(q, k, v, *, causal=True):
    """The ``flash_attention_state`` premeasure hook: measure (autotune
    on) the blocks of the state kernels on these arguments under the
    ambient scope (inside ``use_level(O3|O4)``, on shard-shaped tensors,
    the ``...|mesh|<shape>`` entry a ring's per-shard calls read); returns
    ``{"q": bq, "k": bk}``."""
    name = registry.select("flash_attention_state", q, k, v,
                           causal=causal).name
    if name != "cuda":
        raise ValueError(f"flash_attention_state: the {name!r} variant runs "
                         f"no blocks to measure")
    bq, bk = _state_blocks(q, k, v, causal, None, None)
    return {"q": bq, "k": bk}


blocking.PREMEASURE["flash_attention_state"] = _fa_state_premeasure


@registry.register("flash_attention_state", "torch", plane="torch",
                   cost=Cost.TORCH, accepts=_fa_state_accepts,
                   doc="materialising oracle returning (o, m, l)")
def _attn_state_torch(q, k, v, *, causal=True, kv_len=None, block_q=None,
                      block_k=None):
    return ref.attention_state_ref(q, k, v, causal=causal, kv_len=kv_len)


def flash_attention_state(q, k, v, *, causal=True, kv_len=None, block_q=None,
                          block_k=None, variant=None):
    """Attention that also returns the online-softmax (m, l) row state.
    ``kv_len`` (B,) int32 masks keys at positions ``>= kv_len[b]``."""
    return registry.dispatch("flash_attention_state", q, k, v,
                             variant=variant, causal=causal, kv_len=kv_len,
                             block_q=block_q, block_k=block_k)


# ---------------------------------------------------------------------------
# paged attention: one-token decode over the paged KV cache
# ---------------------------------------------------------------------------

def page_gather(pages, table):
    """``pages`` (P, kv_heads, page_size, d) + ``table`` (B, n) of global
    page ids -> dense per-slot views (B, kv_heads, n * page_size, d) in
    table-position order.  Unused entries point at the trash page 0; the
    caller masks them off with ``kv_len``."""
    b, n = table.shape
    _, kv_heads, ps, d = pages.shape
    g = pages[table.long()]                          # (B, n, hk, ps, d)
    return g.transpose(1, 2).reshape(b, kv_heads, n * ps, d)


def _paged_accepts(q, kpages, vpages, table, lens):
    return q.shape[1] % kpages.shape[1] == 0


@registry.register("paged_attention", "gather", cost=Cost.TORCH,
                   accepts=_paged_accepts,
                   doc="gather the slot's pages into a dense view, then "
                       "prefix-masked flash over it")
def _paged_gather(q, kpages, vpages, table, lens):
    kg = page_gather(kpages, table)
    vg = page_gather(vpages, table)
    o, _, _ = flash_attention_state(q, kg, vg, causal=False, kv_len=lens,
                                    variant=registry.resolve_backend(q))
    return o


def paged_attention(q, kpages, vpages, table, lens, *, variant=None):
    """Decode attention over a paged KV cache: ``q`` (B, H, 1, d) against
    the pages of each slot's ``table`` row, ``lens`` (B,) valid tokens."""
    return registry.dispatch("paged_attention", q, kpages, vpages, table,
                             lens, variant=variant)


# ---------------------------------------------------------------------------
# chunk attention: one prefill chunk against (gathered prefix + itself)
# ---------------------------------------------------------------------------

def _chunk_accepts(q, kp, vp, plen, kc, vc):
    return q.shape[1] % kp.shape[1] == 0 and q.shape[2] == kc.shape[2]


@registry.register("chunk_attention", "merge", cost=Cost.CUDA,
                   accepts=_chunk_accepts,
                   doc="prefix-masked state + causal chunk state, merged")
def _chunk_merge(q, kp, vp, plen, kc, vc):
    plane = registry.resolve_backend(q)
    prefix = flash_attention_state(q, kp, vp, causal=False, kv_len=plen,
                                   variant=plane)
    chunk = flash_attention_state(q, kc, vc, causal=True, variant=plane)
    return fa_k.merge_states(prefix, chunk)[0]


@registry.register("chunk_attention", "oracle", plane="torch",
                   cost=Cost.TORCH, accepts=_chunk_accepts,
                   doc="contiguous-layout oracle, bitwise one-shot prefill")
def _chunk_oracle(q, kp, vp, plen, kc, vc):
    """Gathers ``[prefix[:plen] || chunk]`` into a fixed-capacity buffer so
    every valid key sits at the index it has in a one-shot prefill over the
    same tokens: the softmax folds the identical nonzero terms in the
    identical order, so chunked prefill is bitwise one-shot in f32."""
    b, hq, c, d = q.shape
    hk, cap = kp.shape[1], kp.shape[2]
    group = hq // hk
    plen = plen.to(q.device).long()
    cat_k = torch.cat([kp, kc], dim=2)               # (b, hk, cap + c, d)
    cat_v = torch.cat([vp, vc], dim=2)
    j = torch.arange(cap, device=q.device)
    src = torch.where(j[None, :] < plen[:, None], j[None, :],
                      (cap + j[None, :] - plen[:, None]).clamp(0,
                                                               cap + c - 1))
    idx = src[:, None, :, None].expand(b, hk, cap, d)
    kcat = torch.gather(cat_k, 2, idx)
    vcat = torch.gather(cat_v, 2, idx)
    kk = kcat.repeat_interleave(group, dim=1) if group > 1 else kcat
    vv = vcat.repeat_interleave(group, dim=1) if group > 1 else vcat
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * d ** -0.5
    qpos = plen[:, None, None, None] + torch.arange(
        c, device=q.device)[None, None, :, None]
    live = j[None, None, None, :] <= qpos            # causal at offset plen
    s = torch.where(live, s, fa_k.NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(live, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vv.float())
    return (out / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def chunk_attention(q, kp, vp, plen, kc, vc, *, variant=None):
    """One prefill chunk: queries ``q`` (B, H, C, d) at positions
    ``plen + [0, C)`` attend the gathered prefix ``kp``/``vp`` (B, kv_heads,
    cap, d; valid length ``plen``) and the chunk's own keys causally.
    Contract: ``plen + C <= cap`` (the scheduler reserves a slot's whole
    span at admission)."""
    return registry.dispatch("chunk_attention", q, kp, vp, plen, kc, vc,
                             variant=variant)
