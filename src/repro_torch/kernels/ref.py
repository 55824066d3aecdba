"""Plain PyTorch oracles for the paper's four kernels, the blocked-sparse
plane and attention (counterpart of ``repro.kernels.ref``).

Each is the transparent formulation: the 'torch' plane of the main path,
the plain version each CUDA kernel is held against, and the oracle of the
tests.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.numerics.sparse import csr_row_ids

__all__ = ["matmul_ref", "spmv_ell_ref", "spmv_dia_ref", "spmm_ell_ref",
           "spmm_bsr_ref", "bsr_todense_ref", "spgemm_bsr_ref",
           "fft_stage_ref", "fft_ref", "attention_ref", "attention_state_ref",
           "attention_masked_ref", "attention_chunked", "NEG_INF"]

#: The additive mask value (finite, so exp() underflows to 0 instead of
#: giving inf - inf = nan); ``kernels.flash_attention.NEG_INF`` is this.
NEG_INF = -1e30


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None
               ) -> torch.Tensor:
    """``a @ b`` in float32 (full precision, never TF32), cast to
    ``out_dtype`` (default: a's dtype)."""
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def spmv_ell_ref(values: torch.Tensor, cols: torch.Tensor, x: torch.Tensor
                 ) -> torch.Tensor:
    """``y[i] = sum_w values[i, w] * x[cols[i, w]]``."""
    return torch.sum(values * x[cols], dim=1)


def spmv_dia_ref(diags: torch.Tensor, offsets: Sequence[int],
                 x: torch.Tensor) -> torch.Tensor:
    """``y[i] = sum_d diags[d, i] * x[i + offsets[d]]``, out-of-range reads
    giving 0."""
    n = diags.shape[1]
    y = torch.zeros(n, dtype=diags.dtype, device=diags.device)
    idx = torch.arange(n, device=diags.device)
    for d, off in enumerate(offsets):
        src = idx + off
        valid = (src >= 0) & (src < n)
        y = y + diags[d] * torch.where(valid, x[src.clamp(0, n - 1)],
                                       torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
    return y


def spmm_ell_ref(values: torch.Tensor, cols: torch.Tensor, x: torch.Tensor
                 ) -> torch.Tensor:
    """ELL x dense panel: ``y[i, :] = sum_w values[i, w] * x[cols[i, w], :]``."""
    return torch.einsum("iw,iwk->ik", values, x[cols])


def spmm_bsr_ref(values: torch.Tensor, cols: torch.Tensor, rowp: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """BSR x dense panel: per-block dense products + a block-row segment-sum
    (``index_add_``)."""
    nblocks, bs, _ = values.shape
    n, k = x.shape
    nbrows = rowp.shape[0] - 1
    out = torch.zeros((nbrows, bs, k), dtype=values.dtype,
                      device=values.device)
    if nblocks == 0:
        return out.reshape(nbrows * bs, k)
    xb = x.reshape(n // bs, bs, k)
    prod = torch.bmm(values, xb[cols])                   # (nblocks, bs, k)
    out.index_add_(0, csr_row_ids(rowp, nblocks), prod)
    return out.reshape(nbrows * bs, k)


def bsr_todense_ref(values: torch.Tensor, cols: torch.Tensor,
                    rowp: torch.Tensor, shape: tuple[int, int]
                    ) -> torch.Tensor:
    """BSR -> dense, a scatter-add over the block grid (the device-side dual
    of the container's host ``todense``)."""
    n, m = shape
    nblocks, bs, _ = values.shape
    grid = torch.zeros((n // bs, m // bs, bs, bs), dtype=values.dtype,
                       device=values.device)
    if nblocks:
        rows = csr_row_ids(rowp, nblocks)
        grid.index_put_((rows, cols.long()), values, accumulate=True)
    return grid.permute(0, 2, 1, 3).reshape(n, m)


def spgemm_bsr_ref(a_values, a_cols, a_rowp, b_values, b_cols, b_rowp,
                   a_shape: tuple[int, int], b_shape: tuple[int, int]
                   ) -> torch.Tensor:
    """SpGEMM dense oracle: densify both BSR operands and multiply in f32.
    Returns the *dense* (n, m) product."""
    ad = bsr_todense_ref(a_values, a_cols, a_rowp, a_shape)
    bd = bsr_todense_ref(b_values, b_cols, b_rowp, b_shape)
    return torch.matmul(ad.float(), bd.float()).to(a_values.dtype)


def fft_stage_ref(data_re, data_im, tw_re, tw_im):
    """(n/2, 2) re/im -> (2, n/2) re/im: up row 0, down row 1.  ``tw`` is
    the stage's twiddle row, already tiled to n/2."""
    er, orr = data_re[:, 0], data_re[:, 1]
    ei, oi = data_im[:, 0], data_im[:, 1]
    up_re, up_im = er + orr, ei + oi
    dr, di = er - orr, ei - oi
    down_re = dr * tw_re - di * tw_im
    down_im = dr * tw_im + di * tw_re
    return (torch.stack([up_re, down_re]), torch.stack([up_im, down_im]))


def fft_ref(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.fft(x)


def _expand_kv(k: torch.Tensor, v: torch.Tensor, hq: int):
    """K/V (b, hk, lk, d) repeated along heads to ``hq`` (GQA: q-head h
    reads kv-head h // (hq / hk))."""
    group = hq // k.shape[1]
    if group == 1:
        return k, v
    return (k.repeat_interleave(group, dim=1),
            v.repeat_interleave(group, dim=1))


def attention_ref(q, k, v, *, causal: bool = True, scale=None
                  ) -> torch.Tensor:
    """(b, hq, lq, d) x (b, hk, lk, d) GQA attention, f32 softmax."""
    return attention_state_ref(q, k, v, causal=causal, scale=scale)[0]


def attention_state_ref(q, k, v, *, causal: bool = True, scale=None,
                        kv_len=None):
    """:func:`attention_ref` that also returns the online-softmax state
    ``(o, m, l)``, ``m``/``l`` (b, hq, lq) f32.  Causal masks align the
    tails (``tril(k=lk - lq)``).  ``kv_len`` (b,) masks keys at positions
    ``>= kv_len[b]``; a row with no live key keeps ``m == NEG_INF`` and
    garbage ``l`` (a state merge weights it by exactly 0)."""
    b, hq, lq, d = q.shape
    lk = k.shape[2]
    kk, vv = _expand_kv(k, v, hq)
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * scale
    if causal:
        mask = torch.ones((lq, lk), dtype=torch.bool,
                          device=q.device).tril(lk - lq)
        s = torch.where(mask, s, NEG_INF)
    if kv_len is not None:
        live = torch.arange(lk, device=q.device)[None, None, None, :] \
            < kv_len.to(q.device)[:, None, None, None]
        s = torch.where(live, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vv.float())
    out = out / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype), m, l


def attention_masked_ref(q, k, v, mask, *, scale=None) -> torch.Tensor:
    """GQA attention under a bool mask (lq, lk), True = attend: the oracle
    of the tile-skipping kernel.  Fully masked rows output exactly 0."""
    d = q.shape[3]
    kk, vv = _expand_kv(k, v, q.shape[1])
    scale = scale if scale is not None else d ** -0.5
    mask = torch.as_tensor(mask, device=q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * scale
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    # dead rows: exp(0) = 1 per entry; zero them so the row sums to 0
    p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vv.float())
    return (out / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def attention_chunked(q, k, v, *, causal: bool = True, scale=None,
                      block_kv: int = 1024) -> torch.Tensor:
    """Streaming-softmax attention: a loop over KV blocks with a running
    (max, denom, acc) carry, which never materialises (lq, lk) scores."""
    b, hq, lq, d = q.shape
    lk = k.shape[2]
    kk, vv = _expand_kv(k, v, hq)
    scale = scale if scale is not None else d ** -0.5
    if lk % block_kv:
        raise ValueError(f"attention_chunked: lk={lk} does not tile by "
                         f"{block_kv}")
    q32 = q.float() * scale
    qi = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
    m = torch.full((b, hq, lq), float("-inf"), device=q.device)
    l = torch.zeros((b, hq, lq), device=q.device)
    acc = torch.zeros((b, hq, lq, d), device=q.device)
    for j0 in range(0, lk, block_kv):
        s = torch.einsum("bhqd,bhkd->bhqk", q32,
                         kk[:, :, j0:j0 + block_kv].float())
        if causal:
            kj = j0 + torch.arange(block_kv, device=q.device)[None, :]
            s = torch.where(qi >= kj, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p, vv[:, :, j0:j0 + block_kv].float())
        m = m_new
    return (acc / l[..., None]).to(q.dtype)
