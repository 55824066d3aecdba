"""The port's attention plane (repro_torch.sparse.maskcompiler, the
attention oracles of repro_torch.kernels.ref, the kernel wrappers of
repro_torch.kernels.flash_attention on host tensors, and the attention
entry points of repro_torch.kernels.ops) against the JAX package's, on the
same numpy inputs.  The JAX kernels run in interpret mode, as its own tests
run them; the port's wrappers run their plain versions on host tensors.

Bars: 1e-5 in f32 (the JAX suite's, tests/test_kernels.py and
tests/test_blocksparse_attention.py); the mask compiler's arrays are equal.
Rows with no live key carry garbage l (only m == NEG_INF is meaningful
there; the dense grid and tiles write o = 0 on them, the lens walk
garbage), so o and l are compared on live rows only.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.sparse import maskcompiler as jmc
from repro_torch.core import registry as treg
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.sparse import maskcompiler as tmc

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(B=2, H=4, HK=2, LQ=64, LK=None, D=16, seed=0):
    LK = LQ if LK is None else LK
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, LQ, D)).astype(np.float32),
            rng.standard_normal((B, HK, LK, D)).astype(np.float32),
            rng.standard_normal((B, HK, LK, D)).astype(np.float32))


def _both(*arrays):
    return (tuple(jnp.asarray(a) for a in arrays),
            tuple(torch.as_tensor(a) for a in arrays))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rows=None, **tol):
    got, want = _np(got), _np(want)
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, **(tol or TOL))


def _spec_pair(kind, lq, lk):
    """The same mask as a JAX MaskSpec and a port MaskSpec."""
    if kind == "causal":
        kw = dict(causal=True)
    elif kind == "window":
        kw = dict(causal=True, window=max(lq // 4, 1))
    elif kind == "bidir_window":
        kw = dict(window=max(lq // 3, 1))
    elif kind == "globals":
        kw = dict(causal=True, window=lq // 4, global_tokens=(0, 1, lk // 2))
    else:
        pat = (np.random.default_rng(7).random((lq // 16, lk // 16)) < 0.4) \
            | np.eye(lq // 16, lk // 16, k=(lk - lq) // 16, dtype=bool)
        return (jmc.MaskSpec.from_block_mask(pat, 16),
                tmc.MaskSpec.from_block_mask(pat, 16))
    return jmc.MaskSpec(**kw), tmc.MaskSpec(**kw)


SPECS = ["causal", "window", "bidir_window", "globals", "blocks"]


# ---------------------------------------------------------------------------
# the mask compiler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", SPECS)
@pytest.mark.parametrize("lq,lk,bq,bk", [(64, 64, 16, 16), (32, 96, 16, 32),
                                         (64, 64, 32, 16)])
def test_mask_compiler_arrays_equal_jax(kind, lq, lk, bq, bk):
    js, ts = _spec_pair(kind, lq, lk)
    np.testing.assert_array_equal(tmc.dense_mask(ts, lq, lk),
                                  jmc.dense_mask(js, lq, lk))
    for compile_ in ("compile_layout", "dense_masked_layout"):
        jl = getattr(jmc, compile_)(js, lq, lk, bq, bk)
        tl = getattr(tmc, compile_)(ts, lq, lk, bq, bk)
        for f in ("rowp", "mid", "prowp", "cols", "biases"):
            np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f),
                                          err_msg=f"{compile_} {f}")
            assert getattr(tl, f).dtype == getattr(jl, f).dtype
        assert (tl.shape, tl.ntiles, tl.nfull, tl.band, tl.density) == \
            (jl.shape, jl.ntiles, jl.nfull, jl.band, jl.density)
        assert dataclasses.asdict(tl.stats) == dataclasses.asdict(jl.stats)
        np.testing.assert_array_equal(tl.tile_classes(), jl.tile_classes())
        np.testing.assert_array_equal(tl.dense(), jl.dense())
    assert tmc.causal_layout(lq, lk, bq, bk).cols.tolist() == \
        jmc.causal_layout(lq, lk, bq, bk).cols.tolist()


def test_mask_compiler_validation_errors():
    with pytest.raises(ValueError):
        tmc.MaskSpec(causal=True, window=0)
    with pytest.raises(ValueError):
        tmc.MaskSpec(blocks=((True,),))
    with pytest.raises(ValueError):
        tmc.dense_mask(tmc.MaskSpec.from_block_mask(np.ones((2, 2), bool),
                                                    16), 64, 64)
    with pytest.raises(ValueError):
        tmc.compile_layout(tmc.MaskSpec(causal=True), 60, 64, 0, 16)


@pytest.mark.parametrize("kind", ["causal", "window", "bidir_window",
                                  "globals"])
@pytest.mark.parametrize("lq,lk,bq,bk", [(77, 77, 16, 16), (60, 64, 16, 16),
                                         (37, 101, 16, 32)])
def test_mask_compiler_ragged_layouts_round_trip(kind, lq, lk, bq, bk):
    """Blocks that do not divide the lengths: a ceil-divided tile grid
    whose last tiles are short, classified on their positions inside
    (Lq, Lk) only, still encodes the reference mask exactly."""
    _, ts = _spec_pair(kind, lq, lk)
    want = tmc.dense_mask(ts, lq, lk)
    lay = tmc.compile_layout(ts, lq, lk, bq, bk)
    assert (lay.nq, lay.nk) == (-(-lq // bq), -(-lk // bk))
    np.testing.assert_array_equal(lay.dense(), want)
    np.testing.assert_array_equal(
        tmc.dense_masked_layout(ts, lq, lk, bq, bk).dense(), want)
    # a tile is FULL when every position of it inside (Lq, Lk) is live
    classes = lay.tile_classes()
    for i in range(lay.nq):
        for j in range(lay.nk):
            t = want[i * bq:(i + 1) * bq, j * bk:(j + 1) * bk]
            assert classes[i, j] == (tmc.FULL if t.all() else
                                     tmc.PARTIAL if t.any() else tmc.DEAD)


# ---------------------------------------------------------------------------
# the oracles (the torch plane)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lq,lk", [(64, 64), (16, 48)])
def test_attention_refs_match_jax(causal, lq, lk):
    (jq, jk, jv), (tq, tk, tv) = _both(*_qkv(LQ=lq, LK=lk))
    _close(ref.attention_ref(tq, tk, tv, causal=causal),
           jref.attention_ref(jq, jk, jv, causal=causal))
    lens = np.asarray([0, lk - 5], np.int32)
    want = jref.attention_state_ref(jq, jk, jv, causal=causal,
                                    kv_len=jnp.asarray(lens))
    got = ref.attention_state_ref(tq, tk, tv, causal=causal,
                                  kv_len=torch.as_tensor(lens))
    np.testing.assert_array_equal(_np(got[1])[0], np.float32(fa.NEG_INF))
    for g, w in zip(got, want):
        _close(g, w, rows=1)


@pytest.mark.parametrize("kind", ["globals", "blocks"])
def test_attention_masked_ref_matches_jax(kind):
    js, ts = _spec_pair(kind, 64, 64)
    (jq, jk, jv), (tq, tk, tv) = _both(*_qkv())
    _close(ref.attention_masked_ref(tq, tk, tv, tmc.dense_mask(ts, 64, 64)),
           jref.attention_masked_ref(jq, jk, jv,
                                     jnp.asarray(jmc.dense_mask(js, 64, 64))))


@pytest.mark.parametrize("causal", [False, True])
def test_attention_chunked_matches_jax(causal):
    (jq, jk, jv), (tq, tk, tv) = _both(*_qkv(LQ=32, LK=128))
    _close(ref.attention_chunked(tq, tk, tv, causal=causal, block_kv=32),
           jref.attention_chunked(jq, jk, jv, causal=causal, block_kv=32))


# ---------------------------------------------------------------------------
# the kernel wrappers (plain versions on host tensors) vs the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("heads,bk", [((4, 4), 16), ((4, 2), 32),
                                      ((4, 1), 64)])
def test_dense_grid_matches_pallas(causal, heads, bk):
    H, HK = heads
    (jq, jk, jv), (tq, tk, tv) = _both(*_qkv(H=H, HK=HK))
    want = jfa.flash_attention(jq, jk, jv, causal=causal, block_q=32,
                               block_k=bk, return_state=True,
                               row_extents=False, interpret=True)
    got = fa.flash_attention(tq, tk, tv, causal=causal, block_q=32,
                             block_k=bk, return_state=True,
                             row_extents=False)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("lq,lk,bk", [(1, 64, 16), (8, 96, 32)])
def test_lens_grid_matches_pallas(lq, lk, bk):
    (jq, jk, jv), (tq, tk, tv) = _both(*_qkv(B=4, LQ=lq, LK=lk))
    lens = np.asarray([0, lk, 13, 1], np.int32)
    want = jfa.flash_attention(jq, jk, jv, causal=False, block_k=bk,
                               return_state=True, kv_len=jnp.asarray(lens),
                               interpret=True)
    got = fa.flash_attention(tq, tk, tv, causal=False, block_k=bk,
                             return_state=True, kv_len=torch.as_tensor(lens))
    live = lens > 0
    assert np.all(_np(got[1])[~live] == fa.NEG_INF)
    for g, w in zip(got, want):
        _close(g, w, rows=live)


@pytest.mark.parametrize("kind", SPECS)
@pytest.mark.parametrize("heads", [(4, 4), (4, 2)])
def test_tiles_match_pallas(kind, heads):
    H, HK = heads
    js, ts = _spec_pair(kind, 64, 64)
    (jq, jk, jv), (tq, tk, tv) = _both(*_qkv(H=H, HK=HK))
    want = jfa.flash_attention_tiles(
        jq, jk, jv, jmc.compile_layout(js, 64, 64, 16, 16),
        return_state=True, interpret=True)
    got = fa.flash_attention_tiles(tq, tk, tv,
                                   tmc.compile_layout(ts, 64, 64, 16, 16),
                                   return_state=True)
    for g, w in zip(got, want):
        _close(g, w)
    _close(got[0], jref.attention_masked_ref(
        jq, jk, jv, jnp.asarray(jmc.dense_mask(js, 64, 64))))


def test_tiles_unequal_lengths_and_causal_routing_match_pallas():
    js, ts = (jmc.MaskSpec(causal=True, window=40),
              tmc.MaskSpec(causal=True, window=40))
    (jq, jk, jv), (tq, tk, tv) = _both(*_qkv(LQ=32, LK=96))
    _close(fa.flash_attention_tiles(tq, tk, tv,
                                    tmc.compile_layout(ts, 32, 96, 16, 16)),
           jfa.flash_attention_tiles(jq, jk, jv,
                                     jmc.compile_layout(js, 32, 96, 16, 16),
                                     interpret=True))
    (jq, jk, jv), (tq, tk, tv) = _both(*_qkv(LQ=64))
    _close(fa.flash_attention(tq, tk, tv, causal=True, block_q=16,
                              block_k=16),
           jfa.flash_attention(jq, jk, jv, causal=True, block_q=16,
                               block_k=16, interpret=True))


@pytest.mark.parametrize("lq,lk,bq,bk", [(77, 77, 16, 32), (37, 101, 16, 32),
                                         (61, 61, 128, 128)])
def test_wrappers_at_ragged_lengths_match_the_jax_oracles(lq, lk, bq, bk):
    """Blocks that do not divide the lengths (the Pallas kernels refuse
    them; the JAX package then runs its oracles): the dense grid, the lens
    grid and the tiles walk, each with a short last tile, against the JAX
    oracles on the same inputs."""
    (jq, jk, jv), (tq, tk, tv) = _both(*_qkv(B=3, LQ=lq, LK=lk))
    # the dense grid's causal compare has no tail offset: Lq == Lk only
    for causal in (False, True) if lq == lk else (False,):
        got = fa.flash_attention(tq, tk, tv, causal=causal, block_q=bq,
                                 block_k=bk, row_extents=False,
                                 return_state=True)
        want = jref.attention_state_ref(jq, jk, jv, causal=causal)
        for g, w in zip(got, want):
            _close(g, w)
    lens = np.asarray([0, lk, lk // 2 + 1], np.int32)
    got = fa.flash_attention(tq, tk, tv, causal=False, block_k=bk,
                             kv_len=torch.as_tensor(lens), return_state=True)
    want = jref.attention_state_ref(jq, jk, jv, causal=False,
                                    kv_len=jnp.asarray(lens))
    live = lens > 0
    assert np.all(_np(got[1])[~live] == fa.NEG_INF)
    for g, w in zip(got, want):
        _close(g, w, rows=live)
    for kind in ("causal", "window", "globals"):
        js, ts = _spec_pair(kind, lq, lk)
        got = fa.flash_attention_tiles(
            tq, tk, tv, tmc.compile_layout(ts, lq, lk, bq, bk))
        _close(got, jref.attention_masked_ref(
            jq, jk, jv, jnp.asarray(jmc.dense_mask(js, lq, lk))))


def test_tiles_dead_rows_and_empty_layout():
    pat = np.zeros((4, 4), bool)
    pat[0] = True
    (jq, jk, jv), (tq, tk, tv) = _both(*_qkv())
    got = fa.flash_attention_tiles(
        tq, tk, tv, tmc.compile_layout(tmc.MaskSpec.from_block_mask(pat, 16),
                                       64, 64, 16, 16))
    assert np.all(_np(got)[:, :, 16:] == 0.0)
    _close(got, jfa.flash_attention_tiles(
        jq, jk, jv, jmc.compile_layout(jmc.MaskSpec.from_block_mask(pat, 16),
                                       64, 64, 16, 16), interpret=True))
    empty = tmc.compile_layout(
        tmc.MaskSpec.from_block_mask(np.zeros((4, 4), bool), 16), 64, 64, 16,
        16)
    assert empty.ntiles == 0
    o, m, l = fa.flash_attention_tiles(tq, tk, tv, empty, return_state=True)
    assert not o.any() and not l.any() and torch.all(m == fa.NEG_INF)


@pytest.mark.parametrize("lq,bq,bk", [(128, 32, 32), (96, 32, 16),
                                      (64, 16, 32), (77, 16, 32),
                                      (61, 32, 16)])
def test_plain_tiles_bitwise_equal_plain_dense_causal_f32(lq, bq, bk):
    """The JAX package's test_causal_row_extents_bitwise_parity, pinned on
    the port's plain versions: the banded walk folds the same tiles in the
    same order as the dense causal grid."""
    tq, tk, tv = map(torch.as_tensor, _qkv(LQ=lq))
    tiles = fa.flash_attention_tiles(tq, tk, tv,
                                     tmc.causal_layout(lq, lq, bq, bk),
                                     return_state=True)
    dense = fa.flash_attention(tq, tk, tv, causal=True, block_q=bq,
                               block_k=bk, row_extents=False,
                               return_state=True)
    for t, d in zip(tiles, dense):
        assert torch.equal(t, d)


def test_merge_states_matches_jax():
    (jq, jk, jv), (tq, tk, tv) = _both(*_qkv(LQ=1, LK=64))
    halves = []
    for sl in (slice(0, 40), slice(40, 64)):
        halves.append((jref.attention_state_ref(jq, jk[:, :, sl],
                                                jv[:, :, sl], causal=False),
                       ref.attention_state_ref(tq, tk[:, :, sl],
                                               tv[:, :, sl], causal=False)))
    want = jfa.merge_states(halves[0][0], halves[1][0])
    got = fa.merge_states(halves[0][1], halves[1][1])
    for g, w in zip(got, want):
        _close(g, w)
    whole = ref.attention_state_ref(tq, tk, tv, causal=False)
    _close(got[0], whole[0])
    dead = ref.attention_state_ref(tq, tk, tv, causal=False,
                                   kv_len=torch.zeros(2, dtype=torch.int32))
    merged = fa.merge_states(whole, dead)
    _close(merged[0], whole[0])
    _close(merged[2], whole[2])


# ---------------------------------------------------------------------------
# head_dim 96 and 256 (phi3-mini-3.8b, gemma-2b)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [96, 256])
def test_plain_attention_matches_pallas_at_head_dims(d):
    """The plain versions the CUDA kernels are held against, at the head
    sizes of phi3-mini-3.8b (96) and gemma-2b (256, MQA): the dense grid
    (causal and not), the lens grid with state and the tiles walk, against
    the Pallas kernels in interpret mode (bar 1e-5, as at 16)."""
    (jq, jk, jv), (tq, tk, tv) = _both(*_qkv(B=2, H=4, HK=1, LQ=32, D=d))
    for causal in (False, True):
        want = jfa.flash_attention(jq, jk, jv, causal=causal, block_q=16,
                                   block_k=16, return_state=True,
                                   row_extents=False, interpret=True)
        got = fa.flash_attention(tq, tk, tv, causal=causal, block_q=16,
                                 block_k=16, return_state=True,
                                 row_extents=False)
        for g, w in zip(got, want):
            _close(g, w)
    lens = np.asarray([0, 19], np.int32)
    want = jfa.flash_attention(jq, jk, jv, causal=False, block_k=16,
                               return_state=True, kv_len=jnp.asarray(lens),
                               interpret=True)
    got = fa.flash_attention(tq, tk, tv, causal=False, block_k=16,
                             return_state=True, kv_len=torch.as_tensor(lens))
    live = lens > 0
    assert np.all(_np(got[1])[~live] == fa.NEG_INF)
    for g, w in zip(got, want):
        _close(g, w, rows=live)
    js, ts = _spec_pair("window", 32, 32)
    want = jfa.flash_attention_tiles(
        jq, jk, jv, jmc.compile_layout(js, 32, 32, 16, 16),
        return_state=True, interpret=True)
    got = fa.flash_attention_tiles(tq, tk, tv,
                                   tmc.compile_layout(ts, 32, 32, 16, 16),
                                   return_state=True)
    for g, w in zip(got, want):
        _close(g, w)


# ---------------------------------------------------------------------------
# the split-K key-length kernels: the partition and a model of their fold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lk,bk,groups,sms", [(2048, 128, 64, 132),
                                              (1152, 128, 16, 132),
                                              (1021, 128, 4, 132),
                                              (80, 16, 3, 1),
                                              (100000, 64, 1, 132),
                                              (1, 128, 8, 132)])
def test_lens_partition_covers_each_live_tile_once(lk, bk, groups, sms):
    """The key ranges are whole block_k tiles, in order, disjoint, and
    cover the capacity's tiles; for every kv_len (0, 1, a tile, a tile and
    one key, the capacity) each live tile is folded by exactly one range
    and no range folds a dead tile."""
    part = fa.lens_partition(lk, bk, groups, sms)
    ntiles = -(-lk // bk)
    assert part.ntiles == ntiles
    assert 1 <= part.nsplit <= fa.LENS_MAX_SPLITS
    spans = part.splits()
    assert len(spans) == part.nsplit
    assert spans[0][0] == 0 and spans[-1][1] == ntiles
    for (a0, a1), (b0, _) in zip(spans, spans[1:]):
        assert a1 == b0 and a1 - a0 == part.tps
    assert all(t1 > t0 for t0, t1 in spans)
    for kv_len in (0, 1, bk, bk + 1, lk):
        # the kernels' rule (csrc/flash_attention_lens.cu block_of): range
        # s folds its tiles below ceil(kend / block_k)
        kend = min(kv_len, lk)
        live = min(ntiles, -(-kend // bk))
        seen = []
        for t0, t1 in spans:
            seen += range(t0, max(t0, min(t1, live)))
        assert seen == list(range(-(-kend // bk)))
    # about LENS_CTAS_PER_SM CTAs per SM, never more ranges than tiles
    want = -(-fa.LENS_CTAS_PER_SM * sms // groups)
    assert part.nsplit <= max(1, min(want, ntiles))


def test_lens_blocks_pick_the_kernel():
    """f32 always runs the decode kernel (the FMA units); bf16 does up to
    LENS_DECODE_ROWS rows per group, the prefix kernel (tensor cores)
    above."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert fa.lens_blocks(f32, 1) == ("decode", 4)
    assert fa.lens_blocks(f32, 2) == ("decode", 4)
    assert fa.lens_blocks(f32, 8) == ("decode", 16)
    assert fa.lens_blocks(f32, 256) == ("decode", 16)
    assert fa.lens_blocks(bf16, 2) == ("decode", 4)
    assert fa.lens_blocks(bf16, fa.LENS_DECODE_ROWS) == ("decode", 16)
    assert fa.lens_blocks(bf16, fa.LENS_DECODE_ROWS + 1) == ("prefix", 64)
    assert fa.lens_blocks(bf16, 256) == ("prefix", 128)


def _lens_split_model(q, k, v, kv_len, causal, bk, part):
    """The split-K lens kernels in torch: per key range, the plain fold of
    its tiles (fa._fold, masked by kpos < kv_len[b] and the causal
    compare), then the ranges' states merged by merge_states in range
    order."""
    b, hq, lq, d = q.shape
    lk = k.shape[2]
    kk, vv = ref._expand_kv(k, v, hq)
    qpos = torch.arange(lq)[:, None]
    states = []
    for t0, t1 in part.splits():
        carry = fa._init_carry(q, lq)
        for t in range(t0, t1):
            k0 = t * bk
            kpos = k0 + torch.arange(min(bk, lk - k0))[None, :]
            live = kpos[None, None] < kv_len[:, None, None, None]
            if causal:
                live = live & (qpos >= kpos)
            carry = fa._fold(carry, q, kk[:, :, k0:k0 + bk],
                             vv[:, :, k0:k0 + bk], d ** -0.5, live=live)
        m, l, acc = carry
        states.append(((acc / l.clamp_min(1e-30)[..., None]).to(q.dtype),
                       m, l))
    out = states[0]
    for st in states[1:]:
        out = fa.merge_states(out, st)
    return out


@pytest.mark.parametrize("d", [64, 96, 256])
@pytest.mark.parametrize("heads", [(2, 2), (4, 2), (8, 1)])
@pytest.mark.parametrize("causal", [False, True])
def test_lens_split_model_matches_pallas(d, heads, causal):
    """The lens kernels' split-K fold (ranges of whole tiles from
    lens_partition, merged in order) against the JAX flash_attention with
    kv_len in interpret mode: GQA groups 1, 2 and 8, kv_len 0, 1, a tile,
    a tile and one key, and the capacity (bar 1e-5 on live rows)."""
    H, HK = heads
    lq, lk, bk = 16, 80, 16
    (jq, jk, jv), (tq, tk, tv) = _both(*_qkv(B=5, H=H, HK=HK, LQ=lq, LK=lk,
                                             D=d, seed=d + H))
    lens = np.asarray([0, 1, bk, bk + 1, lk], np.int32)
    groups = 5 * HK
    part = fa.lens_partition(lk, bk, groups, groups)
    assert part.nsplit == 3 and part.tps == 2
    got = _lens_split_model(tq, tk, tv, torch.as_tensor(lens), causal, bk,
                            part)
    want = jfa.flash_attention(jq, jk, jv, causal=causal, block_q=lq,
                               block_k=bk, return_state=True,
                               kv_len=jnp.asarray(lens), interpret=True)
    live = lens > 0
    assert np.all(_np(got[1])[~live] == fa.NEG_INF)
    for g, w in zip(got, want):
        _close(g, w, rows=live)


# ---------------------------------------------------------------------------
# the entry points (host tensors select the torch plane)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", [None, "causal", "window", "globals",
                                  "blocks"])
def test_flash_attention_op_matches_jax(kind):
    (jq, jk, jv), (tq, tk, tv) = _both(*_qkv())
    js, ts = _spec_pair(kind, 64, 64) if kind else (None, None)
    with jops.backend("xla"):
        want = jops.flash_attention(jq, jk, jv, causal=True, mask=js)
    assert treg.select("flash_attention", tq, tk, tv, causal=True,
                       mask=ts).name == "torch"
    _close(ops.flash_attention(tq, tk, tv, causal=True, mask=ts), want)


def test_flash_attention_selection_gates():
    q, k = torch.zeros(1, 4, 4096, 8), torch.zeros(1, 2, 4096, 8)
    assert treg.select("flash_attention", q, k, k).name == "torch_chunked"
    _, causal = _spec_pair("causal", 256, 256)
    _, window = _spec_pair("window", 256, 256)
    q, k = torch.zeros(1, 4, 256, 8), torch.zeros(1, 2, 256, 8)
    # causal tile density is above BLOCKSPARSE_MAX_DENSITY, windows always
    # take the tile walk: the gates the card's variants apply
    assert not ops._bs_accepts(q, k, k, mask=causal)
    assert ops._bs_accepts(q, k, k, mask=window)
    assert ops._fa_accepts(q, k, k, mask=causal)
    assert not ops._fa_accepts(q, k, k, mask=window)
    assert not ops._fa_accepts(q, torch.zeros(1, 3, 256, 8),
                               torch.zeros(1, 3, 256, 8))
    # any length keeps its blocks (the last tile is short); only K tiles
    # above the kernels' 128 keys are refused
    q, k = torch.zeros(1, 4, 777, 8), torch.zeros(1, 2, 777, 8)
    assert ops._fa_blocks(777, 777, None, None) == (128, 128)
    assert ops._fa_accepts(q, k, k)
    assert ops._fa_accepts(q, k, k, block_q=128, block_k=128)
    assert not ops._fa_accepts(q, k, k, block_k=256)
    assert not ops._bs_accepts(q, k, k, mask=window, block_k=256)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_state_op_matches_jax(causal):
    (jq, jk, jv), (tq, tk, tv) = _both(*_qkv(B=3, LQ=32, LK=32))
    lens = np.asarray([32, 5, 19], np.int32)
    with jops.backend("xla"):
        want = jops.flash_attention_state(jq, jk, jv, causal=causal,
                                          kv_len=jnp.asarray(lens))
    got = ops.flash_attention_state(tq, tk, tv, causal=causal,
                                    kv_len=torch.as_tensor(lens))
    for g, w in zip(got, want):
        _close(g, w)


def _pool(seed=1, P=9, HK=2, PS=8, D=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((P, HK, PS, D)).astype(np.float32),
            rng.standard_normal((P, HK, PS, D)).astype(np.float32))


def test_page_gather_and_paged_attention_match_jax():
    kp, vp = _pool()
    table = np.asarray([[3, 1, 7, 0], [2, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    lens = np.asarray([20, 6, 0], np.int32)
    q = np.random.default_rng(2).standard_normal((3, 4, 1, 16)).astype(
        np.float32)
    (jq, jkp, jvp, jt, jl), (tq, tkp, tvp, tt, tl) = _both(q, kp, vp, table,
                                                           lens)
    np.testing.assert_array_equal(_np(ops.page_gather(tkp, tt)),
                                  _np(jops.page_gather(jkp, jt)))
    with jops.backend("xla"):
        want = jops.paged_attention(jq, jkp, jvp, jt, jl)
    got = ops.paged_attention(tq, tkp, tvp, tt, tl)
    _close(got, want, rows=lens > 0)


@pytest.mark.parametrize("variant", ["merge", "oracle"])
@pytest.mark.parametrize("plen", [0, 9, 24])
def test_chunk_attention_matches_jax(variant, plen):
    kp, vp = _pool(P=5)
    table = np.asarray([[1, 2, 3, 4]], np.int32)
    rng = np.random.default_rng(plen)
    q = rng.standard_normal((1, 4, 8, 16)).astype(np.float32)
    kc = rng.standard_normal((1, 2, 8, 16)).astype(np.float32)
    vc = rng.standard_normal((1, 2, 8, 16)).astype(np.float32)
    pl = np.asarray([plen], np.int32)
    (jq, jkp, jvp, jt, jkc, jvc, jpl), (tq, tkp, tvp, tt, tkc, tvc, tpl) = \
        _both(q, kp, vp, table, kc, vc, pl)
    with jops.backend("xla"):
        want = jops.chunk_attention(
            jq, jops.page_gather(jkp, jt), jops.page_gather(jvp, jt), jpl,
            jkc, jvc, variant=variant)
    got = ops.chunk_attention(tq, ops.page_gather(tkp, tt),
                              ops.page_gather(tvp, tt), tpl, tkc, tvc,
                              variant=variant)
    _close(got, want)


def test_chunked_prefill_oracle_bitwise_equals_oneshot_f32():
    """The JAX package's test_chunked_equals_oneshot_bitwise_f32 on the
    port: under the torch plane chunk_attention selects the contiguous
    oracle, so prefilling in chunks of 4 gives bitwise the logits and the
    pages of one 16-token chunk."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.lm import LM
    from repro_torch.serve import (Request, Scheduler, init_cache_state,
                                   make_spec)

    cfg = ModelConfig(name="stest-paged", family="dense", num_layers=2,
                      d_model=32, vocab_size=64, num_heads=4, num_kv_heads=2,
                      head_dim=8, d_ff=64, dtype="float32",
                      param_dtype="float32", serve_page_size=8)
    lm = LM(cfg)
    params = lm.init(0, device="cpu")
    spec = make_spec(cfg, num_slots=2, max_tokens=32)
    sched = Scheduler(spec, queue_depth=4)
    prompt = np.random.default_rng(5).integers(0, 64, 16).astype(np.int32)
    sched.submit(Request(rid=0, prompt=prompt, max_new=4))
    sched.admit_next()

    def state():
        st = init_cache_state(cfg, spec, device="cpu")
        st["table"].copy_(torch.as_tensor(sched.table))
        return st

    with ops.backend("torch"):
        sel = treg.select("chunk_attention", torch.zeros(1, 4, 4, 8),
                          torch.zeros(1, 2, 32, 8), torch.zeros(1, 2, 32, 8),
                          torch.zeros(1, dtype=torch.int32),
                          torch.zeros(1, 2, 4, 8), torch.zeros(1, 2, 4, 8))
        assert sel.name == "oracle"
        lg_mono, st_mono = lm.prefill_chunk(params, state(),
                                            torch.as_tensor(prompt), 0, 0, 16)
        st = state()
        for s0 in range(0, 16, 4):
            lg_chunk, st = lm.prefill_chunk(
                params, st, torch.as_tensor(prompt[s0:s0 + 4]), 0, s0, 4)
    assert torch.equal(lg_mono, lg_chunk)
    assert torch.equal(st_mono["lens"], st["lens"])
    assert torch.equal(st_mono["kpages"], st["kpages"])
