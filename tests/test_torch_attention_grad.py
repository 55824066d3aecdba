"""The port's attention backward (repro_torch.kernels.flash_attention: the
autograd wrapper of the kernel entry points and its plain backward
``flash_attention_tiles_bwd_plain``, on host tensors) against
``jax.vjp`` of the JAX package's attention: its oracles
(``repro.kernels.ref``) and ``repro.kernels.ops.flash_attention`` on its
CPU plane, on the same numpy inputs and cotangents.

Bar: 1e-5 in f32, as tests/test_torch_models.py.  Rows with no live key
are 0 in the JAX masked oracle, whose gradient through them is 0; the
port's backward gives such rows no probability (dQ = 0, nothing into dK or
dV), so the gradients agree there too, for any cotangent.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.sparse import maskcompiler as jmc
from repro_torch.kernels import flash_attention as fa
from repro_torch.sparse import maskcompiler as tmc

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(B=2, H=4, HK=2, LQ=37, LK=None, D=16, seed=0):
    LK = LQ if LK is None else LK
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, H, LQ, D), f(B, HK, LK, D), f(B, HK, LK, D), f(B, H, LQ, D)


def _jax_grads(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))], np.asarray(out)


def _port_grads(fn, q, k, v, do):
    leaves = [torch.as_tensor(a).requires_grad_() for a in (q, k, v)]
    out = fn(*leaves)
    assert out.grad_fn is not None
    out.backward(torch.as_tensor(do))
    return [t.grad.numpy() for t in leaves], out.detach().numpy()


def _close_all(got, want):
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, err_msg=what, **TOL)


def _spec_pair(kind, lq, lk):
    if kind == "window":
        kw = dict(causal=True, window=max(lq // 4, 1))
    elif kind == "bidir_window":
        kw = dict(window=max(lq // 3, 1))
    elif kind == "globals":
        kw = dict(causal=True, window=lq // 4, global_tokens=(0, 1, lk // 2))
    else:
        pat = np.tril(np.ones((lq // 8, lk // 8), bool))
        if kind == "deadrows":
            pat[2:4] = False     # rows 16-31: a dead Q tile at block_q 16
            pat[5] = False       # rows 40-47: dead inside a live Q tile
        return (jmc.MaskSpec.from_block_mask(pat, 8),
                tmc.MaskSpec.from_block_mask(pat, 8))
    return jmc.MaskSpec(**kw), tmc.MaskSpec(**kw)


@pytest.mark.parametrize("heads", [(4, 2), (4, 1)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("L", [37, 64])
def test_flash_attention_grads_match_jax(L, causal, heads):
    """Causal calls walk causal_layout (the tiles walk), non-causal ones
    the dense grid; ragged L leaves a short last tile."""
    q, k, v, do = _inputs(H=heads[0], HK=heads[1], LQ=L, seed=L)
    want, jo = _jax_grads(lambda a, b, c: jref.attention_ref(
        a, b, c, causal=causal), q, k, v, do)
    got, to = _port_grads(lambda a, b, c: fa.flash_attention(
        a, b, c, causal=causal, block_q=16, block_k=8), q, k, v, do)
    np.testing.assert_allclose(to, jo, **TOL)
    _close_all(got, want)
    via_ops, _ = _jax_grads(lambda a, b, c: jops.flash_attention(
        a, b, c, causal=causal), q, k, v, do)
    _close_all(got, via_ops)


@pytest.mark.parametrize("causal,lq,lk", [(True, 48, 48), (False, 40, 72),
                                          (False, 72, 40)])
def test_dense_grid_grads_match_jax(causal, lq, lk):
    """``row_extents=False``: the dense grid, whose backward walks
    grid_layout (every tile FULL, or causal with no tail offset)."""
    q, k, v, do = _inputs(LQ=lq, LK=lk, seed=lq + lk)
    want, _ = _jax_grads(lambda a, b, c: jref.attention_ref(
        a, b, c, causal=causal), q, k, v, do)
    got, _ = _port_grads(lambda a, b, c: fa.flash_attention(
        a, b, c, causal=causal, row_extents=False, block_q=16, block_k=16),
        q, k, v, do)
    _close_all(got, want)


@pytest.mark.parametrize("heads", [(4, 2), (4, 1)])
@pytest.mark.parametrize("kind", ["window", "bidir_window", "globals",
                                  "blocks", "deadrows"])
def test_tiles_grads_match_jax_masked(kind, heads):
    """The tiles walk over compiled masks: the band path (windows), the
    bias path (global tokens, block patterns) and dead rows, against the
    masked oracle and ops.flash_attention(mask=...)."""
    L = 64
    q, k, v, do = _inputs(H=heads[0], HK=heads[1], LQ=L, seed=3)
    js, ts = _spec_pair(kind, L, L)
    mask = jnp.asarray(jmc.dense_mask(js, L, L))
    want, _ = _jax_grads(lambda a, b, c: jref.attention_masked_ref(
        a, b, c, mask), q, k, v, do)
    lay = tmc.compile_layout(ts, L, L, 16, 16)
    got, _ = _port_grads(lambda a, b, c: fa.flash_attention_tiles(
        a, b, c, lay), q, k, v, do)
    _close_all(got, want)
    via_ops, _ = _jax_grads(lambda a, b, c: jops.flash_attention(
        a, b, c, mask=js), q, k, v, do)
    _close_all(got, via_ops)
    if kind == "deadrows":
        for g in got:
            assert np.isfinite(g).all()
        assert not got[0][:, :, 16:32].any() and not got[0][:, :, 40:48].any()


@pytest.mark.parametrize("kind", ["causal", "globals"])
def test_bwd_plain_matches_jax(kind):
    """flash_attention_tiles_bwd_plain called directly, on the forward's
    o and lse (softmax_lse of its state)."""
    L = 48
    q, k, v, do = _inputs(H=4, HK=2, LQ=L, seed=11)
    if kind == "causal":
        lay = tmc.causal_layout(L, L, 16, 8)
        fn = lambda a, b, c: jref.attention_ref(a, b, c, causal=True)
    else:
        js, ts = _spec_pair(kind, L, L)
        lay = tmc.compile_layout(ts, L, L, 16, 8)
        mask = jnp.asarray(jmc.dense_mask(js, L, L))
        fn = lambda a, b, c: jref.attention_masked_ref(a, b, c, mask)
    want, _ = _jax_grads(fn, q, k, v, do)
    tq, tk, tv, tdo = (torch.as_tensor(a) for a in (q, k, v, do))
    o, m, l = fa.flash_attention_tiles(tq, tk, tv, lay, return_state=True)
    got = fa.flash_attention_tiles_bwd_plain(tq, tk, tv, o,
                                             fa.softmax_lse(m, l), tdo, lay)
    _close_all([g.numpy() for g in got], want)


def test_empty_layout_has_zero_grads():
    """A layout with no live tile: o = 0, and every gradient is 0."""
    pat = np.zeros((4, 4), bool)
    lay = tmc.compile_layout(tmc.MaskSpec.from_block_mask(pat, 8), 32, 32,
                             8, 8)
    assert lay.ntiles == 0
    q, k, v, do = _inputs(LQ=32, seed=2)
    got, out = _port_grads(lambda a, b, c: fa.flash_attention_tiles(
        a, b, c, lay), q, k, v, do)
    assert not out.any() and not any(g.any() for g in got)


def test_state_has_no_backward():
    """(m, l) carry no gradient: a loss that uses them raises on backward
    rather than dropping their share."""
    q, k, v, _ = _inputs(LQ=32)
    leaves = [torch.as_tensor(a).requires_grad_() for a in (q, k, v)]
    o, m, l = fa.flash_attention(*leaves, causal=True, return_state=True)
    o.sum().backward(retain_graph=True)
    assert leaves[0].grad is not None
    with pytest.raises(NotImplementedError, match="state"):
        (o.sum() + m.sum()).backward()


def test_lens_with_grad_raises_and_no_grad_is_untouched():
    q, k, v, _ = _inputs(LQ=1, LK=32)
    kv_len = torch.tensor([5, 32], dtype=torch.int32)
    tq = torch.as_tensor(q).requires_grad_()
    with pytest.raises(NotImplementedError, match="no backward"):
        fa.flash_attention_lens(tq, torch.as_tensor(k), torch.as_tensor(v),
                                kv_len)
    with torch.no_grad():
        out = fa.flash_attention_lens(tq, torch.as_tensor(k),
                                      torch.as_tensor(v), kv_len)
    assert out.grad_fn is None


def test_no_grad_calls_skip_autograd():
    """Serving calls (no input requires grad) return plain tensors."""
    q, k, v, _ = _inputs(LQ=32)
    out = fa.flash_attention(*(torch.as_tensor(a) for a in (q, k, v)))
    assert out.grad_fn is None


@pytest.mark.parametrize("kind", ["causal", "globals", "deadrows"])
def test_column_walk_transposes_the_layout(kind):
    """Every walk entry once in its K tile's column, Q tiles ascending."""
    L = 64
    if kind == "causal":
        lay = tmc.causal_layout(L, 48, 16, 8)
    else:
        lay = tmc.compile_layout(_spec_pair(kind, L, L)[1], L, L, 16, 8)
    colp, colq, colt = fa.column_walk(lay)
    assert colp[0] == 0 and colp[-1] == lay.ntiles
    assert sorted(colt.tolist()) == list(range(lay.ntiles))
    rowp = np.asarray(lay.rowp)
    for c in range(lay.nk):
        ts = range(colp[c], colp[c + 1])
        assert all(lay.cols[colt[t]] == c for t in ts)
        assert all(rowp[colq[t]] <= colt[t] < rowp[colq[t] + 1] for t in ts)
        assert list(colq[colp[c]:colp[c + 1]]) == \
            sorted(colq[colp[c]:colp[c + 1]])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("lq,lk", [(40, 40), (24, 56), (56, 24)])
def test_grid_layout_is_the_dense_grids_mask(causal, lq, lk):
    lay = tmc.grid_layout(lq, lk, 16, 16, causal)
    want = (np.tril(np.ones((lq, lk), bool)) if causal
            else np.ones((lq, lk), bool))
    np.testing.assert_array_equal(lay.dense(), want)
    if not causal:
        assert lay.nfull == lay.ntiles == lay.nq * lay.nk
