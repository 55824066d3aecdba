"""The port's four kernel entry points (repro_torch.kernels.ops) against the
JAX package's (repro.kernels.ops in interpret mode, as tests/test_kernels.py
runs them), on the same numpy inputs, at the JAX suite's tolerances.

Tests marked ``cuda`` hold each CUDA kernel against its plain PyTorch
version on the card; they skip without one.  This module imports JAX only
inside fixtures, so the card tests collect where JAX is not installed:

    python -m pytest -m cuda tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import registry
from repro_torch.kernels import fft as fft_k
from repro_torch.kernels import matmul as mm_k
from repro_torch.kernels import ops
from repro_torch.kernels import spgemm as spgemm_k
from repro_torch.kernels import spmm as spmm_k
from repro_torch.kernels import spmv as spmv_k
from repro_torch.numerics.fft import split_stream_twiddles

@pytest.fixture
def jax_ops():
    """The JAX package's entry points and oracles, imported on use."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops, ref as jref

    return jnp, jops, jref


@pytest.fixture
def jax_spmm():
    """The JAX package's Pallas SpMM kernels, imported on use."""
    from repro.kernels import spmm as jspmm

    return jspmm


@pytest.fixture
def card():
    """The CUDA device; the test skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# parity with the JAX package (CPU)
# ---------------------------------------------------------------------------

MM_SHAPES = [(8, 8, 8), (96, 80, 112), (1, 7, 3), (130, 257, 129)]


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_jax(m, k, n, dtype, jax_ops):
    jnp, jops, _ = jax_ops
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    a, b = _randn(rng, (m, k)), _randn(rng, (k, n))
    with jops.backend("interpret"):
        want = jops.matmul(jnp.asarray(a, dtype), jnp.asarray(b, dtype))
    tdt = getattr(torch, dtype)
    got = ops.matmul(torch.as_tensor(a).to(tdt), torch.as_tensor(b).to(tdt))
    assert got.dtype == tdt
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol * 10)


@pytest.mark.parametrize("nrows,width", [(16, 4), (40, 9), (100, 17)])
def test_spmv_ell_matches_jax(nrows, width, jax_ops):
    jnp, jops, _ = jax_ops
    rng = np.random.default_rng(nrows * 31 + width)
    vals = _randn(rng, (nrows, width))
    cols = rng.integers(0, nrows, (nrows, width)).astype(np.int32)
    x = _randn(rng, nrows)
    with jops.backend("interpret"):
        want = jops.spmv_ell(jnp.asarray(vals), jnp.asarray(cols),
                             jnp.asarray(x))
    got = ops.spmv_ell(torch.as_tensor(vals), torch.as_tensor(cols),
                       torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,offsets", [(32, (0,)), (64, (-3, -1, 0, 1, 3)),
                                       (128, (-31, 0, 31))])
def test_spmv_dia_matches_jax(n, offsets, jax_ops):
    jnp, jops, _ = jax_ops
    rng = np.random.default_rng(n + len(offsets))
    diags = _randn(rng, (len(offsets), n))
    x = _randn(rng, n)
    with jops.backend("interpret"):
        want = jops.spmv_dia(jnp.asarray(diags), offsets, jnp.asarray(x))
    got = ops.spmv_dia(torch.as_tensor(diags), offsets, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("logn", [3, 6, 10])
def test_fft_matches_jax(logn, jax_ops):
    jnp, jops, _ = jax_ops
    n = 1 << logn
    rng = np.random.default_rng(logn)
    z = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    with jops.backend("interpret"):
        want = jops.fft(jnp.asarray(z))
    got = ops.fft(torch.as_tensor(z))
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-2, atol=1e-3 * n)
    np.testing.assert_allclose(got.numpy(), np.fft.fft(z),
                               rtol=1e-2, atol=1e-3 * n)


def test_fft_stage_plain_matches_jax_ref(jax_ops):
    """The plain stage (untiled table + m) equals the JAX oracle fed the
    tiled table the JAX stage loop builds."""
    jnp, _, jref = jax_ops
    rng = np.random.default_rng(7)
    half, m = 64, 8
    re, im = _randn(rng, (half, 2)), _randn(rng, (half, 2))
    twr, twi = _randn(rng, half), _randn(rng, half)
    want = jref.fft_stage_ref(jnp.asarray(re), jnp.asarray(im),
                              jnp.tile(jnp.asarray(twr[:m]), half // m),
                              jnp.tile(jnp.asarray(twi[:m]), half // m))
    got = fft_k.fft_stage(*map(torch.as_tensor, (re, im, twr, twi)), m)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def _stage_chain(re, im, twr, twi, s0, count):
    """Stages s0 .. s0 + count - 1, one fft_stage_plain call each."""
    n = re.shape[0]
    for s in range(s0, s0 + count):
        ore, oim = fft_k.fft_stage_plain(re.view(n // 2, 2),
                                         im.view(n // 2, 2), twr, twi,
                                         (n // 2) >> s)
        re, im = ore.reshape(n), oim.reshape(n)
    return re, im


def _fft_operands(logn, dtype=np.float32):
    rng = np.random.default_rng(logn)
    n = 1 << logn
    tw = split_stream_twiddles(n)
    return (torch.as_tensor(rng.standard_normal(n).astype(dtype)),
            torch.as_tensor(rng.standard_normal(n).astype(dtype)),
            torch.as_tensor(tw.real.astype(dtype)),
            torch.as_tensor(tw.imag.astype(dtype)))


#: (log2 n, first stage, stages): whole transforms, partial runs, a count
#: that does not divide log2 n, more stages than one pass takes, and n = 2.
STAGE_RUNS = [(1, 0, 1), (4, 0, 4), (6, 1, 5), (11, 0, 11), (13, 0, 13),
              (13, 3, 7), (12, 2, 10)]


@pytest.mark.parametrize("logn,s0,count", STAGE_RUNS)
def test_fft_stages_plain_equals_the_stage_chain(logn, s0, count):
    re, im, twr, twi = _fft_operands(logn)
    want = _stage_chain(re, im, twr, twi, s0, count)
    for got in (fft_k.fft_stages_plain(re, im, twr, twi, s0, count),
                fft_k.fft_stages(re, im, twr, twi, s0, count)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def _fused_passes_model(re, im, twr, twi, s0, count):
    """csrc/fft.cu's passes in numpy, CTA by CTA: pass sizes from
    pass_sizes; a CTA holds G = min(POINTS_PER_CTA, n) >> k groups and
    reads them as one contiguous block; the pair at local index c of local
    stage t takes the twiddle tw[(pos >> 1) % m] at global position pos;
    stages go two per round (the radix-4 unit at 4q .. 4q + 3 writes q,
    q + h/2, q + h, q + 3h/2), an odd last one alone; local point r of
    group g goes to g + r * n / 2^k, a run of G values per r."""
    n = re.size
    logn = n.bit_length() - 1
    m0 = (n // 2) >> s0

    def bfly(er, ei, orr, oi, w):
        xr, xi = er - orr, ei - oi
        return (er + orr, ei + oi, xr * twr[w] - xi * twi[w],
                xr * twi[w] + xi * twr[w])

    for k in fft_k.pass_sizes(count):
        ngroups = n >> k
        G = min(fft_k.POINTS_PER_CTA, n) >> k
        h = 1 << (k - 1)
        out_re, out_im = np.empty_like(re), np.empty_like(im)
        for g0 in range(0, ngroups, G):
            block = slice(g0 << k, (g0 + G) << k)
            lre = re[block].reshape(G, 1 << k)
            lim = im[block].reshape(G, 1 << k)
            g = g0 + np.arange(G)[:, None]

            def tw(t, c):
                sh = k - t
                pos = (((c >> sh) << (logn - t)) | (g << sh)
                       | (c & ((1 << sh) - 1)))
                w = (pos >> 1) % (m0 >> t)
                # the kernel drops the bits the modulus drops
                u = (g << (sh - 1)) + ((c & ((1 << sh) - 1)) >> 1)
                np.testing.assert_array_equal(u % (m0 >> t), w)
                return w

            t = 0
            while t + 1 < k:
                q = np.arange(h // 2)[None, :]
                x = [(lre[:, 4 * q[0] + e], lim[:, 4 * q[0] + e])
                     for e in range(4)]
                u0r, u0i, d0r, d0i = bfly(*x[0], *x[1], tw(t, 4 * q))
                u1r, u1i, d1r, d1i = bfly(*x[2], *x[3], tw(t, 4 * q + 2))
                a_r, a_i, c_r, c_i = bfly(u0r, u0i, u1r, u1i,
                                          tw(t + 1, 2 * q))
                b_r, b_i, e_r, e_i = bfly(d0r, d0i, d1r, d1i,
                                          tw(t + 1, 2 * q + h))
                lre, lim = np.empty_like(lre), np.empty_like(lim)
                for off, vr, vi in ((0, a_r, a_i), (h // 2, b_r, b_i),
                                    (h, c_r, c_i), (h + h // 2, e_r, e_i)):
                    lre[:, q[0] + off], lim[:, q[0] + off] = vr, vi
                t += 2
            if t < k:
                c = 2 * np.arange(h)[None, :]
                ur, ui, dr, di = bfly(lre[:, 0::2], lim[:, 0::2],
                                      lre[:, 1::2], lim[:, 1::2], tw(t, c))
                lre = np.concatenate([ur, dr], axis=1)
                lim = np.concatenate([ui, di], axis=1)
            dst = g + np.arange(1 << k)[None, :] * ngroups
            out_re[dst], out_im[dst] = lre, lim
        re, im = out_re, out_im
        m0 >>= k
    return re, im


@pytest.mark.parametrize("logn,s0,count", STAGE_RUNS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_pass_index_model_equals_the_stage_chain(logn, s0, count,
                                                       dtype):
    """The kernel's group read, position/twiddle formula and strided write
    (modelled in numpy with its pass sizes and CTA shape) give the stage
    chain bitwise."""
    ops_ = _fft_operands(logn, dtype)
    want = _stage_chain(*ops_, s0, count)
    got = _fused_passes_model(*(t.numpy() for t in ops_), s0, count)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_fft_pass_sizes():
    assert fft_k.pass_sizes(1) == [1]
    assert fft_k.pass_sizes(10) == [10]
    assert fft_k.pass_sizes(13) == [7, 6]
    assert fft_k.pass_sizes(20) == [10, 10]
    assert fft_k.pass_sizes(21) == [7, 7, 7]
    assert fft_k.pass_sizes(23) == [8, 8, 7]


def test_fft_stages_rejects_bad_ranges():
    re, im, twr, twi = _fft_operands(4)
    for s0, count in ((0, 0), (0, 5), (3, 2), (-1, 1)):
        with pytest.raises(ValueError, match="fft_stages"):
            fft_k.fft_stages(re, im, twr, twi, s0, count)
    with pytest.raises(ValueError, match="power of two"):
        fft_k.fft_stages(re[:12], im[:12], twr, twi, 0, 2)


def _bsr_operand(rng, nbrows, nbcols, bs, fill, empty_rows=()):
    """Random BSR arrays (numpy): live blocks at ``fill``, sorted columns,
    the block-rows in ``empty_rows`` left empty."""
    occ = rng.random((nbrows, nbcols)) < fill
    occ[list(empty_rows)] = False
    rows, cols = np.nonzero(occ)
    rowp = np.zeros(nbrows + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=nbrows), out=rowp[1:])
    vals = _randn(rng, (cols.size, bs, bs))
    return vals, cols.astype(np.int32), rowp


@pytest.mark.parametrize("nrows,width,k", [(16, 4, 1), (40, 9, 3),
                                           (100, 17, 65)])
def test_spmm_ell_matches_jax(nrows, width, k, jax_ops, jax_spmm):
    """The wrapper's host path against the JAX Pallas kernel (interpret
    mode, one block per axis) and the JAX oracle."""
    jnp, _, jref = jax_ops
    rng = np.random.default_rng(nrows + width + k)
    vals = _randn(rng, (nrows, width))
    cols = rng.integers(0, nrows, (nrows, width)).astype(np.int32)
    vals[::3, -1], cols[::3, -1] = 0.0, 0               # ELL padding
    x = _randn(rng, (nrows, k))
    want = jax_spmm.spmm_ell(jnp.asarray(vals), jnp.asarray(cols),
                             jnp.asarray(x), block_rows=nrows,
                             block_width=width, block_rhs=k, interpret=True)
    got = spmm_k.spmm_ell(*map(torch.as_tensor, (vals, cols, x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.spmm_ell_ref(*map(jnp.asarray,
                                                       (vals, cols, x)))),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("bs,k", [(8, 1), (8, 3), (16, 8), (32, 65)])
def test_spmm_bsr_matches_jax(bs, k, jax_ops, jax_spmm):
    jnp, _, jref = jax_ops
    rng = np.random.default_rng(bs * 100 + k)
    vals, cols, rowp = _bsr_operand(rng, 6, 5, bs, 0.4, empty_rows=(2,))
    x = _randn(rng, (5 * bs, k))
    args = (vals, cols, rowp, x)
    want = jax_spmm.spmm_bsr(*map(jnp.asarray, args), block_rhs=k,
                             interpret=True)
    got = spmm_k.spmm_bsr(*map(torch.as_tensor, args))
    assert got.shape == (6 * bs, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.spmm_bsr_ref(*map(jnp.asarray, args))),
        rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got.numpy()[2 * bs:3 * bs], 0.0)


def test_spmm_bsr_empty_matrix_gives_zeros(jax_ops):
    jnp, _, jref = jax_ops
    vals = np.zeros((0, 8, 8), np.float32)
    cols, rowp = np.zeros(0, np.int32), np.zeros(5, np.int32)
    x = np.ones((32, 3), np.float32)
    got = spmm_k.spmm_bsr(*map(torch.as_tensor, (vals, cols, rowp, x)))
    want = jref.spmm_bsr_ref(*map(jnp.asarray, (vals, cols, rowp, x)))
    assert got.shape == want.shape == (32, 3)
    np.testing.assert_array_equal(got.numpy(), 0.0)


@pytest.mark.parametrize("bs", [8, 16, 32])
def test_spgemm_bsr_plain_matches_jax_ref(bs, jax_ops):
    """The wrapper's host path (pairs enumerated in torch) against the
    dense JAX oracle's live tiles.  The JAX Pallas kernel cannot run on
    this jax (``pl.store``), so the oracle is ``ref.spgemm_bsr_ref``."""
    from repro import sparse as JS

    jnp, _, jref = jax_ops
    rng = np.random.default_rng(bs)
    nb = 6
    av, ac, ar = _bsr_operand(rng, nb, nb, bs, 0.4, empty_rows=(1,))
    bv, bc, br = _bsr_operand(rng, nb, nb, bs, 0.4, empty_rows=(3,))
    shape = (nb * bs, nb * bs)
    ja = JS.BSR(jnp.asarray(av), jnp.asarray(ac), jnp.asarray(ar), shape, bs)
    jb = JS.BSR(jnp.asarray(bv), jnp.asarray(bc), jnp.asarray(br), shape, bs)
    plan = JS.spgemm_symbolic(ja, jb)
    got = spgemm_k.spgemm_bsr(
        *map(torch.as_tensor, (av, ac, ar, bv, bc, br, plan.c_cols,
                               plan.c_rowp)), ncols=shape[1])
    dense = np.asarray(jref.spgemm_bsr_ref(
        *map(jnp.asarray, (av, ac, ar, bv, bc, br)), a_shape=shape,
        b_shape=shape))
    tiles = dense.reshape(nb, bs, nb, bs).transpose(0, 2, 1, 3)
    brows = np.repeat(np.arange(nb), np.diff(plan.c_rowp))
    np.testing.assert_allclose(got.numpy(), tiles[brows, plan.c_cols],
                               rtol=1e-5, atol=1e-4)


def _spgemm_args_missing_a_tile(dev):
    """spgemm_bsr's arguments for a random A @ B at bs 8, with one tile
    that a product reaches taken out of the output pattern."""
    from repro_torch import sparse

    rng = np.random.default_rng(21)
    nb, bs = 6, 8
    a, b = (sparse.BSR(*(torch.as_tensor(v, device=dev) for v in
                         _bsr_operand(rng, nb, nb, bs, 0.5)),
                       (nb * bs, nb * bs), bs) for _ in range(2))
    plan = sparse.spgemm_symbolic(a, b)
    c_rowp = plan.c_rowp.copy()
    c_rowp[1:] -= 1                      # drop block-row 0's last tile
    c_cols = np.delete(plan.c_cols, plan.c_rowp[1] - 1)
    assert plan.c_rowp[1] > 0
    return ((a.values, a.cols, a.rowp, b.values, b.cols, b.rowp,
             torch.as_tensor(c_cols, device=dev),
             torch.as_tensor(c_rowp, device=dev)), nb * bs)


def test_spgemm_bsr_plain_raises_on_a_tile_missing_from_the_plan():
    args, ncols = _spgemm_args_missing_a_tile("cpu")
    with pytest.raises(ValueError, match="not in c_cols"):
        spgemm_k.spgemm_bsr(*args, ncols=ncols)


def test_non_power_of_two_fft_has_no_variant():
    with pytest.raises(LookupError):
        ops.fft(torch.zeros(12, dtype=torch.complex64))


def test_host_operands_select_torch_plane():
    a = torch.ones(4, 4)
    for op, args in (("matmul", (a, a)), ("fft", (torch.ones(8, dtype=torch.complex64),))):
        assert registry.select(op, *args).plane == "torch"
    assert registry.resolve_backend(a) == "torch"


def test_cuda_plane_on_host_operands_raises():
    a = torch.ones(4, 4)
    before = mm_k.matmul.launches
    with ops.backend("cuda"), pytest.raises(RuntimeError, match="host"):
        ops.matmul(a, a)
    with pytest.raises(RuntimeError, match="host"):
        registry.dispatch("matmul", a, a, variant="cuda")
    assert mm_k.matmul.launches == before


# ---------------------------------------------------------------------------
# CUDA kernels against their plain versions (card only)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1024, 1024, 1024), (130, 257, 129),
                                   (1, 7, 3), (64, 0, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_kernel_matches_plain(m, k, n, dtype, card):
    g = torch.Generator(device=card).manual_seed(m + k + n)
    a = torch.randn(m, k, device=card, generator=g).to(dtype)
    b = torch.randn(k, n, device=card, generator=g).to(dtype)
    before = mm_k.matmul.launches
    got = mm_k.matmul(a, b)
    want = mm_k.matmul_plain(a, b)
    torch.cuda.synchronize()
    assert mm_k.matmul.launches == before + 1
    # f32: IEEE FMA, sums in another order (bar 2e-5 relative); bf16 output
    # rounds to 8 bits.
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * 10 * max(1.0, (k / 128) ** 0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("n,fill", [(10240, 5.72), (100, 3.5), (37, 20.0)])
def test_spmv_ell_kernel_matches_plain(n, fill, card):
    from repro_torch.numerics import sparse

    a = sparse.random_sparse(n, fill, seed=n)
    ell = sparse.ell_from_csr(sparse.csr_from_dense(a, device=card))
    x = torch.randn(n, device=card)
    got = spmv_k.spmv_ell(ell.values, ell.cols, x)
    want = spmv_k.spmv_ell_plain(ell.values, ell.cols, x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,bw", [(1024, 511), (100, 3), (33, 32)])
def test_spmv_dia_kernel_matches_plain(n, bw, card):
    from repro_torch.numerics import sparse

    dia = sparse.dia_from_dense(sparse.banded_spd(n, bw, seed=n),
                                device=card)
    x = torch.randn(n, device=card)
    got = spmv_k.spmv_dia(dia.diags, dia.offsets, x)
    want = spmv_k.spmv_dia_plain(dia.diags, dia.offsets, x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("logn", [20, 13, 10, 1])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_fft_kernel_matches_plain(logn, dtype, card):
    n = 1 << logn
    g = torch.Generator(device=card).manual_seed(logn)
    z = torch.randn(n, dtype=dtype, device=card, generator=g)
    before = fft_k.fft_stages.launches
    got = ops.fft(z)
    # one wrapper call, one launch per pass (2^20: two passes of 10)
    assert fft_k.fft_stages.launches == before + len(fft_k.pass_sizes(logn))
    with ops.backend("torch"):
        plain = ops.fft(z)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    # The kernel fuses the twiddle multiply-add (FMA), the plain version
    # rounds twice: per stage that differs by a few ulps of |x|, which grows
    # like sqrt(n), over log2 n stages.
    eps = torch.finfo(got.real.dtype).eps
    torch.testing.assert_close(got, plain, rtol=1e-5,
                               atol=4 * eps * n ** 0.5 * logn)
    torch.testing.assert_close(got, torch.fft.fft(z), rtol=1e-2,
                               atol=1e-3 * n)


@pytest.mark.cuda
def test_cuda_operands_select_cuda_plane(card):
    a = torch.ones(4, 4, device=card)
    assert registry.select("matmul", a, a).plane == "cuda"
    with ops.backend("torch"):
        assert registry.select("matmul", a, a).plane == "torch"
    from repro_torch.core import bind
    assert bind(np.ones(3)).device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("n,fill,k", [(10240, 5.72, 64), (100, 3.5, 1),
                                      (37, 20.0, 3), (37, 20.0, 65)])
def test_spmm_ell_kernel_matches_plain(n, fill, k, card):
    from repro_torch.numerics import sparse

    a = sparse.random_sparse(n, fill, seed=n)
    ell = sparse.ell_from_csr(sparse.csr_from_dense(a, device=card))
    g = torch.Generator(device=card).manual_seed(k)
    x = torch.randn(n, k, device=card, generator=g)
    before = spmm_k.spmm_ell.launches
    got = spmm_k.spmm_ell(ell.values, ell.cols, x)
    want = spmm_k.spmm_ell_plain(ell.values, ell.cols, x)
    torch.cuda.synchronize()
    assert spmm_k.spmm_ell.launches == before + 1
    # f32 sums in another order (FMA chain per thread vs einsum)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("k", [1, 3, 65])
def test_spmm_bsr_kernel_matches_plain(bs, k, card):
    rng = np.random.default_rng(bs * 1000 + k)
    vals, cols, rowp = _bsr_operand(rng, 40, 30, bs, 0.2,
                                    empty_rows=(0, 17, 39))
    vals, cols, rowp = (torch.as_tensor(v, device=card)
                        for v in (vals, cols, rowp))
    x = torch.as_tensor(_randn(rng, (30 * bs, k)), device=card)
    before = spmm_k.spmm_bsr.launches
    got = spmm_k.spmm_bsr(vals, cols, rowp, x)
    want = spmm_k.spmm_bsr_plain(vals, cols, rowp, x)
    torch.cuda.synchronize()
    assert spmm_k.spmm_bsr.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert not got[17 * bs:18 * bs].any()           # an empty block-row


@pytest.mark.cuda
def test_spmm_bsr_no_blocks_gives_zeros_without_launch(card):
    vals = torch.zeros((0, 8, 8), device=card)
    cols = torch.zeros(0, dtype=torch.int32, device=card)
    rowp = torch.zeros(5, dtype=torch.int32, device=card)
    before = spmm_k.spmm_bsr.launches
    y = spmm_k.spmm_bsr(vals, cols, rowp, torch.ones(32, 3, device=card))
    assert y.shape == (32, 3) and not y.any()
    assert spmm_k.spmm_bsr.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [8, 16, 32])
def test_spgemm_bsr_kernel_matches_plain(bs, card):
    from repro_torch import sparse

    rng = np.random.default_rng(bs)
    nb = 24
    shape = (nb * bs, nb * bs)
    a, b = (sparse.BSR(*(torch.as_tensor(v, device=card) for v in
                         _bsr_operand(rng, nb, nb, bs, 0.3,
                                      empty_rows=(3, 11))), shape, bs)
            for _ in range(2))
    plan = sparse.spgemm_symbolic(a, b)
    args = (a.values, a.cols, a.rowp, b.values, b.cols, b.rowp,
            torch.as_tensor(plan.c_cols, device=card),
            torch.as_tensor(plan.c_rowp, device=card))
    before = spgemm_k.spgemm_bsr.launches
    got = spgemm_k.spgemm_bsr(*args, ncols=shape[1])
    want = spgemm_k.spgemm_bsr_plain(*args, ncols=shape[1])
    torch.cuda.synchronize()
    assert spgemm_k.spgemm_bsr.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_spgemm_bsr_no_pairs_gives_zeros(card):
    """A's only live block-column meets an empty block-row of B: the plan
    has no pairs and no output tiles, and nothing launches."""
    from repro_torch import sparse

    a_np = np.zeros((32, 32), np.float32)
    a_np[:8, :8] = 1.0
    b_np = np.zeros((32, 32), np.float32)
    b_np[8:16, :8] = 1.0
    a = sparse.bsr_from_dense(a_np, device=card)
    b = sparse.bsr_from_dense(b_np, device=card)
    before = spgemm_k.spgemm_bsr.launches
    c = sparse.spgemm(a, b)
    assert c.nblocks == 0 and c.device.type == "cuda"
    assert spgemm_k.spgemm_bsr.launches == before
    np.testing.assert_array_equal(c.todense(), np.zeros((32, 32)))


@pytest.mark.cuda
def test_spgemm_bsr_kernel_raises_on_a_tile_missing_from_the_plan(card):
    args, ncols = _spgemm_args_missing_a_tile(card)
    before = spgemm_k.spgemm_bsr.launches
    with pytest.raises(ValueError, match="not in c_cols"):
        spgemm_k.spgemm_bsr(*args, ncols=ncols)
    assert spgemm_k.spgemm_bsr.launches == before + 1


@pytest.mark.cuda
def test_sparse_ops_select_the_kernels(card):
    from repro_torch import sparse

    a = np.zeros((64, 64), np.float32)
    a[:16, 16:32] = 1.0
    x = torch.ones(64, 4, device=card)
    for fmt, name in (("bsr", "bsr"), ("ell", "ell")):
        m = sparse.matrix(a, format=fmt, device=card)
        assert registry.select("spmm", m, x).name == name
    m = sparse.matrix(a, format="bsr", device=card)
    assert registry.select("spgemm", m, m).name == "bsr"


# ---------------------------------------------------------------------------
# the attention kernels against their plain versions (card only)
# ---------------------------------------------------------------------------

from repro_torch.kernels import flash_attention as fa_k  # noqa: E402
from repro_torch.sparse.maskcompiler import (MaskSpec,  # noqa: E402
                                             causal_layout, compile_layout)

#: f32: the kernel sums q.k serially over d and the plain version through
#: a BLAS product, a few ulps apart.  bf16: P is rounded to bf16 before
#: P.V in both, and a rounding that flips by one ulp moves o by about
#: 2^-8 * p * |v| / l; with |v| ~ 0.1 that is under 1e-3, the JAX bar.
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}


def _attn_inputs(card, dtype, b=2, hq=4, hkv=2, lq=64, lk=64, d=64,
                 seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn(b, hq, lq, d, device=card, generator=g).to(dtype)
    k = torch.randn(b, hkv, lk, d, device=card, generator=g).to(dtype)
    v = (0.1 * torch.randn(b, hkv, lk, d, device=card, generator=g)).to(
        dtype)
    return q, k, v


def _close(got, want, tol, what, rows=None):
    got, want = got.float(), want.float()
    if rows is not None:
        got, want = got[rows], want[rows]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol,
                               msg=lambda m: f"{what}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hq,hkv,d,lq,lk,bk",
                         [(4, 4, 32, 64, 64, 16), (4, 2, 64, 100, 100, 100),
                          (4, 2, 128, 256, 256, 128), (2, 1, 128, 48, 96, 32),
                          (4, 2, 64, 77, 77, 32)])
def test_flash_attention_kernel_matches_plain(dtype, causal, hq, hkv, d, lq,
                                              lk, bk, card):
    q, k, v = _attn_inputs(card, dtype, hq=hq, hkv=hkv, lq=lq, lk=lk, d=d)
    before = fa_k.flash_attention.launches
    got = fa_k.flash_attention(q, k, v, causal=causal, block_k=bk,
                               row_extents=False, return_state=True)
    assert fa_k.flash_attention.launches == before + 1
    want = fa_k.flash_attention_plain(q, k, v, causal=causal, block_k=bk,
                                      return_state=True)
    for g, w, what in zip(got, want, "oml"):
        _close(g, w, ATTN_TOL[dtype] * (lk if what == "l" else 1), what)
    o = fa_k.flash_attention(q, k, v, causal=causal, block_k=bk,
                             row_extents=False)
    assert torch.equal(o, got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lk,bk,causal", [(1, 2048, 128, False),
                                             (1, 96, 96, False),
                                             (32, 256, 128, False),
                                             (64, 64, 16, True),
                                             (1, 1000, 128, False)])
def test_flash_attention_lens_kernel_matches_plain(dtype, lq, lk, bk, causal,
                                                   card):
    b = 5
    q, k, v = _attn_inputs(card, dtype, b=b, hq=4, hkv=2, lq=lq, lk=lk,
                           d=128)
    kv_len = torch.tensor([0, lk, 1, lk // 2 + 3, lk - 1],
                          dtype=torch.int32, device=card)
    before = fa_k.flash_attention_lens.launches
    got = fa_k.flash_attention_lens(q, k, v, kv_len, causal=causal,
                                    block_k=bk, return_state=True)
    assert fa_k.flash_attention_lens.launches == before + 1
    want = fa_k.flash_attention_plain(q, k, v, causal=causal, block_k=bk,
                                      kv_len=kv_len, return_state=True)
    live = kv_len > 0                   # rows with a live key
    assert torch.all(got[1][~live] == fa_k.NEG_INF)
    _close(got[0], want[0], ATTN_TOL[dtype], "o", live)
    _close(got[1], want[1], ATTN_TOL[dtype], "m", live)
    _close(got[2], want[2], ATTN_TOL[dtype] * lk, "l", live)


_TILE_SPECS = {
    "causal": lambda lq, lk: MaskSpec(causal=True),
    "window": lambda lq, lk: MaskSpec(causal=True, window=lq // 4),
    "bidir_window": lambda lq, lk: MaskSpec(window=lq // 3),
    "globals": lambda lq, lk: MaskSpec(causal=True, window=lq // 4,
                                       global_tokens=(0, 1, lk // 2)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spec", sorted(_TILE_SPECS))
@pytest.mark.parametrize("hkv", [4, 2])
@pytest.mark.parametrize("lq,lk,bq,bk", [(128, 128, 32, 32),
                                         (64, 192, 64, 16),
                                         (77, 77, 32, 32), (37, 101, 16, 32)])
def test_flash_attention_tiles_kernel_matches_plain(dtype, spec, hkv, lq, lk,
                                                    bq, bk, card):
    q, k, v = _attn_inputs(card, dtype, hq=4, hkv=hkv, lq=lq, lk=lk, d=64)
    layout = compile_layout(_TILE_SPECS[spec](lq, lk), lq, lk, bq, bk)
    before = fa_k.flash_attention_tiles.launches
    got = fa_k.flash_attention_tiles(q, k, v, layout, return_state=True)
    assert fa_k.flash_attention_tiles.launches == before + 1
    want = fa_k.flash_attention_tiles_plain(q, k, v, layout,
                                            return_state=True)
    for g, w, what in zip(got, want, "oml"):
        _close(g, w, ATTN_TOL[dtype] * (lk if what == "l" else 1), what)


@pytest.mark.cuda
def test_flash_attention_tiles_dead_rows_and_empty_layout(card):
    q, k, v = _attn_inputs(card, torch.float32, lq=64, lk=64, d=32)
    pat = np.zeros((4, 4), bool)
    pat[0] = True                       # Q tiles 1-3 attend to nothing
    lay = compile_layout(MaskSpec.from_block_mask(pat, 16), 64, 64, 16, 16)
    o, m, l = fa_k.flash_attention_tiles(q, k, v, lay, return_state=True)
    assert torch.all(o[:, :, 16:] == 0) and torch.all(l[:, :, 16:] == 0)
    assert torch.all(m[:, :, 16:] == fa_k.NEG_INF)
    want = fa_k.flash_attention_tiles_plain(q, k, v, lay)
    _close(o, want, 1e-5, "o")
    empty = compile_layout(MaskSpec.from_block_mask(np.zeros((4, 4), bool),
                                                    16), 64, 64, 16, 16)
    before = fa_k.flash_attention_tiles.launches
    o, m, l = fa_k.flash_attention_tiles(q, k, v, empty, return_state=True)
    assert fa_k.flash_attention_tiles.launches == before
    assert not o.any() and not l.any() and torch.all(m == fa_k.NEG_INF)


@pytest.mark.cuda
@pytest.mark.parametrize("lq,bq,bk,d", [(128, 32, 32, 64), (512, 128, 128, 128),
                                        (96, 48, 32, 32), (77, 32, 32, 64),
                                        (1021, 128, 128, 128)])
def test_tiles_kernel_bitwise_equals_dense_causal_f32(lq, bq, bk, d, card):
    q, k, v = _attn_inputs(card, torch.float32, hq=4, hkv=2, lq=lq, lk=lq,
                           d=d)
    tiles = fa_k.flash_attention_tiles(q, k, v,
                                       causal_layout(lq, lq, bq, bk),
                                       return_state=True)
    dense = fa_k.flash_attention(q, k, v, causal=True, block_q=bq,
                                 block_k=bk, row_extents=False,
                                 return_state=True)
    for t, g in zip(tiles, dense):
        assert torch.equal(t, g)


@pytest.mark.cuda
@pytest.mark.parametrize("b,L", [(4, 512), (1, 1021), (1, 128), (1, 9)])
def test_tiles_kernel_bf16_at_the_serve_shapes(b, L, card):
    """The tensor-core kernel at qwen3-1.7b's heads (16/8, d = 128) on the
    serve path's causal walks, with state: the Engine's prefill (B = 4,
    L = 512, 128 x 128 tiles), a prime prompt (short last Q and K tiles),
    a ContinuousEngine chunk's own keys (128 x 128) and a short last chunk
    (one 9 x 9 tile, padded to 16 keys)."""
    q, k, v = _attn_inputs(card, torch.bfloat16, b=b, hq=16, hkv=8, lq=L,
                           lk=L, d=128)
    bq = min(128, L)
    layout = causal_layout(L, L, bq, bq)
    before = fa_k.flash_attention_tiles.launches
    got = fa_k.flash_attention_tiles(q, k, v, layout, return_state=True)
    assert fa_k.flash_attention_tiles.launches == before + 1
    want = fa_k.flash_attention_tiles_plain(q, k, v, layout,
                                            return_state=True)
    for g, w, what in zip(got, want, "oml"):
        _close(g, w, ATTN_TOL[torch.bfloat16] * (L if what == "l" else 1),
               what)
    assert torch.equal(fa_k.flash_attention_tiles(q, k, v, layout), got[0])


@pytest.mark.cuda
def test_tiles_kernel_bf16_dead_rows(card):
    """Q tiles with no live K tile: o = 0, m = NEG_INF, l = 0 in bf16."""
    q, k, v = _attn_inputs(card, torch.bfloat16, lq=64, lk=64, d=32)
    pat = np.zeros((4, 4), bool)
    pat[0] = True                       # Q tiles 1-3 attend to nothing
    lay = compile_layout(MaskSpec.from_block_mask(pat, 16), 64, 64, 16, 16)
    o, m, l = fa_k.flash_attention_tiles(q, k, v, lay, return_state=True)
    assert torch.all(o[:, :, 16:] == 0) and torch.all(l[:, :, 16:] == 0)
    assert torch.all(m[:, :, 16:] == fa_k.NEG_INF)
    want = fa_k.flash_attention_tiles_plain(q, k, v, lay, return_state=True)
    for g, w, what in zip((o, m, l), want, "oml"):
        _close(g, w, ATTN_TOL[torch.bfloat16] * (64 if what == "l" else 1),
               what)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_at_a_prime_length_and_full_width(dtype, causal, card):
    """qwen3-1.7b's heads (16/8, d = 128) at a prime prompt length: the
    op keeps 128-key tiles and the kernels run a short last tile."""
    L = 1021
    q, k, v = _attn_inputs(card, dtype, b=1, hq=16, hkv=8, lq=L, lk=L,
                           d=128)
    assert registry.select("flash_attention", q, k, v,
                           causal=causal).name == "cuda"
    wrapper = fa_k.flash_attention_tiles if causal else fa_k.flash_attention
    before = wrapper.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    assert wrapper.launches == before + 1
    if causal:
        want = fa_k.flash_attention_tiles_plain(
            q, k, v, causal_layout(L, L, 128, 128))
    else:
        want = fa_k.flash_attention_plain(q, k, v, causal=False)
    _close(got, want, ATTN_TOL[dtype], "o")
    with ops.backend("torch"):
        _close(got, ops.flash_attention(q, k, v, causal=causal),
               ATTN_TOL[dtype], "o against the torch plane")
    kv_len = torch.tensor([L - 5], dtype=torch.int32, device=card)
    got = fa_k.flash_attention_lens(q[:, :, -1:], k, v, kv_len,
                                    return_state=True)
    want = fa_k.flash_attention_plain(q[:, :, -1:], k, v, causal=False,
                                      kv_len=kv_len, return_state=True)
    for g, w, what in zip(got, want, "oml"):
        _close(g, w, ATTN_TOL[dtype] * (L if what == "l" else 1), what)


@pytest.mark.cuda
def test_attention_ops_on_the_card_match_the_torch_plane(card):
    """paged_attention and chunk_attention('merge') through the kernels
    against the same ops pinned to the torch plane, on the same tensors."""
    g = torch.Generator(device=card).manual_seed(3)
    P, hk, ps, d, B, n = 17, 2, 16, 64, 3, 4
    kp = torch.randn(P, hk, ps, d, device=card, generator=g)
    vp = torch.randn(P, hk, ps, d, device=card, generator=g)
    table = torch.tensor([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0]],
                         dtype=torch.int32, device=card)
    lens = torch.tensor([40, 17, 0], dtype=torch.int32, device=card)
    q = torch.randn(B, 4, 1, d, device=card, generator=g)
    got = ops.paged_attention(q, kp, vp, table, lens)
    with ops.backend("torch"):
        want = ops.paged_attention(q, kp, vp, table, lens)
    _close(got, want, 1e-5, "paged", lens > 0)
    qc = torch.randn(1, 4, 16, d, device=card, generator=g)
    kc = torch.randn(1, hk, 16, d, device=card, generator=g)
    vc = torch.randn(1, hk, 16, d, device=card, generator=g)
    kpre, vpre = ops.page_gather(kp, table[:1]), ops.page_gather(vp, table[:1])
    plen = torch.tensor([24], dtype=torch.int32, device=card)
    got = ops.chunk_attention(qc, kpre, vpre, plen, kc, vc, variant="merge")
    want = ops.chunk_attention(qc, kpre, vpre, plen, kc, vc, variant="oracle")
    _close(got, want, 1e-5, "chunk")


def test_cuda_plane_on_host_attention_operands_raises():
    q = torch.zeros(1, 2, 4, 32)
    k = torch.zeros(1, 1, 4, 32)
    with ops.backend("cuda"):
        with pytest.raises(RuntimeError, match="host"):
            ops.flash_attention(q, k, k)
    with pytest.raises(RuntimeError, match="host"):
        ops.flash_attention_state(q, k, k, variant="cuda")
