"""The port's four kernel entry points (repro_torch.kernels.ops) against the
JAX package's (repro.kernels.ops in interpret mode, as tests/test_kernels.py
runs them), on the same numpy inputs, at the JAX suite's tolerances.

Tests marked ``cuda`` hold each CUDA kernel against its plain PyTorch
version on the card; they skip without one.  This module imports JAX only
inside fixtures, so the card tests collect where JAX is not installed:

    python -m pytest -m cuda tests/test_torch_kernels.py
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import registry, settings
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


def _band_offsets(n, ndiags):
    """``ndiags`` consecutive offsets about the main diagonal, ``|o| < n``."""
    lo = -(ndiags // 2)
    return tuple(range(lo, lo + ndiags))


#: Diagonal counts from 1 to 1023, around each change of the partition
#: (lanes per row group 1/2/4/8, chunk sizes).
DIA_COUNTS = (1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65,
              127, 128, 129, 255, 256, 257, 511, 512, 1000, 1022, 1023)


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("n", [1, 33, 1024, 1000003])
def test_dia_partition_covers_each_stored_entry_once(n, sms):
    """Tiles partition the rows and chunks the diagonals; each diagonal's
    live rows, cut by the tiles, add up to its stored nonzeros once."""
    for ndiags in (k for k in DIA_COUNTS if k <= 2 * n - 1):
        part = spmv_k.dia_partition(n, ndiags, sms)
        assert part.dw in (1, 2, 4, 8) and part.dw * part.rows == 1024
        assert 1 <= part.nchunks <= 65535
        tiles = np.array(part.tiles(n))
        chunks = np.array(part.chunks(ndiags))
        assert len(tiles) == part.ntiles and len(chunks) == part.nchunks
        for cuts, total in ((tiles, n), (chunks, ndiags)):
            assert cuts[0, 0] == 0 and cuts[-1, 1] == total
            np.testing.assert_array_equal(cuts[1:, 0], cuts[:-1, 1])
            assert np.all(cuts[:, 1] > cuts[:, 0])        # none empty
        offsets = np.array(_band_offsets(n, ndiags))
        for b0 in range(0, ndiags, 64):
            o = offsets[b0:b0 + 64, None]
            lo, hi = spmv_k.dia_live_rows(n, o, tiles[None, :, 0],
                                          tiles[None, :, 1])
            lo, hi = np.broadcast_arrays(lo, hi)
            live = np.maximum(hi - lo, 0)
            assert np.all((lo >= tiles[None, :, 0]) | (live == 0))
            assert np.all((hi <= tiles[None, :, 1]) | (live == 0))
            np.testing.assert_array_equal(live.sum(axis=1),
                                          n - np.abs(o[:, 0]))


def test_dia_partition_sizes_the_grid_by_shape():
    """A tridiagonal system at large n runs many row tiles and one chunk;
    the CG conf-18 band few row tiles and many chunks (hundreds of warps)."""
    tri = spmv_k.dia_partition(1 << 20, 3, 132)
    assert (tri.dw, tri.nchunks) == (1, 1) and tri.ntiles == 1024
    band = spmv_k.dia_partition(1024, 1023, 132)
    assert band.dw == 8 and band.ntiles == 8 and band.nchunks >= 16
    assert band.ntiles * band.nchunks * 8 >= 500          # warps
    assert spmv_k.dia_window(band, _band_offsets(1024, 1023)) \
        == band.rows + band.per_chunk - 1
    wide = spmv_k.dia_partition(40000, 3, 132)
    assert spmv_k.dia_window(wide, (-30000, 0, 30000)) == 0


def _dia_kernel_model(diags, offsets, x, part):
    """csrc/spmv.cu's sums in numpy (f32): per (tile, chunk), lane q of a
    row group adds the chunk's diagonals q, q + dw, ... into 4 accumulators
    in turn, summed (a0 + a1) + (a2 + a3); the lanes' sums add in order q =
    0, 1, ...; with several chunks, lane q adds chunks q, q + dw, ... and
    the lanes' sums add in order again.  Reads outside a diagonal's live
    rows, and of x outside [0, n), are skipped (they hold or give 0)."""
    n = x.size
    y = np.zeros(n, np.float32)

    def in_lanes(terms):
        lanes = [terms[q::part.dw] for q in range(part.dw)]
        return lanes

    for r0, r1 in part.tiles(n):
        partials = []
        for d0, d1 in part.chunks(len(offsets)):
            sums = []
            for lane in in_lanes(list(range(d0, d1))):
                acc = np.zeros((4, r1 - r0), np.float32)
                for u, d in enumerate(lane):
                    lo, hi = spmv_k.dia_live_rows(n, offsets[d], r0, r1)
                    if hi > lo:
                        acc[u % 4, lo - r0:hi - r0] += (
                            diags[d, lo:hi] * x[lo + offsets[d]:
                                                hi + offsets[d]])
                sums.append((acc[0] + acc[1]) + (acc[2] + acc[3]))
            partials.append(functools.reduce(np.add, sums))
        if len(partials) == 1:
            y[r0:r1] = partials[0]
            continue
        sums = [functools.reduce(np.add, lane,
                                 np.zeros(r1 - r0, np.float32))
                for lane in in_lanes(partials)]
        y[r0:r1] = functools.reduce(np.add, sums)
    return y


@pytest.mark.parametrize("n,offsets,sms", [
    (1024, _band_offsets(1024, 1023), 132),    # CG conf 18
    (33, _band_offsets(33, 65), 132), (1030, _band_offsets(1030, 64), 132),
    (1000, (-100, -1, 0, 1, 100), 132), (100, (-1, 0, 1), 1),
    (4096, (7,), 132), (2048, _band_offsets(2048, 129), 1)])
def test_dia_kernel_model_matches_plain(n, offsets, sms):
    rng = np.random.default_rng(n + len(offsets))
    diags = _randn(rng, (len(offsets), n))
    for d, o in enumerate(offsets):     # zeros outside the live rows
        lo, hi = spmv_k.dia_live_rows(n, o, 0, n)
        diags[d, :lo], diags[d, hi:] = 0.0, 0.0
    x = _randn(rng, n)
    part = spmv_k.dia_partition(n, len(offsets), sms)
    got = _dia_kernel_model(diags, offsets, x, part)
    # the plain version in f64 on the same values: the bar measures the
    # model's own f32 rounding, not the plain version's serial sum's
    want = spmv_k.spmv_dia_plain(torch.as_tensor(diags, dtype=torch.float64),
                                 offsets,
                                 torch.as_tensor(x, dtype=torch.float64))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5)


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


#: Block edges off the selector's 8/16/32 ladder: edges the CUDA kernels
#: run as they are (1..64), with a block grid that keeps n <= 256, and one
#: above 64 that the wrappers re-cut on the card.
EDGE_GRIDS = [(1, 6, 5), (4, 6, 5), (12, 6, 5), (64, 4, 3), (96, 3, 2)]


@pytest.mark.parametrize("bs,nbr,nbc", EDGE_GRIDS)
def test_spmm_bsr_block_edges_match_jax(bs, nbr, nbc, jax_ops, jax_spmm):
    """The wrapper's host path at block edges 1, 4, 12, 64 and 96 against
    the JAX Pallas kernel (interpret mode) and the JAX oracle."""
    jnp, _, jref = jax_ops
    rng = np.random.default_rng(bs + 7)
    vals, cols, rowp = _bsr_operand(rng, nbr, nbc, bs, 0.5, empty_rows=(1,))
    x = _randn(rng, (nbc * bs, 5))
    args = (vals, cols, rowp, x)
    want = jax_spmm.spmm_bsr(*map(jnp.asarray, args), block_rhs=5,
                             interpret=True)
    got = spmm_k.spmm_bsr(*map(torch.as_tensor, args))
    assert got.shape == (nbr * bs, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.spmm_bsr_ref(*map(jnp.asarray, args))),
        rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got.numpy()[bs:2 * bs], 0.0)


@pytest.mark.parametrize("bs,nb", [(1, 40), (4, 16), (12, 8), (64, 4),
                                   (96, 3)])
def test_spgemm_bsr_block_edges_match_jax(bs, nb, jax_ops):
    """The wrapper's host path at block edges 1, 4, 12, 64 and 96 against
    the JAX package's ``bsr_xla`` SpGEMM and its dense oracle."""
    from repro import sparse as JS

    jnp, _, jref = jax_ops
    rng = np.random.default_rng(bs + 3)
    av, ac, ar = _bsr_operand(rng, nb, nb, bs, 0.4, empty_rows=(1,))
    bv, bc, br = _bsr_operand(rng, nb, nb, bs, 0.4, empty_rows=(2,))
    shape = (nb * bs, nb * bs)
    ja = JS.BSR(jnp.asarray(av), jnp.asarray(ac), jnp.asarray(ar), shape, bs)
    jb = JS.BSR(jnp.asarray(bv), jnp.asarray(bc), jnp.asarray(br), shape, bs)
    plan = JS.spgemm_symbolic(ja, jb)
    got = spgemm_k.spgemm_bsr(
        *map(torch.as_tensor, (av, ac, ar, bv, bc, br, plan.c_cols,
                               plan.c_rowp)), ncols=shape[1])
    want = JS.spgemm(ja, jb, variant="bsr_xla")
    np.testing.assert_array_equal(np.asarray(want.cols), plan.c_cols)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.values),
                               rtol=1e-5, atol=1e-4)
    dense = np.asarray(jref.spgemm_bsr_ref(
        *map(jnp.asarray, (av, ac, ar, bv, bc, br)), a_shape=shape,
        b_shape=shape))
    tiles = dense.reshape(nb, bs, nb, bs).transpose(0, 2, 1, 3)
    brows = np.repeat(np.arange(nb), np.diff(plan.c_rowp))
    np.testing.assert_allclose(got.numpy(), tiles[brows, plan.c_cols],
                               rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# the ELL kernel's cut and walk, modelled in numpy (the kernel runs only on
# the card; these hold the index scheme it implements)
# ---------------------------------------------------------------------------

def _sorted_ell(n):
    """ell_from_csr's ELL of a random matrix (ascending columns, padding of
    value 0 and column 0 at each row's end) and its live entries a row."""
    from repro_torch.numerics import sparse

    csr = sparse.csr_from_dense(sparse.random_sparse(n, 12.0, seed=5),
                                device="cpu")
    ell = sparse.ell_from_csr(csr)
    return (ell.values.numpy().copy(), ell.cols.numpy().copy(),
            np.diff(csr.rowp.numpy()))


def _ell_walk_model(values, cols, x, part):
    """The walk of ``csrc/spmm.cu`` spmm_ell_kernel for each row: a pointer
    over the stored entries, windows of ``ELL_WIN`` of them, X swept in
    ``part.nchunks(n)`` chunks of ``part.chunk`` rows; in each chunk a row
    takes its entries from the pointer on up to the first one at or past
    the chunk's end (the last chunk takes all that are left).  Where X is
    staged and X[0, :] is finite, padding (value 0, column 0) is passed
    over: it adds exactly 0.  Returns the product (f32 sums in the kernel's order), how many
    times each stored entry was taken, and how many were read from the
    staged chunk."""
    win = spmm_k.ELL_WIN
    nrows, width = values.shape
    n, k = x.shape
    x0fin = bool(np.isfinite(x[0]).all()) and part.chunk > 0
    y = np.zeros((nrows, k), np.float32)
    taken = np.zeros((nrows, width), np.int64)
    staged = 0
    for i in range(nrows):
        ptr = wb = 0
        acc = np.zeros(k, np.float32)
        passes = max(part.nchunks(n), 1)  # no chunks: gather every row
        for ch in range(passes):
            lo = ch * part.chunk
            end = min(n, lo + part.chunk)
            hi = np.iinfo(np.int64).max if ch + 1 == passes else end
            while ptr < width:
                if ptr == wb + win:
                    wb += win
                j0 = ptr - wb
                stops = [j for j in range(j0, win)
                         if wb + j >= width or cols[i, wb + j] >= hi]
                j1 = stops[0] if stops else win
                for j in range(j0, j1):
                    c, v = cols[i, wb + j], values[i, wb + j]
                    taken[i, wb + j] += 1
                    if x0fin and c == 0 and v == 0:
                        continue
                    acc = (acc + v * x[c]).astype(np.float32)
                    staged += lo <= c < end
                ptr = wb + j1
                if j1 < win:
                    break
        y[i] = acc
    return y, taken, staged


def _ell_case(kind, rng):
    """(values, cols, n) of an ELL of the given kind."""
    from repro_torch.numerics import sparse

    if kind in ("sorted", "shuffled", "reversed"):
        n = 150
        vals, cols, _ = _sorted_ell(n)
        if kind == "shuffled":
            for i in range(n):
                p = rng.permutation(cols.shape[1])
                vals[i], cols[i] = vals[i, p], cols[i, p]
        elif kind == "reversed":
            vals, cols = vals[:, ::-1].copy(), cols[:, ::-1].copy()
        return vals, cols, n
    if kind == "ragged":       # a few dense rows among short ones
        n = 120
        a = sparse.random_sparse(n, 2.0, seed=6).astype(np.float32)
        a[[3, 77]] = _randn(rng, (2, n))
        ell = sparse.ell_from_csr(sparse.csr_from_dense(a, device="cpu"))
        return ell.values.numpy(), ell.cols.numpy(), n
    if kind == "width1":
        n = 90
        return (_randn(rng, (70, 1)),
                rng.integers(0, n, (70, 1)).astype(np.int32), n)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["sorted", "shuffled", "reversed", "ragged",
                                  "width1"])
@pytest.mark.parametrize("chunk", [None, 16, 7, 0])
def test_ell_walk_model_takes_every_entry_once(kind, chunk):
    """Whatever the column order, the walk takes every stored entry exactly
    once and gives the plain product; rows in ascending order read every
    entry they add from the staged chunk."""
    rng = np.random.default_rng(len(kind) + (chunk or 0))
    vals, cols, n = _ell_case(kind, rng)
    x = _randn(rng, (n, 3))
    part = spmm_k.ell_partition(vals.shape[0], vals.shape[1], n, 3, 132)
    if chunk is not None:
        part = spmm_k.EllPartition(part.cpl, part.rpw, part.nwarps, chunk)
    y, taken, staged = _ell_walk_model(vals, cols, x, part)
    np.testing.assert_array_equal(taken, 1)
    want = spmm_k.spmm_ell(*map(torch.as_tensor, (vals, cols, x)))
    np.testing.assert_allclose(y, want.numpy(), rtol=1e-4, atol=1e-5)
    if kind == "sorted" and part.chunk:
        assert staged == int(_sorted_ell(n)[2].sum())


def test_ell_walk_model_keeps_nan_from_x0_in_padded_rows():
    """Padding (value 0, column 0) adds 0 * X[0, :]: an inf there gives NaN
    in every padded row, as in the plain version."""
    rng = np.random.default_rng(8)
    vals, cols, n = _ell_case("sorted", rng)
    x = _randn(rng, (n, 4))
    x[0, 1] = np.inf
    part = spmm_k.EllPartition(1, 1, 1, 16)
    y, _, _ = _ell_walk_model(vals, cols, x, part)
    want = spmm_k.spmm_ell(*map(torch.as_tensor, (vals, cols, x))).numpy()
    np.testing.assert_array_equal(np.isnan(y), np.isnan(want))
    padded = ((vals == 0) & (cols == 0)).any(axis=1)
    assert padded.any() and np.isnan(y[padded, 1]).all()
    np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("nrows,width,n,k,sms", [
    (10240, 675, 10240, 64, 132), (1024, 16, 1024, 8, 132),
    (1024, 16, 1024, 64, 132), (512, 255, 512, 8, 132),
    (37, 20, 37, 65, 132), (100, 4, 100, 1, 132), (50000, 8, 50000, 3, 132),
    (10240, 675, 10240, 64, 1), (5, 3, 7, 33, 8)])
def test_ell_partition_fits_the_card(nrows, width, n, k, sms):
    """The cut covers every row and column of the product, fits one CTA's
    shared memory, at mod2as puts one row tile on each SM, and stages no X
    where a tile's entries are fewer than X's rows (the SpMM suite's
    uniform class)."""
    part = spmm_k.ell_partition(nrows, width, n, k, sms)
    tiles, panels = part.grid(nrows, k)
    assert tiles * part.rows >= nrows and panels * part.panel >= k
    assert 1 <= part.nwarps <= (20 if part.rpw == 4 else 15)
    assert part.rpw in (1, 4)
    assert part.cpl == (1 if k <= 32 else 2)
    stride, nchunks = part.stride(k), part.nchunks(n)
    assert stride >= min(k, part.panel) and stride % part.cpl == 0
    assert part.smem_bytes(n, k) <= spmm_k.SMEM_PER_CTA - 64
    gather = part.rows * width < n
    assert (part.chunk, nchunks) == (0, 0) if gather else \
        part.chunk * nchunks >= n > part.chunk * (nchunks - 1)
    assert part.nbuf(n) == (1 if nchunks <= 1 else 2)
    if (nrows, k, sms) == (10240, 64, 132):
        assert (part.rpw, part.nwarps, tiles) == (4, 20, 128)
        assert nchunks > 1
    if (nrows, width) == (1024, 16):
        assert gather
    if (nrows, width) == (512, 255):
        assert not gather


# ---------------------------------------------------------------------------
# the SpGEMM kernel's warp ranges, modelled in numpy
# ---------------------------------------------------------------------------

def _spgemm_range_model(av, ac, ar, bv, bc, br, c_cols, c_rowp, nbcols,
                        span):
    """``csrc/spgemm.cu`` spgemm_bsr_kernel's cut: output row i's block-
    columns in ranges of ``span`` (a warp each; CTAs of SPGEMM_WARPS
    ranges), each range's live slots found by a search of c_cols, and for
    every block p of A's row (in order) the sub-run of B's row a_cols[p]
    inside the range found by two searches.  Returns (c_vals, err, the
    number of pair products taken)."""
    bs = av.shape[1]
    nc = c_cols.shape[0]
    out = np.zeros((nc, bs, bs), np.float32)
    err, pairs = False, 0
    per_cta = spgemm_k.SPGEMM_WARPS * span
    for i in range(c_rowp.shape[0] - 1):
        for w in range(-(-nbcols // per_cta) * spgemm_k.SPGEMM_WARPS):
            jw0 = w * span
            if jw0 >= nbcols:
                continue
            jw1 = min(jw0 + span, nbcols)
            c_lo, c_hi = c_rowp[i], c_rowp[i + 1]
            s0 = c_lo + np.searchsorted(c_cols[c_lo:c_hi], jw0)
            slot = {int(c_cols[s]) - jw0: s for s in range(s0, c_hi)
                    if c_cols[s] < jw1}
            acc = np.zeros((span, bs, bs), np.float32)
            for p in range(ar[i], ar[i + 1]):
                r0, r1 = br[ac[p]], br[ac[p] + 1]
                lo = r0 + np.searchsorted(bc[r0:r1], jw0)
                top = min(r1, lo + span)
                hi = lo + np.searchsorted(bc[lo:top], jw1)
                for q in range(lo, hi):
                    jj = int(bc[q]) - jw0
                    if jj not in slot:
                        err = True
                        continue
                    acc[jj] += (av[p] @ bv[q]).astype(np.float32)
                    pairs += 1
            for jj, s in slot.items():
                out[s] = acc[jj]
    return out, err, pairs


@pytest.mark.parametrize("bs", [1, 4, 8, 12, 32, 64])
def test_spgemm_span_fits_the_accumulator(bs):
    span = spgemm_k.spgemm_span(bs)
    assert 1 <= span <= 32
    assert span == 1 or span * bs * bs * 4 <= spgemm_k.SPGEMM_ACC_BYTES
    assert spgemm_k.SPGEMM_WARPS * span * (bs * bs * 4 + 4) <= \
        spmm_k.SMEM_PER_CTA
    if bs == 8:
        assert span == 16


@pytest.mark.parametrize("bs,nb,span", [(8, 24, 16), (8, 24, 1), (4, 40, 32),
                                        (12, 10, None), (1, 70, None)])
def test_spgemm_range_model_matches_plain(bs, nb, span):
    """Every pair product lands in exactly one warp's range, in p order,
    and the ranges' slots together give the plain pair formulation."""
    from repro_torch import sparse

    span = span or spgemm_k.spgemm_span(bs)
    rng = np.random.default_rng(bs * 10 + nb)
    a, b = (sparse.BSR(*(torch.as_tensor(v) for v in
                         _bsr_operand(rng, nb, nb, bs, 0.3,
                                      empty_rows=(2, 5))), (nb * bs,) * 2, bs)
            for _ in range(2))
    plan = sparse.spgemm_symbolic(a, b)
    host = [t.numpy() for t in (a.values, a.cols, a.rowp, b.values, b.cols,
                                b.rowp)]
    got, err, pairs = _spgemm_range_model(*host, plan.c_cols, plan.c_rowp,
                                          nb, span)
    assert not err and pairs == plan.npairs
    want = spgemm_k.spgemm_bsr(a.values, a.cols, a.rowp, b.values, b.cols,
                               b.rowp, torch.as_tensor(plan.c_cols),
                               torch.as_tensor(plan.c_rowp), ncols=nb * bs)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-4)


def test_spgemm_range_model_flags_a_tile_missing_from_the_plan():
    args, ncols = _spgemm_args_missing_a_tile("cpu")
    host = [t.numpy() for t in args]
    _, err, _ = _spgemm_range_model(*host, ncols // 8, spgemm_k.spgemm_span(8))
    assert err


# ---------------------------------------------------------------------------
# the BSR SpMM kernel's work split, and the re-cut of edges above 64, in
# numpy and on the host
# ---------------------------------------------------------------------------

def _bsr_warp_ranges(start, stop, warps):
    """``csrc/spmm.cu`` spmm_bsr_kernel's ranges of a block-row's blocks
    ``[start, stop)``: cut evenly over the CTA's warps, warp w taking
    ``[start + len * w // warps, start + len * (w + 1) // warps)``."""
    n = stop - start
    return [(start + n * w // warps, start + n * (w + 1) // warps)
            for w in range(warps)]


def _bsr_split_model(vals, cols, rowp, x, panel, warps):
    """``csrc/spmm.cu`` spmm_bsr_kernel's cut: for each (block-row, panel)
    CTA, the row's blocks in :func:`_bsr_warp_ranges` (one a warp), each
    warp's partial summed over its range in p order, the warps' partials
    added in warp order.  Returns the product (f32), how many times each
    block was taken in each panel, and for each block-row the blocks in the
    order their products were added."""
    nbrows, bs = rowp.size - 1, vals.shape[1]
    k = x.shape[1]
    npanels = -(-k // panel)
    y = np.full((nbrows * bs, k), np.nan, np.float32)
    taken = np.zeros((vals.shape[0], npanels), np.int64)
    added = {}
    for i in range(nbrows):
        ranges = _bsr_warp_ranges(int(rowp[i]), int(rowp[i + 1]), warps)
        for pi in range(npanels):
            p0 = pi * panel
            pw = min(panel, k - p0)
            total = np.zeros((bs, pw), np.float32)
            order = []
            for lo, hi in ranges:
                acc = np.zeros((bs, pw), np.float32)
                for p in range(lo, hi):
                    xs = x[cols[p] * bs:(cols[p] + 1) * bs, p0:p0 + pw]
                    acc = (acc + vals[p] @ xs).astype(np.float32)
                    taken[p, pi] += 1
                    order.append(p)
                total = (total + acc).astype(np.float32)
            y[i * bs:(i + 1) * bs, p0:p0 + pw] = total
            added.setdefault(i, []).append(order)
    return y, taken, added


def _bsr_case(name):
    """(vals, cols, rowp, n columns, k values) of a named shape: the timed
    shape (the SpGEMM suite's clustered 0.2 operand, bs 8); block-CG's
    (half-bandwidth 127 at n 512 in 32-blocks: 16 block-rows); the SpMM
    suite's blocked class (n 1024, bs 8, 6 % of the blocks); a ragged grid
    with empty block-rows at bs 12."""
    rng = np.random.default_rng(len(name))
    if name == "timed":
        occ, bs, ks = np.random.default_rng(1).random((256, 256)) < 0.2, 8, \
            (64,)
    elif name == "block-CG":
        i = np.arange(16)
        occ, bs, ks = np.abs(i[:, None] - i[None, :]) <= 4, 32, (8,)
    elif name == "blocked":
        occ, bs, ks = rng.random((128, 128)) < 0.06, 8, (8, 64)
    elif name == "ragged":
        occ, bs, ks = rng.random((9, 7)) < 0.4, 12, (1, 3, 65)
        occ[[0, 4, 8]] = False
    else:
        raise ValueError(name)
    from repro_torch.sparse import block_pattern
    cols, rowp = block_pattern(occ)
    vals = _randn(rng, (cols.size, bs, bs))
    return vals, cols, rowp, occ.shape[1] * bs, ks


BSR_CASES = ["timed", "block-CG", "blocked", "ragged"]


@pytest.mark.parametrize("name", BSR_CASES)
@pytest.mark.parametrize("warps", ["partition", 1, 3])
def test_bsr_split_model_adds_every_block_once_in_order(name, warps):
    """Under bsr_partition's cut every stored block is added exactly once
    per panel, into its own block-row, and each block-row's products are
    added in p order (the warp ranges in order): an order fixed by the data
    alone.  The same holds at fewer warps, which the launcher takes where
    the partition's do not fit shared memory.  The sums give the plain
    product; an empty block-row gives zeros."""
    vals, cols, rowp, n, ks = _bsr_case(name)
    nbrows, bs = rowp.size - 1, vals.shape[1]
    rng = np.random.default_rng(3)
    for k in ks:
        part = spmm_k.bsr_partition(nbrows, cols.size, bs, k)
        x = _randn(rng, (n, k))
        y, taken, added = _bsr_split_model(
            vals, cols, rowp, x, part.panel,
            part.warps if warps == "partition" else warps)
        np.testing.assert_array_equal(taken, 1)
        for i in range(nbrows):
            for order in added[i]:
                assert order == list(range(rowp[i], rowp[i + 1]))
        want = spmm_k.spmm_bsr(*map(torch.as_tensor, (vals, cols, rowp, x)))
        np.testing.assert_allclose(y, want.numpy(), rtol=1e-4, atol=1e-4)
        empty = np.flatnonzero(np.diff(rowp) == 0)
        for i in empty:
            np.testing.assert_array_equal(y[i * bs:(i + 1) * bs], 0.0)
        if name in ("timed", "block-CG", "blocked"):
            assert part.warps == spmm_k.BSR_MAX_WARPS


@pytest.mark.parametrize("bs", [1, 3, 4, 8, 12, 16, 32, 33, 48, 64])
@pytest.mark.parametrize("k", [1, 3, 8, 32, 64, 65, 200])
def test_bsr_partition_fits_the_card(bs, k):
    """The cut covers the (bs, panel) tile with 32 lanes of at most 32
    outputs each, takes k itself as the panel up to 32 columns (at bs <=
    32), gives a block-row one warp a block up to 8, and at k = 8 leaves no
    lane idle at the path's edges (bs 8 and 32)."""
    for nbrows, nblocks in ((256, 13052), (16, 124), (4, 360), (1, 1)):
        part = spmm_k.bsr_partition(nbrows, nblocks, bs, k)
        lanes_r = 32 // part.lanes_c
        assert part.lanes_c * lanes_r == 32
        assert 1 <= part.panel <= min(k, spmm_k.BSR_MAX_PANEL)
        assert 2 * part.lanes_c >= part.panel
        assert part.lanes_c == 1 or part.lanes_c < part.panel  # no wider
        assert part.rpl in (1, 2, 4, 8, 16) and lanes_r * part.rpl >= bs
        assert 2 * part.rpl <= spmm_k.BSR_LANE_OUTPUTS
        assert part.warps == min(spmm_k.BSR_MAX_WARPS,
                                 -(-nblocks // nbrows))
        if k <= 32 and bs <= 32:
            assert part.panel == k
        if k == 8 and bs in (8, 32):
            assert 2 * part.lanes_c == 8 and lanes_r * part.rpl == bs
        grid = part.grid(nbrows, k)
        assert grid[0] == nbrows and grid[1] * part.panel >= k


@pytest.mark.parametrize("bs", [96, 128, 65])
def test_bsr_recut_is_the_same_matrix(bs):
    """An edge above 64 re-cut into sub-blocks of its largest divisor <= 64
    gives the same plain SpMM and SpGEMM results as the uncut operands, and
    bsr_uncut puts the blocks back as they were."""
    from repro_torch import sparse

    d = spmm_k.recut_edge(bs)
    assert d <= 64 and bs % d == 0 and d == max(
        e for e in range(1, 65) if bs % e == 0)
    rng = np.random.default_rng(bs)
    vals, cols, rowp = map(torch.as_tensor, _bsr_operand(
        rng, 4, 3, bs, 0.5, empty_rows=(1,)))
    v2, c2, r2, order = spmm_k.bsr_recut(vals, cols, rowp, bs, d)
    m = bs // d
    assert v2.shape == (cols.numel() * m * m, d, d)
    assert r2.shape == (4 * m + 1,) and int(r2[-1]) == cols.numel() * m * m
    assert torch.equal(spmm_k.bsr_uncut(v2, order), vals)
    x = torch.as_tensor(_randn(rng, (3 * bs, 5)))
    torch.testing.assert_close(spmm_k.spmm_bsr_plain(v2, c2, r2, x),
                               spmm_k.spmm_bsr_plain(vals, cols, rowp, x),
                               rtol=1e-5, atol=1e-4)
    nb = 4
    a, b = (sparse.BSR(*(torch.as_tensor(v) for v in _bsr_operand(
        rng, nb, nb, bs, 0.5, empty_rows=(e,))), (nb * bs,) * 2, bs)
        for e in (1, 2))
    plan = sparse.spgemm_symbolic(a, b)
    cc, cr = torch.as_tensor(plan.c_cols), torch.as_tensor(plan.c_rowp)
    want = spgemm_k.spgemm_bsr_plain(a.values, a.cols, a.rowp, b.values,
                                     b.cols, b.rowp, cc, cr, ncols=nb * bs)
    a2 = spmm_k.bsr_recut(a.values, a.cols, a.rowp, bs, d)[:3]
    b2 = spmm_k.bsr_recut(b.values, b.cols, b.rowp, bs, d)[:3]
    _, cc2, cr2, corder = spmm_k.bsr_recut(None, cc, cr, bs, d)
    got = spmm_k.bsr_uncut(spgemm_k.spgemm_bsr_plain(
        *a2, *b2, cc2, cr2, ncols=nb * bs), corder)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


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
def test_matmul_block_keywords_on_the_card(card):
    """ops.matmul takes the reference's block keywords on the cuda plane
    too; the kernel's tile is its own, so the result is the same bits."""
    g = torch.Generator(device=card).manual_seed(4)
    a = torch.randn(200, 96, device=card, generator=g)
    b = torch.randn(96, 72, device=card, generator=g)
    before = mm_k.matmul.launches
    plain = ops.matmul(a, b)
    pinned = ops.matmul(a, b, block_m=64, block_n=128, block_k=32)
    assert mm_k.matmul.launches == before + 2
    assert torch.equal(plain, pinned)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 127, 129])
@pytest.mark.parametrize("n", [1, 4, 68, 127, 129, 132])
@pytest.mark.parametrize("k", [0, 13, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_kernel_edges(m, n, k, dtype, card):
    """Around the 128 x 64 tile and the 16-deep K slab: one row or column,
    a tile less or more one, K not a multiple of the slab (13, 100) and
    K = 0 (zeros).  In f32, N in {4, 68, 132} with K in {0, 100} (multiples
    of 4) takes the three-stage 16-byte cp.async ring, so its zero-filled
    copies and float4 stores meet ragged M, N and K; every other case takes
    the register-staged path."""
    g = torch.Generator(device=card).manual_seed(m * 7 + n * 3 + k)
    a = torch.randn(m, k, device=card, generator=g).to(dtype)
    b = torch.randn(k, n, device=card, generator=g).to(dtype)
    before = mm_k.matmul.launches
    got = mm_k.matmul(a, b)
    want = mm_k.matmul_plain(a, b)
    torch.cuda.synchronize()
    assert mm_k.matmul.launches == before + 1
    assert got.shape == (m, n) and got.dtype == dtype
    if k == 0:
        assert not got.any()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * 10)


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


#: (n, offsets): a tridiagonal system at 2^20 (many row tiles, one
#: chunk); n below and past a row tile and not a multiple of 4 (4-byte
#: loads); one diagonal; a band of 64 at n % 4 == 2; offsets too far apart
#: for the staged window (x read from global memory).
DIA_CARD_CASES = {
    "tridiagonal_2^20": (1 << 20, (-1, 0, 1)),
    "n_1000": (1000, (-2, -1, 0, 1, 2)),
    "n_1030_band64": (1030, tuple(range(-32, 32))),
    "n_3001": (3001, (-3, 0, 5)),
    "one_diagonal": (4096, (7,)),
    "wide_offsets": (40000, (-30000, 0, 30000)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(DIA_CARD_CASES))
def test_spmv_dia_kernel_partitions(case, card):
    n, offsets = DIA_CARD_CASES[case]
    rng = np.random.default_rng(n)
    diags = _randn(rng, (len(offsets), n))
    for d, o in enumerate(offsets):     # zeros outside the live rows
        lo, hi = spmv_k.dia_live_rows(n, o, 0, n)
        diags[d, :lo], diags[d, hi:] = 0.0, 0.0
    diags = torch.as_tensor(diags, device=card)
    x = torch.as_tensor(_randn(rng, n), device=card)
    before = spmv_k.spmv_dia.launches
    got = spmv_k.spmv_dia(diags, offsets, x)
    assert spmv_k.spmv_dia.launches == before + 1
    want = spmv_k.spmv_dia_plain(diags, offsets, x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_spmv_dia_kernel_is_bitwise_run_to_run(card):
    """CG conf 18 (many chunks, partial sums added in a fixed order): the
    same inputs give the same y bit for bit."""
    from repro_torch.numerics import sparse

    dia = sparse.dia_from_dense(sparse.banded_spd(1024, 511, seed=18),
                                device=card)
    x = torch.randn(1024, device=card)
    first = spmv_k.spmv_dia(dia.diags, dia.offsets, x)
    for _ in range(20):
        assert torch.equal(spmv_k.spmv_dia(dia.diags, dia.offsets, x), first)


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


def _random_ell(rng, nrows, n, width, order="sorted"):
    """An ELL with rows of 1..width distinct columns (ascending, shuffled
    or descending), padded as ell_from_csr pads (value 0, column 0)."""
    vals = np.zeros((nrows, width), np.float32)
    cols = np.zeros((nrows, width), np.int32)
    for i in range(nrows):
        m = int(rng.integers(1, width + 1))
        c = np.sort(rng.choice(n, size=m, replace=False))
        if order == "shuffled":
            c = rng.permutation(c)
        elif order == "reversed":
            c = c[::-1]
        cols[i, :m] = c
        vals[i, :m] = rng.standard_normal(m)
    return vals, cols


def _ell_on_card(kind, card, rng):
    """(values, cols, n) on the card: the model cases, the SpMM suite's
    ragged class (n = 1024, four dense rows) and multi-chunk ELLs (n =
    4096, X swept in chunks at k > 8) in each column order."""
    from repro_torch.numerics import sparse

    if kind == "ragged_suite":
        n = 1024
        a = sparse.random_sparse(n, 2.0, seed=4).astype(np.float32)
        a[rng.choice(n, size=4, replace=False)] = _randn(rng, (4, n))
        ell = sparse.ell_from_csr(sparse.csr_from_dense(a, device=card))
        return ell.values, ell.cols, n
    if kind.startswith("chunks_"):
        n = 4096
        vals, cols = _random_ell(rng, 3000, n, 300, kind[len("chunks_"):])
    else:
        vals, cols, n = _ell_case(kind, rng)
    return (torch.as_tensor(np.ascontiguousarray(vals), device=card),
            torch.as_tensor(np.ascontiguousarray(cols), device=card), n)


ELL_CARD_KINDS = ["sorted", "shuffled", "reversed", "ragged", "width1",
                  "ragged_suite", "chunks_sorted", "chunks_shuffled",
                  "chunks_reversed"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ELL_CARD_KINDS)
@pytest.mark.parametrize("k", [1, 3, 8, 64, 65])
def test_spmm_ell_kernel_any_column_order(kind, k, card):
    """The kernel against its plain version for rows in any column order,
    of very different lengths, of width 1, and with X swept in chunks."""
    rng = np.random.default_rng(k + len(kind))
    vals, cols, n = _ell_on_card(kind, card, rng)
    x = torch.as_tensor(_randn(rng, (n, k)), device=card)
    before = spmm_k.spmm_ell.launches
    got = spmm_k.spmm_ell(vals, cols, x)
    want = spmm_k.spmm_ell_plain(vals, cols, x)
    torch.cuda.synchronize()
    assert spmm_k.spmm_ell.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sorted", "chunks_sorted",
                                  "chunks_shuffled"])
def test_spmm_ell_kernel_keeps_nan_from_x0(kind, card):
    """An inf in X[0, :] gives NaN in every padded row's column, as 0 *
    X[0, :] does in the plain version."""
    rng = np.random.default_rng(3)
    vals, cols, n = _ell_on_card(kind, card, rng)
    x = torch.as_tensor(_randn(rng, (n, 64)), device=card)
    x[0, 5] = float("inf")
    got = spmm_k.spmm_ell(vals, cols, x)
    want = spmm_k.spmm_ell_plain(vals, cols, x)
    torch.cuda.synchronize()
    padded = ((vals == 0) & (cols == 0)).any(dim=1)
    assert padded.any() and got[padded, 5].isnan().all()
    assert torch.equal(got.isnan(), want.isnan())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4,
                               equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["chunks_sorted", "chunks_shuffled"])
def test_spmm_ell_kernel_is_bitwise_run_to_run(kind, card):
    from repro_torch.numerics import sparse

    rng = np.random.default_rng(11)
    vals, cols, n = _ell_on_card(kind, card, rng)
    x = torch.as_tensor(_randn(rng, (n, 64)), device=card)
    first = spmm_k.spmm_ell(vals, cols, x)
    for _ in range(3):
        assert torch.equal(spmm_k.spmm_ell(vals, cols, x), first)
    a = sparse.random_sparse(10240, 5.72, seed=10240)
    ell = sparse.ell_from_csr(sparse.csr_from_dense(a, device=card))
    x = torch.as_tensor(_randn(rng, (10240, 64)), device=card)
    first = spmm_k.spmm_ell(ell.values, ell.cols, x)
    assert torch.equal(spmm_k.spmm_ell(ell.values, ell.cols, x), first)


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [8, 16, 32, 1, 4, 12, 64, 65, 96, 128])
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
@pytest.mark.parametrize("name", BSR_CASES)
def test_spmm_bsr_kernel_matches_plain_at_path_shapes(name, card):
    """The kernel at the blocked-sparse path's shapes (the timed shape at k
    64, block-CG's bs 32 at k 8, the SpMM suite's blocked class at k 8 and
    64), and ragged k with empty block-rows."""
    vals, cols, rowp, n, ks = _bsr_case(name)
    args = [torch.as_tensor(v, device=card) for v in (vals, cols, rowp)]
    rng = np.random.default_rng(5)
    for k in ks:
        x = torch.as_tensor(_randn(rng, (n, k)), device=card)
        before = spmm_k.spmm_bsr.launches
        got = spmm_k.spmm_bsr(*args, x)
        want = spmm_k.spmm_bsr_plain(*args, x)
        torch.cuda.synchronize()
        assert spmm_k.spmm_bsr.launches == before + 1
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["timed", "block-CG"])
def test_spmm_bsr_kernel_is_bitwise_run_to_run(name, card):
    """The same bits from two calls: the warp ranges are added in a fixed
    order."""
    vals, cols, rowp, n, ks = _bsr_case(name)
    args = [torch.as_tensor(v, device=card) for v in (vals, cols, rowp)]
    x = torch.as_tensor(_randn(np.random.default_rng(6), (n, ks[0])),
                        device=card)
    first = spmm_k.spmm_bsr(*args, x)
    for _ in range(3):
        assert torch.equal(spmm_k.spmm_bsr(*args, x), first)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [96, 128])
def test_sparse_spmm_above_64_keeps_the_recut(block, card):
    """sparse.spmm on a matrix pinned to an edge above 64 runs the kernel
    on the re-cut it keeps on the matrix: one launch a call, the plain
    product, the same bits on the next call."""
    from repro_torch import sparse

    rng = np.random.default_rng(block)
    vals, cols, rowp = (torch.as_tensor(v, device=card) for v in
                        _bsr_operand(rng, 6, 5, block, 0.4, empty_rows=(2,)))
    m = sparse.BSR(vals, cols, rowp, (6 * block, 5 * block), block)
    x = torch.as_tensor(_randn(rng, (5 * block, 8)), device=card)
    before = spmm_k.spmm_bsr.launches
    got = sparse.spmm(m, x).read()
    assert spmm_k.spmm_bsr.launches == before + 1
    torch.testing.assert_close(
        torch.as_tensor(got), spmm_k.spmm_bsr_plain(vals, cols, rowp, x)
        .cpu(), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(sparse.spmm(m, x).read(), got)
    assert spmm_k.spmm_bsr.launches == before + 2


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
@pytest.mark.parametrize("bs", [8, 16, 32, 1, 4, 12, 64, 65, 96, 128])
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


def _clustered(n, bs, frac, seed):
    """The SpGEMM suite's clustered operand (benchmarks/spgemm.py) at block
    edge ``bs``."""
    rng = np.random.default_rng(seed)
    nb = n // bs
    occ = rng.random((nb, nb)) < frac
    d = rng.standard_normal((n, n)).astype(np.float32)
    return np.where(np.kron(occ, np.ones((bs, bs), bool)), d, 0.0) \
        .astype(np.float32)


def _spgemm_card_args(a, b):
    from repro_torch import sparse

    plan = sparse.spgemm_symbolic(a, b)
    dev = a.device
    return (a.values, a.cols, a.rowp, b.values, b.cols, b.rowp,
            torch.as_tensor(plan.c_cols, device=dev),
            torch.as_tensor(plan.c_rowp, device=dev))


SPGEMM_CARD_CASES = {
    # the suite's timed case; bs 32 (a whole output row's accumulator,
    # 256 KB, is more than a CTA's shared memory) and 64; a banded product
    "clustered0.2_bs8": (2048, 8, 0.2), "clustered0.2_bs32": (2048, 32, 0.2),
    "clustered0.3_bs64": (1024, 64, 0.3), "banded_bw127_bs8": (2048, 8, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SPGEMM_CARD_CASES))
def test_spgemm_bsr_kernel_at_suite_sizes(case, card):
    """The kernel against its plain version at the SpGEMM suite's sizes,
    and the same bits from a second call."""
    from repro_torch import sparse
    from repro_torch.numerics.sparse import banded_spd

    n, bs, frac = SPGEMM_CARD_CASES[case]
    if frac is None:
        ops = [banded_spd(n, 127, seed=s).astype(np.float32) for s in (3, 4)]
    else:
        ops = [_clustered(n, bs, frac, s) for s in (1, 2)]
    a, b = (sparse.bsr_from_dense(m, block=bs, device=card) for m in ops)
    args = _spgemm_card_args(a, b)
    got = spgemm_k.spgemm_bsr(*args, ncols=n)
    want = spgemm_k.spgemm_bsr_plain(*args, ncols=n)
    torch.cuda.synchronize()
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)
    assert torch.equal(spgemm_k.spgemm_bsr(*args, ncols=n), got)


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
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hq,hkv,d,lq,lk,bk",
                         [(4, 2, 64, 1, 100, 32), (4, 2, 128, 63, 200, 128),
                          (8, 2, 64, 130, 77, 16), (4, 1, 32, 63, 129, 100),
                          (16, 4, 128, 200, 1021, 128)])
def test_flash_attention_bf16_kernel_edges(causal, hq, hkv, d, lq, lk, bk,
                                           card):
    """The tensor-core dense grid at Lq 1 and 63 (one partial warpgroup),
    GQA group 4, block_k 16 and 100, Lq != Lk, with and without state."""
    q, k, v = _attn_inputs(card, torch.bfloat16, hq=hq, hkv=hkv, lq=lq,
                           lk=lk, d=d, seed=lq + lk)
    before = fa_k.flash_attention.launches
    got = fa_k.flash_attention(q, k, v, causal=causal, block_k=bk,
                               row_extents=False, return_state=True)
    assert fa_k.flash_attention.launches == before + 1
    want = fa_k.flash_attention_plain(q, k, v, causal=causal, block_k=bk,
                                      return_state=True)
    for g, w, what in zip(got, want, "oml"):
        _close(g, w, ATTN_TOL[torch.bfloat16] * (lk if what == "l" else 1),
               what)
    assert torch.equal(fa_k.flash_attention(q, k, v, causal=causal,
                                            block_k=bk, row_extents=False),
                       got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("b,L", [(4, 512), (1, 1021)])
def test_tiles_kernel_bitwise_equals_dense_causal_bf16(b, L, card):
    """The bf16 counterpart of the f32 property: both walks fold the same
    rows over the same K tiles in the same order through one fold."""
    q, k, v = _attn_inputs(card, torch.bfloat16, b=b, hq=16, hkv=8, lq=L,
                           lk=L, d=128, seed=L)
    tiles = fa_k.flash_attention_tiles(q, k, v,
                                       causal_layout(L, L, 128, 128),
                                       return_state=True)
    dense = fa_k.flash_attention(q, k, v, causal=True, row_extents=False,
                                 return_state=True)
    for t, g in zip(tiles, dense):
        assert torch.equal(t, g)


@pytest.mark.cuda
def test_flash_attention_bf16_misaligned_view_raises(card):
    """The dense and tiles tensor-core kernels copy 16-byte chunks: a bf16
    view that starts one element into its storage is refused, never run on
    another kernel.  The key-length kernels take such a view in either
    dtype and match the plain version."""
    q, k, v = _attn_inputs(card, torch.bfloat16, lq=64, lk=64, d=64)
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=card)
    qm = flat[1:].view(q.shape)
    qm.copy_(q)
    assert qm.is_contiguous() and qm.data_ptr() % 16
    before = fa_k.flash_attention.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa_k.flash_attention(qm, k, v, causal=False)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa_k.flash_attention(qm, k, v, causal=True, row_extents=False)
    assert fa_k.flash_attention.launches == before
    # the key-length kernels take it in either dtype (the wrapper copies a
    # misaligned operand into an aligned one; the same kernel runs)
    kv_len = torch.tensor([64, 10], dtype=torch.int32, device=card)
    flat32 = torch.empty(q.numel() + 1, device=card)
    qm32 = flat32[1:].view(q.shape)
    qm32.copy_(q)
    assert qm32.data_ptr() % 16
    for view, dtype in ((qm, torch.bfloat16), (qm32, torch.float32)):
        kd, vd = k.to(dtype), v.to(dtype)
        before = fa_k.flash_attention_lens.launches
        got = fa_k.flash_attention(view, kd, vd, causal=False, kv_len=kv_len)
        assert fa_k.flash_attention_lens.launches == before + 1
        _close(got, fa_k.flash_attention_plain(view.clone(), kd, vd,
                                               causal=False, kv_len=kv_len),
               ATTN_TOL[dtype], "o")


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("lq,causal", [(1, False), (3, False), (40, False),
                                       (40, True)])
def test_flash_attention_lens_kernel_groups(dtype, hq, hkv, lq, causal,
                                            card):
    """The split-K lens kernels at GQA groups 1, 2 and 8, kv_len 0, 1, the
    capacity and ragged (a short last tile at Lk 1000), causal and not:
    decode (f32, and bf16 groups of at most 16 rows) and prefix (bf16
    groups above 16 rows, 64- and 128-row blocks, a block across heads at
    group 8), each reached as lens_blocks says."""
    b, lk = 4, 1000
    q, k, v = _attn_inputs(card, dtype, b=b, hq=hq, hkv=hkv, lq=lq, lk=lk,
                           d=128, seed=hq * lq)
    kv_len = torch.tensor([0, 1, lk, 517], dtype=torch.int32, device=card)
    kind = fa_k.lens_blocks(dtype, hq // hkv * lq)[0]
    before = fa_k.flash_attention_lens.launches
    by_kind = fa_k.flash_attention_lens.kernels[kind]
    got = fa_k.flash_attention_lens(q, k, v, kv_len, causal=causal,
                                    return_state=True)
    torch.cuda.synchronize()
    assert fa_k.flash_attention_lens.launches == before + 1
    assert fa_k.flash_attention_lens.kernels[kind] == by_kind + 1
    want = fa_k.flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len,
                                      return_state=True)
    live = kv_len > 0
    assert torch.all(got[1][~live] == fa_k.NEG_INF)
    _close(got[0], want[0], ATTN_TOL[dtype], "o", live)
    _close(got[1], want[1], ATTN_TOL[dtype], "m", live)
    _close(got[2], want[2], ATTN_TOL[dtype] * lk, "l", live)
    o = fa_k.flash_attention_lens(q, k, v, kv_len, causal=causal)
    assert torch.equal(o, got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,lq,lk", [
    (torch.bfloat16, 8, 1, 2048), (torch.float32, 8, 1, 2048),
    (torch.bfloat16, 1, 128, 1152), (torch.float32, 1, 128, 1152)])
def test_flash_attention_lens_kernel_is_bitwise_run_to_run(dtype, b, lq, lk,
                                                           card):
    """Paged decode (8 slots, Lq 1, kv_len spread over the capacity) and a
    chunk's prefix (Lq 128 against 1152 keys) at qwen3-1.7b's heads: the
    keys are split (several ranges, merged by the group's last CTA in a
    fixed order), and the same inputs give the same bits every time."""
    q, k, v = _attn_inputs(card, dtype, b=b, hq=16, hkv=8, lq=lq, lk=lk,
                           d=128, seed=lk)
    kv_len = torch.linspace(1, lk, b, device=card).round().to(torch.int32)
    rows_blk = fa_k.lens_blocks(dtype, 2 * lq)[1]
    groups = b * 8 * -(-2 * lq // rows_blk)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert fa_k.lens_partition(lk, 128, groups, sms).nsplit > 1
    first = fa_k.flash_attention_lens(q, k, v, kv_len, return_state=True)
    for _ in range(20):
        again = fa_k.flash_attention_lens(q, k, v, kv_len, return_state=True)
        assert all(torch.equal(x, y) for x, y in zip(again, first))
    want = fa_k.flash_attention_plain(q, k, v, causal=False, kv_len=kv_len,
                                      return_state=True)
    for g, w, what in zip(first, want, "oml"):
        _close(g, w, ATTN_TOL[dtype] * (lk if what == "l" else 1), what)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [96, 256])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (8, 1)])
def test_attention_kernels_at_head_dims_96_and_256(dtype, d, hq, hkv, card):
    """phi3-mini-3.8b's head_dim (96) and gemma-2b's (256, MQA 8/1) in all
    three kernels: the dense grid (causal and not, with state; a short last
    K tile), lens (decode at Lq 1, and at Lq 48 the prefix kernel in bf16)
    and the tiles walk (band and bias masks)."""
    _hold_forward_kernels_at(dtype, d, hq, hkv, card)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv", [(32, 32), (4, 2)])
def test_attention_kernels_at_head_dim_112(dtype, hq, hkv, card):
    """zamba2-7b's head_dim (112, 32/32 heads: 112 / 32 columns a lane in
    the f32 fold, m64n112k16 in the bf16 one) in all three kernels, as
    at 96 and 256."""
    _hold_forward_kernels_at(dtype, 112, hq, hkv, card)


def _hold_forward_kernels_at(dtype, d, hq, hkv, card):
    """The dense grid, lens and tiles at head_dim ``d`` against their plain
    versions."""
    L = 200
    q, k, v = _attn_inputs(card, dtype, hq=hq, hkv=hkv, lq=L, lk=L, d=d,
                           seed=d)
    for causal in (False, True):
        got = fa_k.flash_attention(q, k, v, causal=causal,
                                   row_extents=False, return_state=True)
        want = fa_k.flash_attention_plain(q, k, v, causal=causal,
                                          return_state=True)
        for g, w, what in zip(got, want, "oml"):
            _close(g, w, ATTN_TOL[dtype] * (L if what == "l" else 1),
                   f"dense causal={causal} {what}")
    kv_len = torch.tensor([0, 150], dtype=torch.int32, device=card)
    live = kv_len > 0
    for lq in (1, 48):
        ql = q[:, :, :lq].contiguous()
        got = fa_k.flash_attention_lens(ql, k, v, kv_len, return_state=True)
        want = fa_k.flash_attention_plain(ql, k, v, causal=False,
                                          kv_len=kv_len, return_state=True)
        assert torch.all(got[1][~live] == fa_k.NEG_INF)
        for g, w, what in zip(got, want, "oml"):
            _close(g, w, ATTN_TOL[dtype] * (L if what == "l" else 1),
                   f"lens Lq={lq} {what}", live)
    for spec in ("window", "globals"):
        layout = compile_layout(_TILE_SPECS[spec](L, L), L, L, 64, 64)
        got = fa_k.flash_attention_tiles(q, k, v, layout, return_state=True)
        want = fa_k.flash_attention_tiles_plain(q, k, v, layout,
                                                return_state=True)
        for g, w, what in zip(got, want, "oml"):
            _close(g, w, ATTN_TOL[dtype] * (L if what == "l" else 1),
                   f"tiles {spec} {what}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [96, 112, 256])
def test_tiles_kernel_bitwise_equals_dense_causal_at_head_dims(dtype, d,
                                                               card):
    """The bitwise property of both folds at 96, 112 and 256 (at 112 the
    f32 fold's lanes 16-31 own a dead fourth column; at 256 the bf16 fold
    stages K and V in one buffer each), with a short last tile."""
    L = 300
    q, k, v = _attn_inputs(card, dtype, b=2, hq=4, hkv=2, lq=L, lk=L, d=d,
                           seed=L + d)
    tiles = fa_k.flash_attention_tiles(q, k, v,
                                       causal_layout(L, L, 128, 128),
                                       return_state=True)
    dense = fa_k.flash_attention(q, k, v, causal=True, row_extents=False,
                                 return_state=True)
    for t, g in zip(tiles, dense):
        assert torch.equal(t, g)


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


# ---------------------------------------------------------------------------
# the attention backward kernels (fa_bwd_delta, fa_bwd_dkdv, fa_bwd_dq)
# ---------------------------------------------------------------------------

def _bwd_layout(kind, L, bq=128, bk=128):
    """The layout a backward case walks: ``kind`` names the forward call."""
    if kind == "causal":
        return causal_layout(L, L, bq, bk)
    if kind == "window":
        return compile_layout(MaskSpec(causal=True, window=L // 3 + 1), L, L,
                              bq, bk)
    if kind == "globals":
        return compile_layout(MaskSpec(causal=True, window=L // 4 + 1,
                                       global_tokens=(0, 1, L // 2)), L, L,
                              bq, bk)
    if kind == "deadrow":
        # a causal pattern of 64-row blocks with block rows 2-4 dead: Q
        # tile 1 (rows 128-255) walks nothing, and rows 256-319 are dead
        # inside Q tile 2's bias tiles
        blocks = np.tril(np.ones((L // 64, L // 64), bool))
        blocks[2:5] = False
        return compile_layout(MaskSpec.from_block_mask(blocks, 64), L, L, bq,
                              bk)
    from repro_torch.sparse.maskcompiler import grid_layout
    return grid_layout(L, L, bq, bk, kind == "grid_causal")


def _bwd_call(kind, q, k, v, layout):
    if kind.startswith("grid"):
        return fa_k.flash_attention(q, k, v, causal=kind == "grid_causal",
                                    row_extents=False,
                                    block_q=layout.block_q,
                                    block_k=layout.block_k)
    return fa_k.flash_attention_tiles(q, k, v, layout)


#: Gradient bars: f32 1e-5 (the kernels and the plain version sum in other
#: orders, a few ulps apart); bf16 2^-7 relative (two bf16 ulps: both round
#: f32 sums to bf16 and a last-bit difference flips a rounding), and in
#: either dtype an absolute part of the bar times the gradient's largest
#: entry (2e-3 in bf16, as chip_smoke.py's attn_tol for outputs of size 1).
BWD_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -7, 2e-3)}


def _close_grad(got, want, dtype, what):
    rtol, atol = BWD_TOL[dtype]
    want = want.float()
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got.float(), want, rtol=rtol,
                               atol=atol * scale,
                               msg=lambda m: f"{what}: {m}")


def _bwd_run(kind, dtype, b, hq, hkv, L, d, card, bq=128, bk=128,
             do_cols=None):
    """(got, want): the wrapper's gradients through autograd on the card,
    and the plain backward's on the same o, lse and dO (zero outside the
    columns ``do_cols`` where given)."""
    q, k, v = _attn_inputs(card, dtype, b=b, hq=hq, hkv=hkv, lq=L, lk=L, d=d,
                           seed=L + d)
    lay = _bwd_layout(kind, L, bq, bk)
    g = torch.Generator(device=card).manual_seed(d)
    do = torch.randn(q.shape, device=card, generator=g).to(dtype)
    if do_cols is not None:
        keep = torch.zeros(d, dtype=torch.bool, device=card)
        keep[do_cols] = True
        do = torch.where(keep, do, torch.zeros_like(do))
    with torch.no_grad():
        if kind.startswith("grid"):
            o, m, l = fa_k.flash_attention(
                q, k, v, causal=kind == "grid_causal", row_extents=False,
                block_q=bq, block_k=bk, return_state=True)
        else:
            o, m, l = fa_k.flash_attention_tiles(q, k, v, lay,
                                                 return_state=True)
    lse = fa_k.softmax_lse(m, l)
    want = fa_k.flash_attention_tiles_bwd_plain(q, k, v, o, lse, do, lay)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = [w.launches for w in (fa_k.fa_bwd_delta, fa_k.fa_bwd_dkdv,
                                   fa_k.fa_bwd_dq)]
    out = _bwd_call(kind, *leaves, lay)
    assert torch.equal(out.detach(), o)
    out.backward(do)
    after = [w.launches for w in (fa_k.fa_bwd_delta, fa_k.fa_bwd_dkdv,
                                  fa_k.fa_bwd_dq)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    torch.cuda.synchronize()
    return [t.grad for t in leaves], want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,b,hq,hkv,L,d", [
    ("causal", 4, 16, 8, 512, 128), ("causal", 1, 32, 32, 256, 96),
    ("causal", 1, 8, 1, 256, 256), ("causal", 2, 4, 2, 777, 64),
    ("causal", 1, 8, 4, 200, 32), ("window", 2, 8, 1, 512, 64),
    ("globals", 1, 4, 2, 384, 128), ("grid", 1, 4, 2, 300, 64),
    ("grid_causal", 1, 4, 4, 257, 128), ("deadrow", 1, 4, 2, 384, 64)])
def test_attention_backward_kernels_match_plain(kind, b, hq, hkv, L, d,
                                                dtype, card):
    """dQ, dK, dV through the autograd wrapper (three launches) against the
    plain backward on the same o, lse and dO: causal tiles at the training
    shape, head_dim 32/64/96/128/256, GQA groups 1, 2 and 8, a ragged
    length, a window (the band path), global tokens (the bias path), the
    dense grid causal and not, and a layout with dead rows (their dQ is 0,
    and nothing is NaN)."""
    got, want = _bwd_run(kind, dtype, b, hq, hkv, L, d, card)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert torch.isfinite(g).all(), what
        _close_grad(g, w, dtype, f"{kind} {dtype} d={d} {what}")
    if kind == "deadrow":
        assert not got[0][:, :, 128:320].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bq,bk", [(64, 32), (128, 16), (32, 128)])
def test_attention_backward_kernels_at_other_blocks(bq, bk, dtype, card):
    """Blocks that are not the default: the K sub-tiles and Q sub-tiles of
    the kernels cut tiles of 16 to 128."""
    got, want = _bwd_run("causal", dtype, 1, 4, 2, 200, 64, card, bq, bk)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        _close_grad(g, w, dtype, f"bq={bq} bk={bk} {dtype} {what}")


@pytest.mark.cuda
def test_attention_backward_kernels_at_d256_blocks_64(card):
    """bf16 at head_dim 256 with 64 x 64 tiles and a GQA group of 8: the
    dK/dV kernel's two warpgroups split d over one K tile of 64 keys, and
    sum the group's eight heads."""
    got, want = _bwd_run("causal", torch.bfloat16, 1, 8, 1, 320, 256, card,
                         64, 64)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        _close_grad(g, w, torch.bfloat16, f"d=256 blocks 64 {what}")


#: The SDPA backend the library yardstick is pinned to, here and in
#: chip_smoke.py, so that it means one thing from run to run.
SDPA_BACKEND = "FLASH_ATTENTION"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,hq,hkv,L", [
    ("causal", 32, 32, 512), ("causal", 4, 2, 300), ("window", 4, 4, 384),
    ("globals", 4, 2, 256), ("grid", 4, 4, 200)])
def test_attention_backward_at_head_dim_112(kind, hq, hkv, L, dtype, card):
    """zamba2's head_dim 112, where 32 does not divide d (the f32 kernels'
    lanes 0-15 own a fourth column, the bf16 ones run m64n112k16): the
    three launches against the plain backward, at zamba2's 32/32 heads and
    at a ragged length, a window, global tokens and the dense grid."""
    got, want = _bwd_run(kind, dtype, 1, hq, hkv, L, 112, card)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert torch.isfinite(g).all(), what
        _close_grad(g, w, dtype, f"{kind} {dtype} d=112 {what}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_at_head_dim_112_last_columns(dtype, card):
    """dO zero except in columns 96-111, the columns of a lane's fourth:
    a delta loop that stopped at 3 x 32 columns would give D = 0, and
    accumulators that stopped there would leave columns 96-111 of dQ, dK
    and dV unwritten; dV would be zero everywhere.  A random dO could hide
    the first inside the tolerance."""
    got, want = _bwd_run("causal", dtype, 1, 4, 2, 256, 112, card,
                         do_cols=slice(96, 112))
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert float(w.float().abs().max()) > 0, what
        _close_grad(g, w, dtype, f"d=112 columns 96-111 {dtype} {what}")
    assert not got[2][..., :96].any()  # dV = P^T dO has dO's columns


#: The frontend configs' attention: musicgen-medium's training shape (B 4,
#: 24/24 heads, GQA group 1, 768 = 256 frame + 512 text positions, d 64)
#: and qwen2-vl-72b's prefill (64/8, d 128, 1536 = 1024 patch + 512 text
#: positions; B 1 here).
FRONTEND_ATTN = [(4, 24, 24, 768, 64), (1, 64, 8, 1536, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,L,d", FRONTEND_ATTN)
def test_tiles_kernel_at_the_frontend_configs_heads(b, hq, hkv, L, d, dtype,
                                                    card):
    """The tiles forward over causal_layout with state, one launch, against
    its plain version at the two frontend configs' heads."""
    q, k, v = _attn_inputs(card, dtype, b=b, hq=hq, hkv=hkv, lq=L, lk=L,
                           d=d, seed=hq)
    layout = causal_layout(L, L, 128, 128)
    before = fa_k.flash_attention_tiles.launches
    got = fa_k.flash_attention_tiles(q, k, v, layout, return_state=True)
    assert fa_k.flash_attention_tiles.launches == before + 1
    want = fa_k.flash_attention_tiles_plain(q, k, v, layout,
                                            return_state=True)
    for g, w, what in zip(got, want, "oml"):
        _close(g, w, ATTN_TOL[dtype] * (L if what == "l" else 1),
               f"{hq}/{hkv} d={d} {dtype} {what}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,L,d", FRONTEND_ATTN)
def test_attention_backward_at_the_frontend_configs_heads(b, hq, hkv, L, d,
                                                          dtype, card):
    """dQ, dK, dV through the autograd wrapper (three launches) against the
    plain backward at the two frontend configs' heads: GQA group 1 at d 64
    (musicgen's training) and group 8 at d 128 over 1536 positions
    (qwen2-vl's gradient check)."""
    got, want = _bwd_run("causal", dtype, b, hq, hkv, L, d, card)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert torch.isfinite(g).all(), what
        _close_grad(g, w, dtype, f"{hq}/{hkv} d={d} {dtype} {what}")


@pytest.mark.cuda
def test_attention_backward_bf16_error_within_twice_sdpas(card):
    """At the training attention (bf16, causal tiles, B 4, Hq/Hkv 16/8, L
    512, d 128) the kernels' dQ, dK and dV are no further from the f32
    plain backward on the same bf16 values (unrounded P and dS, o and lse
    of the f32 forward) than twice SDPA's backward on the bf16 inputs
    (pinned to SDPA_BACKEND, GQA expanded, dK and dV summed over the group
    in f32), in relative L2 error per gradient."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, hq, hkv, L, d = 4, 16, 8, 512, 128
    group = hq // hkv
    q, k, v = _attn_inputs(card, torch.bfloat16, b=b, hq=hq, hkv=hkv, lq=L,
                           lk=L, d=d, seed=21)
    g = torch.Generator(device=card).manual_seed(22)
    do = torch.randn(q.shape, device=card, generator=g).to(torch.bfloat16)
    lay = causal_layout(L, L, 128, 128)
    full = [t.float() for t in (q, k, v, do)]
    with torch.no_grad():
        o, m, l = fa_k.flash_attention_tiles(*full[:3], lay,
                                             return_state=True)
    ref = fa_k.flash_attention_tiles_bwd_plain(
        *full[:3], o, fa_k.softmax_lse(m, l), full[3], lay)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa_k.flash_attention_tiles(*leaves, lay).backward(do)
    ours = [t.grad for t in leaves]
    lib = [q.clone().requires_grad_()] + [
        t.repeat_interleave(group, 1).requires_grad_() for t in (k, v)]
    with sdpa_kernel(getattr(SDPBackend, SDPA_BACKEND)):
        F.scaled_dot_product_attention(*lib, is_causal=True).backward(do)
    theirs = [lib[0].grad] + [
        t.grad.float().view(b, hkv, group, L, d).sum(2) for t in lib[1:]]

    def err(x, r):
        return float((x.float() - r).norm() / r.norm())

    for x, y, r, what in zip(ours, theirs, ref, ("dq", "dk", "dv")):
        assert err(x, r) <= 2 * err(y, r), (what, err(x, r), err(y, r))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_kernels_are_bitwise_run_to_run(dtype, card):
    """No atomics: dK and dV sum the GQA group's heads in a fixed order, so
    two backward passes on the same inputs give the same bits."""
    q, k, v = _attn_inputs(card, dtype, b=2, hq=16, hkv=8, lq=512, lk=512,
                           d=128, seed=5)
    do = torch.randn(q.shape, device=card).to(dtype)
    grads = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fa_k.flash_attention(*leaves, causal=True).backward(do)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiles_forward_is_bitwise_run_to_run(dtype, card):
    """Remat recomputes the forward inside backward: the tiles kernel must
    give the same o, m and l from run to run, or the saved lse would not
    match the recomputed o."""
    q, k, v = _attn_inputs(card, dtype, b=4, hq=16, hkv=8, lq=512, lk=512,
                           d=128, seed=9)
    lay = causal_layout(512, 512, 128, 128)
    first = fa_k.flash_attention_tiles(q, k, v, lay, return_state=True)
    for _ in range(3):
        again = fa_k.flash_attention_tiles(q, k, v, lay, return_state=True)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_lens_kernel_with_grad_raises(card):
    """flash_attention_lens has no backward: an input that requires grad
    raises instead of returning an output with no gradient."""
    q, k, v = _attn_inputs(card, torch.float32, lq=1, lk=64)
    kv_len = torch.tensor([10, 64], dtype=torch.int32, device=card)
    with pytest.raises(NotImplementedError, match="no backward"):
        fa_k.flash_attention_lens(q.requires_grad_(), k, v, kv_len)
    with torch.no_grad():
        fa_k.flash_attention_lens(q, k, v, kv_len)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dead_rows_output_zero_and_backward_is_its_derivative(dtype, card):
    """At the ``deadrow`` layout (Q tile 1 walks nothing, rows 256-319 are
    dead inside Q tile 2's bias tiles) the tiles kernel writes o = 0 on
    every row with m == NEG_INF.  In f32 the kernels' backward (three
    launches) matches autograd of the plain forward on the card, whose o
    is also 0 there; in bf16 the kernels round P and dS where the plain
    backward does and autograd of the plain forward does not, so there
    they are held against the plain backward on their own o and lse; the
    backward bars in both."""
    L = 384
    q, k, v = _attn_inputs(card, dtype, b=1, hq=4, hkv=2, lq=L, lk=L, d=64,
                           seed=31)
    lay = _bwd_layout("deadrow", L)
    g = torch.Generator(device=card).manual_seed(32)
    do = torch.randn(q.shape, device=card, generator=g).to(dtype)
    with torch.no_grad():
        o, m, l = fa_k.flash_attention_tiles(q, k, v, lay,
                                             return_state=True)
    dead = m <= fa_k.NEG_INF
    assert dead[:, :, 128:320].all() and not dead[:, :, :128].any()
    assert not o[dead].any()
    fns = (fa_k.flash_attention_tiles, fa_k.flash_attention_tiles_plain)
    if dtype == torch.bfloat16:
        fns = fns[:1]
    grads = []
    for fn in fns:
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fn(*leaves, lay).backward(do)
        grads.append([t.grad for t in leaves])
    if dtype == torch.bfloat16:
        grads.append(fa_k.flash_attention_tiles_bwd_plain(
            q, k, v, o, fa_k.softmax_lse(m, l), do, lay))
    for g_, w, what in zip(*grads, ("dq", "dk", "dv")):
        assert torch.isfinite(g_).all(), what
        _close_grad(g_, w, dtype, f"deadrow {dtype} {what}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv", [(32, 4), (56, 8)])
def test_lens_and_tiles_kernels_at_the_moe_heads(dtype, hq, hkv, card):
    """The MoE family's heads at d = 128: qwen3-moe-30b-a3b's 32/4 (GQA
    group 8) and arctic-480b's 56/8 (group 7, which sizes the lens row
    blocks unevenly): lens at the ContinuousEngine's decode (4 slots,
    capacity 1152) and a chunk's prefix (128 rows against 1152), tiles at
    the Engine's prefill (causal, L 512) and at a chunk's own keys."""
    for b, lq, lk in ((4, 1, 1152), (1, 128, 1152)):
        q, k, v = _attn_inputs(card, dtype, b=b, hq=hq, hkv=hkv, lq=lq,
                               lk=lk, d=128, seed=hq + lq)
        kv_len = torch.tensor([0, lk, 517, 1][:b] if b > 1 else [1000],
                              dtype=torch.int32, device=card)
        got = fa_k.flash_attention_lens(q, k, v, kv_len, return_state=True)
        want = fa_k.flash_attention_plain(q, k, v, causal=False,
                                          kv_len=kv_len, return_state=True)
        live = kv_len > 0
        assert torch.all(got[1][~live] == fa_k.NEG_INF)
        _close(got[0], want[0], ATTN_TOL[dtype], f"lens o {b}x{lq}", live)
        _close(got[1], want[1], ATTN_TOL[dtype], f"lens m {b}x{lq}", live)
        _close(got[2], want[2], ATTN_TOL[dtype] * lk, f"lens l {b}x{lq}",
               live)
    for b, L in ((2, 512), (1, 128)):
        q, k, v = _attn_inputs(card, dtype, b=b, hq=hq, hkv=hkv, lq=L, lk=L,
                               d=128, seed=hq + L)
        layout = causal_layout(L, L, 128, 128)
        got = fa_k.flash_attention_tiles(q, k, v, layout, return_state=True)
        want = fa_k.flash_attention_tiles_plain(q, k, v, layout,
                                                return_state=True)
        for g_, w, what in zip(got, want, "oml"):
            _close(g_, w, ATTN_TOL[dtype] * (L if what == "l" else 1),
                   f"tiles {what} {b}x{L}")


# ---------------------------------------------------------------------------
# the training families' backward on the card, bitwise from run to run
# (a resume bitwise equal to an uninterrupted run rests on it)
# ---------------------------------------------------------------------------

def _grads_twice(card, fn, inputs):
    """The gradients of every input of ``fn(*inputs)`` (a tuple of outputs,
    each given a seeded random output gradient) from two backward passes on
    the same inputs."""
    runs = []
    for _ in range(2):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        outs = [o for o in fn(*leaves) if o.requires_grad]
        g = torch.Generator(device=card).manual_seed(1)
        gys = [torch.randn(o.shape, device=card, generator=g).to(o.dtype)
               for o in outs]
        runs.append(torch.autograd.grad(outs, leaves, gys))
    torch.cuda.synchronize()
    return runs


@pytest.mark.cuda
def test_moe_backward_is_bitwise_run_to_run(card):
    """moe_apply at qwen3-moe-30b-a3b's width in bf16 (d 2048, 128 experts,
    top-8, moe_d_ff 768, the router f32) on 4 x 512 tokens: two backward
    passes give the same bits in every gradient.  The token gather
    ``xt[:, tok]`` has an accumulating index_put_ for its backward, and
    the combine's gather another."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod

    cfg = get_config("qwen3-moe-30b-a3b")
    gen = torch.Generator(device=card).manual_seed(0)
    p = moe_mod.moe_init(gen, cfg)
    x = torch.randn(4, 512, cfg.d_model, device=card, generator=gen).to(
        cfg.pdtype)
    names = sorted(p)

    def fn(x, *w):
        y, aux = moe_mod.moe_apply(x, dict(zip(names, w)), cfg)
        return y, aux["aux_lb"], aux["aux_z"]

    a, b = _grads_twice(card, fn, (x, *(p[n] for n in names)))
    for ga, gb, what in zip(a, b, ("x", *names)):
        assert ga.abs().max() > 0, what
        assert torch.equal(ga, gb), what


@pytest.mark.cuda
def test_ssd_backward_is_bitwise_run_to_run(card):
    """ssd_chunked at zamba2-7b's widths (112 heads of 64, one SSM group,
    state 64) on 4 x 512 tokens, x, B and C in bf16 as mamba2 gives them:
    two backward passes give the same bits.  One SSM group shared by 112
    heads makes the head repeat's backward a sum over 112."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm as ssm_mod

    cfg = get_config("zamba2-7b")
    B, L, H, P = 4, 512, cfg.ssm_heads, cfg.ssm_headdim
    G, N = cfg.ssm_groups, cfg.ssm_state
    gen = torch.Generator(device=card).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device=card, generator=gen)

    x = randn(B, L, H, P).bfloat16()
    dt = torch.nn.functional.softplus(randn(B, L, H) - 2.0)
    a_log = torch.log(torch.rand(H, device=card, generator=gen) * 15 + 1)
    bmat, cmat = randn(B, L, G, N).bfloat16(), randn(B, L, G, N).bfloat16()
    a, b = _grads_twice(card, lambda *t: ssm_mod.ssd_chunked(*t, cfg),
                        (x, dt, a_log, bmat, cmat))
    for ga, gb, what in zip(a, b, ("x", "dt", "a_log", "bmat", "cmat")):
        assert bool(torch.isfinite(ga).all()), what
        assert torch.equal(ga, gb), what


# ---------------------------------------------------------------------------
# measured dispatch on the card: blocks, syncs, the device rule, capture
# ---------------------------------------------------------------------------

@pytest.fixture
def torch_files(monkeypatch, tmp_path):
    """The port's cost model and block cache in ``tmp_path`` (read at
    ``settings.reload()``, and again once the variables are restored)."""
    from repro_torch.core import blocking

    monkeypatch.setenv("REPRO_TORCH_COSTMODEL", str(tmp_path / "cm.json"))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "at.json"))
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE", raising=False)
    settings.reload()
    yield blocking
    monkeypatch.undo()
    settings.reload()


def _train_qkv(card, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    return tuple(torch.randn(shape, device=card, generator=g).bfloat16()
                 for shape in ((4, 16, 512, 128), (4, 8, 512, 128),
                               (4, 8, 512, 128)))


@pytest.mark.cuda
def test_resolve_blocks_measures_and_persists_a_block_the_kernel_takes(
        card, torch_files, monkeypatch):
    from repro_torch.kernels import flash_attention as fa_k

    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "1")
    settings.reload()
    q, k, v = _train_qkv(card)
    want = ops.flash_attention(q, k, v, causal=True,
                               block_q=128, block_k=128)
    got = ops.flash_attention(q, k, v, causal=True)
    key = torch_files.AutotuneCache.key(
        "flash_attention", {"b": 4, "h": 16, "lq": 512, "lk": 512,
                            "d": 128}, "bfloat16")
    entry = torch_files.get_cache().entry(key)
    assert entry is not None and entry["_seconds"] > 0
    assert "_default" not in entry
    assert fa_k.takes_blocks(entry["q"], entry["k"], 128)
    rtol, atol = 2.0 ** -7, 2e-3
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
def test_dispatch_outside_collect_never_synchronises(card, torch_files,
                                                     monkeypatch):
    from repro_torch.core import costmodel
    from repro_torch.obs import trace

    syncs = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: syncs.append(1) or real(*a))
    a = torch.randn(256, 256, device=card)
    q, k, v = _train_qkv(card, 1)
    for _ in range(2):
        ops.matmul(a, a)
        ops.flash_attention(q, k, v, causal=True)
    costmodel.get_model().record("matmul", "cuda", seconds=1e-5,
                                 args=(a, a))
    with trace.TRACER.tracing():
        ops.matmul(a, a)
    assert syncs == []
    real()


@pytest.mark.cuda
def test_a_faster_torch_variant_is_not_selected_on_card_operands(
        card, torch_files):
    from repro_torch.core import costmodel

    a = torch.randn(128, 128, device=card)
    m = costmodel.get_model()
    m.record("matmul", "torch", seconds=1e-9, args=(a, a))
    m.record("matmul", "cuda", seconds=1.0, args=(a, a))
    assert registry.select("matmul", a, a).name == "cuda"
    rows = {r["variant"]: r for r in registry.explain("matmul", a, a)}
    assert rows["cuda"]["selected"]
    assert rows["torch"]["reason"].startswith("plane-unavailable")
    before = mm_k.matmul.launches
    ops.matmul(a, a)
    assert mm_k.matmul.launches == before + 1


@pytest.mark.cuda
def test_resolve_blocks_inside_capture_marks_defaults_without_a_sync(
        card, torch_files, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "1")
    settings.reload()
    measured, syncs = [], []

    def measure(bl):
        measured.append(bl)
        return 1.0

    x = torch.zeros(8, device=card)
    graph = torch.cuda.CUDAGraph()
    real = torch.cuda.synchronize
    # the graph context synchronises on entry and exit: count only what
    # the resolve does inside the capture
    with torch.cuda.graph(graph):
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda *a: syncs.append(1) or real(*a))
        got = torch_files.resolve_blocks(
            "_t_capture", {"n": 8}, "float32", {"k": 64}, ({"k": 32},),
            measure)
        monkeypatch.setattr(torch.cuda, "synchronize", real)
        x.add_(1.0)
    graph.replay()
    real()
    assert got == {"k": 64} and measured == [] and syncs == []
    key = torch_files.AutotuneCache.key("_t_capture", {"n": 8}, "float32")
    assert torch_files.get_cache().entry(key)["_default"] is True
    assert float(x[0]) == 1.0
