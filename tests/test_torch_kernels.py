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
from repro_torch.kernels import spmv as spmv_k

@pytest.fixture
def jax_ops():
    """The JAX package's entry points and oracles, imported on use."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops, ref as jref

    return jnp, jops, jref


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
@pytest.mark.parametrize("logn", [20, 10, 1])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_fft_kernel_matches_plain(logn, dtype, card):
    n = 1 << logn
    g = torch.Generator(device=card).manual_seed(logn)
    z = torch.randn(n, dtype=dtype, device=card, generator=g)
    got = ops.fft(z)
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
