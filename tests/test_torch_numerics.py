"""The port's numerics (repro_torch.numerics) against the JAX package's
(repro.numerics) on the same numpy inputs: the paper's input generators and
sparse formats, mod2am, mod2as, mod2f, the solvers, and the slice as a
whole (the four paper sections of examples/euroben_suite.py at small
sizes)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.numerics import fft as j_fft, matmul as j_mm, solvers as j_sol
from repro.numerics import sparse as j_sp, spmv as j_spmv
from repro_torch.kernels import ops as t_ops
from repro_torch.numerics import fft as t_fft, matmul as t_mm
from repro_torch.numerics import solvers as t_sol, sparse as t_sp
from repro_torch.numerics import spmv as t_spmv

CPU = "cpu"


def _tb(x):
    return T.bind(x, device=CPU)


class TestSparse:
    @pytest.mark.parametrize("n,fill,seed", [(100, 3.5, 0), (256, 5.0, 7),
                                             (37, 20.0, 3)])
    def test_random_sparse_identical(self, n, fill, seed):
        np.testing.assert_array_equal(t_sp.random_sparse(n, fill, seed),
                                      j_sp.random_sparse(n, fill, seed))

    @pytest.mark.parametrize("n,bw,seed", [(128, 3, 0), (64, 31, 5),
                                           (33, 32, 1)])
    def test_banded_spd_identical(self, n, bw, seed):
        np.testing.assert_array_equal(t_sp.banded_spd(n, bw, seed),
                                      j_sp.banded_spd(n, bw, seed))

    def test_paper_tables_identical(self):
        assert tuple(t_sp.MOD2AS_TABLE1) == tuple(j_sp.MOD2AS_TABLE1)
        assert tuple(t_sp.CG_TABLE2) == tuple(j_sp.CG_TABLE2)

    @pytest.mark.parametrize("pad_to", [1, 8])
    def test_converters_identical(self, pad_to):
        a = j_sp.random_sparse(60, 8.0, seed=4)
        a[7] = 0.0                                    # an empty row
        jc, tc = j_sp.csr_from_dense(a), t_sp.csr_from_dense(a, device=CPU)
        for f in ("matvals", "indx", "rowp"):
            np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                          np.asarray(getattr(jc, f)))
        assert tc.matvals.dtype == torch.float32 and tc.nnz == jc.nnz
        np.testing.assert_array_equal(tc.todense(), jc.todense())
        np.testing.assert_array_equal(
            t_sp.csr_row_ids(tc.rowp, tc.nnz).numpy(),
            np.asarray(j_sp.csr_row_ids(jc.rowp, jc.nnz)))
        je = j_sp.ell_from_csr(jc, pad_to=pad_to)
        te = t_sp.ell_from_csr(tc, pad_to=pad_to)
        np.testing.assert_array_equal(te.values.numpy(), np.asarray(je.values))
        np.testing.assert_array_equal(te.cols.numpy(), np.asarray(je.cols))
        assert te.width == je.width and te.cols.dtype == torch.int32
        with pytest.raises(ValueError, match="ELL width"):
            t_sp.ell_from_csr(tc, width=1)

    def test_dia_identical(self):
        a = j_sp.banded_spd(40, 5, seed=2)
        jd, td = j_sp.dia_from_dense(a), t_sp.dia_from_dense(a, device=CPU)
        assert td.offsets == jd.offsets and td.shape == jd.shape
        np.testing.assert_array_equal(td.diags.numpy(), np.asarray(jd.diags))


class TestMod2am:
    @pytest.mark.parametrize("n", [10, 33])
    def test_variants_match_jax(self, n):
        rng = np.random.default_rng(n)
        a = rng.standard_normal((n, n)).astype(np.float32)
        b = rng.standard_normal((n, n)).astype(np.float32)
        for name in ("arbb_mxm0", "arbb_mxm1", "arbb_mxm2a", "arbb_mxm2b"):
            got = getattr(t_mm, name)(_tb(a), _tb(b)).read()
            want = getattr(j_mm, name)(J.bind(a), J.bind(b)).read()
            np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3,
                                       err_msg=name)
        np.testing.assert_allclose(t_mm.mxm_torch(_tb(a), _tb(b)).read(),
                                   a @ b, rtol=2e-3, atol=2e-3)

    @pytest.mark.parametrize("u", [1, 3, 5, 32])
    def test_mxm2b_unroll_u(self, u):
        rng = np.random.default_rng(1)
        a = rng.standard_normal((20, 20)).astype(np.float32)
        b = rng.standard_normal((20, 20)).astype(np.float32)
        got = t_mm.mxm2b(_tb(a), _tb(b), u).read()
        want = j_mm.mxm2b(J.bind(a), J.bind(b), u).read()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


class TestMod2as:
    @pytest.mark.parametrize("n,fill", [(100, 3.5), (256, 5.0)])
    def test_spmv_formulations_match_jax(self, n, fill):
        a = t_sp.random_sparse(n, fill, seed=n)
        x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
        jc, tc = j_sp.csr_from_dense(a), t_sp.csr_from_dense(a, device=CPU)
        je, te = j_sp.ell_from_csr(jc), t_sp.ell_from_csr(tc)
        pairs = [(t_spmv.arbb_spmv1(tc, _tb(x)), j_spmv.arbb_spmv1(jc, J.bind(x))),
                 (t_spmv.arbb_spmv2(tc, _tb(x)), j_spmv.arbb_spmv2(jc, J.bind(x))),
                 (t_spmv.spmv_ell(te, _tb(x)), j_spmv.spmv_ell(je, J.bind(x))),
                 (t_spmv.spmv1(tc, _tb(x)), j_spmv.spmv1(jc, J.bind(x)))]
        for got, want in pairs:
            np.testing.assert_allclose(got.read(), np.asarray(want.data),
                                       rtol=1e-4, atol=1e-4)

    def test_dia_and_panel_match_jax(self):
        a = t_sp.banded_spd(64, 3, seed=7)
        rng = np.random.default_rng(3)
        x = rng.standard_normal(64).astype(np.float32)
        jd, td = j_sp.dia_from_dense(a), t_sp.dia_from_dense(a, device=CPU)
        np.testing.assert_allclose(t_spmv.spmv_dia(td, _tb(x)).read(),
                                   np.asarray(j_spmv.spmv_dia(jd, J.bind(x)).data),
                                   rtol=1e-4, atol=1e-4)
        xf = rng.standard_normal((70, 3)).astype(np.float32)
        for row0 in (0, 6):
            got = t_spmv.dia_panel(td.diags, td.offsets, torch.as_tensor(xf),
                                   row0)
            want = j_spmv.dia_panel(jd.diags, jd.offsets, jnp.asarray(xf),
                                    row0)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-4)

    def test_solver_spmv_selection_by_layout(self):
        a = t_sp.banded_spd(16, 2, seed=0)
        x = _tb(np.ones(16, np.float32))
        from repro_torch.core import registry
        tc = t_sp.csr_from_dense(a, device=CPU)
        assert registry.select("solver_spmv", tc, x).name == "spmv2"
        assert registry.select("solver_spmv", t_sp.ell_from_csr(tc), x).name == "ell"
        assert registry.select("solver_spmv", t_sp.dia_from_dense(a, device=CPU),
                               x).name == "dia"
        # a 2-D x takes the multi-RHS route of the blocked-sparse plane
        assert registry.select("solver_spmv", tc,
                               _tb(np.ones((16, 2)))).name == "spmm"


class TestMod2f:
    def test_tables_identical(self):
        for n in (2, 4, 64, 1024):
            np.testing.assert_array_equal(t_fft.bitrev_permutation(n),
                                          j_fft.bitrev_permutation(n))
            np.testing.assert_array_equal(t_fft.split_stream_twiddles(n),
                                          j_fft.split_stream_twiddles(n))
        with pytest.raises(ValueError):
            t_fft.bitrev_permutation(12)

    @pytest.mark.parametrize("n", [8, 256])
    def test_forms_match_jax(self, n):
        rng = np.random.default_rng(n)
        z = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
            np.complex64)
        for name in ("split_stream_fft", "stockham_fft", "naive_radix2_fft",
                     "dft_ref"):
            got = getattr(t_fft, name)(_tb(z)).read()
            want = getattr(j_fft, name)(J.bind(z)).read()
            np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-3 * n,
                                       err_msg=name)
            assert got.dtype == np.complex64

    def test_stage_loop_is_gather_free(self):
        n = 64
        tw = t_fft.split_stream_twiddles(n).astype(np.complex64)
        cl = T.capture(t_fft.arbb_fft, T.Dense.zeros(n, torch.complex64,
                                                     device=CPU), _tb(tw))
        assert cl.gather_free(), cl.op_counts()


class TestSolvers:
    N, BW = 128, 31              # paper Table 2, conf 2

    @pytest.fixture
    def system(self):
        a = t_sp.banded_spd(self.N, self.BW, seed=self.N + self.BW)
        b = np.random.default_rng(self.N).standard_normal(self.N).astype(
            np.float32)
        return a, b

    @pytest.mark.parametrize("backend", ["spmv1", "spmv2", "ell", "dia", None])
    def test_cg_matches_jax(self, system, backend):
        a, b = system
        if backend == "dia":
            jm, tm = j_sp.dia_from_dense(a), t_sp.dia_from_dense(a, device=CPU)
        else:
            jm, tm = j_sp.csr_from_dense(a), t_sp.csr_from_dense(a, device=CPU)
            if backend == "ell":
                jm, tm = j_sp.ell_from_csr(jm), t_sp.ell_from_csr(tm)
        want = j_sol.cg_solve(jm, J.bind(b), stop=1e-10, max_iters=2 * self.N,
                              backend=backend)
        got = t_sol.cg_solve(tm, _tb(b), stop=1e-10, max_iters=2 * self.N,
                             backend=backend)
        x = got.x.read()
        np.testing.assert_allclose(x, want.x.read(), rtol=1e-4, atol=1e-4)
        # sums run in another order, so the stopping step may move
        assert abs(int(got.iterations) - int(want.iterations)) <= 2
        assert got.iterations.dtype == torch.int32
        assert np.linalg.norm(a @ x - b) / np.linalg.norm(b) < 1e-5

    def test_cg_jit_matches_cg_solve(self, system):
        a, b = system
        dia = t_sp.dia_from_dense(a, device=CPU)
        x, r2, k = t_sol.cg_jit(dia, _tb(b), 1e-10, 2 * self.N, "dia")
        res = t_sol.cg_solve(dia, _tb(b), stop=1e-10, max_iters=2 * self.N,
                             backend="dia")
        np.testing.assert_array_equal(x.numpy(), res.x.read())
        assert int(k) == int(res.iterations)

    def test_cg_max_iters_caps(self, system):
        a, b = system
        res = t_sol.cg_solve(t_sp.dia_from_dense(a, device=CPU), _tb(b),
                             stop=0.0, max_iters=3)
        assert int(res.iterations) == 3

    def test_jacobi_gauss_seidel_match_jax(self):
        a = t_sp.banded_spd(32, 2, seed=5)
        b = np.random.default_rng(2).standard_normal(32).astype(np.float32)
        np.testing.assert_allclose(
            t_sol.jacobi_solve(a, _tb(b), iters=60).read(),
            j_sol.jacobi_solve(a, J.bind(b), iters=60).read(),
            rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(
            t_sol.gauss_seidel_solve(a, _tb(b), iters=10).read(),
            j_sol.gauss_seidel_solve(a, J.bind(b), iters=10).read(),
            rtol=1e-4, atol=1e-4)


def test_euroben_slice_through_both_packages():
    """The four paper sections of examples/euroben_suite.py at small sizes,
    through both packages, each held against the other and the example's
    own oracle and bar."""
    rng = np.random.default_rng(0)

    n = 64                                               # mod2am
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    got = t_mm.arbb_mxm2b(_tb(a), _tb(b)).read()
    want = j_mm.arbb_mxm2b(J.bind(a), J.bind(b)).read()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, a @ b, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(t_ops.matmul(torch.as_tensor(a),
                                            torch.as_tensor(b)).numpy(),
                               a @ b, rtol=2e-3, atol=2e-3)

    n = 128                                              # mod2as
    A = t_sp.random_sparse(n, 4.0, seed=1)
    x = rng.standard_normal(n).astype(np.float32)
    got = t_spmv.arbb_spmv2(t_sp.csr_from_dense(A, device=CPU), _tb(x)).read()
    want = j_spmv.arbb_spmv2(j_sp.csr_from_dense(A), J.bind(x)).read()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, A @ x, rtol=1e-3, atol=1e-3)

    n = 512                                              # mod2f
    z = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    got = t_fft.split_stream_fft(_tb(z)).read()
    want = j_fft.split_stream_fft(J.bind(z)).read()
    for g in (got, t_ops.fft(torch.as_tensor(z)).numpy()):
        np.testing.assert_allclose(g, want, rtol=1e-2, atol=1e-3 * n)
        np.testing.assert_allclose(g, np.fft.fft(z), rtol=1e-2, atol=1e-3 * n)

    n, bw = 128, 7                                       # cg
    A = t_sp.banded_spd(n, bw, seed=2)
    bvec = rng.standard_normal(n).astype(np.float32)
    got = t_sol.cg_solve(t_sp.dia_from_dense(A, device=CPU), _tb(bvec),
                         stop=1e-10, max_iters=2 * n, backend="dia")
    want = j_sol.cg_solve(j_sp.dia_from_dense(A), J.bind(bvec), stop=1e-10,
                          max_iters=2 * n, backend="dia")
    np.testing.assert_allclose(got.x.read(), want.x.read(), rtol=1e-4,
                               atol=1e-4)
    assert abs(int(got.iterations) - int(want.iterations)) <= 2
    rel = np.linalg.norm(A @ got.x.read() - bvec) / np.linalg.norm(bvec)
    assert rel < 1e-5
