"""The port's blocked-sparse plane (repro_torch.sparse, block-CG in
repro_torch.numerics.solvers) against the JAX package's (repro.sparse,
repro.numerics.solvers) on the same numpy inputs: the statistics, BSR
storage and converters, the format selector, ``spmm`` on every format (the
JAX side on its ``xla`` and ``interpret`` planes), the ``solver_spmv`` seam,
block-CG, and the slice as a whole (the SpMM suite's flow at a small size).

Tolerances are the JAX suite's (tests/test_sparse.py): SpMM at rtol 1e-4 /
atol 1e-5, block-CG to a relative residual of 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as J
from repro import sparse as JS
from repro.core import registry as jreg
from repro.numerics import solvers as j_sol
from repro.numerics.sparse import banded_spd, random_sparse
from repro.numerics.sparse import csr_from_dense as j_csr_from_dense
import repro_torch.core as T
from repro_torch import sparse as TS
from repro_torch.core import registry as treg
from repro_torch.numerics import solvers as t_sol
from repro_torch.numerics.sparse import csr_from_dense as t_csr_from_dense

CPU = "cpu"


def _banded(n=256, bw=15, seed=1):
    return banded_spd(n, bw, seed=seed).astype(np.float32)


def _blocked(n=256, block=8, nblocks=60, seed=2):
    rng = np.random.default_rng(seed)
    nb = n // block
    a = np.zeros((n, n), np.float32)
    for p in rng.choice(nb * nb, size=nblocks, replace=False):
        i, j = divmod(int(p), nb)
        a[i * block:(i + 1) * block, j * block:(j + 1) * block] = \
            rng.standard_normal((block, block))
    return a


def _uniform(n=256, width=12, seed=3):
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n), np.float32)
    for i in range(n):
        a[i, rng.choice(n, size=width, replace=False)] = \
            rng.standard_normal(width)
    return a


def _ragged(n=256, seed=4):
    a = random_sparse(n, 2.0, seed=seed).astype(np.float32)
    rng = np.random.default_rng(seed)
    for i in rng.choice(n, size=3, replace=False):
        a[i, :] = rng.standard_normal(n)
    return a


CLASSES = {"banded": (_banded, "dia"), "blocked": (_blocked, "bsr"),
           "uniform": (_uniform, "ell"), "ragged": (_ragged, "csr")}


def _rhs(n, k=8, seed=0):
    return np.random.default_rng(seed).standard_normal((n, k)) \
        .astype(np.float32)


def _tb(x):
    return T.bind(x, device=CPU)


def _rel(a, x, b):
    return float((np.linalg.norm(a @ x - b, axis=0)
                  / np.linalg.norm(b, axis=0)).max())


# ---------------------------------------------------------------------------
# statistics + storage
# ---------------------------------------------------------------------------

class TestStats:
    @pytest.mark.parametrize("name", sorted(CLASSES))
    @pytest.mark.parametrize("block", [8, 16])
    def test_stats_identical(self, name, block):
        a = CLASSES[name][0]()
        ts = TS.sparse_stats(a, block=block)
        js = JS.sparse_stats(a, block=block)
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
        assert ts.describe() == js.describe()
        assert ts.row_nnz_cv == js.row_nnz_cv

    def test_product_block_bound_identical(self):
        a, b = _blocked(seed=5), _blocked(seed=6, nblocks=90)
        assert TS.sparse_stats(a).product_block_bound(TS.sparse_stats(b)) \
            == JS.sparse_stats(a).product_block_bound(JS.sparse_stats(b))
        with pytest.raises(ValueError, match="block mismatch"):
            TS.sparse_stats(a).product_block_bound(TS.sparse_stats(b, 16))

    def test_empty_matrix(self):
        z = np.zeros((32, 32), np.float32)
        assert dataclasses.asdict(TS.sparse_stats(z)) \
            == dataclasses.asdict(JS.sparse_stats(z))


class TestFormats:
    def test_block_pattern_identical(self):
        occ = np.random.default_rng(0).random((12, 9)) < 0.3
        occ[4] = False                              # an empty block-row
        for got, want in zip(TS.block_pattern(occ), JS.block_pattern(occ)):
            np.testing.assert_array_equal(got, np.asarray(want))
            assert got.dtype == np.int32

    @pytest.mark.parametrize("block", [8, 16, 32])
    def test_bsr_from_dense_identical(self, block):
        a = _blocked(block=block, nblocks=8, seed=block)
        t, j = TS.bsr_from_dense(a, block=block, device=CPU), \
            JS.bsr_from_dense(a, block=block)
        for f in ("values", "cols", "rowp"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)))
        assert t.cols.dtype == t.rowp.dtype == torch.int32
        assert (t.shape, t.block, t.nblocks, t.nnz, t.cost_dims()) == \
            (j.shape, j.block, j.nblocks, j.nnz, j.cost_dims())
        assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)

    def test_round_trips(self):
        a = _blocked(seed=7)
        t = TS.bsr_from_dense(a, device=CPU)
        np.testing.assert_array_equal(t.todense(), a)
        np.testing.assert_array_equal(t.todense(),
                                      JS.bsr_from_dense(a).todense())
        csr = TS.csr_from_bsr(t)
        assert isinstance(csr, TS.CSR) and csr.device.type == "cpu"
        np.testing.assert_array_equal(csr.todense(), a)
        tc = TS.bsr_from_csr(t_csr_from_dense(a, device=CPU))
        jc = JS.bsr_from_csr(j_csr_from_dense(a))
        for f in ("values", "cols", "rowp"):
            np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                          np.asarray(getattr(jc, f)))
        np.testing.assert_array_equal(tc.todense(), a)

    def test_bsr_requires_divisible_shape(self):
        a = np.ones((20, 20), np.float32)
        with pytest.raises(ValueError, match="tile"):
            TS.bsr_from_dense(a, block=8, device=CPU)
        with pytest.raises(ValueError, match="tile"):
            JS.bsr_from_dense(a, block=8)

    def test_empty_bsr(self):
        t = TS.bsr_from_dense(np.zeros((64, 64), np.float32), device=CPU)
        assert t.nblocks == 0 and t.values.shape == (0, 8, 8)
        assert t.rowp.tolist() == [0] * 9
        np.testing.assert_array_equal(t.todense(), np.zeros((64, 64)))

    def test_bsr_follows_the_device_rule(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TS.bsr_from_dense(_blocked(64, nblocks=4))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TS.matrix(_blocked(64, nblocks=4))


class TestSelector:
    @pytest.mark.parametrize("name", sorted(CLASSES))
    def test_statistics_pick_the_format(self, name):
        build, expect = CLASSES[name]
        a = build()
        t = TS.matrix(a, device=CPU)
        assert TS.format_of(t) == JS.format_of(JS.matrix(a)) == expect
        assert TS.select_format(TS.sparse_stats(a)) == expect
        assert dataclasses.asdict(t.stats) == \
            dataclasses.asdict(JS.matrix(a).stats)

    @pytest.mark.parametrize("edge", [8, 16, 32])
    def test_autotune_picks_the_clustering_granularity(self, edge):
        a = _blocked(256, block=edge, nblocks=(60 * 64) // (edge * edge),
                     seed=edge)
        t = TS.matrix(a, device=CPU)
        assert TS.format_of(t) == "bsr" and t.block == edge
        assert TS.autotune_block(a)[0] == JS.autotune_block(a)[0] == edge

    def test_explicit_format_and_block_pin(self):
        a = _blocked(256, block=16, nblocks=15, seed=5)
        assert TS.matrix(a, block=8, device=CPU).block == 8
        assert TS.matrix(a, device=CPU).block == 16
        for fmt in TS.FORMATS:
            assert TS.format_of(TS.matrix(_banded(64, 3), format=fmt,
                                          device=CPU)) == fmt
        with pytest.raises(ValueError, match="unknown sparse format"):
            TS.matrix(_banded(64, 3), format="coo", device=CPU)

    def test_indivisible_shape_is_not_bsr(self):
        a = np.zeros((30, 30), np.float32)
        a[:3, :3] = 1.0
        assert TS.format_of(TS.matrix(a, device=CPU)) \
            == JS.format_of(JS.matrix(a)) != "bsr"

    def test_constants_identical(self):
        from repro.sparse import selector as jsel
        from repro_torch.sparse import selector as tsel
        for name in ("FORMATS", "MIN_FILL", "BLOCKSPARSE_MAX_DENSITY",
                     "MAX_DIAGS", "BLOCK_CANDIDATES"):
            assert getattr(tsel, name) == getattr(jsel, name), name


# ---------------------------------------------------------------------------
# spmm against the JAX planes
# ---------------------------------------------------------------------------

class TestSpmm:
    @pytest.mark.parametrize("fmt", ["dia", "bsr", "ell", "csr"])
    @pytest.mark.parametrize("k", [1, 3, 16])
    def test_matches_jax_xla_plane(self, fmt, k):
        a = _blocked(seed=11) + _banded(seed=12)
        x = _rhs(256, k, seed=k)
        want = JS.spmm(JS.matrix(a, format=fmt), J.bind(x)).read()
        got = TS.spmm(TS.matrix(a, format=fmt, device=CPU), _tb(x)).read()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got, a @ x, rtol=1e-4, atol=1e-5)

    @pytest.mark.parametrize("fmt", ["bsr", "ell"])
    def test_matches_jax_interpret_kernels(self, fmt):
        a = _blocked(128, nblocks=20, seed=13)
        x = _rhs(128, 8, seed=13)
        jm = JS.matrix(a, format=fmt)
        with jreg.use_backend("interpret"):
            assert jreg.select("spmm", jm, J.bind(x)).plane == "interpret"
            want = JS.spmm(jm, J.bind(x)).read()
        got = TS.spmm(TS.matrix(a, format=fmt, device=CPU), _tb(x)).read()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    @pytest.mark.parametrize("name", sorted(CLASSES))
    def test_auto_selected_spmm_matches_jax(self, name):
        a = CLASSES[name][0]()
        x = _rhs(256, 8, seed=1)
        want = JS.spmm(JS.matrix(a), J.bind(x)).read()
        got = TS.spmm(TS.matrix(a, device=CPU), _tb(x)).read()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    def test_host_operands_select_the_torch_plane(self):
        a = _blocked(64, nblocks=6) + _banded(64, 3)
        x = _tb(_rhs(64, 4))
        names = {fmt: treg.select("spmm", TS.matrix(a, format=fmt,
                                                    device=CPU), x).name
                 for fmt in TS.FORMATS}
        assert names == {"dia": "dia", "bsr": "bsr_torch",
                         "ell": "ell_torch", "csr": "csr"}

    def test_pinned_kernel_on_host_raises(self):
        m = TS.matrix(_blocked(64, nblocks=6), format="bsr", device=CPU)
        with pytest.raises(RuntimeError, match="host"):
            TS.spmm(m, _tb(_rhs(64, 4)), variant="bsr")
        with T.use_backend("cuda"), pytest.raises(RuntimeError, match="host"):
            TS.spmm(m, _tb(_rhs(64, 4)))

    def test_variant_pin_agrees(self):
        a = _blocked(seed=3)
        x = _rhs(256, 8, seed=3)
        m = TS.matrix(a, device=CPU)
        np.testing.assert_allclose(
            TS.spmm(m, _tb(x), variant="bsr_torch").read(),
            TS.spmm(TS.matrix(a, format="csr", device=CPU), _tb(x),
                    variant="csr").read(), rtol=1e-5, atol=1e-5)

    def test_empty_bsr(self):
        m = TS.bsr_from_dense(np.zeros((64, 64), np.float32), device=CPU)
        y = TS.spmm(m, _tb(_rhs(64, 4))).read()
        np.testing.assert_array_equal(y, np.zeros((64, 4), np.float32))

    def test_rejects_vectors(self):
        with pytest.raises(ValueError, match="2-D RHS panel"):
            TS.spmm(TS.matrix(_banded(64, 3), device=CPU),
                    _tb(np.ones(64, np.float32)))

    @pytest.mark.parametrize("fmt", ["dia", "bsr", "ell", "csr"])
    def test_rejects_a_panel_of_the_wrong_height(self, fmt):
        m = TS.matrix(_banded(64, 3), format=fmt, device=CPU)
        for rows in (56, 72):
            with pytest.raises(ValueError, match="x has"):
                TS.spmm(m, _tb(_rhs(rows, 4)))
            with pytest.raises(ValueError, match="x has"):
                treg.dispatch("solver_spmv", m, _tb(_rhs(rows, 4)))


class TestSolverSeam:
    def test_2d_x_routes_to_spmm(self):
        a = _ragged(128)
        x2 = _rhs(128, 3)
        tm = TS.matrix(a, format="csr", device=CPU)
        assert treg.select("solver_spmv", tm, _tb(x2)).name == "spmm"
        got = treg.dispatch("solver_spmv", tm, _tb(x2)).read()
        want = jreg.dispatch("solver_spmv", JS.matrix(a, format="csr"),
                             J.bind(x2)).read()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    def test_1d_call_sites_untouched(self):
        a = _banded(64, 3)
        x1 = _tb(np.ones(64, np.float32))
        for fmt, name in (("csr", "spmv2"), ("ell", "ell"), ("dia", "dia")):
            assert treg.select("solver_spmv", TS.matrix(
                a, format=fmt, device=CPU), x1).name == name

    def test_bsr_single_vector_lift(self):
        n = 128
        a = _banded(n, 7, seed=3)
        b = np.random.default_rng(3).standard_normal(n).astype(np.float32)
        tm = TS.matrix(a, format="bsr", device=CPU)
        assert treg.select("solver_spmv", tm, _tb(b)).name == "spmm"
        res = t_sol.cg_solve(tm, _tb(b), stop=1e-12, max_iters=2 * n)
        jres = j_sol.cg_solve(JS.matrix(a, format="bsr"), J.bind(b),
                              stop=1e-12, max_iters=2 * n)
        x = res.x.read()
        assert np.linalg.norm(a @ x - b) / np.linalg.norm(b) < 1e-5
        np.testing.assert_allclose(x, jres.x.read(), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# block-CG
# ---------------------------------------------------------------------------

class TestBlockCG:
    @pytest.mark.parametrize("n,bw", [(128, 3), (256, 31)])
    def test_converges_on_table2_like_jax(self, n, bw):
        a = banded_spd(n, bw, seed=n + bw).astype(np.float32)
        b = _rhs(n, 4, seed=n)
        res = t_sol.cg_block_solve(TS.matrix(a, device=CPU), _tb(b),
                                   stop=1e-12, max_iters=2 * n)
        jres = j_sol.cg_block_solve(JS.matrix(a), b, stop=1e-12,
                                    max_iters=2 * n)
        x = res.x.read()
        assert x.shape == (n, 4) and _rel(a, x, b) < 1e-5
        np.testing.assert_allclose(x, jres.x.read(), rtol=1e-4, atol=1e-5)
        assert abs(int(res.iterations) - int(jres.iterations)) <= 1
        assert res.residual_sq.shape == (4,)

    @pytest.mark.parametrize("fmt", ["bsr", "ell", "csr"])
    def test_pinned_formats_match_jax(self, fmt):
        n = 128
        a = banded_spd(n, 15, seed=9).astype(np.float32)
        b = _rhs(n, 4, seed=9)
        res = t_sol.cg_block_solve(TS.matrix(a, format=fmt, device=CPU),
                                   _tb(b), stop=1e-12, max_iters=2 * n)
        jres = j_sol.cg_block_solve(JS.matrix(a, format=fmt), b,
                                    stop=1e-12, max_iters=2 * n)
        assert _rel(a, res.x.read(), b) < 1e-5
        np.testing.assert_allclose(res.x.read(), jres.x.read(), rtol=1e-4,
                                   atol=1e-5)

    def test_shares_one_krylov_space(self):
        n, bw = 256, 31
        a = banded_spd(n, bw, seed=7).astype(np.float32)
        b = _rhs(n, 4, seed=7)
        blk = t_sol.cg_block_solve(TS.matrix(a, device=CPU), _tb(b),
                                   stop=1e-12, max_iters=2 * n)
        singles = [t_sol.cg_solve(TS.matrix(a, format="dia", device=CPU),
                                  _tb(b[:, j]), stop=1e-12,
                                  max_iters=2 * n).iterations
                   for j in range(4)]
        assert int(blk.iterations) <= max(int(s) for s in singles)

    def test_duplicate_columns_no_nan(self):
        n = 256
        a = _banded(n, 31, seed=1)
        b = _rhs(n, 4, seed=0)
        b[:, 1] = b[:, 0]
        b[:, 3] = 2.0 * b[:, 2]
        res = t_sol.cg_block_solve(TS.matrix(a, device=CPU), _tb(b),
                                   stop=1e-10, max_iters=2 * n)
        x = res.x.read()
        assert np.isfinite(x).all()
        assert _rel(a, x, b) < 1e-5
        np.testing.assert_allclose(x[:, 1], x[:, 0], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(x[:, 3], 2.0 * x[:, 2], rtol=1e-5,
                                   atol=1e-6)
        jx = j_sol.cg_block_solve(JS.matrix(a), b, stop=1e-10,
                                  max_iters=2 * n).x.read()
        np.testing.assert_allclose(x, jx, rtol=1e-4, atol=1e-5)

    def test_converged_column_freezes_others_continue(self):
        n = 256
        a = _banded(n, 31, seed=2)
        b = _rhs(n, 4, seed=2)
        b[:, 2] = 0.0
        res = t_sol.cg_block_solve(TS.matrix(a, device=CPU), _tb(b),
                                   stop=1e-8, max_iters=2 * n)
        x = res.x.read()
        assert np.isfinite(x).all()
        np.testing.assert_allclose(x[:, 2], 0.0, atol=1e-6)
        live = [0, 1, 3]
        assert _rel(a, x[:, live], b[:, live]) < 1e-5

    def test_full_rank_panel_unchanged(self):
        n, bw = 256, 31
        a = banded_spd(n, bw, seed=7).astype(np.float32)
        b = _rhs(n, 4, seed=7)
        res = t_sol.cg_block_solve(TS.matrix(a, device=CPU), _tb(b),
                                   stop=1e-12, max_iters=2 * n)
        assert _rel(a, res.x.read(), b) < 1e-5
        assert int(res.iterations) < n // 4

    def test_rejects_vector_rhs(self):
        with pytest.raises(ValueError, match="RHS panel"):
            t_sol.cg_block_solve(TS.matrix(_banded(64, 3), device=CPU),
                                 _tb(np.ones(64, np.float32)))

    def test_rejects_a_panel_of_the_wrong_height(self):
        with pytest.raises(ValueError, match="b has 56 rows"):
            t_sol.cg_block_solve(TS.matrix(_banded(64, 3), format="bsr",
                                           device=CPU), _tb(_rhs(56, 4)))


# ---------------------------------------------------------------------------
# the slice as a whole: the SpMM suite's flow (benchmarks/spmm.py) at n=256
# ---------------------------------------------------------------------------

def test_spmm_suite_flow_matches_jax():
    """Each format class through matrix -> spmm at the suite's two panel
    widths, then block-CG on a Table-2 system: the same formats, products
    within the JAX bar of each other and of the dense oracle, and the
    suite's convergence bar."""
    rng = np.random.default_rng(0)
    for name, (build, expect) in sorted(CLASSES.items()):
        a = build()
        tm, jm = TS.matrix(a, device=CPU), JS.matrix(a)
        assert TS.format_of(tm) == JS.format_of(jm) == expect
        for k in (8, 16):
            x = rng.standard_normal((256, k)).astype(np.float32)
            got = TS.spmm(tm, _tb(x)).read()
            np.testing.assert_allclose(got, JS.spmm(jm, J.bind(x)).read(),
                                       rtol=1e-4, atol=1e-5)
            assert np.abs(got - a @ x).max() < 1e-3
    cn, bw, k = 256, 31, 4
    a = banded_spd(cn, bw, seed=cn + bw).astype(np.float32)
    b = np.random.default_rng(cn).standard_normal((cn, k)).astype(np.float32)
    res = t_sol.cg_block_solve(TS.matrix(a, device=CPU), _tb(b), stop=1e-12,
                               max_iters=2 * cn)
    assert _rel(a, res.x.read(), b) < 1e-5
