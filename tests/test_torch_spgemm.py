"""The port's SpGEMM (repro_torch.sparse.spgemm and the numeric-phase kernel
wrapper repro_torch.kernels.spgemm) against the JAX package's on the same
numpy inputs: symbolic plans identical to ``repro.sparse.spgemm_symbolic``,
and products held against the JAX ``bsr_xla`` variant and the dense oracle
``repro.kernels.ref.spgemm_bsr_ref`` at rtol 1e-5 / atol 1e-5 (1e-4 where a
banded operand's products reach larger magnitudes), the JAX suite's bars.

The JAX Pallas SpGEMM kernel (``bsr_interpret``) cannot run on this jax
(it calls ``pl.store``), so it is never the reference here.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import sparse as JS
from repro.kernels import ref as jref
from repro.numerics.sparse import banded_spd
from repro_torch import sparse as TS
from repro_torch.core import registry as treg
from repro_torch.kernels import spgemm as spgemm_k

CPU = "cpu"


def _blocked(n=128, block=8, frac=0.3, seed=2):
    rng = np.random.default_rng(seed)
    nb = n // block
    occ = rng.random((nb, nb)) < frac
    d = rng.standard_normal((n, n)).astype(np.float32)
    return np.where(np.kron(occ, np.ones((block, block), bool)), d, 0.0) \
        .astype(np.float32)


def _banded(n=128, bw=7, seed=1):
    return banded_spd(n, bw, seed=seed).astype(np.float32)


def _block_diagonal(n=64, bs=8, seed=5):
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n), np.float32)
    for i in range(n // bs):
        a[i * bs:(i + 1) * bs, i * bs:(i + 1) * bs] = \
            rng.standard_normal((bs, bs))
    return a


#: (label, A, B, atol): operand pairs covering clustered, banded, mixed,
#: block-diagonal and empty patterns.
def _pairs():
    return [
        ("clustered", _blocked(seed=3), _blocked(seed=4), 1e-5),
        ("clustered_sparse", _blocked(frac=0.05, seed=5),
         _blocked(frac=0.4, seed=6), 1e-5),
        ("mixed", _blocked(seed=7), _banded(seed=8), 1e-4),
        ("banded", _banded(128, 7, seed=6), _banded(128, 3, seed=7), 1e-4),
        ("block_diagonal", _block_diagonal(), _block_diagonal(seed=6), 1e-5),
        ("empty", np.zeros((64, 64), np.float32), _blocked(64), 1e-5),
    ]


PAIRS = {label: (a, b, atol) for label, a, b, atol in _pairs()}


def _both(a, b, block=8):
    return ((TS.bsr_from_dense(a, block=block, device=CPU),
             TS.bsr_from_dense(b, block=block, device=CPU)),
            (JS.bsr_from_dense(a, block=block),
             JS.bsr_from_dense(b, block=block)))


def _jax_dense_ref(ja, jb):
    return np.asarray(jref.spgemm_bsr_ref(
        ja.values, ja.cols, ja.rowp, jb.values, jb.cols, jb.rowp,
        a_shape=ja.shape, b_shape=jb.shape))


# ---------------------------------------------------------------------------
# symbolic phase
# ---------------------------------------------------------------------------

class TestSymbolic:
    @pytest.mark.parametrize("label", sorted(PAIRS))
    def test_plan_identical_to_jax(self, label):
        a, b, _ = PAIRS[label]
        (ta, tb), (ja, jb) = _both(a, b)
        tp, jp = TS.spgemm_symbolic(ta, tb), JS.spgemm_symbolic(ja, jb)
        # the port's plan keeps the pattern and the pair count, not the
        # pair lists (its numeric phases find each product's slot)
        for f in ("c_cols", "c_rowp"):
            got, want = getattr(tp, f), getattr(jp, f)
            np.testing.assert_array_equal(got, want, err_msg=f)
            assert got.dtype == np.int32, f
        assert (tp.nbrows, tp.nbcols, tp.nc, tp.npairs) == \
            (jp.nbrows, jp.nbcols, jp.nc, jp.npairs)

    def test_pair_count_within_stats_bound(self):
        (ta, tb), _ = _both(_blocked(seed=14), _blocked(seed=15))
        plan = TS.spgemm_symbolic(ta, tb)
        bound = ta.stats.product_block_bound(tb.stats)
        assert 0 < plan.npairs == bound

    def test_mismatched_operands_raise(self):
        a = TS.bsr_from_dense(_blocked(64), device=CPU)
        with pytest.raises(ValueError, match="inner dims"):
            TS.spgemm_symbolic(a, TS.bsr_from_dense(_blocked(128),
                                                    device=CPU))
        with pytest.raises(ValueError, match="block mismatch"):
            TS.spgemm_symbolic(a, TS.bsr_from_dense(_blocked(64), block=16,
                                                    device=CPU))


# ---------------------------------------------------------------------------
# numeric phase against bsr_xla and the dense oracle
# ---------------------------------------------------------------------------

class TestNumeric:
    @pytest.mark.parametrize("variant", [None, "bsr_torch", "dense"])
    @pytest.mark.parametrize("label", sorted(PAIRS))
    def test_matches_jax(self, label, variant):
        a, b, atol = PAIRS[label]
        (ta, tb), (ja, jb) = _both(a, b)
        got = TS.spgemm(ta, tb, variant=variant)
        want = JS.spgemm(ja, jb, variant="bsr_xla")
        assert isinstance(got, TS.BSR) and got.block == 8
        np.testing.assert_array_equal(got.cols.numpy(), np.asarray(want.cols))
        np.testing.assert_array_equal(got.rowp.numpy(), np.asarray(want.rowp))
        np.testing.assert_allclose(got.values.numpy(),
                                   np.asarray(want.values), rtol=1e-5,
                                   atol=atol)
        np.testing.assert_allclose(got.todense(), _jax_dense_ref(ja, jb),
                                   rtol=1e-5, atol=atol)

    @pytest.mark.parametrize("label", ["clustered", "banded", "empty"])
    def test_kernel_wrapper_plain_path_matches_jax(self, label):
        """The kernel wrapper on host tensors (its plain pair formulation,
        pairs enumerated in torch) equals the JAX pair formulation."""
        a, b, atol = PAIRS[label]
        (ta, tb), (ja, jb) = _both(a, b)
        plan = TS.spgemm_symbolic(ta, tb)
        before = spgemm_k.spgemm_bsr.launches
        vals = spgemm_k.spgemm_bsr(
            ta.values, ta.cols, ta.rowp, tb.values, tb.cols, tb.rowp,
            torch.as_tensor(plan.c_cols), torch.as_tensor(plan.c_rowp),
            ncols=tb.shape[1])
        assert spgemm_k.spgemm_bsr.launches == before     # no kernel here
        want = JS.spgemm(ja, jb, variant="bsr_xla").values
        assert vals.shape == (plan.nc, 8, 8) and vals.dtype == torch.float32
        np.testing.assert_allclose(vals.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=atol)

    @pytest.mark.parametrize("block", [16, 32])
    def test_larger_blocks_match_jax(self, block):
        a = _blocked(128, block=block, frac=0.3, seed=block)
        b = _blocked(128, block=block, frac=0.3, seed=block + 1)
        (ta, tb), (ja, jb) = _both(a, b, block=block)
        got = TS.spgemm(ta, tb)
        assert got.block == block
        np.testing.assert_allclose(
            got.values.numpy(),
            np.asarray(JS.spgemm(ja, jb, variant="bsr_xla").values),
            rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got.todense(), a @ b, rtol=1e-5,
                                   atol=1e-4)

    @pytest.mark.parametrize("fmt_a,fmt_b", [
        ("bsr", "bsr"), ("bsr", "csr"), ("csr", "bsr"), ("csr", "csr"),
        ("ell", "dia"), ("dia", "bsr")])
    def test_format_pairings_match_jax(self, fmt_a, fmt_b):
        A, B = _blocked(seed=2), _banded()
        got = TS.spgemm(TS.matrix(A, format=fmt_a, device=CPU),
                        TS.matrix(B, format=fmt_b, device=CPU))
        want = JS.spgemm(JS.matrix(A, format=fmt_a),
                         JS.matrix(B, format=fmt_b), variant="bsr_xla")
        assert isinstance(got, TS.BSR) and got.device.type == "cpu"
        np.testing.assert_allclose(got.todense(), want.todense(), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(got.todense(), A @ B, rtol=1e-5,
                                   atol=1e-4)

    def test_dense_host_operand_follows_the_other(self):
        A, B = _blocked(seed=2), _blocked(seed=9)
        got = TS.spgemm(TS.bsr_from_dense(A, device=CPU), B)
        assert got.device.type == "cpu"
        np.testing.assert_allclose(got.todense(), A @ B, rtol=1e-5,
                                   atol=1e-5)

    def test_empty_and_block_diagonal_patterns(self):
        (ta, tb), _ = _both(*PAIRS["empty"][:2])
        c = TS.spgemm(ta, tb)
        assert c.nblocks == 0 and c.values.shape == (0, 8, 8)
        np.testing.assert_array_equal(c.todense(), np.zeros((64, 64)))
        d = _block_diagonal()
        td = TS.bsr_from_dense(d, device=CPU)
        c = TS.spgemm(td, td)
        assert c.nblocks == 64 // 8
        np.testing.assert_allclose(c.todense(), d @ d, rtol=1e-5, atol=1e-5)

    def test_host_selection_and_pins(self):
        (ta, tb), _ = _both(_blocked(64), _blocked(64, seed=8))
        assert treg.select("spgemm", ta, tb).name == "bsr_torch"
        assert treg.select("spgemm", ta, tb, variant="dense").name == "dense"
        with pytest.raises(RuntimeError, match="host"):
            TS.spgemm(ta, tb, variant="bsr")


class TestStatsFields:
    def test_counts_identical(self):
        a = _blocked(seed=20)
        t, j = TS.sparse_stats(a, block=8), JS.sparse_stats(a, block=8)
        assert t.block_row_counts == j.block_row_counts
        assert t.block_col_counts == j.block_col_counts
        assert sum(t.block_row_counts) == t.nblocks

    def test_dataclass_fields_identical(self):
        assert [f.name for f in dataclasses.fields(TS.SparseStats)] == \
            [f.name for f in dataclasses.fields(JS.SparseStats)]


def test_spgemm_suite_flow_matches_jax():
    """The SpGEMM suite's flow (benchmarks/spgemm.py, its cases and seeds)
    at n = 256: clustered and banded cases through bsr_from_dense ->
    spgemm_symbolic -> spgemm, held to the suite's relative-error bar and to
    the JAX product."""
    n = 256
    cases = [(f"clustered_f{f}", _blocked(n, frac=f, seed=1),
              _blocked(n, frac=f, seed=2)) for f in (0.02, 0.08, 0.2)]
    cases += [(f"banded_bw{bw}", _banded(n, bw, seed=3), _banded(n, bw, seed=4))
              for bw in (31, 127)]
    for case, A, B in cases:
        (ta, tb), (ja, jb) = _both(A, B)
        assert TS.spgemm_symbolic(ta, tb).npairs == \
            JS.spgemm_symbolic(ja, jb).npairs
        ref = A @ B
        scale = max(1.0, float(np.abs(ref).max()))
        got = TS.spgemm(ta, tb).todense()
        assert float(np.abs(got - ref).max()) / scale < 1e-3, case
        want = JS.spgemm(ja, jb, variant="bsr_xla").todense()
        np.testing.assert_allclose(got / scale, want / scale, rtol=1e-5,
                                   atol=1e-5, err_msg=case)
