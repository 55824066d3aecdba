"""The carry-across function (repro_torch.interop.carry): the JAX package's
containers become the port's with the same arrays, and an operation on the
carried objects agrees with the same operation in the JAX package."""
import numpy as np
import pytest
import torch

import repro.core as J
from repro.numerics import sparse as j_sp, spmv as j_spmv
from repro_torch import interop
from repro_torch.numerics import sparse as t_sp, spmv as t_spmv

CPU = "cpu"


@pytest.fixture
def matrix():
    return j_sp.random_sparse(48, 10.0, seed=9)


def test_carry_csr(matrix):
    jc = j_sp.csr_from_dense(matrix)
    tc = interop.carry(jc, device=CPU)
    assert isinstance(tc, t_sp.CSR) and tc.shape == jc.shape
    for f in ("matvals", "indx", "rowp"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)))
    assert tc.indx.dtype == tc.rowp.dtype == torch.int32
    x = np.random.default_rng(0).standard_normal(48).astype(np.float32)
    np.testing.assert_allclose(
        t_spmv.arbb_spmv2(tc, interop.carry(J.bind(x), device=CPU)).read(),
        j_spmv.arbb_spmv2(jc, J.bind(x)).read(), rtol=1e-4, atol=1e-4)


def test_carry_ell_and_dia(matrix):
    je = j_sp.ell_from_csr(j_sp.csr_from_dense(matrix), pad_to=4)
    te = interop.carry(je, device=CPU)
    assert isinstance(te, t_sp.ELL) and te.width == je.width
    np.testing.assert_array_equal(te.values.numpy(), np.asarray(je.values))
    np.testing.assert_array_equal(te.cols.numpy(), np.asarray(je.cols))
    band = j_sp.banded_spd(30, 4, seed=1)
    jd = j_sp.dia_from_dense(band)
    td = interop.carry(jd, device=CPU)
    assert isinstance(td, t_sp.DIA) and td.offsets == jd.offsets
    np.testing.assert_array_equal(td.diags.numpy(), np.asarray(jd.diags))


def test_carry_numpy_fields_and_arrays():
    """Fields given as plain numpy arrays (no JAX object at all) carry the
    same way; float64 narrows to float32 unless a dtype is asked for."""
    class Fields:
        matvals = np.array([1.0, 2.0, 3.0])
        indx = np.array([0, 2, 1], np.int64)
        rowp = np.array([0, 2, 2, 3], np.int64)
        shape = (3, 3)

    tc = interop.carry(Fields(), device=CPU)
    assert tc.matvals.dtype == torch.float32 and tc.indx.dtype == torch.int32
    np.testing.assert_array_equal(tc.todense(),
                                  [[1, 0, 2], [0, 0, 0], [0, 3, 0]])
    d = interop.carry(np.arange(4.0), device=CPU)
    assert d.dtype == torch.float32 and d.shape == (4,)
    d = interop.carry(np.arange(4.0), device=CPU, dtype=torch.float64)
    assert d.dtype == torch.float64
    z = interop.carry(J.bind(np.ones(4, np.complex64)), device=CPU)
    assert z.dtype == torch.complex64


def test_carry_follows_the_device_rule(monkeypatch, matrix):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.carry(j_sp.csr_from_dense(matrix))


def test_carry_bsr_is_not_mistaken_for_ell():
    """A BSR has ELL's fields (values, cols, shape) too; it must come
    across as a BSR, with its block, arrays and statistics."""
    import dataclasses

    from repro import sparse as j_sparse
    from repro_torch import sparse as t_sparse

    a = np.zeros((64, 64), np.float32)
    a[:8, 8:16] = 1.0
    a[40:48, :8] = np.arange(64, dtype=np.float32).reshape(8, 8)
    jb = j_sparse.bsr_from_dense(a, block=8)
    tb = interop.carry(jb, device=CPU)
    assert isinstance(tb, t_sparse.BSR) and not isinstance(tb, t_sp.ELL)
    assert (tb.shape, tb.block, tb.nblocks) == (jb.shape, jb.block,
                                                jb.nblocks)
    for f in ("values", "cols", "rowp"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)))
    assert tb.cols.dtype == tb.rowp.dtype == torch.int32
    np.testing.assert_array_equal(tb.todense(), a)
    assert isinstance(tb.stats, t_sparse.SparseStats)
    assert dataclasses.asdict(tb.stats) == dataclasses.asdict(jb.stats)
    # the carried statistics feed the symbolic phase's bound check
    plan = t_sparse.spgemm_symbolic(tb, tb)
    assert plan.npairs <= tb.stats.product_block_bound(tb.stats)


def test_carry_bsr_without_stats():
    import dataclasses

    from repro import sparse as j_sparse

    jb = j_sparse.bsr_from_dense(np.eye(16, dtype=np.float32), block=8)
    tb = interop.carry(dataclasses.replace(jb, stats=None), device=CPU)
    assert tb.stats is None and tb.nblocks == 2


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_carry_params_gives_jax_logits(param_dtype):
    """JAX LM.init parameters carried over: per-layer weights in the same
    (in, out) layout, and the port's logits within 1e-5 of JAX's (f32
    activations; bf16 parameters carry exactly through f32)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.models.lm import LM as JLM
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM

    def small(cfg):
        return dataclasses.replace(
            cfg, num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=96, vocab_size=300, dtype="float32",
            param_dtype=param_dtype)

    jcfg, tcfg = small(j_get_config("qwen3-1.7b")), small(
        get_config("qwen3-1.7b"))
    jlm = JLM(jcfg)
    jp = jlm.init(jax.random.PRNGKey(3))
    tp = interop.carry_params(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                              device=CPU)
    assert len(tp["layers"]) == 3 and "unembed" not in tp
    wq = tp["layers"][1]["attn"]["wq"]
    assert wq.dtype == tcfg.pdtype and wq.shape == (64, 4 * 16)
    np.testing.assert_array_equal(
        wq.float().numpy(),
        np.asarray(jp["layers"]["attn"]["wq"][1], np.float32))
    tok = np.random.default_rng(4).integers(0, 300, (2, 10)).astype(np.int32)
    want, _ = jlm.forward(jp, jnp.asarray(tok))
    got, _ = LM(tcfg).forward(tp, torch.as_tensor(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
