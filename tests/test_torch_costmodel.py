"""The port's measured cost model, block cache and calibrated dispatch
(repro_torch.core.costmodel, core.blocking, core.registry) against the JAX
package's (tests/test_costmodel.py at chip scope; the mesh cases wait for
mesh scope), and launch.train's named depth.

Contracts: for the same numpy inputs the port's exact and class keys equal
the reference's letter for letter; with the same seconds injected into
both models, ``select`` and ``explain`` pick the same variant names; a
calibrated variant never crosses the device rule; a singleton never
re-ranks; a plane request disables calibration; ``record`` drops a
memoised ranking; blocks outside the kernels' domain are excluded by rule
and a cache entry holding one raises; nothing catches a measurement that
fails.  Every test points the port's files at ``tmp_path``.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sparse as JS
from repro.core import bind as jbind
from repro.core import costmodel as jcm
from repro.core import registry as jreg
from repro.numerics import sparse as jsp
from repro.sparse.maskcompiler import MaskSpec as JMask
from repro_torch.core import bind as tbind
from repro_torch.core import blocking, costmodel, registry, settings
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import ops
from repro_torch.numerics import sparse as tsp
from repro_torch.sparse import formats as tfmt
from repro_torch.sparse.maskcompiler import MaskSpec

CPU = "cpu"


@pytest.fixture(autouse=True)
def _torch_files(monkeypatch, tmp_path):
    """The port's model and block cache in ``tmp_path``, autotune off, and
    no plane requested on either side (./test.sh's REPRO_KERNELS would
    disable the JAX side's calibration).  The port reads its variables at
    ``settings.reload()``, here and after every change, and again once
    they are restored."""
    monkeypatch.setenv("REPRO_TORCH_COSTMODEL", str(tmp_path / "cm.json"))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "at.json"))
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE", raising=False)
    settings.reload()
    monkeypatch.delenv("REPRO_KERNELS", raising=False)
    yield
    monkeypatch.undo()
    settings.reload()


def _on_card(monkeypatch):
    """Selection as it runs on CUDA operands: ``device_type_of`` says
    'cuda' (select and explain run nothing, so host tensors do)."""
    monkeypatch.setattr(registry, "device_type_of", lambda *a: "cuda")


def _keys(cm, op, args, kwargs):
    dims = cm.signature(args, kwargs)
    dtype = cm.dtype_of(args)
    return cm.CostModel.key(op, dims, dtype), \
        cm.CostModel.class_key(op, dims, dtype)


# ---------------------------------------------------------------------------
# keys: letter for letter the reference's
# ---------------------------------------------------------------------------

def _key_cases():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((16, 24)).astype(np.float32)
    b = rng.standard_normal((24, 8)).astype(np.float32)
    spd = jsp.banded_spd(60, 3, seed=1).astype(np.float32)
    x = rng.standard_normal(60).astype(np.float32)
    occ = np.kron(rng.random((8, 8)) < 0.3, np.ones((8, 8)))
    bd = (occ * rng.standard_normal((64, 64))).astype(np.float32)
    xp = rng.standard_normal((64, 8)).astype(np.float32)
    q = rng.standard_normal((1, 4, 64, 32)).astype(np.float32)
    k = rng.standard_normal((1, 2, 64, 32)).astype(np.float32)
    out = {
        "matmul": (
            lambda: ((jnp.asarray(a), jnp.asarray(b)), {}),
            lambda: ((torch.from_numpy(a), torch.from_numpy(b)), {})),
        "solver_spmv": (
            lambda: ((jsp.csr_from_dense(spd), jbind(x)), {}),
            lambda: ((tsp.csr_from_dense(spd, device=CPU),
                      tbind(x, device=CPU)), {})),
        "spmm": (
            lambda: ((JS.bsr_from_dense(bd, block=8), jbind(xp)), {}),
            lambda: ((tfmt.bsr_from_dense(bd, block=8, device=CPU),
                      tbind(xp, device=CPU)), {})),
    }
    for dt, jdt, tdt in (("f32", jnp.float32, torch.float32),
                         ("bf16", jnp.bfloat16, torch.bfloat16)):
        out[f"flash_attention_{dt}"] = (
            lambda jdt=jdt: (tuple(jnp.asarray(t, jdt) for t in (q, k, k)),
                             dict(causal=True,
                                  mask=JMask(causal=True, window=16),
                                  block_q=None, block_k=None)),
            lambda tdt=tdt: (tuple(torch.from_numpy(t).to(tdt)
                                   for t in (q, k, k)),
                             dict(causal=True,
                                  mask=MaskSpec(causal=True, window=16),
                                  block_q=None, block_k=None)))
    return out


KEY_CASES = _key_cases()


@pytest.mark.parametrize("name", sorted(KEY_CASES))
def test_keys_equal_the_reference(name):
    jmake, tmake = KEY_CASES[name]
    op = name.split("_f")[0] if name.startswith("flash") else name
    jargs, jkw = jmake()
    targs, tkw = tmake()
    assert _keys(costmodel, op, targs, tkw) == _keys(jcm, op, jargs, jkw)


def test_dtype_names_are_numpy_names():
    for dt, want in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16"),
                     (torch.complex64, "complex64"), (torch.int32, "int32")):
        assert costmodel.dtype_of(("x", torch.zeros(1, dtype=dt))) == want
    assert costmodel.dtype_of(("x", 3)) == "-"
    sig = costmodel.signature((torch.ones(4, 6), 3, "cfg"),
                              {"causal": True, "tag": "x"})
    assert sig == {"a0.0": 4, "a0.1": 6, "causal": 1}


def test_arg_bytes_counts_container_arrays_once():
    spd = jsp.banded_spd(32, 2, seed=2).astype(np.float32)
    csr = tsp.csr_from_dense(spd, device=CPU)
    x = tbind(np.ones(32, np.float32), device=CPU)
    want = sum(t.nbytes for t in (csr.matvals, csr.indx, csr.rowp, x.data))
    assert costmodel.arg_bytes((csr, x)) == want
    assert costmodel.arg_bytes((csr, x, (x, csr.matvals))) == want
    a = torch.ones(4, 6)
    assert costmodel.arg_bytes((a, 3, "cfg")) == 96


def test_mask_cost_dims_equal_the_reference():
    pat = np.eye(4, dtype=bool)
    for kw in (dict(causal=True), dict(causal=True, window=8),
               dict(global_tokens=(0, 3))):
        assert MaskSpec(**kw).cost_dims() == JMask(**kw).cost_dims()
    assert MaskSpec.from_block_mask(pat, 16).cost_dims() == \
        JMask.from_block_mask(pat, 16).cost_dims()


# ---------------------------------------------------------------------------
# winners: the reference's names for the same seconds
# ---------------------------------------------------------------------------

@pytest.fixture
def csr_pair():
    """One CSR call in both packages: static order spmv2 (Cost.CSR = 20)
    ahead of spmv1 (40)."""
    spd = jsp.banded_spd(64, 3, seed=1)
    x = np.random.default_rng(1).standard_normal(64).astype(np.float32)
    return ((jsp.csr_from_dense(spd), jbind(x)),
            (tsp.csr_from_dense(spd.astype(np.float32), device=CPU),
             tbind(x, device=CPU)))


@pytest.mark.parametrize("fast,slow", [("spmv1", "spmv2"),
                                       ("spmv2", "spmv1")])
def test_same_seconds_same_winner(csr_pair, fast, slow):
    jargs, targs = csr_pair
    assert registry.select("solver_spmv", *targs).name == \
        jreg.select("solver_spmv", *jargs).name == "spmv2"
    for cm, args in ((jcm, jargs), (costmodel, targs)):
        m = cm.get_model()
        m.record("solver_spmv", fast, seconds=1e-4, args=args)
        m.record("solver_spmv", slow, seconds=5e-4, args=args)
    assert registry.select("solver_spmv", *targs).name == \
        jreg.select("solver_spmv", *jargs).name == fast
    t_rows = registry.explain("solver_spmv", *targs)
    j_rows = jreg.explain("solver_spmv", *jargs)
    pick = [next(r["variant"] for r in rows if r["selected"])
            for rows in (t_rows, j_rows)]
    assert pick == [fast, fast]
    loser = next(r for r in t_rows if r["variant"] == slow)
    assert loser["reason"].startswith("outranked")
    winner = next(r for r in t_rows if r["selected"])
    assert winner["source"] == "calibrated"
    assert winner["calibrated_seconds"] == pytest.approx(1e-4)


def test_record_drops_the_memoised_ranking(csr_pair):
    _, (csr, x) = csr_pair
    m = costmodel.get_model()
    m.record("solver_spmv", "spmv1", seconds=1e-4, args=(csr, x))
    m.record("solver_spmv", "spmv2", seconds=5e-4, args=(csr, x))
    assert registry.select("solver_spmv", csr, x).name == "spmv1"
    assert registry.select("solver_spmv", csr, x).name == "spmv1"
    m.record("solver_spmv", "spmv1", seconds=9e-4, args=(csr, x))
    assert registry.select("solver_spmv", csr, x).name == "spmv2"


def test_singleton_never_reranks(csr_pair):
    _, (csr, x) = csr_pair
    costmodel.get_model().record("solver_spmv", "spmv1", seconds=1e-9,
                                 args=(csr, x))
    assert registry.select("solver_spmv", csr, x).name == "spmv2"


def test_plane_request_disables_calibration(csr_pair):
    _, (csr, x) = csr_pair
    m = costmodel.get_model()
    m.record("solver_spmv", "spmv1", seconds=1e-4, args=(csr, x))
    m.record("solver_spmv", "spmv2", seconds=5e-4, args=(csr, x))
    with registry.use_backend("torch"):
        assert registry.select("solver_spmv", csr, x).name == "spmv2"
    assert registry.select("solver_spmv", csr, x).name == "spmv1"


def test_no_model_is_the_static_order(csr_pair):
    _, (csr, x) = csr_pair
    assert len(costmodel.get_model()) == 0
    assert {registry.select("solver_spmv", csr, x).name
            for _ in range(5)} == {"spmv2"}


# ---------------------------------------------------------------------------
# the device rule: calibration never crosses it
# ---------------------------------------------------------------------------

def _mm():
    a = torch.ones(16, 16)
    return a, a


def test_host_operands_never_select_a_measured_cuda_variant():
    a, b = _mm()
    m = costmodel.get_model()
    m.record("matmul", "cuda", seconds=1e-9, args=(a, b))
    m.record("matmul", "torch", seconds=1.0, args=(a, b))
    assert registry.select("matmul", a, b).name == "torch"
    rows = {r["variant"]: r for r in registry.explain("matmul", a, b)}
    assert rows["cuda"]["reason"].startswith("plane-unavailable")
    assert rows["cuda"]["calibrated_seconds"] is None
    assert rows["torch"]["selected"]


def test_card_operands_never_select_a_measured_torch_variant(monkeypatch):
    """On CUDA operands a 'torch' variant whose seconds beat every 'cuda'
    one stays out: its plane is not admissible without use_backend."""
    a, b = _mm()
    _on_card(monkeypatch)
    m = costmodel.get_model()
    m.record("matmul", "torch", seconds=1e-9, args=(a, b))
    m.record("matmul", "cuda", seconds=1.0, args=(a, b))
    assert registry.select("matmul", a, b).name == "cuda"
    rows = {r["variant"]: r for r in registry.explain("matmul", a, b)}
    assert rows["torch"]["reason"].startswith("plane-unavailable")
    assert rows["cuda"]["selected"] and rows["cuda"]["source"] == "static"
    with registry.use_backend("torch"):
        assert registry.select("matmul", a, b).name == "torch"


def _bsr(seed, frac):
    rng = np.random.default_rng(seed)
    occ = np.kron(rng.random((4, 4)) < frac, np.ones((8, 8)))
    return tfmt.bsr_from_dense(
        (occ * rng.standard_normal((32, 32))).astype(np.float32), block=8,
        device=CPU)


def test_card_spgemm_oracle_never_outranks_the_kernel(monkeypatch):
    """On CUDA operands spgemm's plane-free ``dense`` oracle (the plain
    reference) does not beat the 'bsr' kernel, however much faster its
    recorded seconds: an oracle's seconds are not counted there, and one
    counted variant re-ranks nothing.  On host operands it still
    competes with ``bsr_torch``."""
    a = _bsr(3, 0.5)
    m = costmodel.get_model()
    m.record("spgemm", "bsr_torch", seconds=1e-3, args=(a, a))
    m.record("spgemm", "dense", seconds=1e-6, args=(a, a))
    m.record("spgemm", "bsr", seconds=1e-3, args=(a, a))
    assert registry.select("spgemm", a, a).name == "dense"
    _on_card(monkeypatch)
    assert registry.select("spgemm", a, a).name == "bsr"
    rows = {r["variant"]: r for r in registry.explain("spgemm", a, a)}
    assert rows["bsr"]["selected"] and rows["bsr"]["source"] == "static"
    assert rows["dense"]["reason"].startswith("outranked")
    assert rows["dense"]["calibrated_seconds"] is None
    assert rows["bsr_torch"]["reason"].startswith("plane-unavailable")
    assert registry.REGISTRY.get("spgemm", "dense").oracle
    assert registry.REGISTRY.get("spmm", "csr").oracle


def test_an_oracle_is_plane_free():
    with pytest.raises(ValueError, match="plane-free"):
        registry.register("_t_oracle", "x", lambda: None, plane="cuda",
                          oracle=True)
    assert "_t_oracle" not in registry.REGISTRY._ops


@pytest.mark.parametrize("spmv1,spread,winner", [
    (4.8e-4, None, "spmv2"),        # 4 % faster: inside the margin
    (4.0e-4, 1.5e-4, "spmv2"),      # 20 % faster, inside the spread
    (4.0e-4, 5e-5, "spmv1"),        # 20 % faster, beyond both
    (4.0e-4, None, "spmv1"),
], ids=["margin", "spread", "resolved", "resolved_no_spread"])
def test_a_difference_inside_the_margin_keeps_the_static_order(
        csr_pair, spmv1, spread, winner):
    """spmv2 is the static pick (cost 20 < 40) and measures 5e-4 s;
    spmv1's measured lead reorders them only beyond the margin and both
    spreads.  ``explain`` agrees with ``select`` either way."""
    _, (csr, x) = csr_pair
    m = costmodel.get_model()
    m.record("solver_spmv", "spmv1", seconds=spmv1, spread=spread,
             args=(csr, x))
    m.record("solver_spmv", "spmv2", seconds=5e-4, args=(csr, x))
    assert registry.select("solver_spmv", csr, x).name == winner
    rows = registry.explain("solver_spmv", csr, x)
    assert [r["variant"] for r in rows if r["selected"]] == [winner]
    assert {r["variant"]: r["calibrated_seconds"] for r in rows
            if r["source"] == "calibrated"} == pytest.approx(
        {"spmv1": spmv1, "spmv2": 5e-4})


def test_memoised_rankings_key_on_block_density():
    """Two BSR operands of one shape and edge but other live-block counts
    are two calibrations (``cost_dims``): a model holding seconds for one
    leaves the other's ranking static, memoised or not."""
    sparse_a, dense_a = _bsr(4, 0.3), _bsr(5, 0.6)
    assert sparse_a.cost_dims() != dense_a.cost_dims()
    m = costmodel.get_model()
    m.record("spgemm", "dense", seconds=1e-6, args=(sparse_a, sparse_a))
    m.record("spgemm", "bsr_torch", seconds=1e-3, args=(sparse_a, sparse_a))
    for _ in range(2):
        assert registry.select("spgemm", sparse_a, sparse_a).name == "dense"
        assert registry.select("spgemm", dense_a, dense_a).name == \
            "bsr_torch"


# ---------------------------------------------------------------------------
# the file: round trip, shape classes, predictions
# ---------------------------------------------------------------------------

def test_roundtrip_keeps_every_variant_and_its_spread(tmp_path,
                                                     monkeypatch):
    path = tmp_path / "model.json"
    monkeypatch.setenv("REPRO_TORCH_COSTMODEL", str(path))
    settings.reload()
    m = costmodel.get_model()
    a = torch.ones(8, 8)
    m.record("matmul", "torch", seconds=0.25, spread=0.01, args=(a, a))
    m.record("matmul", "cuda", seconds=0.125, args=(a, a))
    again = costmodel.CostModel(str(path))
    assert again.seconds_for("matmul", (a, a)) == {"torch": 0.25,
                                                   "cuda": 0.125}
    assert again.records_for("matmul", (a, a)) == {
        "torch": {"seconds": 0.25, "spread": 0.01},
        "cuda": {"seconds": 0.125}}
    assert all(k.endswith("|chip|-") for k in json.loads(path.read_text()))


def test_shape_class_fallback():
    m = costmodel.get_model()
    a = torch.ones(64, 64)
    m.record("matmul", "torch", seconds=1e-4, args=(a, a))
    near = torch.ones(60, 60)
    far = torch.ones(65, 65)
    key, sec = m.lookup("matmul", (near, near))
    assert key.startswith("~matmul|") and sec == {"torch": 1e-4}
    assert m.seconds_for("matmul", (far, far)) == {}


def test_block_keys_and_roofline_terms():
    from repro_torch.utils.roofline import RooflineTerms

    key = blocking.AutotuneCache.key("flash_attention",
                                     {"lq": 512, "b": 4, "d": 128},
                                     "bfloat16")
    assert key == "flash_attention|b=4,d=128,lq=512|bfloat16|chip|-"
    t = RooflineTerms(arch="a", shape="s", mesh="-", flops_per_chip=989e12,
                      hbm_bytes_per_chip=6.7e12, coll_bytes_per_chip=0.0,
                      coll_breakdown={}, t_compute=1.0, t_memory=2.0,
                      t_collective=0.0, model_flops_total=0.0,
                      useful_ratio=1.0)
    assert t.dominant == "memory" and t.step_time == 2.0
    assert t.roofline_fraction == 0.5 and t.mfu_bound == pytest.approx(0.5)
    assert t.to_json()["dominant"] == "memory"


def test_predictions_use_the_h100_peak_of_the_dtype():
    from repro_torch.utils.roofline import H100

    m = costmodel.get_model()
    f32 = torch.ones(256, 256)
    bf = f32.bfloat16()
    flops = 2.0 * 256 ** 3
    r32 = m.record("matmul", "torch", seconds=1e-3, args=(f32, f32),
                   flops=flops, bytes_moved=1.0)
    r16 = m.record("matmul", "torch", seconds=1e-3, args=(bf, bf),
                   flops=flops, bytes_moved=1.0)
    assert r32["predicted_seconds"] == pytest.approx(flops / 67e12,
                                                     rel=1e-6)
    assert r16["predicted_seconds"] == pytest.approx(flops / 989e12,
                                                     rel=1e-6)
    assert (H100.hbm_bw, H100.peak_flops_f32, H100.peak_flops) == \
        (3.35e12, 67e12, 989e12)
    assert r32["hw"] == "cpu" and r32["gflops"] == pytest.approx(
        flops / 1e-3 / 1e9)
    rows = m.agreement("matmul")
    assert len(rows) == 2                    # class keys don't double-count
    assert all(r["ratio"] == pytest.approx(
        r["measured_seconds"] / r["predicted_seconds"]) for r in rows)


# ---------------------------------------------------------------------------
# blocks: domain by rule, capture marks defaults, nothing caught
# ---------------------------------------------------------------------------

@pytest.fixture
def autotune(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "1")
    settings.reload()
    return blocking.get_cache()


def test_k256_is_out_by_rule():
    assert {"q": 128, "k": 256} not in ops.fa_candidates(128)
    assert not fa_k.takes_blocks(128, 256, 128)
    assert not fa_k.takes_blocks(128, 128, 100)
    assert ops.fa_candidates(128) == [{"q": 128, "k": 128},
                                      {"q": 256, "k": 128},
                                      {"q": 64, "k": 64}]
    assert ops.fa_candidates(100) == []


def test_capture_marks_defaults_then_a_resolve_outside_upgrades(
        autotune, monkeypatch):
    cache = autotune
    key = blocking.AutotuneCache.key("_t_op", {"m": 32}, "float32")
    measured = []

    def measure(bl):
        measured.append(dict(bl))
        return bl["m"] * 1e-6

    monkeypatch.setattr(blocking, "capturing", lambda: True)
    got = blocking.resolve_blocks("_t_op", {"m": 32}, "float32", {"m": 8},
                                  ({"m": 16},), measure)
    assert got == {"m": 8} and measured == []
    assert cache.entry(key)["_default"] is True
    monkeypatch.setattr(blocking, "capturing", lambda: False)
    got = blocking.resolve_blocks("_t_op", {"m": 32}, "float32", {"m": 8},
                                  ({"m": 16},), measure)
    assert got == {"m": 8} and measured == [{"m": 8}, {"m": 16}]
    assert "_default" not in cache.entry(key)
    blocking.resolve_blocks("_t_op", {"m": 32}, "float32", {"m": 8},
                            ({"m": 16},), measure)
    assert len(measured) == 2                # a hit measures nothing


def test_untuned_defaults_resolve_once_and_a_put_or_autotune_reopens(
        monkeypatch):
    """With autotune off and no entry, the defaults are resolved once and
    then answered from memory (no entry lookup, no capture query); a
    ``put`` drops that memory, and turning autotune on measures."""
    cache = blocking.get_cache()
    lookups, measured = [], []
    real_entry = cache.entry
    monkeypatch.setattr(cache, "entry",
                        lambda key: lookups.append(key) or real_entry(key))
    monkeypatch.setattr(blocking, "capturing",
                        lambda: pytest.fail("capture queried"))

    def resolve():
        return blocking.resolve_blocks(
            "_t_untuned", {"m": 32}, "float32", {"m": 8}, ({"m": 16},),
            lambda bl: measured.append(bl["m"]) or bl["m"] * 1e-6)
    assert [resolve() for _ in range(3)] == [{"m": 8}] * 3
    assert len(lookups) == 1 and measured == []
    cache.put(blocking.AutotuneCache.key("_t_untuned", {"m": 32},
                                         "float32"), {"m": 16})
    assert resolve() == {"m": 16} and len(lookups) == 2
    monkeypatch.setattr(blocking, "capturing", lambda: False)
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "1")
    settings.reload()
    assert blocking.resolve_blocks(
        "_t_untuned2", {"m": 32}, "float32", {"m": 8}, ({"m": 16},),
        lambda bl: measured.append(bl["m"]) or bl["m"] * 1e-6) == {"m": 8}
    assert measured == [8, 16]


def test_candidates_outside_the_domain_never_run(autotune):
    ran = []
    got = blocking.resolve_blocks(
        "_t_dom", {"n": 4}, "float32", {"k": 128}, ({"k": 256}, {"k": 64}),
        lambda bl: ran.append(bl["k"]) or bl["k"] * 1e-6,
        takes=lambda bl: bl["k"] <= 128)
    assert ran == [128, 64] and got == {"k": 64}


def test_a_failing_measurement_raises(autotune):
    def measure(bl):
        raise RuntimeError("launch failed")

    with pytest.raises(RuntimeError, match="launch failed"):
        blocking.resolve_blocks("_t_fail", {"n": 4}, "float32", {"k": 8},
                                ({"k": 16},), measure)


def test_a_cached_block_outside_the_domain_raises(tmp_path):
    """A k 256 entry (a Pallas block from a TPU's cache) raises naming the
    file and the key, on the attention variant's first resolve."""
    q = torch.randn(1, 2, 64, 32)
    k = torch.randn(1, 2, 64, 32)
    key = blocking.AutotuneCache.key(
        "flash_attention", {"b": 1, "h": 2, "lq": 64, "lk": 64, "d": 32},
        "float32")
    blocking.get_cache().put(key, {"q": 128, "k": 256}, seconds=1e-5)
    with pytest.raises(ValueError, match="at.json") as e:
        ops._attn_cuda(q, k, k, causal=True)
    assert key in str(e.value)


def test_premeasure_persists_a_block_the_kernels_take(autotune,
                                                      monkeypatch):
    _on_card(monkeypatch)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2, 96, 32, generator=g)
    k = torch.randn(1, 2, 96, 32, generator=g)
    got = blocking.premeasure("flash_attention", q, k, k, causal=True)
    key = blocking.AutotuneCache.key(
        "flash_attention", {"b": 1, "h": 2, "lq": 96, "lk": 96, "d": 32},
        "float32")
    entry = autotune.entry(key)
    assert "_seconds" in entry and "_default" not in entry
    assert fa_k.takes_blocks(entry["q"], entry["k"], 32)
    assert got == {"q": min(entry["q"], 96), "k": min(entry["k"], 96)}
    with pytest.raises(LookupError, match="premeasurable"):
        blocking.premeasure("no_such_op")


def test_measured_blocks_compute_the_same_attention(autotune, monkeypatch):
    """The variant's output at its measured blocks equals the plain
    oracle's (the blocks change only the order of summation)."""
    from repro_torch.kernels import ref

    g = torch.Generator().manual_seed(1)
    q = torch.randn(1, 4, 80, 32, generator=g)
    k = torch.randn(1, 2, 80, 32, generator=g)
    v = torch.randn(1, 2, 80, 32, generator=g)
    win = MaskSpec(causal=True, window=20)
    for impl, kw in ((ops._attn_cuda, {}), (ops._attn_blocksparse,
                                            {"mask": win})):
        got = impl(q, k, v, causal=True, **kw)
        want = ref.attention_masked_ref(
            q, k, v, ops._dense_mask_arr(win, 80, 80)) if kw else \
            ref.attention_ref(q, k, v, causal=True)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert len(autotune) == 2                # one key each: mask apart


def test_autotune_block_hits_and_persists(autotune):
    from repro_torch.sparse import selector

    a = np.kron(np.eye(4), np.ones((16, 16))).astype(np.float32)
    b1, _ = selector.autotune_block(a)
    keys = [k for k in json.loads(open(autotune.path).read())
            if k.startswith("bsr_block|")]
    assert len(keys) == 1 and b1 == 32
    autotune.put(keys[0], {"block": 16})
    assert selector.autotune_block(a)[0] == 16


# ---------------------------------------------------------------------------
# the sweep, at smoke size on the host
# ---------------------------------------------------------------------------

def test_autotune_sweep_records_and_reranks(csr_pair):
    from repro_torch.launch import calibrate

    _, (csr, x) = csr_pair
    cases = {"solver_spmv": [calibrate.Case("csr", (csr, x), {}, 2.0 * 190)],
             "matmul": [calibrate.Case("mm", _mm(), {}, 2.0 * 16 ** 3)]}
    rows = calibrate.autotune_sweep(cases)
    got = {(r["op"], r["variant"]): r for r in rows}
    assert set(got) == {("solver_spmv", "spmv1"), ("solver_spmv", "spmv2"),
                        ("matmul", "torch")}
    # the registry's own reorder rule on the sweep's seconds and spreads:
    # beyond the margin the faster one, else the static order (spmv2)
    ranks = registry.calibration_ranks({n: got[("solver_spmv", n)]
                                        for n in ("spmv1", "spmv2")})
    static = [v.name for v in registry.variants("solver_spmv")]
    want = min(ranks, key=lambda n: (ranks[n][1], static.index(n)))
    assert registry.select("solver_spmv", csr, x).name == want
    back = calibrate.backend_sweep(cases)
    cuda = next(r for r in back if r["variant"] == "cuda")
    assert cuda["seconds"] is None and cuda["note"].startswith(
        "plane-unavailable")


# ---------------------------------------------------------------------------
# launch.train names a depth that fits at the update's peak
# ---------------------------------------------------------------------------

def test_train_refusal_names_a_depth_that_fits(monkeypatch, capsys):
    """qwen2-vl-72b at scale 1 on an 80 GB card: the refusal, by the
    step's peak (here the update's), stands, and the depth it names fits
    by the same count while one layer more does not."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as t_launch

    monkeypatch.setattr(t_launch, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"total_memory": 80e9}))
    monkeypatch.setattr(t_launch, "Trainer", None)   # never reached
    with pytest.raises(SystemExit):
        t_launch.main(["--arch", "qwen2-vl-72b", "--scale", "1.0"])
    err = capsys.readouterr().err
    assert "do not fit the card's 80.0 GB" in err
    assert "(26 bytes a parameter at the update's peak)" in err
    cfg = get_config("qwen2-vl-72b")
    tokens = 8 * (256 + cfg.frontend_len)       # the launcher's defaults
    assert f"activations of {tokens} positions a microbatch" in err
    fit = int(err.split("at full width ")[1].split(" of")[0])
    room = 80e9 - t_launch.TRAIN_SLACK_BYTES
    assert t_launch.UPDATE_PEAK_BYTES == 26
    assert 26 * dataclasses.replace(cfg, num_layers=fit).param_count() \
        <= room
    assert t_launch.train_peak_bytes(dataclasses.replace(
        cfg, num_layers=fit), tokens) <= room
    assert t_launch.train_peak_bytes(dataclasses.replace(
        cfg, num_layers=fit + 1), tokens) > room


class _Admitted(Exception):
    """Raised by the stub Trainer: ``main`` admitted the config."""


@pytest.mark.parametrize("arch,admitted", [("phi3-mini-3.8b", False),
                                           ("gemma-2b", True),
                                           ("minicpm-2b", True)])
def test_train_admits_by_the_update_peak(monkeypatch, capsys, arch,
                                         admitted):
    """On the 85.0 GB an H100 reports, ``main`` refuses by the count that
    names its depth, :func:`update_peak_bytes` (less the slack):
    phi3-mini-3.8b (99.3 GB at the update's peak, 53.5 GB of parameters,
    gradients and moments) is refused with a depth that fits; gemma-2b
    and minicpm-2b are admitted."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as t_launch

    def trainer(*a, **k):
        raise _Admitted

    monkeypatch.setattr(t_launch, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"total_memory": 85.0e9}))
    monkeypatch.setattr(t_launch, "Trainer", trainer)
    cfg = get_config(arch)
    peak = t_launch.update_peak_bytes(cfg)
    room = 85.0e9 - t_launch.TRAIN_SLACK_BYTES
    assert (peak <= room) == admitted
    if admitted:
        with pytest.raises(_Admitted):
            t_launch.main(["--arch", arch, "--scale", "1.0", "--steps", "1",
                           "--batch", "1", "--seq", "16"])
        return
    # 14 bytes a parameter (its own 2, an f32 gradient, two f32 moments)
    # fit; the update's peak does not
    assert 14 * cfg.param_count() <= room < peak
    with pytest.raises(SystemExit):
        t_launch.main(["--arch", arch, "--scale", "1.0", "--steps", "1"])
    err = capsys.readouterr().err
    assert f"{peak / 1e9:.1f} GB" in err
    assert "do not fit the card's 85.0 GB less 5 GB of slack" in err
    fit = int(err.split("at full width ")[1].split(" of")[0])
    assert 0 < fit < cfg.num_layers and f"--layers {fit}" in err
    # at the launcher's 8 x 256 the update's peak is the step's
    assert t_launch.train_peak_bytes(cfg, 8 * 256) == peak
    assert t_launch.update_peak_bytes(dataclasses.replace(
        cfg, num_layers=fit)) <= room
    assert t_launch.update_peak_bytes(dataclasses.replace(
        cfg, num_layers=fit + 1)) > room


def test_train_refuses_by_the_activations(monkeypatch, capsys):
    """gemma-2b on 85.0 GB: admitted at the launcher's 8 x 256, where the
    update's peak is the step's, and refused at 8 x 2048, where the
    logits of 16384 positions (16 bytes a token and entry of the 256000
    vocabulary) put the backward's start above the update; the depth it
    names fits by the same count, and two microbatches are admitted
    whole."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as t_launch

    def trainer(*a, **k):
        raise _Admitted

    monkeypatch.setattr(t_launch, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"total_memory": 85.0e9}))
    monkeypatch.setattr(t_launch, "Trainer", trainer)
    cfg = get_config("gemma-2b")
    room = 85.0e9 - t_launch.TRAIN_SLACK_BYTES
    assert t_launch.train_peak_bytes(cfg, 2048) == \
        t_launch.update_peak_bytes(cfg) <= room
    with pytest.raises(_Admitted):
        t_launch.main(["--arch", "gemma-2b", "--scale", "1.0"])
    tokens = 8 * 2048
    need = t_launch.train_peak_bytes(cfg, tokens)
    assert need == 14 * cfg.param_count() + t_launch.activation_bytes(
        cfg, tokens) > room
    assert t_launch.activation_bytes(cfg, tokens) == tokens * (
        16 * 256000 + 2 * 18 * 2048)
    with pytest.raises(SystemExit):
        t_launch.main(["--arch", "gemma-2b", "--scale", "1.0", "--batch",
                       "8", "--seq", "2048"])
    err = capsys.readouterr().err
    assert f"{need / 1e9:.1f} GB" in err
    assert f"activations of {tokens} positions a microbatch" in err
    fit = int(err.split("at full width ")[1].split(" of")[0])
    assert t_launch.train_peak_bytes(dataclasses.replace(
        cfg, num_layers=fit), tokens) <= room
    assert 0 < fit < cfg.num_layers and t_launch.train_peak_bytes(
        dataclasses.replace(cfg, num_layers=fit + 1), tokens) > room
    # two microbatches halve the activations a microbatch
    assert t_launch.train_peak_bytes(cfg, tokens // 2) <= room
    with pytest.raises(_Admitted):
        t_launch.main(["--arch", "gemma-2b", "--scale", "1.0", "--batch",
                       "8", "--seq", "2048", "--microbatches", "2"])


# ---------------------------------------------------------------------------
# no environment read on a dispatch that changes nothing
# ---------------------------------------------------------------------------

class _CountingEnviron(dict):
    """A stand-in for ``os.environ`` that counts every read."""

    reads = 0

    def __getitem__(self, key):
        type(self).reads += 1
        return super().__getitem__(key)

    def get(self, key, default=None):
        type(self).reads += 1
        return super().get(key, default)

    def __contains__(self, key):
        type(self).reads += 1
        return super().__contains__(key)


def test_cached_dispatch_reads_no_environment(monkeypatch, tmp_path):
    """Once ``settings.reload()`` has run, an attention dispatch whose
    blocks the cache holds reads ``os.environ`` zero times (the kernel
    wrapper runs its plain version on these host tensors), with and
    without a cost model file."""
    import os

    _on_card(monkeypatch)
    q, k, v = (torch.randn(s, generator=torch.Generator().manual_seed(i))
               for i, s in enumerate(((1, 4, 64, 32), (1, 2, 64, 32),
                                      (1, 2, 64, 32))))
    cache = blocking.get_cache()
    cache.put(blocking.AutotuneCache.key(
        "flash_attention", ops._fa_dims(q, k), "float32"), {"q": 32, "k": 32})
    for with_model in (False, True):
        if with_model:
            costmodel.get_model().record("matmul", "torch", seconds=1.0,
                                         args=(q[0, 0], q[0, 0].T))
        want = ops.flash_attention(q, k, v, causal=True)   # checks the entry
        counting = _CountingEnviron(os.environ)
        monkeypatch.setattr(os, "environ", counting)
        _CountingEnviron.reads = 0
        for _ in range(3):
            got = ops.flash_attention(q, k, v, causal=True)
        monkeypatch.setattr(os, "environ", dict.copy(counting))
        assert _CountingEnviron.reads == 0
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert registry.select("flash_attention", q, k, v).name == "cuda"


def test_settings_reload_sees_a_changed_variable(monkeypatch, tmp_path):
    """A variable set after import takes effect at the re-read hook: the
    block cache and the cost model re-open at the new paths, and autotune
    turns on."""
    monkeypatch.setenv("REPRO_TORCH_COSTMODEL", str(tmp_path / "m2.json"))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "a2.json"))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "1")
    assert not blocking.autotune_enabled()          # not re-read yet
    settings.reload()
    assert blocking.autotune_enabled()
    assert blocking.get_cache().path == str(tmp_path / "a2.json")
    assert costmodel.get_model().path == str(tmp_path / "m2.json")
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE")
    settings.reload()
    assert not blocking.autotune_enabled()
