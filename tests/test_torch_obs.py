"""The port's observability plane (repro_torch.obs: trace, metrics, drift,
explain) against the JAX package's (tests/test_obs.py at chip scope; the
mesh cases wait for mesh scope).

Contracts: the same spans give the same Chrome-trace structure and the same
records give equal METRICS snapshots in both packages; ``explain`` agrees
with ``dispatch`` on every registered op (the winner it names is the
variant whose counter the dispatch bumps); the drift detector flags an
injected stale calibration, directly and through a dispatch under
``collect()``; the serve loop's spans, metrics and heartbeats count what
the requests fix.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro_torch.core import bind, costmodel, registry, settings
from repro_torch.numerics import sparse as tsp
from repro_torch.obs import drift, explain, explain_str, metrics, trace
from repro_torch.sparse import formats as tfmt
from repro_torch.sparse.maskcompiler import MaskSpec

CPU = "cpu"


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    """The tracer, drift detector and metrics are process globals, and the
    port's files live in ``tmp_path``: every test starts clean."""
    monkeypatch.setenv("REPRO_TORCH_COSTMODEL", str(tmp_path / "cm.json"))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "at.json"))
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE", raising=False)
    settings.reload()
    for tr in (trace.TRACER, jtrace.TRACER):
        tr.disable()
        tr.clear()
    drift.DETECTOR.clear()
    for m in (metrics.METRICS, jmetrics.METRICS):
        m.reset("t.")
    yield
    trace.TRACER.disable()
    trace.TRACER.clear()
    drift.DETECTOR.clear()
    monkeypatch.undo()
    settings.reload()


def _mm():
    a = torch.ones(16, 16)
    return a, a


# ---------------------------------------------------------------------------
# tracer: the reference's structure, ring bound, disabled no-op
# ---------------------------------------------------------------------------

def _spans(tr):
    tr.enable()
    with tr.span("outer", cat="t", a=1):
        with tr.span("inner", cat="t"):
            pass
        tr.event("mark", cat="t", n=2)
        tr.counter("depth", q=3)


def _structure(doc):
    """A Chrome trace without its clocks and ids."""
    return [{k: v for k, v in ev.items() if k not in ("ts", "dur", "pid",
                                                      "tid")}
            for ev in doc["traceEvents"]], doc["otherData"]


def test_chrome_trace_structure_equals_the_reference(tmp_path):
    tt, jt = trace.Tracer(), jtrace.Tracer()
    _spans(tt)
    _spans(jt)
    assert _structure(tt.chrome_trace()) == _structure(jt.chrome_trace())
    inner, mark, _, outer = tt.events()
    assert inner["args"]["parent"] == "outer" and outer["args"]["a"] == 1
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6
    path = tmp_path / "trace.json"
    tt.save(str(path))
    loaded = json.loads(path.read_text())
    assert [e["name"] for e in loaded["traceEvents"]] == \
        ["inner", "mark", "depth", "outer"]
    for ev in loaded["traceEvents"]:
        assert {"name", "ph", "ts", "pid", "tid"} <= set(ev)
        assert ev["pid"] == os.getpid()


def test_ring_buffer_keeps_most_recent():
    tr = trace.Tracer(capacity=4)
    tr.enable()
    for i in range(10):
        tr.event(f"e{i}")
    assert len(tr) == 4 and tr.dropped == 6
    assert [e["name"] for e in tr.events()] == ["e6", "e7", "e8", "e9"]


def test_disabled_tracer_records_nothing_and_costs_nothing():
    tr = trace.TRACER
    assert not tr.enabled
    assert tr.span("x", attr=1) is tr.span("y")       # the shared no-op
    with tr.span("x", cat="y", attr=1):
        tr.event("z")
    assert len(tr) == 0
    t0 = trace.clock()
    for _ in range(200_000):
        with tr.span("hot"):
            pass
    assert trace.clock() - t0 < 5.0


def test_scoped_tracing_restores_state():
    with trace.TRACER.tracing():
        assert trace.TRACER.enabled
        trace.TRACER.event("inside")
    assert not trace.TRACER.enabled and len(trace.TRACER) == 1


# ---------------------------------------------------------------------------
# metrics: equal snapshots for the same records
# ---------------------------------------------------------------------------

def _record(m):
    m.counter("t.c").inc(2.5)
    m.counter("t.c").inc()
    m.gauge("t.g").set(7)
    for v in (0.75, 0.75, 1.0, 3.0, 0.0, 1e-6, 12.5):
        m.histogram("t.h").record(v)
    m.histogram("t.w").record(0.002, n=5)


def test_metrics_snapshots_equal_the_reference():
    _record(metrics.METRICS)
    _record(jmetrics.METRICS)
    assert metrics.METRICS.snapshot("t.") == jmetrics.METRICS.snapshot("t.")
    h = metrics.METRICS.histogram("t.h")
    assert h.buckets[0] == 3 and h.zero == 1 and h.quantile(0.5) == 1.0
    with pytest.raises(TypeError):
        metrics.METRICS.gauge("t.c")
    metrics.METRICS.reset("t.")
    assert metrics.METRICS.snapshot("t.") == {}


# ---------------------------------------------------------------------------
# explain == dispatch on every registered op (host operands)
# ---------------------------------------------------------------------------

def _host_calls():
    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s)
                                    .astype(np.float32))
    spd = tsp.banded_spd(32, 3, seed=1).astype(np.float32)
    x = bind(rng.standard_normal(32).astype(np.float32), device=CPU)
    xp = bind(rng.standard_normal((32, 4)).astype(np.float32), device=CPU)
    csr = tsp.csr_from_dense(spd, device=CPU)
    ell = tsp.ell_from_csr(csr)
    dia = tsp.dia_from_dense(spd, device=CPU)
    bsr = tfmt.bsr_from_dense(spd, block=8, device=CPU)
    q, k = f(1, 4, 16, 32), f(1, 2, 16, 32)
    pages = f(5, 2, 8, 32)
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    lens = torch.tensor([11], dtype=torch.int32)
    return [
        ("matmul", (f(8, 8), f(8, 8)), {}),
        ("spmv_ell", (ell.values, ell.cols, x.data), {}),
        ("spmv_dia", (dia.diags, tuple(dia.offsets), x.data), {}),
        ("fft", (torch.randn(16, dtype=torch.complex64),), {}),
        *[("solver_spmv", (m, x), {}) for m in (csr, ell, dia, bsr)],
        ("solver_spmv", (csr, xp), {}),
        *[("spmm", (m, xp), {}) for m in (csr, ell, dia, bsr)],
        ("spgemm", (bsr, bsr), {}),
        ("flash_attention", (q, k, k), {"causal": True}),
        ("flash_attention", (q, k, k),
         {"mask": MaskSpec(causal=True, window=4)}),
        ("flash_attention_state", (q, k, k), {"causal": True}),
        ("paged_attention", (f(1, 4, 1, 32), pages, pages, table, lens), {}),
        ("chunk_attention", (f(1, 4, 4, 32), f(1, 2, 16, 32),
                             f(1, 2, 16, 32), torch.tensor([5]),
                             f(1, 2, 4, 32), f(1, 2, 4, 32)), {}),
    ]


def test_every_op_is_covered():
    assert {op for op, _, _ in _host_calls()} == set(registry.ops())


@pytest.mark.parametrize("i", range(len(_host_calls())))
def test_explain_agrees_with_dispatch(i):
    op, args, kwargs = _host_calls()[i]
    rows = explain(op, *args, **kwargs)
    assert [r["rank"] for r in rows] == list(range(len(rows)))
    winners = [r["variant"] for r in rows if r["selected"]]
    assert len(winners) == 1
    assert winners[0] == registry.select(op, *args, **kwargs).name
    for r in rows:
        # the reference's vocabulary; at O2 the mesh variants are scope
        # mismatches
        assert r["reason"].startswith((
            "selected", "plane-unavailable", "scope-mismatch",
            "available-predicate", "accepts-predicate", "outranked")), r
        if r["scope"] == "mesh":
            assert r["reason"].startswith("scope-mismatch"), r
        if r["plane"] == "cuda":
            assert r["reason"].startswith("plane-unavailable")
    metrics.METRICS.reset(f"dispatch.{op}.")
    registry.dispatch(op, *args, **kwargs)
    ran = [k.rsplit(".", 1)[1] for k, v in
           metrics.METRICS.snapshot(f"dispatch.{op}.").items()
           if v["value"] == 1]
    assert ran == winners
    assert winners[0] in explain_str(rows)


def test_explain_on_card_operands(monkeypatch):
    """The card's table, without the card: the torch plane is unavailable,
    and the masked call's winner is the tile walk (the dense kernel's
    accepts refuses a window)."""
    monkeypatch.setattr(registry, "device_type_of", lambda *a: "cuda")
    q, k = torch.ones(1, 4, 16, 32), torch.ones(1, 2, 16, 32)
    rows = {r["variant"]: r for r in explain(
        "flash_attention", q, k, k, mask=MaskSpec(causal=True, window=4))}
    assert rows["blocksparse"]["selected"]
    assert rows["cuda"]["reason"].startswith("accepts-predicate")
    assert rows["torch"]["reason"].startswith("plane-unavailable")
    rows = {r["variant"]: r for r in explain("flash_attention", q, k, k,
                                             causal=True)}
    assert rows["cuda"]["selected"]
    assert rows["blocksparse"]["reason"].startswith("accepts-predicate")


def test_explain_pins_and_requests():
    a, b = _mm()
    rows = explain("matmul", a, b, variant="torch")
    assert len(rows) == 1 and rows[0]["selected"]
    assert rows[0]["source"] == "pinned"
    rows = explain("matmul", a, b, variant="cuda")
    assert not rows[0]["selected"] and rows[0]["no_variant_selected"]
    with registry.use_backend("cuda"):
        rows = explain("matmul", a, b)
    assert all(r["no_variant_selected"] for r in rows)
    assert all(r["reason"].startswith("plane-unavailable") for r in rows)


def test_dispatch_counts_span_and_falloff():
    a, b = _mm()
    before = metrics.METRICS.counter("dispatch.matmul.torch").value
    with trace.TRACER.tracing():
        registry.dispatch("matmul", a, b)
    span = next(e for e in trace.TRACER.events()
                if e["name"] == "dispatch:matmul")
    assert span["ph"] == "X"
    assert {"op", "variant", "plane", "scope", "level", "mesh"} <= \
        set(span["args"])
    assert metrics.METRICS.counter("dispatch.matmul.torch").value == \
        before + 1
    # torch_chunked (admissible, ranked first) refuses a short sequence
    q, k = torch.ones(1, 2, 8, 32), torch.ones(1, 2, 8, 32)
    falls = metrics.METRICS.counter("dispatch.falloff.flash_attention")
    n0 = falls.value
    registry.dispatch("flash_attention", q, k, k, causal=True)
    assert falls.value == n0 + 1
    # but a cuda variant refused on host operands is no fall-off
    m0 = metrics.METRICS.counter("dispatch.falloff.matmul").value
    registry.dispatch("matmul", a, b)
    assert metrics.METRICS.counter("dispatch.falloff.matmul").value == m0


# ---------------------------------------------------------------------------
# drift
# ---------------------------------------------------------------------------

def test_injected_stale_entry_flags():
    a, b = _mm()
    m = costmodel.get_model()
    m.record("matmul", "torch", seconds=1e-6, args=(a, b))
    m.record("matmul", "cuda", seconds=1e-3, args=(a, b))
    d = drift.DETECTOR
    d.observe("matmul", "torch", 1.0, (a, b), {})
    d.observe("matmul", "cuda", 1.2e-3, (a, b), {})
    by = {r["variant"]: r for r in d.report()}
    assert by["torch"]["stale"] and not by["cuda"]["stale"]
    assert d.report()[0]["variant"] == "torch"
    assert d.flagged() == [by["torch"]]


def test_dispatch_under_collect_flags_a_stale_model(monkeypatch):
    a, b = _mm()
    costmodel.get_model().record("matmul", "torch", seconds=1e-9,
                                 args=(a, b))
    assert not drift.collecting()
    registry.dispatch("matmul", a, b)
    assert drift.DETECTOR.report() == [] and drift.DETECTOR.unmatched == 0
    with drift.collect():
        assert drift.collecting()
        registry.dispatch("matmul", a, b)
    flagged = drift.DETECTOR.flagged()
    assert flagged and flagged[0]["variant"] == "torch"
    assert flagged[0]["ratio"] > drift.threshold()
    monkeypatch.setenv("REPRO_TORCH_DRIFT_RATIO", "1e12")
    assert drift.DETECTOR.flagged() == []


# ---------------------------------------------------------------------------
# the serve loop: spans, metrics, heartbeats
# ---------------------------------------------------------------------------

def test_serve_loop_spans_metrics_heartbeat():
    """Two requests (8 and 5 prompt tokens, 3 and 2 new) through the
    ContinuousEngine: the counts are the ones the requests fix."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.lm import LM
    from repro_torch.runtime.fault_tolerance import HeartbeatStore
    from repro_torch.serve import ContinuousEngine, SamplingParams

    cfg = ModelConfig(name="obstest", family="dense", num_layers=2,
                      d_model=32, vocab_size=64, num_heads=4, num_kv_heads=2,
                      head_dim=8, d_ff=64, dtype="float32",
                      param_dtype="float32")
    lm = LM(cfg)
    params = lm.init(0, device=CPU)
    beats = HeartbeatStore()
    eng = ContinuousEngine(lm, params, num_slots=2, max_len=64, chunk_size=4,
                           sampling=SamplingParams(greedy=True),
                           heartbeats=beats, worker=3)
    reqs = [(np.arange(8) % 64, 3), (np.arange(5) % 64, 2)]
    plain = eng.serve(reqs)
    metrics.METRICS.reset("serve.")
    with trace.TRACER.tracing():
        outs, stats = eng.serve(reqs, collect_stats=True)
    assert [o.tolist() for o in outs] == [o.tolist() for o in plain]
    assert [len(o) for o in outs] == [3, 2]
    names = {e["name"] for e in trace.TRACER.events()}
    assert {"serve.admit", "serve.prefill_chunk", "serve.decode",
            "serve.demux"} <= names
    snap = metrics.METRICS.snapshot("serve.")
    for name in ("serve.submitted", "serve.admitted", "serve.recycled"):
        assert snap[name]["value"] == 2
    assert snap["serve.tokens"]["value"] == 5
    assert snap["serve.ttft_s"]["count"] == 2
    assert snap["serve.token_latency_s"]["count"] == 5
    assert snap["serve.occupancy_dist"]["count"] > 0
    assert 0 < snap["serve.occupancy_dist"]["max"] <= 1.0
    beat = beats.all()[3]
    assert beat.step == len(stats.iter_times)
    assert beat.occupancy is not None


def test_serve_loop_never_idles_and_recounts_per_serve():
    """Every request is submitted at once, so ``serve.idle_s`` stays at 0;
    a second serve on the same engine, after a reset, counts the same
    requests again and emits the same tokens."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.lm import LM
    from repro_torch.serve import ContinuousEngine, SamplingParams

    cfg = ModelConfig(name="obstest", family="dense", num_layers=1,
                      d_model=32, vocab_size=64, num_heads=4, num_kv_heads=2,
                      head_dim=8, d_ff=64, dtype="float32",
                      param_dtype="float32")
    lm = LM(cfg)
    params = lm.init(0, device=CPU)
    eng = ContinuousEngine(lm, params, num_slots=2, max_len=32, chunk_size=4,
                           sampling=SamplingParams(greedy=True))
    reqs = [(np.arange(4) % 64, 2), (np.arange(6) % 64, 2)]
    metrics.METRICS.reset("serve.")
    first = eng.serve(reqs)
    snap = metrics.METRICS.snapshot("serve.")
    assert snap["serve.idle_s"]["value"] == 0
    metrics.METRICS.reset("serve.")
    again = eng.serve(reqs)
    assert [o.tolist() for o in again] == [o.tolist() for o in first]

    def counts(sn):         # counter values and histogram counts, no times
        return {k: v.get("count", v.get("value")) for k, v in sn.items()}
    assert counts(metrics.METRICS.snapshot("serve.")) == counts(snap)


def test_heartbeat_occupancy_file_round_trip(tmp_path):
    from repro_torch.runtime.fault_tolerance import FileHeartbeatStore

    store = FileHeartbeatStore(str(tmp_path / "hb"))
    store.post(3, 17, occupancy=0.625)
    store.post(4, 17)
    beats = store.all()
    assert beats[3].occupancy == pytest.approx(0.625)
    assert beats[4].occupancy is None
