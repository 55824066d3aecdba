"""The port's serve tier (repro_torch.serve: the paged cache spec, the
scheduler, the fixed Engine and the ContinuousEngine) on the CPU.

The spec and scheduler cases are the JAX suite's (tests/test_serve.py
TestPagedCacheSpec / TestScheduler), and the specs are compared field by
field with the JAX package's.  The port's fixed Engine is held against the
JAX Engine and against a stepwise full-forward argmax chain; the port's
ContinuousEngine is held against the port's fixed Engine per request
(greedy), as ROADMAP queue 3 says: the JAX ContinuousEngine tests depend on
test order and are not a reliable reference on this tree.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JCfg
from repro.models.lm import LM as JLM
from repro.serve import Engine as JEngine
from repro.serve import SamplingParams as JSampling
from repro.serve import make_spec as j_make_spec
from repro_torch.configs.base import ModelConfig
from repro_torch.interop import carry_params
from repro_torch.models.lm import LM
from repro_torch.serve import (ContinuousEngine, Engine, Request,
                               SamplingParams, Scheduler, init_cache_state,
                               make_spec, sample_token)

KW = dict(name="stest-paged", family="dense", num_layers=2, d_model=32,
          vocab_size=64, num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64,
          dtype="float32", param_dtype="float32", serve_page_size=8)
PCFG = ModelConfig(**KW)
JCFG = JCfg(**KW, remat=False)         # remat is the JAX schema's alone
GREEDY = SamplingParams(greedy=True)


@pytest.fixture(scope="module")
def carried():
    """The JAX LM's parameters and the same ones carried to the port."""
    jl = JLM(JCFG)
    jp = jl.init(jax.random.PRNGKey(0))
    tp = carry_params(jax.tree_util.tree_map(np.asarray, jp), PCFG,
                      device="cpu")
    return jl, jp, LM(PCFG), tp


def _reqs(n, *, seed=0, plen=(3, 12), max_new=5, vocab=64):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=int(rng.integers(*plen)))
             .astype(np.int32), max_new) for _ in range(n)]


def _fixed_reference(lm, params, reqs):
    """Per-request greedy outputs through the port's fixed engine, one
    request at a time."""
    eng = Engine(lm, params, max_len=64, sampling=GREEDY)
    return [eng.generate(torch.as_tensor(p[None]), max_new_tokens=m)[0]
            .numpy() for p, m in reqs]


def _continuous(lm, params, **kw):
    return ContinuousEngine(lm, params, max_len=kw.pop("max_len", 64),
                            sampling=GREEDY, **kw)


class TestPagedCacheSpec:
    def test_spec_shapes_and_striping(self):
        spec = make_spec(PCFG, num_slots=4, max_tokens=60)
        assert spec.page_size == 8
        assert spec.slot_capacity >= 60
        assert spec.num_pages > spec.num_slots * spec.pages_per_slot - 1
        assert spec.pages_for(1) == 1 and spec.pages_for(9) == 2
        assert spec.owner(0) == 0
        assert dataclasses.asdict(spec) == dataclasses.asdict(
            j_make_spec(JCFG, num_slots=4, max_tokens=60))

    def test_ring_rounding(self):
        spec = make_spec(PCFG, num_slots=2, max_tokens=60, ring=4)
        assert spec.pages_per_slot % 4 == 0
        assert spec.num_pages % 4 == 0
        assert [spec.owner(p) for p in range(4)] == [0, 1, 2, 3]
        lo, hi = spec.shard_range(1)
        assert hi - lo == spec.pages_per_shard
        assert dataclasses.asdict(spec) == dataclasses.asdict(
            j_make_spec(JCFG, num_slots=2, max_tokens=60, ring=4))

    def test_state_shapes(self):
        spec = make_spec(PCFG, num_slots=2, max_tokens=32)
        state = init_cache_state(PCFG, spec, device="cpu")
        assert state["kpages"].shape == (PCFG.num_layers, spec.num_pages,
                                         PCFG.num_kv_heads, spec.page_size,
                                         PCFG.head_dim)
        assert state["table"].shape == (2, spec.pages_per_slot)
        assert state["table"].dtype == torch.int32
        assert state["lens"].shape == (2,)


class TestScheduler:
    def _sched(self, slots=2, cap=32):
        return Scheduler(make_spec(PCFG, num_slots=slots, max_tokens=cap),
                         queue_depth=8)

    def test_admission_blocks_when_batch_full(self):
        s = self._sched(slots=2)
        reqs = [Request(rid=i, prompt=np.zeros(4, np.int32), max_new=4)
                for i in range(4)]
        for r in reqs:
            assert s.submit(r)
        assert s.admit_next() is reqs[0]
        assert s.admit_next() is reqs[1]
        assert s.admit_next() is None
        assert len(s.queue) == 2
        s.recycle(reqs[0].slot)
        got = s.admit_next()
        assert got is reqs[2] and got.slot == reqs[0].slot
        assert s.admit_next() is None

    def test_queue_depth_bounds_submit(self):
        s = self._sched()
        s.queue_depth = 1
        assert s.submit(Request(rid=0, prompt=np.zeros(2, np.int32),
                                max_new=1))
        assert not s.submit(Request(rid=1, prompt=np.zeros(2, np.int32),
                                    max_new=1))

    def test_oversized_request_rejected(self):
        s = self._sched(cap=16)
        with pytest.raises(ValueError):
            s.submit(Request(rid=0, prompt=np.zeros(20, np.int32),
                             max_new=20))

    def test_recycle_reuses_freed_pages(self):
        s = self._sched(slots=1)
        free0 = s.num_free_pages
        s.submit(Request(rid=0, prompt=np.zeros(12, np.int32), max_new=8))
        s.admit_next()
        used = {int(g) for g in s.table[0] if g != 0}
        assert used and 0 not in used
        assert s.num_free_pages == free0 - len(used)
        s.recycle(0)
        assert s.num_free_pages == free0
        assert not s.table.any() and not s.lens.any()
        s.submit(Request(rid=1, prompt=np.zeros(12, np.int32), max_new=8))
        s.admit_next()
        assert {int(g) for g in s.table[0] if g != 0} & used

    def test_page_reservation_covers_generation(self):
        s = self._sched(slots=2, cap=32)
        r = Request(rid=0, prompt=np.zeros(9, np.int32), max_new=20)
        s.submit(r)
        s.admit_next()
        assert int((s.table[r.slot] != 0).sum()) == s.spec.pages_for(29)


class TestEngine:
    def test_greedy_tokens_equal_jax_engine(self, carried):
        jl, jp, tl, tp = carried
        prompts = np.random.default_rng(1).integers(0, 64, (2, 8)).astype(
            np.int32)
        want = JEngine(jl, jp, max_len=64,
                       sampling=JSampling(greedy=True)).generate(
            jnp.asarray(prompts), max_new_tokens=8)
        got = Engine(tl, tp, max_len=64, sampling=GREEDY).generate(
            torch.as_tensor(prompts), max_new_tokens=8)
        assert got.dtype == torch.int32 and got.shape == (2, 8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_generation_matches_stepwise_forward(self, carried):
        _, _, lm, params = carried
        prompt = torch.as_tensor(np.random.default_rng(2).integers(
            0, 64, (1, 6)).astype(np.int32))
        out = Engine(lm, params, max_len=64, sampling=GREEDY).generate(
            prompt, max_new_tokens=4)
        seq, want = prompt, []
        for _ in range(4):
            logits, _ = lm.forward(params, seq)
            nxt = logits[:, -1].argmax(-1).to(torch.int32)
            want.append(int(nxt[0]))
            seq = torch.cat([seq, nxt[:, None]], dim=1)
        assert out[0].tolist() == want

    def test_eos_early_stop_pads_with_eos(self, carried):
        _, _, lm, params = carried
        eng = Engine(lm, params, max_len=64, sampling=GREEDY)
        eng.EOS_CHECK_EVERY = 2
        prompt = torch.as_tensor(np.random.default_rng(3).integers(
            0, 64, (1, 4)).astype(np.int32))
        first = int(eng.generate(prompt, max_new_tokens=1)[0, 0])
        out = eng.generate(prompt, max_new_tokens=9, eos_id=first)[0]
        assert out.shape == (9,)
        assert out.tolist() == [first] * 9


class TestContinuousEngine:
    def test_matches_fixed_engine_per_request(self, carried):
        _, _, lm, params = carried
        reqs = _reqs(4, max_new=5)
        want = _fixed_reference(lm, params, reqs)
        got = _continuous(lm, params, num_slots=2, chunk_size=4).serve(reqs)
        for i, (w, g) in enumerate(zip(want, got)):
            assert g.tolist() == w.tolist(), f"request {i}"

    def test_recycling_across_many_admissions(self, carried):
        _, _, lm, params = carried
        base = _reqs(3, max_new=4)
        want = _fixed_reference(lm, params, base)
        reqs = [base[i % 3] for i in range(9)]
        got = _continuous(lm, params, num_slots=3, chunk_size=4).serve(reqs)
        for i, g in enumerate(got):
            assert g.tolist() == want[i % 3].tolist(), f"request {i}"

    def test_decode_inputs_keep_their_shapes_and_buffers(self, carried):
        """Admissions and recycles rewrite table/lens/active contents only:
        every decode step of the engine's life sees the same tensors."""
        _, _, lm, params = carried
        eng = _continuous(lm, params, num_slots=2, chunk_size=4)
        table = eng.state["table"]
        eng.serve(_reqs(5, seed=1, max_new=3))
        eng.serve(_reqs(3, seed=2, max_new=6))
        assert len(eng.decode_inputs) == 1
        assert eng.state["table"] is table

    def test_eos_never_emits_past_eos(self, carried):
        _, _, lm, params = carried
        reqs = _reqs(4, seed=3, max_new=24)      # crosses EOS_CHECK_EVERY
        want = _fixed_reference(lm, params, reqs)
        eos = int(want[0][2])
        got = _continuous(lm, params, num_slots=2, chunk_size=4).serve(
            reqs, eos_id=eos)
        for i, (w, g) in enumerate(zip(want, got)):
            wl = w.tolist()
            trimmed = wl[:wl.index(eos)] if eos in wl else wl
            assert g.tolist() == trimmed, f"request {i}"
            assert eos not in g.tolist()

    def test_slot_capacity_never_overflows(self, carried):
        _, _, lm, params = carried
        prompt = np.arange(20, dtype=np.int32) % 64
        eng = _continuous(lm, params, num_slots=2, max_len=32, chunk_size=8)
        got = eng.serve([(prompt, 12)])          # 20 + 12 == capacity
        assert len(got[0]) == 12
        assert not eng.sched.running
        assert eng.sched.num_free_pages == eng.spec.num_pages - 1

    def test_stats_account_for_every_token(self, carried):
        _, _, lm, params = carried
        reqs = _reqs(3, seed=5, max_new=4)
        outs, stats = _continuous(lm, params, num_slots=2,
                                  chunk_size=4).serve(reqs,
                                                      collect_stats=True)
        assert sum(stats.tokens_per_iter) == sum(len(o) for o in outs) == 12
        assert len(stats.first_token_times) == 3
        assert len(stats.iter_times) == len(stats.occupancy)


class TestSampling:
    def test_greedy_is_argmax(self):
        logits = torch.tensor([[0.1, 3.0, -1.0], [2.0, 0.0, 5.0]])
        out = sample_token(None, logits, SamplingParams(greedy=True))
        assert out.tolist() == [1, 2] and out.dtype == torch.int32

    def test_top_k_restricts_support(self):
        logits = torch.tensor([[10.0, 9.0, -50.0, -50.0]] * 64)
        gen = torch.Generator().manual_seed(1)
        out = sample_token(gen, logits, SamplingParams(temperature=1.0,
                                                       top_k=2))
        assert set(out.tolist()) <= {0, 1}

    def test_temperature_flattens(self):
        logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]] * 512)
        hot = sample_token(torch.Generator().manual_seed(2), logits,
                           SamplingParams(temperature=0.05))
        warm = sample_token(torch.Generator().manual_seed(2), logits,
                            SamplingParams(temperature=5.0))
        assert len(set(hot.tolist())) <= len(set(warm.tolist()))

    def test_same_generator_seed_same_samples(self):
        logits = torch.randn(16, 32,
                             generator=torch.Generator().manual_seed(0))
        sp = SamplingParams(temperature=0.7, top_k=8)
        a = sample_token(torch.Generator().manual_seed(4), logits, sp)
        b = sample_token(torch.Generator().manual_seed(4), logits, sp)
        assert torch.equal(a, b)
