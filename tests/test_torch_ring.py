"""The port's serving at mesh scope (repro_torch.distributed.attention, the
ring-striped page pool, both engines and ``launch.serve`` under
``use_level(O3|O4)``) against the JAX package's on the same numpy inputs.

The port runs on 8 gloo ranks of one spawned world (one per test module):
every rank builds the O3 mesh (data 8, model 1) and the O4 mesh (pod 2,
data 2, model 2) over the world, runs every case below and sends its
results back; every rank's results must be the same bits.  The JAX side
runs the same calls on the 8 forced host devices (``mesh8``, ``mesh222``),
as tests/test_ring_attention.py and tests/test_serve.py do, while the
world runs.  The port's ContinuousEngine at O3 is held against the port's
O2 one and the JAX fixed Engine, never against the JAX ContinuousEngine
(ROADMAP queue 3 item 4).  A spawned rank imports this module by name, so
it imports no JAX at top level.
"""

import numpy as np
import pytest
import torch

WORLD = 8

#: tests/test_serve.py's paged config (page size 8), in the port's schema.
KW = dict(name="stest-paged", family="dense", num_layers=2, d_model=32,
          vocab_size=64, num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64,
          dtype="float32", param_dtype="float32", serve_page_size=8)
HEADS = {"gqa": (4, 2), "mqa": (4, 1), "mha": (4, 4)}


def _qkv(B=2, H=4, HK=2, L=64, D=16, vscale=1.0, seed=0):
    """tests/test_ring_attention.py's ``_qkv``, as numpy f32."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, L, D)).astype(np.float32)
    k = rng.standard_normal((B, HK, L, D)).astype(np.float32)
    v = (vscale * rng.standard_normal((B, HK, L, D))).astype(np.float32)
    return q, k, v


def _requests():
    """Four continuous-engine requests of two prompt lengths (5 and 11
    tokens, 5 new each), so the JAX fixed Engine compiles twice."""
    rng = np.random.default_rng(4)
    return [(rng.integers(0, 64, size=n).astype(np.int32), 5)
            for n in (5, 11, 5, 11)]


def _engine_prompts():
    return np.random.default_rng(1).integers(0, 64, (2, 32)).astype(np.int32)


def _paged_inputs(W=4):
    """tests/test_serve.py's O4 paged case: lens [37, 11, 0], 3 slots."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.serve import Request, Scheduler, make_spec

    spec = make_spec(ModelConfig(**KW), num_slots=3, max_tokens=48, ring=W)
    sched = Scheduler(spec, queue_depth=4)
    lens = [37, 11, 0]
    for rid, tot in enumerate(t for t in lens if t):
        sched.submit(Request(rid=rid, prompt=np.zeros(tot, np.int32),
                             max_new=0))
        assert sched.admit_next() is not None
    sched.lens[:] = lens
    rng = np.random.default_rng(11)
    B, H, HK, D = 3, 4, 2, 8
    q = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    kp = rng.standard_normal((spec.num_pages, HK, spec.page_size, D)) \
        .astype(np.float32)
    vp = rng.standard_normal((spec.num_pages, HK, spec.page_size, D)) \
        .astype(np.float32)
    return spec, q, kp, vp, sched.table.copy(), sched.lens.copy()


# ---------------------------------------------------------------------------
# the port's side: one world of 8 ranks runs every case
# ---------------------------------------------------------------------------

def _port_cases(rank, mesh8, mesh222, tmp):
    """Every case's results on this rank, keyed by the test that reads
    them."""
    import os

    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import ExecLevel, blocking, registry, settings
    from repro_torch.core import use_level
    from repro_torch.distributed import attention as tattn
    from repro_torch.distributed.collectives import ring_plan
    from repro_torch.models.lm import LM
    from repro_torch.obs import metrics
    from repro_torch.serve import ContinuousEngine, Engine, SamplingParams

    O3, O4 = ExecLevel.O3, ExecLevel.O4
    out = {}

    def record(name, fn):
        try:
            out[name] = fn()
        except Exception as e:                  # the test reads it
            out[name] = {"raised": f"{type(e).__name__}: {e}"}

    def t(*xs):
        return tuple(torch.as_tensor(x) for x in xs)

    def selection():
        q, k, v = t(*_qkv())
        got = {"chip": registry.select("flash_attention", q, k, v,
                                       causal=True).name}
        with use_level(O3, mesh8):
            got["o3"] = registry.select("flash_attention", q, k, v,
                                        causal=True).name
            got["pins"] = [registry.select("flash_attention", q, k, v,
                                           causal=True, variant=n).name
                           for n in ("torch", "ring")]
            pinned = registry.dispatch("flash_attention", q, k, v,
                                       causal=True, variant="torch")
            rows = registry.explain("flash_attention", q, k, v, causal=True)
            got["explain"] = [(r["variant"], r["scope"], r["selected"])
                              for r in rows]
        got["pinned_is_chip"] = torch.equal(pinned, registry.dispatch(
            "flash_attention", q, k, v, causal=True))
        with use_level(O4, mesh222):
            plan = ring_plan(mesh222)
            got["o4"] = (registry.select("flash_attention", q, k, v,
                                         causal=True).name, plan.axes,
                         plan.size)
        # causal needs 2 x 8 half-blocks; 40 % 16 != 0
        q, k, v = t(*_qkv(L=40))
        with use_level(O3, mesh8):
            got["indivisible"] = registry.select(
                "flash_attention", q, k, v, causal=True).scope
            deg = registry.dispatch("flash_attention", q, k, v, causal=True)
        got["indivisible_is_chip"] = torch.equal(deg, registry.dispatch(
            "flash_attention", q, k, v, causal=True))
        return got
    record("selection", selection)

    def numerics():
        got = {}
        for name, (H, HK) in HEADS.items():
            q, k, v = t(*_qkv(H=H, HK=HK))
            for causal in (True, False):
                with use_level(O3, mesh8):
                    got[f"o3 {name} {causal}"] = registry.dispatch(
                        "flash_attention", q, k, v, causal=causal).numpy()
                got[f"chip {name} {causal}"] = registry.dispatch(
                    "flash_attention", q, k, v, causal=causal).numpy()
        q, k, v = t(*_qkv())
        for causal in (True, False):
            with use_level(O4, mesh222):
                got[f"o4 {causal}"] = registry.dispatch(
                    "flash_attention", q, k, v, causal=causal).numpy()
        with use_level(O3, mesh8):
            for order in ("zigzag", "contiguous"):
                got[order] = tattn.ring_attention(q, k, v, causal=True,
                                                  order=order).numpy()
        qb, kb, vb = (x.bfloat16() for x in t(*_qkv(vscale=0.1)))
        with use_level(O3, mesh8):
            got["bf16 ring"] = registry.dispatch(
                "flash_attention", qb, kb, vb, causal=True).float().numpy()
        got["bf16 chip"] = registry.dispatch(
            "flash_attention", qb, kb, vb, causal=True).float().numpy()
        return got
    record("numerics", numerics)

    def paged():
        spec, q, kp, vp, table, lens = _paged_inputs()
        q, kp, vp, table, lens = t(q, kp, vp, table, lens)
        with use_level(O4, mesh222):
            plan = ring_plan(mesh222)
            lo, hi = spec.shard_range(plan.ring_index())
            mine = (kp[lo:hi], vp[lo:hi], table, lens)
            sel = registry.select("paged_attention", q, *mine)
            ring = registry.dispatch("paged_attention", q, *mine)
        chip = registry.dispatch("paged_attention", q, kp, vp, table, lens,
                                 variant="gather")
        return {"sel": (sel.name, sel.scope), "ring": ring.numpy(),
                "chip": chip.numpy()}
    record("paged", paged)

    def refusals():
        q, k, v = t(*_qkv())
        do = torch.as_tensor(np.random.default_rng(5).standard_normal(
            q.shape).astype(np.float32))

        def grads(fn):
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            return torch.autograd.grad(fn(*leaves), leaves, do)
        with use_level(O3, mesh8):
            ring = grads(lambda *a: tattn.ring_attention(*a, causal=True))
            with torch.no_grad():
                quiet = tattn.ring_attention(q, k, v, causal=True)
        chip = grads(lambda *a: registry.dispatch("flash_attention", *a,
                                                  causal=True))
        with pytest.raises(RuntimeError) as e2:
            tattn.ring_attention(q, k, v, causal=True)
        return {"grad": max(float((a - b).abs().max())
                            for a, b in zip(ring, chip)),
                "no_mesh": str(e2.value),
                "no_grad_shape": tuple(quiet.shape)}
    record("refusals", refusals)

    def premeasured():
        """premeasure under O3 on the ring's per-shard shapes writes the
        mesh-scoped key; the ring's per-shard dispatches read it."""
        saved = {k: os.environ.get(k) for k in (
            "REPRO_TORCH_AUTOTUNE", "REPRO_TORCH_AUTOTUNE_CACHE")}
        real = registry.device_type_of
        os.environ["REPRO_TORCH_AUTOTUNE"] = "1"
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(
            tmp, f"autotune-rank{rank}.json")
        settings.reload()
        # selection as on the card: the kernel wrappers, which run their
        # plain versions on host tensors
        registry.device_type_of = lambda *a: "cuda"
        try:
            q, k, v = t(*_qkv(D=32))
            n = q.shape[2] // WORLD
            with use_level(O3, mesh8):
                blocks = blocking.premeasure(
                    "flash_attention_state", q[:, :, :n], k[:, :, :n],
                    v[:, :, :n], causal=False)
                metrics.METRICS.reset("blocking.")
                ring = tattn.ring_attention(q, k, v, causal=False)
                hits = metrics.METRICS.counter(
                    "blocking.cache_hit.flash_attention_state").value
            keys = sorted(blocking.get_cache()._load())
        finally:
            registry.device_type_of = real
            for k_, v_ in saved.items():
                if v_ is None:
                    os.environ.pop(k_, None)
                else:
                    os.environ[k_] = v_
            settings.reload()
        chip = registry.dispatch("flash_attention", q, k, v, causal=False)
        return {"keys": keys, "hits": hits, "blocks": blocks,
                "close": bool(torch.allclose(ring, chip, rtol=1e-5,
                                             atol=1e-5))}
    record("premeasure", premeasured)

    cfg = ModelConfig(**KW)
    lm = LM(cfg)
    params = lm.init(0, device="cpu")   # the JAX side gets them restacked
    greedy = SamplingParams(greedy=True)

    def continuous():
        reqs = _requests()
        o2 = ContinuousEngine(lm, params, num_slots=2, max_len=64,
                              chunk_size=4, sampling=greedy)
        with use_level(O3, mesh8):
            o3 = ContinuousEngine(lm, params, num_slots=2, max_len=64,
                                  chunk_size=4, sampling=greedy)
        metrics.METRICS.reset("dispatch.paged_attention.")
        got = [x.tolist() for x in o3.serve(reqs)]
        return {"o3": got, "o2": [x.tolist() for x in o2.serve(reqs)],
                "ring": o3.ring, "spec_pages": o3.spec.num_pages,
                "pool": tuple(o3.state["kpages"].shape),
                "o2_pages": (o2.spec.num_pages,
                             o2.state["kpages"].shape[1]),
                "ring_decodes": metrics.METRICS.counter(
                    "dispatch.paged_attention.ring").value,
                "decode_inputs": len(o3.decode_inputs)}
    record("continuous", continuous)

    def engine():
        with use_level(O3, mesh8):
            eng = Engine(lm, params, max_len=48, sampling=greedy)
        metrics.METRICS.reset("dispatch.flash_attention.")
        toks = eng.generate(torch.as_tensor(_engine_prompts()),
                            max_new_tokens=4)
        return {"tokens": toks.numpy(), "level": eng.active_level.level.name,
                "mesh_is_pinned": eng.active_level.mesh is mesh8,
                "ring_prefills": metrics.METRICS.counter(
                    "dispatch.flash_attention.ring").value}
    record("engine", engine)
    return out


def _port_world(rank: int, world: int, tmp: str):
    from repro_torch.launch.mesh import make_mesh

    # eight ranks share the host's cores: one thread each (eight threads
    # each made every gloo collective about 100x slower)
    torch.set_num_threads(1)
    mesh8 = make_mesh(data=world, device_type="cpu")
    mesh222 = make_mesh(data=2, model=2, pod=2, device_type="cpu")
    return _port_cases(rank, mesh8, mesh222, tmp)


def _same_bits(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_bits(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_bits(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_params():
    """The JAX LM and its parameters: the port's seeded init (which every
    rank draws too) restacked as the port's Checkpointer stacks it, in the
    JAX package's layout; no JAX compile."""
    import re

    from repro.configs.base import ModelConfig as JCfg
    from repro.models.lm import LM as JLM
    from repro_torch.checkpoint import checkpointer as ckpt_mod
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.lm import LM

    tree: dict = {}
    for path, leaf in ckpt_mod._paths(LM(ModelConfig(**KW)).init(
            0, device="cpu")):
        keys = re.findall(r"\['([^']+)'\]", path)
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = ckpt_mod._stack(leaf).numpy()
    return JLM(JCfg(**KW, remat=False)), tree


def _jax_cases(jl, jp):
    import jax.numpy as jnp

    from repro.core import ExecLevel, compat, registry, use_level
    from repro.distributed import attention as rattn
    from repro.serve import Engine as JEngine
    from repro.serve import SamplingParams as JSampling

    mesh8 = compat.make_mesh((8, 1), ("data", "model"))
    mesh222 = compat.make_mesh((2, 2, 2), ("pod", "data", "model"))
    O3, O4 = ExecLevel.O3, ExecLevel.O4
    out = {}

    def j(*xs):
        return tuple(jnp.asarray(x) for x in xs)

    for name, (H, HK) in HEADS.items():
        q, k, v = j(*_qkv(H=H, HK=HK))
        for causal in (True, False):
            with use_level(O3, mesh8):
                assert registry.select("flash_attention", q, k, v,
                                       causal=causal).name == "ring"
                out[f"o3 {name} {causal}"] = np.asarray(registry.dispatch(
                    "flash_attention", q, k, v, causal=causal))
    q, k, v = j(*_qkv())
    for causal in (True, False):
        with use_level(O4, mesh222):
            out[f"o4 {causal}"] = np.asarray(registry.dispatch(
                "flash_attention", q, k, v, causal=causal))
    with use_level(O3, mesh8):
        for order in ("zigzag", "contiguous"):
            out[order] = np.asarray(rattn.ring_attention(
                q, k, v, causal=True, order=order))

    _, q, kp, vp, table, lens = _paged_inputs()
    with use_level(O4, mesh222):
        out["paged"] = np.asarray(registry.dispatch(
            "paged_attention", *j(q, kp, vp, table, lens)))

    greedy = JSampling(greedy=True)
    fixed = JEngine(jl, jp, max_len=64, sampling=greedy)
    reqs = _requests()
    by_len = {}
    for i, (p, m) in enumerate(reqs):
        by_len.setdefault(len(p), []).append(i)
    out["fixed"] = [None] * len(reqs)
    for idx in by_len.values():
        got = fixed.generate(jnp.asarray(np.stack([reqs[i][0] for i in idx])),
                             max_new_tokens=reqs[idx[0]][1])
        for row, i in zip(np.asarray(got), idx):
            out["fixed"][i] = row.tolist()
    with use_level(O3, mesh8):
        ring_engine = JEngine(jl, jp, max_len=48, sampling=greedy)
    out["engine"] = np.asarray(ring_engine.generate(
        jnp.asarray(_engine_prompts()), max_new_tokens=4))
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the port's results, the JAX package's): the 8-rank gloo world runs
    while the JAX side computes; every rank must return the same bits."""
    from repro_torch.launch.world import start_world

    tmp = str(tmp_path_factory.mktemp("ring"))
    world = start_world(_port_world, WORLD, args=(tmp,), timeout=240)
    try:
        jx = _jax_cases(*_jax_params())
    finally:
        ranks = world.join()
    for r, res in enumerate(ranks[1:], 1):
        assert _same_bits(res, ranks[0]), f"rank {r} differs from rank 0"
    return ranks[0], jx


def _ok(res):
    assert not (isinstance(res, dict) and res.get("raised")), res["raised"]
    return res


# ---------------------------------------------------------------------------
# the helpers, against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length,ring", [(32, 4), (30, 4), (32, 1), (64, 8)])
def test_zigzag_perm_equals_reference(length, ring):
    from repro.distributed import attention as rattn
    from repro_torch.distributed import attention as tattn

    want, got = rattn.zigzag_perm(length, ring), tattn.zigzag_perm(length,
                                                                  ring)
    if want is None:
        assert got is None
        return
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    order, inv = got
    np.testing.assert_array_equal(order[inv], np.arange(length))


def test_merge_equals_reference():
    import jax.numpy as jnp

    from repro.distributed import attention as rattn
    from repro_torch.distributed import attention as tattn

    rng = np.random.default_rng(3)

    def state():
        m = rng.standard_normal((2, 3, 5)).astype(np.float32)
        m[0, 0, 0] = -1e30                      # a state with no live key
        l = rng.random((2, 3, 5)).astype(np.float32) + 0.5
        o = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
        return o, m, l

    a, b = state(), state()
    want = rattn._merge(rattn._as_state(*map(jnp.asarray, a)),
                        rattn._as_state(*map(jnp.asarray, b)))
    got = tattn._merge(tattn._as_state(*map(torch.as_tensor, a)),
                       tattn._as_state(*map(torch.as_tensor, b)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_local_pages_masks_foreign_ids():
    from repro_torch.serve.kvcache import local_pages

    ids = torch.tensor([0, 5, 6, 11, 12, 23])
    loc, mine = local_pages(ids, 1, 6)          # shard 1 holds ids 6..11
    assert mine.tolist() == [False, False, True, True, False, False]
    assert loc.tolist() == [0, 0, 0, 5, 5, 5]


def test_shard_views_split_every_slot_between_the_shards():
    """Each shard's decode view holds, as its valid prefix, the tokens of
    the table positions it owns, in order; the shards' valid lengths add
    up to the slot's length."""
    from repro_torch.serve import Request, Scheduler, make_spec
    from repro_torch.serve.kvcache import shard_view
    from repro_torch.configs.base import ModelConfig

    W, lens = 2, [37, 11, 0]
    spec = make_spec(ModelConfig(**KW), num_slots=3, max_tokens=48, ring=W)
    sched = Scheduler(spec, queue_depth=3)
    for rid, n in enumerate(lens):
        sched.submit(Request(rid=rid, prompt=np.zeros(max(n, 1), np.int32),
                             max_new=0))
        sched.admit_next()
    sched.lens[:] = lens
    ps, P = spec.page_size, spec.num_pages
    # the whole pool's page p, offset o holds the token value p * ps + o
    whole = torch.arange(P * ps, dtype=torch.float32).reshape(P, 1, ps, 1)
    table = torch.as_tensor(sched.table)
    got = 0
    for r in range(W):
        lo, hi = spec.shard_range(r)
        k, _, llen = shard_view(whole[lo:hi], whole[lo:hi], table,
                                torch.as_tensor(sched.lens), r, W)
        for b, n in enumerate(lens):
            want = [int(table[b, p]) * ps + o
                    for p in range(r, table.shape[1], W)
                    for o in range(ps) if p * ps + o < n]
            assert k[b, 0, :int(llen[b]), 0].tolist() == want
        got = got + llen
    assert got.tolist() == lens


def test_one_process_mesh_degrades_to_chip():
    """No process group: use_level(O3) runs on the one-process mesh, whose
    ring is 1 wide; selection degrades to the chip variant, same bits."""
    from repro_torch.core import ExecLevel, registry, use_level

    q, k, v = (torch.as_tensor(x) for x in _qkv())
    chip = registry.dispatch("flash_attention", q, k, v, causal=True)
    with use_level(ExecLevel.O3) as ctx:
        sel = registry.select("flash_attention", q, k, v, causal=True)
        got = registry.dispatch("flash_attention", q, k, v, causal=True)
    assert tuple(ctx.mesh.shape) == (1, 1)
    assert sel.scope == "chip"
    assert torch.equal(got, chip)


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------

class TestRingSelection:
    def test_ring_under_mesh_chip_without(self, both):
        got = _ok(both[0]["selection"])
        assert got["o3"] == "ring" and got["chip"] == "torch"

    def test_explicit_variant_pins(self, both):
        got = _ok(both[0]["selection"])
        assert got["pins"] == ["torch", "ring"]
        assert got["pinned_is_chip"]

    def test_indivisible_length_degrades(self, both):
        got = _ok(both[0]["selection"])
        assert got["indivisible"] == "chip" and got["indivisible_is_chip"]

    def test_o4_rings_over_pod_and_data(self, both):
        assert _ok(both[0]["selection"])["o4"] == ("ring", ("pod", "data"),
                                                   4)

    def test_explain_shows_the_ring_row_with_its_scope(self, both):
        rows = _ok(both[0]["selection"])["explain"]
        assert ("ring", "mesh", True) in rows
        assert [r for r in rows if r[2]] == [("ring", "mesh", True)]


# ---------------------------------------------------------------------------
# numerics: the port's ring == the JAX package's ring == chip
# ---------------------------------------------------------------------------

class TestRingNumerics:
    @pytest.mark.parametrize("heads", list(HEADS))
    @pytest.mark.parametrize("causal", [True, False],
                             ids=["causal", "full"])
    def test_o3_matches_jax_ring_and_chip(self, both, heads, causal):
        port, jx = both
        got = _ok(port["numerics"])
        key = f"o3 {heads} {causal}"
        np.testing.assert_allclose(got[key], jx[key], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[key], got[f"chip {heads} {causal}"],
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("causal", [True, False],
                             ids=["causal", "full"])
    def test_o4_matches_jax_ring(self, both, causal):
        port, jx = both
        got = _ok(port["numerics"])
        np.testing.assert_allclose(got[f"o4 {causal}"], jx[f"o4 {causal}"],
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("order", ["zigzag", "contiguous"])
    def test_orderings_match_jax(self, both, order):
        port, jx = both
        got = _ok(port["numerics"])
        np.testing.assert_allclose(got[order], jx[order], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got[order], got["chip gqa True"],
                                   rtol=1e-5, atol=1e-5)

    def test_bf16_within_1e3_of_chip(self, both):
        got = _ok(both[0]["numerics"])
        np.testing.assert_allclose(got["bf16 ring"], got["bf16 chip"],
                                   atol=1e-3)


class TestPagedRing:
    def test_o4_matches_jax_and_chip(self, both):
        port, jx = both
        got = _ok(port["paged"])
        assert got["sel"] == ("ring", "mesh")
        # the slot with lens 0 is garbage in every path; no engine reads it
        for b, n in enumerate((37, 11, 0)):
            if n == 0:
                continue
            np.testing.assert_allclose(got["ring"][b], jx["paged"][b],
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got["ring"][b], got["chip"][b],
                                       rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

class TestEngines:
    def test_continuous_o3_equals_o2_and_jax_fixed(self, both):
        port, jx = both
        got = _ok(port["continuous"])
        assert got["o3"] == got["o2"] == jx["fixed"]

    def test_continuous_o3_stripes_the_pool(self, both):
        got = _ok(both[0]["continuous"])
        assert got["ring"] == WORLD
        assert got["pool"][1] == got["spec_pages"] // WORLD
        pages, held = got["o2_pages"]
        assert held == pages                # one card holds the whole pool
        assert got["ring_decodes"] > 0 and got["decode_inputs"] == 1

    def test_engine_pins_the_level_for_prefill(self, both):
        port, jx = both
        got = _ok(port["engine"])
        assert got["level"] == "O3" and got["mesh_is_pinned"]
        assert got["ring_prefills"] == KW["num_layers"]
        np.testing.assert_array_equal(got["tokens"], jx["engine"])


# ---------------------------------------------------------------------------
# refusals, the shard-scoped premeasure, the launcher
# ---------------------------------------------------------------------------

class TestRefusals:
    def test_grad_raises_naming_10b_ii(self, both):
        """Ring attention differentiates now (the raise this test held
        until the mesh trainer was ported is gone): whole q, k and v on
        every rank get the chip attention's gradients, whole, at the JAX
        suite's f32 tolerance."""
        got = _ok(both[0]["refusals"])
        assert got["grad"] <= 1e-5
        assert got["no_grad_shape"] == (2, 4, 64, 16)

    def test_without_a_mesh_raises(self, both):
        assert "ambient O3/O4 mesh" in _ok(both[0]["refusals"])["no_mesh"]


def test_premeasure_writes_the_mesh_key_the_ring_reads(both):
    got = _ok(both[0]["premeasure"])
    key = ("flash_attention_state|b=2,causal=0,d=32,h=4,lk=8,lq=8|float32|"
           "mesh|data8xmodel1")
    assert got["keys"] == [key]
    assert got["hits"] == WORLD            # every hop's per-shard call
    assert got["blocks"] == {"q": 8, "k": 8} and got["close"]


def _cli_rank(rank, world, argv):
    """A rank of the launcher's world with tiny("dense") registered."""
    from repro_torch.configs import REGISTRY
    from repro_torch.configs.base import ModelConfig
    from repro_torch.launch import serve

    REGISTRY["tiny-dense"] = ModelConfig(
        name="tiny-dense", family="dense", num_layers=2, d_model=32,
        vocab_size=64, num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64,
        dtype="float32", param_dtype="float32")
    return serve._rank_main(rank, world, argv)


def test_launch_serve_o3_ranks_prints_the_ring(monkeypatch, capsys):
    from repro_torch.launch import serve

    monkeypatch.setattr(serve, "_rank_main", _cli_rank)
    assert serve.main(["--arch", "tiny-dense", "--scale", "1.0",
                       "--opt-level", "O3", "--ranks", "2", "--device",
                       "cpu", "--prompt-len", "32", "--new-tokens", "4",
                       "--batch", "2"]) == 0
    out = capsys.readouterr().out
    assert "engine level O3 on Mesh(data=2, model=1; 2 devices)" in out
    assert "prefill: flash_attention -> ring (mesh scope)" in out
    assert "generated (2, 4)" in out


def test_launch_serve_without_a_world_says_so(capsys):
    from repro_torch.configs import REGISTRY
    from repro_torch.configs.base import ModelConfig
    from repro_torch.launch import serve

    cfg = ModelConfig(**{**KW, "name": "tiny-dense-paged"})
    REGISTRY[cfg.name] = cfg
    try:
        assert serve.main(["--arch", cfg.name, "--scale", "1.0",
                           "--opt-level", "O3", "--device", "cpu",
                           "--prompt-len", "32", "--new-tokens", "3",
                           "--batch", "2"]) == 0
    finally:
        del REGISTRY[cfg.name]
    out = capsys.readouterr().out
    assert "without a process group" in out
    assert "prefill: flash_attention -> torch (chip scope); degraded" in out
