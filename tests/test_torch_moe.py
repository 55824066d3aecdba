"""The port's MoE family (repro_torch.models.moe, the MoE blocks of
repro_torch.models.transformer, the MoE branches of the LM facade, its two
configs, reduce_config, the router's f32 carry and the serve launcher)
against the JAX package's (repro.models), on carried parameters and the
same numpy inputs.

Bars: f32 1e-5 for outputs and logits (tests/test_torch_models.py's), 1e-6
(absolute and relative) for the aux losses; rows that a capacity drop
zeroes must be exactly zero in both.  bf16 ``moe_apply`` (f32 router, bf16
activations and experts): 2e-2 relative to the largest output.  The bf16
LM: a near-tie in the router can flip in bf16, so its top-k sets must
agree on at least 95 % of (token, layer) pairs, and on the tokens whose
sets agree in every layer the logits within 3e-2 of the largest logit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as j_get_config
from repro.configs.base import ModelConfig as JCfg
from repro.models import moe as j_moe
from repro.models.lm import LM as JLM
from repro.serve import init_cache_state as j_init_state
from repro.serve import make_spec as j_make_spec
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig as TCfg
from repro_torch.interop import carry_params, carry_train_state
from repro_torch.models import moe as t_moe
from repro_torch.models.lm import DECODE_CAPACITY_FACTOR
from repro_torch.models.lm import LM as TLM
from repro_torch.serve import init_cache_state as t_init_state
from repro_torch.serve import make_spec as t_make_spec

TOL = dict(rtol=1e-5, atol=1e-5)
AUX_TOL = dict(rtol=1e-6, atol=1e-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _pair(**kw):
    """The same config in both packages."""
    return JCfg(**kw), TCfg(**kw)


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

def _layer_pair(E, k, d=16, f=24, pdtype="float32", seed=0):
    """A JAX MoE layer's config and parameters, and the port's carried
    copy (the router stays f32)."""
    kw = dict(name="moe-layer", family="moe", num_layers=1, d_model=d,
              vocab_size=16, num_experts=E, experts_per_token=k, moe_d_ff=f,
              dtype="float32", param_dtype=pdtype)
    jc, tc = _pair(**kw)
    jp = j_moe.moe_init(jax.random.PRNGKey(seed), jc)
    tp = {n: torch.as_tensor(np.array(v, np.float32)).to(
        t_moe.ROUTER_DTYPE if n == "router" else tc.pdtype)
        for n, v in jp.items()}
    return jc, jp, tc, tp


#: (B, L, E, k, capacity_factor, groups): C per group is
#: max(1, round(t k / E cf)) with t = B L / groups.
APPLY_CASES = {
    "no_drops": (2, 10, 8, 2, 8.0, 1),            # C = 20
    "drops": (4, 16, 8, 2, 1.25, 1),              # C = 20, 128 slots
    "c1": (2, 8, 4, 2, 1e-9, 1),                  # C = 1
    "half_even": (1, 10, 8, 2, 1.0, 1),           # 2.5 -> C = 2
    "top1": (3, 4, 4, 1, 1.25, 1),                # C = round(3.75) = 4
    "groups2": (2, 12, 8, 2, 1.25, 2),            # t = 12, C = 4
}


@pytest.mark.parametrize("case", sorted(APPLY_CASES))
def test_moe_apply_matches_jax(case):
    B, L, E, k, cf, G = APPLY_CASES[case]
    jc, jp, tc, tp = _layer_pair(E, k, seed=len(case))
    x = np.random.default_rng(B * L + E).standard_normal(
        (B, L, 16)).astype(np.float32)
    jy, jaux = j_moe.moe_apply(jnp.asarray(x), jp, jc, capacity_factor=cf,
                               groups=G)
    with t_moe.record_routing() as routes:
        ty, taux = t_moe.moe_apply(torch.as_tensor(x), tp, tc,
                                   capacity_factor=cf, groups=G)
    _close(ty, jy)
    for name in ("aux_lb", "aux_z"):
        _close(taux[name], jaux[name], **AUX_TOL)
    np.testing.assert_array_equal((_np(ty) == 0).all(-1),
                                  (np.asarray(jy) == 0).all(-1))
    # the case is what it says: the heaviest expert of a group over C or not
    (gate_i,) = routes
    t = B * L // G
    C = t_moe.capacity(t, k, E, cf)
    load = max(int(np.bincount(g.reshape(-1), minlength=E).max())
               for g in gate_i.numpy())
    assert gate_i.shape == (G, t, k)
    assert (load > C) == (case not in ("no_drops",)), (load, C)
    if case == "half_even":
        assert C == 2
    if case == "c1":
        assert C == 1


def test_moe_apply_bf16_matches_jax():
    """bf16 activations and expert weights, the router in f32 on both
    sides: the same routing and outputs within 2e-2 of the largest."""
    jc, jp, tc, tp = _layer_pair(8, 2, pdtype="bfloat16", seed=5)
    assert jp["router"].dtype == jnp.float32
    assert tp["router"].dtype == torch.float32
    assert tp["wo"].dtype == torch.bfloat16
    x = np.random.default_rng(7).standard_normal((2, 24, 16)).astype(
        np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.as_tensor(np.array(jx.astype(jnp.float32))).bfloat16()
    jy, jaux = j_moe.moe_apply(jx, jp, jc, capacity_factor=1.25)
    ty, taux = t_moe.moe_apply(tx, tp, tc, capacity_factor=1.25)
    assert ty.dtype == torch.bfloat16
    want = np.asarray(jy.astype(jnp.float32))
    np.testing.assert_allclose(_np(ty), want, rtol=2e-2,
                               atol=2e-2 * np.abs(want).max())
    for name in ("aux_lb", "aux_z"):
        _close(taux[name], jaux[name], **AUX_TOL)


def _dense_mixture(x, p, k):
    """Every expert on every token (no dispatch, no capacity), mixed by the
    renormalised top-k router weights: the plain function moe_apply
    computes when nothing drops."""
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[..., :k], idx[..., :k]
    w = w / w.sum(-1, keepdim=True)
    gate = torch.einsum("btd,edf->btef", x, p["wi_gate"])
    up = torch.einsum("btd,edf->btef", x, p["wi_up"])
    out = torch.einsum("btef,efd->bted", torch.nn.functional.silu(gate) * up,
                       p["wo"])
    picked = torch.gather(out, 2, idx[..., None].expand(*idx.shape,
                                                        out.shape[-1]))
    return (picked * w[..., None]).sum(2), w


@settings(max_examples=8, deadline=None)
@given(tokens=st.integers(2, 16), experts=st.sampled_from([2, 4, 8]),
       k=st.integers(1, 3), seed=st.integers(0, 2**16))
def test_moe_output_is_convex_combination(tokens, experts, k, seed):
    """tests/test_properties.py's MoE invariants on the port: with
    capacity for every token (no drops) each token's output is the convex
    mix of its top-k experts' outputs (weights >= 0 summing to 1), finite,
    with a load-balance loss in range; at C = 1 at most E rows are
    nonzero."""
    k = min(k, experts)
    cfg = TCfg(name="t", family="moe", num_layers=1, d_model=8,
               vocab_size=16, num_experts=experts, experts_per_token=k,
               moe_d_ff=16, dtype="float32", param_dtype="float32")
    gen = torch.Generator().manual_seed(seed)
    p = t_moe.moe_init(gen, cfg)
    x = torch.randn((1, tokens, 8), generator=gen)
    y_full, aux = t_moe.moe_apply(x, p, cfg,
                                  capacity_factor=float(experts))
    assert torch.isfinite(y_full).all()
    want, w = _dense_mixture(x, p, k)
    assert (w >= 0).all()
    torch.testing.assert_close(w.sum(-1), torch.ones_like(w[..., 0]))
    torch.testing.assert_close(y_full, want, **TOL)
    assert 0.4 <= float(aux["aux_lb"]) <= float(experts) + 1e-3
    y_drop, _ = t_moe.moe_apply(x, p, cfg, capacity_factor=1e-9)
    nonzero_rows = int((y_drop[0].abs() > 1e-9).any(-1).sum())
    assert nonzero_rows <= experts


# ---------------------------------------------------------------------------
# the LM facade
# ---------------------------------------------------------------------------

def tiny_moe(**kw):
    """tests/test_models.py's tiny("moe")."""
    base = dict(name="tiny-moe", family="moe", num_layers=2, d_model=32,
                vocab_size=64, dtype="float32", param_dtype="float32",
                remat=False, num_heads=4, num_kv_heads=2, head_dim=8,
                d_ff=0, num_experts=4, experts_per_token=2, moe_d_ff=32,
                capacity_factor=4.0, serve_page_size=8)
    base.update(kw)
    return _pair(**base)


#: tiny("moe"), with arctic's dense residual branch, and with experts
#: enough that the fixed and paged decode steps drop (capacity at
#: DECODE_CAPACITY_FACTOR for 3 slots: round(3 * 2 / 32 * 4) = 1), the
#: training-time capacity factor 1.25 dropping too.
LM_CONFIGS = {
    "tiny": tiny_moe(),
    "dense_residual": tiny_moe(name="tiny-moe-dr", dense_residual=True,
                               d_ff=48),
    "decode_drops": tiny_moe(name="tiny-moe-drops", num_experts=32,
                             capacity_factor=1.25),
}


@pytest.fixture(scope="module", params=sorted(LM_CONFIGS))
def models(request):
    jc, tc = LM_CONFIGS[request.param]
    jl, tl = JLM(jc), TLM(tc)
    jp = jl.init(jax.random.PRNGKey(0))
    tp = carry_params(jax.tree_util.tree_map(np.asarray, jp), tc,
                      device="cpu")
    return jl, jp, tl, tp


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def test_forward_and_aux_match_jax(models):
    jl, jp, tl, tp = models
    tok = _tokens(tl.cfg, (2, 12), 2)
    want, jaux = jl.forward(jp, jnp.asarray(tok))
    got, taux = tl.forward(tp, torch.as_tensor(tok))
    assert got.shape == (2, 12, tl.cfg.vocab_size)
    _close(got, want)
    for name in ("aux_lb", "aux_z"):
        assert float(taux[name]) > 0
        _close(taux[name], jaux[name], **AUX_TOL)


def test_loss_and_its_aux_terms_match_jax(models):
    jl, jp, tl, tp = models
    seq = _tokens(tl.cfg, (2, 13), 3)
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    jloss, jm = jl.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tm = tl.loss(tp, batch)
    _close(tloss, jloss, **AUX_TOL)
    _close(tm["loss"], jm["loss"], **AUX_TOL)
    _close(tm["aux_lb"], jm["aux_lb"], **AUX_TOL)
    assert float(tloss) > float(tm["loss"])       # the aux terms are in
    assert int(tm["tokens"]) == int(jm["tokens"])


def test_prefill_and_decode_steps_match_jax(models):
    jl, jp, tl, tp = models
    tok = _tokens(tl.cfg, (3, 9), 4)
    jlog, jcache = jl.prefill(jp, jnp.asarray(tok), max_len=16)
    tlog, tcache = tl.prefill(tp, torch.as_tensor(tok), max_len=16)
    _close(tlog, jlog)
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])
    assert tcache["cur_len"] == int(jcache["cur_len"]) == 9
    for _ in range(3):
        nxt = np.argmax(_np(jlog), axis=-1).astype(np.int32)[:, None]
        jlog, jcache = jl.decode_step(jp, jcache, jnp.asarray(nxt))
        tlog, tcache = tl.decode_step(tp, tcache, torch.as_tensor(nxt))
        _close(tlog, jlog)
    _close(tcache["v"], jcache["v"])


def test_remat_passes_the_aux_losses_through():
    """With remat each MoE block runs under torch.utils.checkpoint, which
    must hand back its aux dict: the loss (aux terms included) and every
    gradient equal the run without remat bitwise."""
    from repro_torch.train.step import value_and_grad
    from repro_torch.utils.tree import tree_leaves

    _, tc = tiny_moe(name="tiny-moe-remat", dense_residual=True, d_ff=48)
    tp = TLM(tc).init(0, device="cpu")
    seq = _tokens(tc, (2, 13), 9)
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    out = {}
    for remat in (False, True):
        lm = TLM(dataclasses.replace(tc, remat=remat))
        (loss, metrics), grads = value_and_grad(lm.loss, tp, batch)
        out[remat] = (loss, metrics["aux_lb"], grads)
    assert torch.equal(out[False][0], out[True][0])
    assert torch.equal(out[False][1], out[True][1])
    for a, b in zip(tree_leaves(out[False][2]), tree_leaves(out[True][2])):
        assert torch.equal(a, b)
    # the router learns through the gate weights and the aux terms
    assert out[True][2]["layers"][0]["moe"]["router"].abs().max() > 0


def _admitted_table(spec, lens_list):
    table = np.zeros((spec.num_slots, spec.pages_per_slot), np.int32)
    nxt = 1
    for slot, n in enumerate(lens_list):
        for p in range(spec.pages_for(n)):
            table[slot, p] = nxt
            nxt += 1
    return table


def _drops(routes, E, cf):
    """How many routed slots of the recorded calls fell past capacity."""
    n = 0
    for gate_i in routes:
        G, t, k = gate_i.shape
        C = t_moe.capacity(t, k, E, cf)
        for g in gate_i.numpy():
            n += int(np.maximum(np.bincount(g.reshape(-1)) - C, 0).sum())
    return n


def test_chunked_prefill_and_paged_decode_match_jax(models):
    """Chunks of 6 with a padded last chunk (its padding is routed, as in
    the JAX package), then paged decode with slot 2 inactive (its token is
    routed and takes capacity), compared on the active rows."""
    jl, jp, tl, tp = models
    cfg = tl.cfg
    jspec = j_make_spec(jl.cfg, num_slots=3, max_tokens=40)
    tspec = t_make_spec(cfg, num_slots=3, max_tokens=40)
    table = _admitted_table(tspec, [30, 20, 0])
    jst = dict(j_init_state(jl.cfg, jspec), table=jnp.asarray(table))
    tst = t_init_state(cfg, tspec, device="cpu")
    tst["table"].copy_(torch.as_tensor(table))
    prompts = {0: _tokens(cfg, (13,), 5), 1: _tokens(cfg, (5,), 6)}
    for slot, prompt in prompts.items():
        for s0 in range(0, len(prompt), 6):
            valid = min(6, len(prompt) - s0)
            chunk = np.zeros(6, np.int32)
            chunk[:valid] = prompt[s0:s0 + valid]
            jlog, jst = jl.prefill_chunk(jp, jst, jnp.asarray(chunk),
                                         np.int32(slot), np.int32(s0),
                                         np.int32(valid))
            tlog, tst = tl.prefill_chunk(tp, tst, torch.as_tensor(chunk),
                                         slot, s0, valid)
            _close(tlog, jlog)
    np.testing.assert_array_equal(_np(tst["lens"]), np.asarray(jst["lens"]))
    active = np.asarray([1, 1, 0], np.int32)
    cur = np.asarray([[3], [7], [11]], np.int32)
    with t_moe.record_routing() as routes:
        for _ in range(3):
            jlog, jst = jl.decode_step_paged(jp, jst, jnp.asarray(cur),
                                             jnp.asarray(active))
            tlog, tst = tl.decode_step_paged(tp, tst, torch.as_tensor(cur),
                                             torch.as_tensor(active))
            _close(tlog[active > 0], np.asarray(jlog)[active > 0])
            cur = np.argmax(np.asarray(jlog), -1).astype(np.int32)[:, None]
    np.testing.assert_array_equal(_np(tst["lens"]), np.asarray(jst["lens"]))
    _close(tst["kpages"][:, 1:], np.asarray(jst["kpages"])[:, 1:])
    if cfg.num_experts == 32:
        assert _drops(routes, 32, DECODE_CAPACITY_FACTOR) > 0


def _jax_routes(monkeypatch):
    """Record the JAX package's top-k sets as its LM runs them: wrap its
    moe_apply (the module attribute its blocks call) and recompute the
    router's top-k from the call's own inputs."""
    calls = []
    orig = j_moe.moe_apply

    def spy(x, p, cfg, **kw):
        logits = jnp.einsum("btd,de->bte", x.astype(jnp.float32),
                            p["router"])
        _, idx = jax.lax.top_k(jax.nn.softmax(logits, -1),
                               cfg.experts_per_token)
        calls.append(np.asarray(idx).reshape(-1, cfg.experts_per_token))
        return orig(x, p, cfg, **kw)

    monkeypatch.setattr(j_moe, "moe_apply", spy)
    return calls


def test_bf16_lm_routes_and_logits_agree_with_jax(monkeypatch):
    """param_dtype bf16 carried across (the port's router leaf stays f32):
    routing on >= 95 % of (token, layer) pairs, and the logits of tokens
    routed alike in every layer within 3e-2 of the largest logit."""
    jc, tc = tiny_moe(name="tiny-moe-bf16", param_dtype="bfloat16",
                      dtype="bfloat16", scan_layers=False, num_experts=8)
    jl, tl = JLM(jc), TLM(tc)
    jp = jl.init(jax.random.PRNGKey(3))
    tp = carry_params(jax.tree_util.tree_map(np.asarray, jp), tc,
                      device="cpu")
    for lp in tp["layers"]:
        assert lp["moe"]["router"].dtype == torch.float32
        assert lp["moe"]["wi_gate"].dtype == torch.bfloat16
    assert tp["embed"].dtype == torch.bfloat16
    tok = _tokens(tc, (2, 16), 8)
    calls = _jax_routes(monkeypatch)
    want, _ = jl.forward(jp, jnp.asarray(tok))
    with t_moe.record_routing() as routes:
        got, _ = tl.forward(tp, torch.as_tensor(tok))
    assert len(calls) == len(routes) == tc.num_layers
    same = np.stack([
        np.all(np.sort(j, -1) == np.sort(t.reshape(j.shape).numpy(), -1), -1)
        for j, t in zip(calls, routes)])                  # (layers, tokens)
    assert same.mean() >= 0.95, same.mean()
    rows = same.all(0).reshape(tok.shape)
    assert rows.any()
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(_np(got)[rows], want[rows], rtol=0,
                               atol=3e-2 * np.abs(want).max())


# ---------------------------------------------------------------------------
# configs, reduce_config, the carry of a train state and checkpoints
# ---------------------------------------------------------------------------

MOE = ("qwen3-moe-30b-a3b", "arctic-480b")


def test_config_fields_and_param_counts_match_jax():
    for name in MOE:
        j, t = j_get_config(name), get_config(name)
        for f in dataclasses.fields(TCfg):
            assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)
        assert t.param_count() == j.param_count(), name
    assert get_config("qwen3-moe-30b-a3b").param_count() == 30_531_911_680
    assert get_config("arctic-480b").param_count() == 476_849_766_400


@pytest.mark.parametrize("scale", [0.05, 0.1])
def test_reduce_config_matches_jax(scale):
    from repro.launch.train import reduce_config as j_reduce
    from repro_torch.launch.train import reduce_config as t_reduce
    for name in MOE:
        j = j_reduce(j_get_config(name), scale)
        t = t_reduce(get_config(name), scale)
        for f in dataclasses.fields(TCfg):
            assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)


def _state_pair(pdtype):
    from repro.optim import adamw as j_adamw
    from repro.optim import schedules as j_sched
    from repro.train import create as j_create
    from repro_torch.optim import adamw, schedules
    from repro_torch.train import create

    jc, tc = tiny_moe(name="tiny-moe-ckpt", param_dtype=pdtype,
                      dense_residual=True, d_ff=48)
    jopt = j_adamw(j_sched.constant(1e-3))
    topt = adamw(schedules.constant(1e-3))
    js = j_create(JLM(jc), jopt, jax.random.PRNGKey(4))
    return js, tc, create(TLM(tc), topt, 0, device="cpu")


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    else:
        yield path, tree


def test_carry_train_state_keeps_the_router_f32():
    js, tc, _ = _state_pair("bfloat16")
    ts = carry_train_state(jax.tree_util.tree_map(np.asarray, js), tc,
                           device="cpu")
    for path, leaf in _flat(ts.params):
        want = torch.float32 if path.endswith("moe/router") \
            else torch.bfloat16
        assert leaf.dtype == want, path
    router = np.asarray(js.params["layers"]["moe"]["router"][1])
    np.testing.assert_array_equal(
        ts.params["layers"][1]["moe"]["router"].numpy(), router)


def test_jax_bf16_moe_checkpoint_restores_into_the_port(tmp_path):
    """A bf16 MoE state saved by repro.checkpoint.Checkpointer restores
    into the port's template (from LM.init: the router f32) bitwise equal
    to carry_train_state of the same state."""
    from repro.checkpoint import Checkpointer as JCheckpointer
    from repro_torch.checkpoint import Checkpointer

    js, tc, template = _state_pair("bfloat16")
    JCheckpointer(str(tmp_path)).save(1, js)
    got = Checkpointer(str(tmp_path)).restore(template)
    want = carry_train_state(jax.tree_util.tree_map(np.asarray, js), tc,
                             device="cpu")
    g, w = dict(_flat(got.params)), dict(_flat(want.params))
    assert sorted(g) == sorted(w)
    for path in w:
        assert g[path].dtype == w[path].dtype, path
        assert torch.equal(g[path], w[path]), path
    assert g["/layers/0/moe/router"].dtype == torch.float32
    assert int(got.step) == int(js.step)


def test_serve_launcher_refuses_a_config_larger_than_the_card(monkeypatch):
    """arctic-480b at scale 1 (476.8 B parameters, 954 GB in bf16) does not
    fit an 80 GB card: the launcher says so before it allocates."""
    from repro_torch.launch import serve

    monkeypatch.setattr(serve, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"total_memory": 80e9}))
    with pytest.raises(SystemExit):
        serve.main(["--arch", "arctic-480b", "--scale", "1.0"])


def test_serve_launcher_runs_qwen3_moe_reduced(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", "qwen3-moe-30b-a3b", "--scale", "0.05",
                       "--device", "cpu", "--batch", "2", "--prompt-len",
                       "12", "--new-tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert "qwen3-moe-30b-a3b-x0.05 on cpu: generated (2, 4)" in out
