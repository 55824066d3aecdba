"""The port's LM (repro_torch.models: layers, attention, the dense block and
the LM facade) against the JAX package's (repro.models) on carried
parameters (repro_torch.interop.carry_params), on the same numpy inputs, at
1e-5 in f32.  Five configs: the serve tests' small config
(tests/test_serve.py), qwen3-1.7b cut to a CPU size that keeps qk_norm,
GQA, tied embeddings, rope_theta and a padded vocabulary, and gemma-2b,
minicpm-2b and phi3-mini-3.8b cut by each package's reduce_config.

The JAX side runs on its default CPU plane (the plain jnp oracles); the
port's host tensors select the torch plane.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ModelConfig as JCfg
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models.lm import LM as JLM
from repro.serve import init_cache_state as j_init_state
from repro.serve import make_spec as j_make_spec
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig as TCfg
from repro_torch.interop import carry_params
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models.lm import LM as TLM
from repro_torch.serve import init_cache_state as t_init_state
from repro_torch.serve import make_spec as t_make_spec

TOL = dict(rtol=1e-5, atol=1e-5)

SERVE_KW = dict(name="stest", family="dense", num_layers=2, d_model=32,
                vocab_size=64, num_heads=4, num_kv_heads=2, head_dim=8,
                d_ff=64, dtype="float32", param_dtype="float32",
                serve_page_size=8)


def _qwen3_small(base):
    """qwen3-1.7b's structure at a CPU size (GQA 4/2, qk_norm, tied)."""
    return dataclasses.replace(
        base, name="qwen3-small", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=300,
        dtype="float32", param_dtype="float32", serve_page_size=8)


#: The four dense configs of both packages.
DENSE = ("qwen3-1.7b", "gemma-2b", "minicpm-2b", "phi3-mini-3.8b")


def _reduced(name):
    """A dense config cut to a CPU size by each package's reduce_config
    (gemma keeps GeGLU, MQA and embedding scaling; phi3 and minicpm full
    multi-head attention; minicpm a vocabulary that needs padding)."""
    from repro.launch.train import reduce_config as j_reduce
    from repro_torch.launch.train import reduce_config as t_reduce
    return (dataclasses.replace(j_reduce(j_get_config(name), 0.05),
                                serve_page_size=8),
            dataclasses.replace(t_reduce(get_config(name), 0.05),
                                serve_page_size=8))


CONFIGS = {
    "stest": (JCfg(**SERVE_KW, remat=False), TCfg(**SERVE_KW)),
    "qwen3": (_qwen3_small(j_get_config("qwen3-1.7b")),
              _qwen3_small(get_config("qwen3-1.7b"))),
    "gemma": _reduced("gemma-2b"),
    "minicpm": _reduced("minicpm-2b"),
    "phi3": _reduced("phi3-mini-3.8b"),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    jc, tc = CONFIGS[request.param]
    jl, tl = JLM(jc), TLM(tc)
    jp = jl.init(jax.random.PRNGKey(0))
    tp = carry_params(jax.tree_util.tree_map(np.asarray, jp), tc,
                      device="cpu")
    return jl, jp, tl, tp


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_config_fields_match_jax():
    """Every field of the four dense configs, remat and scan_layers
    included."""
    for name in DENSE:
        j, t = j_get_config(name), get_config(name)
        for f in dataclasses.fields(TCfg):
            assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)
        assert t.padded_vocab == j.padded_vocab
        assert t.act_dtype == torch.bfloat16 and t.pdtype == torch.bfloat16
        assert t.param_count() == j.param_count(), name
    assert get_config("qwen3-1.7b").padded_vocab == 152064


@pytest.mark.parametrize("scale", [0.05, 0.1, 0.5])
def test_reduce_config_matches_jax(scale):
    from repro.launch.train import reduce_config as j_reduce
    from repro_torch.launch.train import reduce_config as t_reduce
    for name in DENSE:
        j = j_reduce(j_get_config(name), scale)
        t = t_reduce(get_config(name), scale)
        for f in dataclasses.fields(TCfg):
            assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    _close(t_layers.rms_norm(torch.as_tensor(x),
                             {"scale": torch.as_tensor(scale)}),
           j_layers.rms_norm(jnp.asarray(x), {"scale": jnp.asarray(scale)}))
    w = {k: rng.standard_normal(s).astype(np.float32) * 0.2 for k, s in
         (("wi_gate", (32, 48)), ("wi_up", (32, 48)), ("wo", (48, 32)))}
    for kind in ("swiglu", "geglu"):
        _close(t_layers.mlp(torch.as_tensor(x),
                            {k: torch.as_tensor(v) for k, v in w.items()},
                            kind),
               j_layers.mlp(jnp.asarray(x),
                            {k: jnp.asarray(v) for k, v in w.items()}, kind))
    pos = np.tile(np.arange(7, dtype=np.int32), (2, 1)) * 13
    tc, ts = t_layers.rope(torch.as_tensor(pos), 16, 1e6)
    jc, js = j_layers.rope(jnp.asarray(pos), 16, 1e6)
    _close(tc, jc)
    _close(ts, js)
    h = rng.standard_normal((2, 3, 7, 16)).astype(np.float32)
    _close(t_layers.apply_rope(torch.as_tensor(h), tc, ts),
           j_layers.apply_rope(jnp.asarray(h), jc, js))


def test_attention_apply_kv_matches_jax(models):
    jl, jp, tl, tp = models
    cfg = tl.cfg
    x = np.random.default_rng(1).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    jcs = j_layers.rope(jnp.asarray(pos), cfg.head_dim, cfg.rope_theta)
    tcs = t_layers.rope(torch.as_tensor(pos), cfg.head_dim, cfg.rope_theta)
    jlp = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["attn"])
    want = j_attn.attention_apply_kv(jnp.asarray(x), jlp, jl.cfg, *jcs)
    got = t_attn.attention_apply_kv(torch.as_tensor(x),
                                    tp["layers"][0]["attn"], cfg, *tcs)
    for g, w in zip(got, want):
        _close(g, w)


# ---------------------------------------------------------------------------
# the LM facade
# ---------------------------------------------------------------------------

def test_forward_matches_jax(models):
    jl, jp, tl, tp = models
    tok = _tokens(tl.cfg, (2, 12), 2)
    want, _ = jl.forward(jp, jnp.asarray(tok))
    got, aux = tl.forward(tp, torch.as_tensor(tok))
    assert got.shape == (2, 12, tl.cfg.vocab_size)
    _close(got, want)


def test_prefill_and_decode_steps_match_jax(models):
    jl, jp, tl, tp = models
    tok = _tokens(tl.cfg, (2, 9), 3)
    jlog, jcache = jl.prefill(jp, jnp.asarray(tok), max_len=16)
    tlog, tcache = tl.prefill(tp, torch.as_tensor(tok), max_len=16)
    _close(tlog, jlog)
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])
    assert tcache["cur_len"] == int(jcache["cur_len"]) == 9
    for step in range(3):
        nxt = np.argmax(_np(jlog), axis=-1).astype(np.int32)[:, None]
        jlog, jcache = jl.decode_step(jp, jcache, jnp.asarray(nxt))
        tlog, tcache = tl.decode_step(tp, tcache, torch.as_tensor(nxt))
        _close(tlog, jlog)
    _close(tcache["k"], jcache["k"])
    assert tcache["cur_len"] == 12


def _admitted_table(spec, lens_list):
    """Table rows for requests of ``lens_list`` tokens, as a scheduler
    admits them (pages 1.. in order)."""
    table = np.zeros((spec.num_slots, spec.pages_per_slot), np.int32)
    nxt = 1
    for slot, n in enumerate(lens_list):
        for p in range(spec.pages_for(n)):
            table[slot, p] = nxt
            nxt += 1
    return table


def test_prefill_chunk_and_paged_decode_match_jax(models):
    jl, jp, tl, tp = models
    cfg = tl.cfg
    jspec = j_make_spec(jl.cfg, num_slots=3, max_tokens=40)
    tspec = t_make_spec(cfg, num_slots=3, max_tokens=40)
    assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
    table = _admitted_table(tspec, [30, 20, 0])
    jst = dict(j_init_state(jl.cfg, jspec), table=jnp.asarray(table))
    tst = t_init_state(cfg, tspec, device="cpu")
    tst["table"].copy_(torch.as_tensor(table))
    # slot 0: 13 prompt tokens in chunks of 6 (the last one padded); slot
    # 1: 5 tokens in one chunk
    prompts = {0: _tokens(cfg, (13,), 4), 1: _tokens(cfg, (5,), 5)}
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
    cur = np.asarray([[3], [7], [0]], np.int32)
    for _ in range(3):
        jlog, jst = jl.decode_step_paged(jp, jst, jnp.asarray(cur),
                                         jnp.asarray(active))
        tlog, tst = tl.decode_step_paged(tp, tst, torch.as_tensor(cur),
                                         torch.as_tensor(active))
        _close(tlog[active > 0], np.asarray(jlog)[active > 0])
        cur = np.argmax(np.asarray(jlog), -1).astype(np.int32)[:, None]
    np.testing.assert_array_equal(_np(tst["lens"]), np.asarray(jst["lens"]))
    # the pools agree outside the trash page (frozen slots write there)
    _close(tst["kpages"][:, 1:], np.asarray(jst["kpages"])[:, 1:])
    _close(tst["vpages"][:, 1:], np.asarray(jst["vpages"])[:, 1:])


def test_other_families_raise_not_implemented():
    """No family of the JAX package raises NotImplementedError any more:
    the vlm and audio ones (tests/test_torch_frontends.py) build the dense
    pytree; a family neither package knows raises ValueError."""
    base = TLM(TCfg(**SERVE_KW)).init(0, device="cpu")
    for family in ("vlm", "audio"):
        cfg = dataclasses.replace(TCfg(**SERVE_KW), family=family)
        p = TLM(cfg).init(0, device="cpu")
        assert sorted(p) == sorted(base) and len(p["layers"]) == 2
    with pytest.raises(ValueError, match="unknown family"):
        TLM(dataclasses.replace(TCfg(**SERVE_KW), family="diffusion")).init(
            0, device="cpu")


def test_init_goes_to_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TLM(TCfg(**SERVE_KW)).init(0)
