"""The port's SSM family (repro_torch.models.ssm, the mamba blocks and the
``ssm`` branches of the LM) against the JAX package's (repro.models.ssm,
repro.models.lm) on the same numpy inputs and on parameters carried by
repro_torch.interop.carry_params, at 1e-5 in f32 (the bar of
tests/test_torch_models.py).  Also the port's own properties that the JAX
suite pins for itself (tests/test_models.py: the chunked SSD is
chunk-size invariant; stepwise decode equals the full-sequence pass), the
ValueError for a prompt that is not a multiple of the SSD chunk, and the
ContinuousEngine's refusal of the family.

The JAX side runs on its CPU plane; the port's host tensors select the
torch plane.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch.train import reduce_config as j_reduce
from repro.models import ssm as j_ssm
from repro.models.lm import LM as JLM
from repro_torch.configs import get_config
from repro_torch.interop import carry_params
from repro_torch.launch.train import reduce_config as t_reduce
from repro_torch.models import ssm as t_ssm
from repro_torch.models.lm import LM as TLM
from repro_torch.serve import ContinuousEngine, Engine

TOL = dict(rtol=1e-5, atol=1e-5)

# jitted once, the JAX functions compile in one piece (op by op, eager
# dispatch compiles every primitive)
J_SSD = jax.jit(j_ssm.ssd_chunked, static_argnums=(5,),
                static_argnames=("chunk",))
J_APPLY = jax.jit(j_ssm.mamba2_apply_state, static_argnums=(2,))
J_DECODE = jax.jit(j_ssm.mamba2_decode, static_argnums=(2,))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _pair(**kw):
    """mamba2-370m cut by each package's reduce_config (2 layers, d_model
    64, 4 heads of 32, state 32), with ``kw`` replaced in both."""
    return (dataclasses.replace(j_reduce(j_get_config("mamba2-370m"), 0.05),
                                **kw),
            dataclasses.replace(t_reduce(get_config("mamba2-370m"), 0.05),
                                **kw))


#: Two groups of heads (H 4, G 2): the head-to-group map of the chunk
#: states and of decode.
JCFG, TCFG = _pair(ssm_groups=2)


@pytest.fixture(scope="module")
def mamba():
    """One mamba2 layer's parameters in both packages (the JAX init, carried
    to the port; A_log, D and dt_bias stay f32)."""
    jp = jax.jit(j_ssm.mamba2_init, static_argnums=(1,))(
        jax.random.PRNGKey(0), JCFG)
    tp = carry_params({"mamba": jax.tree_util.tree_map(np.asarray, jp)},
                      TCFG, device="cpu")["mamba"]
    return jp, tp


def _ssd_inputs(B, L, cfg, seed):
    rng = np.random.default_rng(seed)
    H, P, G, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_groups, cfg.ssm_state
    x = rng.standard_normal((B, L, H, P)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    bmat = rng.standard_normal((B, L, G, N)).astype(np.float32) * 0.3
    cmat = rng.standard_normal((B, L, G, N)).astype(np.float32) * 0.3
    a_log = np.log(np.linspace(1.0, 4.0, H)).astype(np.float32)
    return x, dt, a_log, bmat, cmat


@pytest.mark.parametrize("chunk", [4, 16])
def test_ssd_chunked_matches_jax(chunk):
    """y and the final state at 4 chunks of 4 and at one chunk of 16."""
    args = _ssd_inputs(2, 16, TCFG, chunk)
    want = J_SSD(*map(jnp.asarray, args), JCFG, chunk=chunk)
    got = t_ssm.ssd_chunked(*map(torch.as_tensor, args), TCFG, chunk=chunk)
    for g, w in zip(got, want):
        _close(g, w)


def test_ssd_chunked_is_chunk_size_invariant():
    """The port's mirror of tests/test_models.py::
    test_ssd_chunk_size_invariance (its bar, 2e-4)."""
    args = tuple(map(torch.as_tensor, _ssd_inputs(2, 32, TCFG, 1)))
    outs = [t_ssm.ssd_chunked(*args, TCFG, chunk=c) for c in (8, 16, 32)]
    for y, s in outs[1:]:
        _close(y, outs[0][0], rtol=2e-4, atol=2e-4)
        _close(s, outs[0][1], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("L", [2, 12])
def test_mamba2_apply_state_matches_jax(mamba, L):
    """Output, conv tail and SSM state; at L = 2 the tail is shorter than
    conv_width - 1 and left-padded."""
    jp, tp = mamba
    x = np.random.default_rng(L).standard_normal(
        (2, L, TCFG.d_model)).astype(np.float32)
    want_y, want_st = J_APPLY(jnp.asarray(x), jp, JCFG)
    got_y, got_st = t_ssm.mamba2_apply_state(torch.as_tensor(x), tp, TCFG)
    _close(got_y, want_y)
    assert torch.equal(t_ssm.mamba2_apply(torch.as_tensor(x), tp, TCFG),
                       got_y)
    assert got_st["conv"].shape == (2, TCFG.conv_width - 1,
                                    TCFG.d_inner + 2 * 2 * TCFG.ssm_state)
    for k in ("conv", "ssm"):
        _close(got_st[k], want_st[k])


def test_mamba2_decode_matches_jax(mamba):
    """Four decode steps from a 6-token prefill's state."""
    jp, tp = mamba
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, TCFG.d_model)).astype(np.float32)
    _, jst = J_APPLY(jnp.asarray(x), jp, JCFG)
    _, tst = t_ssm.mamba2_apply_state(torch.as_tensor(x), tp, TCFG)
    for _ in range(4):
        xt = rng.standard_normal((2, 1, TCFG.d_model)).astype(np.float32)
        jy, jst = J_DECODE(jnp.asarray(xt), jp, JCFG, jst)
        ty, tst = t_ssm.mamba2_decode(torch.as_tensor(xt), tp, TCFG, tst)
        _close(ty, jy)
    for k in ("conv", "ssm"):
        _close(tst[k], jst[k])


def test_mamba2_decode_matches_forward_stepwise(mamba):
    """The port's mirror of tests/test_models.py::
    test_mamba2_decode_matches_forward_stepwise (its bar, 2e-3), from the
    empty state, and the states after the last token equal."""
    _, tp = mamba
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (1, 8, TCFG.d_model)).astype(np.float32) * 0.5)
    y_full, st_full = t_ssm.mamba2_apply_state(x, tp, TCFG)
    st = t_ssm.mamba2_state_init(TCFG, 1)
    for t in range(8):
        y_t, st = t_ssm.mamba2_decode(x[:, t:t + 1], tp, TCFG, st)
        _close(y_t[:, 0], y_full[:, t], rtol=2e-3, atol=2e-3)
    for k in ("conv", "ssm"):
        _close(st[k], st_full[k], rtol=2e-3, atol=2e-3)


def test_a_prompt_off_the_chunk_raises(mamba):
    """300 tokens are more than one chunk of 256 and not a multiple of it:
    the reference asserts, the port raises ValueError (and pads nothing)."""
    _, tp = mamba
    x = torch.zeros((1, 300, TCFG.d_model))
    with pytest.raises(ValueError, match="multiple of 256"):
        t_ssm.mamba2_apply_state(x, tp, TCFG)


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jc, tc = _pair()
    jl, tl = JLM(jc), TLM(tc)
    jp = jax.jit(jl.init)(jax.random.PRNGKey(0))
    tp = carry_params(jax.tree_util.tree_map(np.asarray, jp), tc,
                      device="cpu")
    return jl, jp, tl, tp


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def test_lm_forward_and_loss_match_jax(models):
    jl, jp, tl, tp = models
    tok = _tokens(tl.cfg, (2, 12), 1)
    want, _ = jax.jit(jl.forward)(jp, jnp.asarray(tok))
    got, aux = tl.forward(tp, torch.as_tensor(tok))
    assert got.shape == (2, 12, tl.cfg.vocab_size)
    _close(got, want)
    assert float(aux["aux_lb"]) == 0.0
    lab = _tokens(tl.cfg, (2, 12), 2)
    jloss, jm = jax.jit(jl.loss)(jp, {"tokens": jnp.asarray(tok),
                             "labels": jnp.asarray(lab)})
    tloss, tm = tl.loss(tp, {"tokens": tok, "labels": lab})
    _close(tloss, jloss)
    assert "aux_lb" not in tm and "aux_lb" not in jm


def test_lm_prefill_and_decode_steps_match_jax(models):
    jl, jp, tl, tp = models
    tok = _tokens(tl.cfg, (2, 9), 3)
    jlog, jcache = jax.jit(jl.prefill, static_argnames=("max_len",))(
        jp, jnp.asarray(tok), max_len=16)
    tlog, tcache = tl.prefill(tp, torch.as_tensor(tok), max_len=16)
    _close(tlog, jlog)
    assert "k" not in tcache and tcache["cur_len"] == 9
    for k in ("conv", "ssm"):
        _close(tcache["ssm"][k], jcache["ssm"][k])
    j_step = jax.jit(jl.decode_step)
    for _ in range(3):
        nxt = np.argmax(_np(jlog), axis=-1).astype(np.int32)[:, None]
        jlog, jcache = j_step(jp, jcache, jnp.asarray(nxt))
        tlog, tcache = tl.decode_step(tp, tcache, torch.as_tensor(nxt))
        _close(tlog, jlog)
    for k in ("conv", "ssm"):
        _close(tcache["ssm"][k], jcache["ssm"][k])
    assert tcache["cur_len"] == 12
    empty = tl.init_cache(2, 16, device="cpu")
    jempty = jl.init_cache(2, 16)
    assert set(empty) == set(jempty)
    for k in ("conv", "ssm"):
        assert tuple(empty["ssm"][k].shape) == jempty["ssm"][k].shape


def test_engine_serves_and_continuous_engine_refuses(models):
    """The fixed Engine's greedy tokens equal the JAX Engine's; the
    ContinuousEngine raises ValueError, as the JAX one does."""
    from repro.serve import ContinuousEngine as JCont
    from repro.serve import Engine as JEngine
    jl, jp, tl, tp = models
    tok = _tokens(tl.cfg, (2, 6), 5)
    want = JEngine(jl, jp, max_len=16).generate(jnp.asarray(tok),
                                                max_new_tokens=4)
    got = Engine(tl, tp, max_len=16).generate(torch.as_tensor(tok),
                                              max_new_tokens=4)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    with pytest.raises(ValueError, match="dense/moe"):
        JCont(jl, jp, num_slots=2, max_len=16, chunk_size=4).serve(
            [(tok[0], 2)])
    with pytest.raises(ValueError, match="dense/moe"):
        ContinuousEngine(tl, tp, num_slots=2, max_len=16,
                         chunk_size=4).serve([(tok[0], 2)])


def test_config_and_param_count_match_jax():
    j, t = j_get_config("mamba2-370m"), get_config("mamba2-370m")
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert (t.d_inner, t.ssm_heads, t.has_ssm, t.has_attention) == \
        (j.d_inner, j.ssm_heads, True, False) == (2048, 32, True, False)
    assert t.param_count() == j.param_count() == 368_077_824
