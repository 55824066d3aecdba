"""The port's hybrid family (zamba2: mamba2 layers with one weight-shared
attention block after every ``attn_every`` of them) against the JAX
package's LM on parameters carried by repro_torch.interop.carry_params,
on the same numpy inputs, at 1e-5 in f32 (the bar of
tests/test_torch_models.py): forward, loss, prefill and decode with groups
and a tail and with a tail only; carry_params keeping A_log, D and dt_bias
f32 in a bf16 config; the plain flash-attention versions at zamba2's
head_dim 112 against the JAX kernels in interpret mode and the JAX
entry point, and the backward there; the ContinuousEngine's refusal;
configs and reduce_config.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.launch.train import reduce_config as j_reduce
from repro.models.lm import LM as JLM
from repro.sparse import maskcompiler as jmc
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig as TCfg
from repro_torch.interop import carry_params
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch.train import reduce_config as t_reduce
from repro_torch.models.lm import LM as TLM
from repro_torch.serve import ContinuousEngine, Engine
from repro_torch.sparse import maskcompiler as tmc

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _pair(num_layers):
    """zamba2-7b cut by each package's reduce_config (d_model 64, 2 heads,
    attn_every 3, state 32), at ``num_layers`` layers: 5 is one group of
    3 and a tail of 2, 2 a tail only."""
    return tuple(dataclasses.replace(red(get(name), 0.05),
                                     num_layers=num_layers)
                 for red, get, name in ((j_reduce, j_get_config, "zamba2-7b"),
                                        (t_reduce, get_config, "zamba2-7b")))


@pytest.fixture(scope="module", params=[5, 2], ids=["groups_tail",
                                                    "tail_only"])
def models(request):
    jc, tc = _pair(request.param)
    jl, tl = JLM(jc), TLM(tc)
    jp = jax.jit(jl.init)(jax.random.PRNGKey(0))
    tp = carry_params(jax.tree_util.tree_map(np.asarray, jp), tc,
                      device="cpu")
    return jl, jp, tl, tp


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def test_params_carry_into_groups_and_tail(models):
    jl, jp, tl, tp = models
    ngroups, tail = tl._hybrid_split()
    assert (ngroups, tail) == jl._hybrid_split()
    assert len(tp.get("groups", [])) == ngroups
    assert all(len(g) == tl.cfg.attn_every for g in tp.get("groups", []))
    assert len(tp.get("tail", [])) == tail
    if ngroups:
        _close(tp["groups"][0][1]["mamba"]["in_proj"],
               np.asarray(jp["groups"]["mamba"]["in_proj"])[0, 1])
    _close(tp["tail"][-1]["mamba"]["conv_w"],
           np.asarray(jp["tail"]["mamba"]["conv_w"])[-1])


def test_lm_forward_and_loss_match_jax(models):
    jl, jp, tl, tp = models
    tok = _tokens(tl.cfg, (2, 12), 1)
    want, _ = jax.jit(jl.forward)(jp, jnp.asarray(tok))
    got, _ = tl.forward(tp, torch.as_tensor(tok))
    assert got.shape == (2, 12, tl.cfg.vocab_size)
    _close(got, want)
    lab = _tokens(tl.cfg, (2, 12), 2)
    jloss, _ = jax.jit(jl.loss)(jp, {"tokens": jnp.asarray(tok),
                                     "labels": jnp.asarray(lab)})
    tloss, tm = tl.loss(tp, {"tokens": tok, "labels": lab})
    _close(tloss, jloss)
    assert "aux_lb" not in tm


def test_lm_prefill_and_decode_steps_match_jax(models):
    jl, jp, tl, tp = models
    tok = _tokens(tl.cfg, (2, 9), 3)
    jlog, jcache = jax.jit(jl.prefill, static_argnames=("max_len",))(
        jp, jnp.asarray(tok), max_len=16)
    tlog, tcache = tl.prefill(tp, torch.as_tensor(tok), max_len=16)
    _close(tlog, jlog)
    assert set(tcache) == set(jcache)
    if "k" in jcache:
        _close(tcache["k"], jcache["k"])
        _close(tcache["v"], jcache["v"])
    else:
        # no group, no shared-block site: no K/V, as in the JAX package
        jcache = dict(jcache, **{
            k: v for k, v in jl.init_cache(2, 16).items() if k in "kv"})
        tcache = dict(tcache, **{
            k: v for k, v in tl.init_cache(2, 16, device="cpu").items()
            if k in "kv"})
    j_step = jax.jit(jl.decode_step)
    for _ in range(3):
        nxt = np.argmax(_np(jlog), axis=-1).astype(np.int32)[:, None]
        jlog, jcache = j_step(jp, jcache, jnp.asarray(nxt))
        tlog, tcache = tl.decode_step(tp, tcache, torch.as_tensor(nxt))
        _close(tlog, jlog)
    for k in ("conv", "ssm"):
        _close(tcache["ssm"][k], jcache["ssm"][k])
    _close(tcache["k"], jcache["k"])
    assert tcache["cur_len"] == 12


def test_engine_serves_and_continuous_engine_refuses(models):
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
        ContinuousEngine(tl, tp, num_slots=2, max_len=16, chunk_size=4)


def test_carry_params_keeps_the_ssm_scalars_f32_in_bf16():
    """zamba2's bf16 parameters: A_log, D and dt_bias stay f32 and equal to
    the JAX values (as the MoE router does); the rest is bf16."""
    jc, tc = (dataclasses.replace(c, param_dtype="bfloat16")
              for c in _pair(5))
    jp = jax.tree_util.tree_map(np.asarray,
                                jax.jit(JLM(jc).init)(jax.random.PRNGKey(1)))
    tp = carry_params(jp, tc, device="cpu")
    for got, want in ((tp["groups"][0][2], lambda a: a[0, 2]),
                      (tp["tail"][1], lambda a: a[1])):
        src = "groups" if got is tp["groups"][0][2] else "tail"
        for name in ("A_log", "D", "dt_bias"):
            w = np.asarray(jp[src]["mamba"][name])
            assert w.dtype == np.float32
            assert got["mamba"][name].dtype == torch.float32, name
            np.testing.assert_array_equal(got["mamba"][name].numpy(),
                                          want(w))
        assert got["mamba"]["in_proj"].dtype == torch.bfloat16
    assert tp["shared_attn"]["attn"]["wq"].dtype == torch.bfloat16


def test_plain_attention_matches_jax_at_head_dim_112():
    """The plain versions the CUDA kernels are held against, at zamba2's
    head_dim (112, Hq = Hkv): the dense grid (causal and not, with state),
    lens with state and the tiles walk against the Pallas kernels in
    interpret mode, and the flash_attention entry point against the JAX
    one (bar 1e-5)."""
    rng = np.random.default_rng(112)
    q, k, v = (rng.standard_normal((2, 2, 32, 112)).astype(np.float32)
               for _ in range(3))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    for causal in (False, True):
        want = jfa.flash_attention(jq, jk, jv, causal=causal, block_q=16,
                                   block_k=16, return_state=True,
                                   row_extents=False, interpret=True)
        got = fa.flash_attention(tq, tk, tv, causal=causal, block_q=16,
                                 block_k=16, return_state=True,
                                 row_extents=False)
        for g, w in zip(got, want):
            _close(g, w)
    lens = np.asarray([0, 19], np.int32)
    want = jfa.flash_attention(jq, jk, jv, causal=False, block_k=16,
                               return_state=True, kv_len=jnp.asarray(lens),
                               interpret=True)
    got = fa.flash_attention(tq, tk, tv, causal=False, block_k=16,
                             return_state=True, kv_len=torch.as_tensor(lens))
    assert np.all(_np(got[1])[0] == fa.NEG_INF)
    for g, w in zip(got, want):
        _close(_np(g)[1:], np.asarray(w)[1:])
    spec = dict(causal=True, window=8)
    want = jfa.flash_attention_tiles(
        jq, jk, jv, jmc.compile_layout(jmc.MaskSpec(**spec), 32, 32, 16, 16),
        return_state=True, interpret=True)
    got = fa.flash_attention_tiles(
        tq, tk, tv, tmc.compile_layout(tmc.MaskSpec(**spec), 32, 32, 16, 16),
        return_state=True)
    for g, w in zip(got, want):
        _close(g, w)
    with jops.backend("xla"):
        want = jops.flash_attention(jq, jk, jv, causal=True)
    _close(ops.flash_attention(tq, tk, tv, causal=True), want)
    # the backward takes every width of HEAD_DIMS, 112 among them: the
    # autograd wrapper's gradients (the plain backward on host tensors)
    # against jax.vjp of the JAX entry point
    assert 112 in fa.HEAD_DIMS and not hasattr(fa, "BWD_HEAD_DIMS")
    do = rng.standard_normal(q.shape).astype(np.float32)
    with jops.backend("xla"):
        _, vjp = jax.vjp(lambda a, b, c: jops.flash_attention(
            a, b, c, causal=True), jq, jk, jv)
        want = vjp(jnp.asarray(do))
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    fa.flash_attention(*leaves, causal=True, block_q=16,
                       block_k=16).backward(torch.as_tensor(do))
    for g, w in zip(leaves, want):
        _close(g.grad, w)


def test_configs_param_counts_and_reduce_config_match_jax():
    j, t = j_get_config("zamba2-7b"), get_config("zamba2-7b")
    for f in dataclasses.fields(TCfg):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.param_count() == j.param_count() == 6_749_649_120
    assert (t.d_inner, t.ssm_heads, t.head_dim, t.attn_every) == \
        (7168, 112, 112, 6)
    assert TLM(t)._hybrid_split() == JLM(j)._hybrid_split() == (13, 3)
    for name in ("mamba2-370m", "zamba2-7b"):
        for scale in (0.05, 0.1, 0.5):
            jr, tr = (j_reduce(j_get_config(name), scale),
                      t_reduce(get_config(name), scale))
            for f in dataclasses.fields(TCfg):
                assert getattr(tr, f.name) == getattr(jr, f.name), \
                    (name, scale, f.name)


def test_serve_launcher_runs_both_families(capsys):
    from repro_torch.launch.serve import main
    for arch in ("mamba2-370m", "zamba2-7b"):
        assert main(["--arch", arch, "--scale", "0.05", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "8",
                     "--new-tokens", "3"]) == 0
        assert "generated (2, 3)" in capsys.readouterr().out
