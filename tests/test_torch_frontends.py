"""The VLM and audio families: the port's M-RoPE, stub frontends, LM,
engines, training and checkpoints against the JAX package's, on the same
numpy inputs at CPU sizes.

Four configs, each in both packages: a tiny VLM with M-RoPE (sections
(2, 1, 1) of head_dim 8, an 8-patch frontend on a 4-wide raster), a tiny
audio config, and qwen2-vl-72b and musicgen-medium cut by each package's
``reduce_config`` (scale 0.05: 64 frontend positions; qwen2-vl keeps
M-RoPE with its sections recut to (35, 17, 17)).  The frontend embeddings
are seeded standard normals, never zeros: zeros would make every
frontend position's q, k and v zero after the first norm, and a wrong
M-RoPE split would pass unseen.  The JAX calls are jitted; the port's host
tensors select the torch plane.

Bars: 1e-5 (tests/test_torch_models.py's TOL) for the port against the
JAX package; prefill + decode against forward within the port at
tests/test_models.py's bars (2e-4 for the prefill, 5e-3 for the decode
steps); three AdamW steps as tests/test_torch_train_families.py holds
them.
"""
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_config as j_get_config
from repro.configs import list_configs as j_list_configs
from repro.configs.base import ModelConfig as JCfg
from repro.launch.train import reduce_config as j_reduce
from repro.models import layers as j_layers
from repro.models.lm import LM as JLM
from repro.optim import adamw as j_adamw
from repro.optim import schedules as j_sched
from repro.train import make_train_step as j_make_train_step
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint import checkpointer as ckpt_mod
from repro_torch.configs import get_config, list_configs
from repro_torch.configs.base import ModelConfig as TCfg
from repro_torch.data import SyntheticLM
from repro_torch.interop import carry_params, carry_train_state
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_launch
from repro_torch.launch.train import reduce_config as t_reduce
from repro_torch.models import layers as t_layers
from repro_torch.models.lm import LM as TLM
from repro_torch.optim import adamw, schedules
from repro_torch.serve import ContinuousEngine, Engine, SamplingParams
from repro_torch.train import create, make_train_step
from repro_torch.train.step import value_and_grad

TOL = dict(rtol=1e-5, atol=1e-5)
GREEDY = SamplingParams(greedy=True)


def _tiny(family, **kw):
    """tests/test_models.py's tiny() of a frontend family."""
    base = dict(name=f"tiny-{family}", family=family, num_layers=2,
                d_model=32, vocab_size=64, num_heads=4, num_kv_heads=2,
                head_dim=8, d_ff=64, dtype="float32", param_dtype="float32",
                remat=False, frontend="vision" if family == "vlm" else "audio",
                frontend_len=8, grid_hw=4, **kw)
    return JCfg(**base), TCfg(**base)


def _reduced(arch):
    return j_reduce(j_get_config(arch), 0.05), t_reduce(get_config(arch), 0.05)


CONFIGS = {
    "tiny-vlm": _tiny("vlm", m_rope=True, mrope_sections=(2, 1, 1)),
    "tiny-audio": _tiny("audio"),
    "qwen2-vl": _reduced("qwen2-vl-72b"),
    "musicgen": _reduced("musicgen-medium"),
}
ARCHS = {"qwen2-vl": "qwen2-vl-72b", "musicgen": "musicgen-medium"}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _inputs(cfg, batch, text, seed):
    """Tokens (batch, text) and standard-normal frontend embeddings
    (batch, frontend_len, d_model), from ``seed``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, text)).astype(np.int32)
    fe = rng.standard_normal((batch, cfg.frontend_len, cfg.d_model)
                             ).astype(np.float32)
    return toks, fe


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    """JAX-layout parameters of CONFIGS[name] (numpy, layers stacked along
    a leading dim), drawn by the port's seeded init and restacked as the
    port's Checkpointer stacks them: no JAX compile, made once a module.
    carry_params of it gives the port's parameters back."""
    tree: dict = {}
    for path, leaf in ckpt_mod._paths(TLM(CONFIGS[name][1]).init(
            0, device="cpu")):
        keys = re.findall(r"\['([^']+)'\]", path)
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = ckpt_mod._stack(leaf).numpy()
    return tree


def _jax_state(name, pdtype="float32", mdtype="float32", moments=None):
    """A JAX TrainState of CONFIGS[name] as numpy arrays, made without a
    compile: the cached parameters in ``pdtype`` and ``moments(shape)``
    (zeros by default; nu takes its absolute value) for AdamW's mu and nu
    in ``mdtype``."""
    from repro.optim.adamw import AdamState
    from repro.train.state import TrainState
    fill = moments or np.zeros
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x).astype(jnp.dtype(pdtype)), _jax_params(name))

    def moment(sign):
        return jax.tree_util.tree_map(
            lambda x: sign(fill(x.shape)).astype(jnp.dtype(mdtype)), params)

    return TrainState(step=np.zeros((), np.int32), params=params,
                      opt_state=AdamState(count=np.zeros((), np.int32),
                                          mu=moment(lambda m: m),
                                          nu=moment(np.abs)))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    jc, tc = CONFIGS[request.param]
    jp = _jax_params(request.param)
    tp = carry_params(_np_tree(jp), tc, device="cpu")
    return JLM(jc), jp, TLM(tc), tp


# ---------------------------------------------------------------------------
# M-RoPE and the configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq_len,frontend_len,grid_hw",
                         [(24, 16, 4), (40, 16, 4), (1600, 1024, 32)])
def test_mrope_positions_match_jax(seq_len, frontend_len, grid_hw):
    """Equal int32 streams, qwen2-vl's 1024 patches on its 32-wide raster
    among them: its first text position is 1024 // 32 = 32."""
    got = t_layers.mrope_positions(seq_len, frontend_len, grid_hw)
    want = np.asarray(j_layers.mrope_positions(seq_len, frontend_len,
                                               grid_hw))
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, seq_len)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:, frontend_len].tolist() == [frontend_len // grid_hw] * 3


@pytest.mark.parametrize("sections", [(2, 1, 1), (16, 24, 24)])
def test_apply_rope_with_sections_matches_jax(sections):
    """cos/sin (3, B, L, D/2) of the three streams stitched by section,
    within 1e-6."""
    half = sum(sections)
    rng = np.random.default_rng(half)
    x = rng.standard_normal((2, 3, 40, 2 * half)).astype(np.float32)
    pos = np.broadcast_to(np.asarray(j_layers.mrope_positions(40, 16, 4))
                          [:, None, :], (3, 2, 40))
    jc, js = j_layers.rope(jnp.asarray(pos), 2 * half, 1e6)
    tc, ts = t_layers.rope(torch.as_tensor(np.ascontiguousarray(pos)),
                           2 * half, 1e6)
    want = j_layers.apply_rope(jnp.asarray(x), jc, js, sections)
    got = t_layers.apply_rope(torch.as_tensor(x), tc, ts, sections)
    _close(got, want, rtol=1e-6, atol=1e-6)


def test_configs_match_jax():
    """The port registers every config the JAX package does; both frontend
    configs' fields and parameter counts are the JAX package's."""
    assert list_configs() == j_list_configs()
    for arch in ARCHS.values():
        t, j = get_config(arch), j_get_config(arch)
        for f in dataclasses.fields(TCfg):
            assert getattr(t, f.name) == getattr(j, f.name), (arch, f.name)
        assert t.param_count() == j.param_count()
    assert get_config("qwen2-vl-72b").param_count() == 72_704_065_536
    assert get_config("musicgen-medium").param_count() == 1_818_230_784


@pytest.mark.parametrize("arch", sorted(ARCHS.values()))
def test_reduce_config_matches_jax(arch):
    """Field by field at seq_len 256 (and 128: the frontend follows it)."""
    for scale, seq in ((0.05, 256), (0.1, 128)):
        j = j_reduce(j_get_config(arch), scale, seq_len=seq)
        t = t_reduce(get_config(arch), scale, seq_len=seq)
        for f in dataclasses.fields(TCfg):
            assert getattr(t, f.name) == getattr(j, f.name), (arch, f.name)
        assert t.frontend_len == seq // 4
        if t.m_rope:
            assert sum(t.mrope_sections) == t.head_dim // 2


# ---------------------------------------------------------------------------
# the LM against the JAX package
# ---------------------------------------------------------------------------

def test_forward_matches_jax(models):
    jl, jp, tl, tp = models
    toks, fe = _inputs(tl.cfg, 2, 9, 1)
    want, _ = jax.jit(jl.forward)(jp, toks, fe)
    got, _ = tl.forward(tp, torch.as_tensor(toks), torch.as_tensor(fe))
    assert tuple(got.shape) == (2, tl.cfg.frontend_len + 9,
                                tl.cfg.vocab_size)
    _close(got, want)


def test_loss_matches_jax(models):
    """The frontend positions' logits are dropped: labels are text only."""
    jl, jp, tl, tp = models
    toks, fe = _inputs(tl.cfg, 2, 10, 2)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "frontend_embeds": fe}
    (want, wm) = jax.jit(jl.loss)(jp, batch)
    got, gm = tl.loss(tp, batch)
    _close(got, want)
    assert int(gm["tokens"]) == int(wm["tokens"]) == 2 * 9


def test_prefill_and_decode_steps_match_jax(models):
    """prefill (logits and the cache, frontend slots included), then three
    teacher-forced decode steps past the frontend."""
    jl, jp, tl, tp = models
    cfg = tl.cfg
    toks, fe = _inputs(cfg, 2, 11, 3)
    S, max_len = 8, cfg.frontend_len + 11
    jpre = jax.jit(functools.partial(jl.prefill, max_len=max_len))
    jlog, jcache = jpre(jp, toks[:, :S], fe)
    tlog, tcache = tl.prefill(tp, torch.as_tensor(toks[:, :S]),
                              torch.as_tensor(fe), max_len=max_len)
    _close(tlog, jlog)
    assert tcache["cur_len"] == int(jcache["cur_len"]) == cfg.frontend_len + S
    _close(tcache["k"], jcache["k"])
    jdec = jax.jit(jl.decode_step)
    for i in range(S, 11):
        jlog, jcache = jdec(jp, jcache, toks[:, i:i + 1])
        tlog, tcache = tl.decode_step(tp, tcache,
                                      torch.as_tensor(toks[:, i:i + 1]))
        _close(tlog, jlog)
    assert tcache["cur_len"] == cfg.frontend_len + 11


# ---------------------------------------------------------------------------
# properties within the port
# ---------------------------------------------------------------------------

def test_prefill_then_decode_equals_forward(models):
    """The serving contract with the frontend ahead: prefill(S) + decode
    steps give forward's logits at positions F + S - 1, F + S, ...; the
    M-RoPE decode offset is F - F // grid_hw below the cache position."""
    _, _, tl, tp = models
    cfg = tl.cfg
    toks, fe = _inputs(cfg, 2, 12, 4)
    F, S = cfg.frontend_len, 8
    full, _ = tl.forward(tp, torch.as_tensor(toks), torch.as_tensor(fe))
    lg, cache = tl.prefill(tp, torch.as_tensor(toks[:, :S]),
                           torch.as_tensor(fe), max_len=F + 12)
    _close(lg, full[:, F + S - 1], rtol=2e-4, atol=2e-4)
    for i in range(S, 12):
        lg, cache = tl.decode_step(tp, cache,
                                   torch.as_tensor(toks[:, i:i + 1]))
        _close(lg, full[:, F + i], rtol=5e-3, atol=5e-3)


def test_engine_greedy_tokens_equal_jax_engine(models):
    from repro.serve import Engine as JEngine
    jl, jp, tl, tp = models
    toks, fe = _inputs(tl.cfg, 2, 6, 5)
    max_len = tl.cfg.frontend_len + 6 + 5
    want = JEngine(jl, jp, max_len=max_len).generate(
        jnp.asarray(toks), max_new_tokens=5, frontend_embeds=jnp.asarray(fe))
    got = Engine(tl, tp, max_len=max_len, sampling=GREEDY).generate(
        torch.as_tensor(toks), max_new_tokens=5,
        frontend_embeds=torch.as_tensor(fe))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen2-vl", "musicgen"])
def test_continuous_engine_refuses_both_families(name):
    """Paged serving takes the dense and MoE families only, as in the JAX
    package; a dense config with M-RoPE or a frontend is refused too."""
    _, tc = CONFIGS[name]
    tp = TLM(tc).init(0, device="cpu")
    with pytest.raises(ValueError, match="dense/moe"):
        ContinuousEngine(TLM(tc), tp, num_slots=2, max_len=128,
                         chunk_size=8)
    dense = dataclasses.replace(tc, family="dense")
    with pytest.raises(ValueError, match="frontend/m-rope"):
        TLM(dense)._check_paged()


@pytest.mark.parametrize("name", ["qwen2-vl", "musicgen"])
def test_engine_refuses_what_does_not_fit_max_len(name):
    """F + S + new > max_len raises ValueError before any work (the JAX
    package's decode would clamp its write onto the last slot); F + S +
    new = max_len serves."""
    _, tc = CONFIGS[name]
    lm = TLM(tc)
    tp = lm.init(0, device="cpu")
    toks, fe = _inputs(tc, 1, 6, 6)
    fit = tc.frontend_len + 6 + 4
    eng = Engine(lm, tp, max_len=fit - 1, sampling=GREEDY)
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(torch.as_tensor(toks), max_new_tokens=4,
                     frontend_embeds=torch.as_tensor(fe))
    out = Engine(lm, tp, max_len=fit, sampling=GREEDY).generate(
        torch.as_tensor(toks), max_new_tokens=4,
        frontend_embeds=torch.as_tensor(fe))
    assert tuple(out.shape) == (1, 4)


def test_frontend_configs_need_their_embeddings():
    _, tc = CONFIGS["tiny-vlm"]
    lm = TLM(tc)
    tp = lm.init(0, device="cpu")
    toks, fe = _inputs(tc, 2, 4, 7)
    with pytest.raises(ValueError, match="requires frontend_embeds"):
        lm.forward(tp, torch.as_tensor(toks))
    with pytest.raises(ValueError, match="frontend_embeds of shape"):
        lm.prefill(tp, torch.as_tensor(toks), torch.as_tensor(fe[:, :4]))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _port_flat(tree) -> dict:
    out = {}
    for p, leaf in ckpt_mod._paths(tree):
        t = ckpt_mod._stack(leaf)
        out[p] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out


def _jax_flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close_trees(got, want, what="", **tol):
    g, w = _port_flat(got), _jax_flat(want)
    assert sorted(g) == sorted(w), what
    for p in w:
        np.testing.assert_allclose(g[p], np.asarray(w[p], g[p].dtype),
                                   err_msg=f"{what}{p}", **(tol or TOL))


def _data(cfg, text=16, batch=4):
    """The port's SyntheticLM with the frontend: batch i the same arrays in
    both packages (tests/test_torch_train.py holds that)."""
    return SyntheticLM(vocab_size=cfg.vocab_size,
                       seq_len=cfg.frontend_len + text, global_batch=batch,
                       frontend_len=cfg.frontend_len, d_model=cfg.d_model)


@pytest.mark.parametrize("name", ["qwen2-vl", "musicgen"])
def test_loss_and_every_gradient_match_jax(name):
    jc, tc = CONFIGS[name]
    jlm, tlm = JLM(jc), TLM(tc)
    jp = _jax_params(name)
    tp = carry_params(_np_tree(jp), tc, device="cpu")
    batch = _data(tc).batch(3)
    (jl, _), jg = jax.jit(jax.value_and_grad(jlm.loss, has_aux=True))(
        jp, batch)
    (tl, _), tg = value_and_grad(tlm.loss, tp, batch)
    _close(tl, jl)
    _close_trees(tg, jg, "grad ")


def test_train_steps_with_microbatches_match_jax():
    """Three AdamW steps with microbatches 2 from one carried state of the
    tiny VLM (M-RoPE, the frontend): the frontend embeddings split with
    the tokens.  Bars as
    tests/test_torch_train_families.py::test_train_steps_match_jax (an
    entry whose first gradient is within the gradient bar of 0 held to
    2 lr a step)."""
    jc, tc = CONFIGS["tiny-vlm"]
    jopt, topt = j_adamw(j_sched.constant(1e-3)), adamw(
        schedules.constant(1e-3))
    jlm, tlm = JLM(jc), TLM(tc)
    js = _jax_state("tiny-vlm")
    ts = carry_train_state(_np_tree(js), tc, device="cpu")
    jstep = jax.jit(j_make_train_step(jlm, jopt, microbatches=2))
    tstep = make_train_step(tlm, topt, microbatches=2)
    data = _data(tc)
    for i in range(3):
        js, jm = jstep(js, data.batch(i))
        ts, tm = tstep(ts, data.batch(i))
        _close(tm["loss"], jm["loss"], rtol=1e-5)
        _close(tm["grad_norm"], jm["grad_norm"], rtol=1e-5)
        if i == 0:
            jmu, tmu = _jax_flat(js.opt_state.mu), _port_flat(ts.opt_state.mu)
            open_ = {p: (np.abs(jmu[p]) < 1e-6) | (np.abs(tmu[p]) < 1e-6)
                     for p in jmu}
    got, want = _port_flat(ts.params), _jax_flat(js.params)
    assert sorted(got) == sorted(want)
    for p in want:
        m = open_[p]
        np.testing.assert_allclose(got[p][~m], want[p][~m], rtol=0,
                                   atol=1e-4, err_msg=f"params {p}")
        np.testing.assert_allclose(got[p][m], want[p][m], rtol=0,
                                   atol=3 * 2 * 1e-3, err_msg=f"params {p}")


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_into_the_port(pdtype, tmp_path):
    """The tiny audio config's state (the dense pytree) as the JAX package
    writes it, with seeded moments and step 3, restored by the port: equal
    to carry_train_state of the same state bitwise, parameters and AdamW
    moments, in f32 and with bf16 parameters and moments."""
    tc = dataclasses.replace(CONFIGS["tiny-audio"][1], param_dtype=pdtype)
    topt = adamw(schedules.constant(1e-3),
                 moment_dtype=getattr(torch, pdtype))
    js = _jax_state("tiny-audio", pdtype, pdtype,
                    np.random.default_rng(3).standard_normal)
    js = js._replace(step=np.int32(3), opt_state=js.opt_state._replace(
        count=np.int32(3)))
    JCheckpointer(str(tmp_path)).save(3, js)
    got = Checkpointer(str(tmp_path)).restore(create(TLM(tc), topt, 0,
                                                     device="cpu"))
    want = carry_train_state(_np_tree(js), tc, device="cpu")
    fg, fw = _port_flat(got), _port_flat(want)
    assert sorted(fg) == sorted(fw)
    for p in fw:
        np.testing.assert_array_equal(fg[p], fw[p], err_msg=p)
    assert int(got.step) == 3
    assert got.params["layers"][0]["attn"]["wq"].dtype == getattr(torch,
                                                                   pdtype)
    assert float(got.opt_state.mu["layers"][1]["mlp"]["wo"].abs().max()) > 0


def test_port_checkpoint_restores_into_jax(tmp_path):
    """f32 only (the JAX package's restore cannot cast a bf16 leaf, ROADMAP
    queue 3 item 4): musicgen's state after one port step, restored by the
    JAX package, holds the same arrays, and both train on alike."""
    jc, tc = CONFIGS["musicgen"]
    jopt, topt = j_adamw(j_sched.constant(1e-3)), adamw(
        schedules.constant(1e-3))
    tlm, jlm = TLM(tc), JLM(jc)
    tstep = make_train_step(tlm, topt)
    data = _data(tc)
    ts, _ = tstep(create(tlm, topt, 4, device="cpu"), data.batch(0))
    Checkpointer(str(tmp_path)).save(1, ts)
    got = JCheckpointer(str(tmp_path)).restore(_jax_state("musicgen"))
    want, have = _port_flat(ts), _jax_flat(got)
    assert sorted(want) == sorted(have)
    for p in want:
        np.testing.assert_array_equal(have[p], want[p], err_msg=p)
    js, jm = jax.jit(j_make_train_step(jlm, jopt))(got, data.batch(1))
    ts, tm = tstep(ts, data.batch(1))
    _close(tm["loss"], jm["loss"], rtol=1e-5)
    _close_trees(ts.params, js.params, "params ", rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_serve_launcher_decodes_past_the_frontend(capsys):
    """launch.serve at scale 0.05 on the CPU: 64 frontend positions ahead
    of 32 prompt tokens and 16 new ones.  The default max_len counts the
    frontend (without it, 56 slots could not hold 112 positions and the
    engine would refuse)."""
    assert t_serve.main(["--arch", "qwen2-vl-72b", "--scale", "0.05",
                         "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "qwen2-vl-72b-x0.05 on cpu: generated (4, 16)" in out
    row = [int(t) for t in out.split("first row: [")[1].split("]")[0]
           .split(",")]
    assert len(row) == 16 and all(0 <= t < 2048 for t in row)


def test_serve_launcher_refuses_qwen2_vl_whole(monkeypatch, capsys):
    """At scale 1 qwen2-vl-72b's 145.4 GB of bf16 parameters do not fit an
    80 GB card: the launcher says so, and how many layers would."""
    monkeypatch.setattr(t_serve, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"total_memory": 80e9}))
    monkeypatch.setattr(t_serve, "LM", None)        # never reached
    with pytest.raises(SystemExit):
        t_serve.main(["--arch", "qwen2-vl-72b", "--scale", "1.0"])
    err = capsys.readouterr().err
    assert "145.4 GB of parameters do not fit the card's 80.0 GB" in err
    fit = int(err.split("at full width ")[1].split(" of")[0])
    cfg = get_config("qwen2-vl-72b")
    assert 2 * dataclasses.replace(cfg, num_layers=fit).param_count() <= 80e9
    assert 2 * dataclasses.replace(cfg, num_layers=fit + 1).param_count() \
        > 80e9


@pytest.mark.parametrize("arch", sorted(ARCHS.values()))
def test_train_launcher_trains_each_frontend_family_reduced(arch, capsys):
    """launch.train at scale 0.05 on the CPU, synthetic batches with
    standard-normal frontend embeddings: two steps, a finite loss."""
    assert t_launch.main(["--arch", arch, "--scale", "0.05", "--steps", "2",
                          "--batch", "2", "--seq", "80",
                          "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"training {arch}-x0.05" in out
    assert np.isfinite(float(out.split("final loss: ")[1]))
