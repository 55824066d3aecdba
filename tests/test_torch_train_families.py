"""Training the MoE, SSM and hybrid families: the port's LM.loss, its
gradients and its train step against the JAX package's, on the same numpy
inputs at CPU sizes, and the hybrid's checkpoints in the JAX package's
layout in both directions.

The configs are each family's assigned config cut by both packages'
``reduce_config`` to a CPU size: qwen3-moe-30b-a3b with 4 experts and
top-2 (capacity factor 4: no drops); mamba2-370m at 2 layers with state
16; zamba2-7b at 5 layers with ``attn_every`` 2, so 2 groups of 2 mamba
layers with the shared attention block after each, and a tail of 1.
Both packages start from the JAX package's state, carried over by
``repro_torch.interop.carry_train_state``; the port's host tensors select
the torch plane.

Bars, as tests/test_torch_train.py's: the loss and every gradient at
1e-5; three AdamW steps at 1e-5 relative for the loss and grad norm and
1e-4 absolute for the parameters (a tenth of what one step at lr 1e-3
can move a weight); remat, checkpoints and a resume bitwise.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_config as j_get_config
from repro.launch.train import reduce_config as j_reduce
from repro.models.lm import LM as JLM
from repro.optim import adamw as j_adamw
from repro.optim import schedules as j_sched
from repro.train import create as j_create
from repro.train import make_train_step as j_make_train_step
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint import checkpointer as ckpt_mod
from repro_torch.configs import get_config
from repro_torch.interop import carry_params, carry_train_state
from repro_torch.launch import train as t_launch
from repro_torch.launch.train import reduce_config as t_reduce
from repro_torch.models.lm import LM as TLM
from repro_torch.optim import adamw, schedules
from repro_torch.runtime import TrainingSupervisor
from repro_torch.train import create, make_train_step
from repro_torch.train.step import value_and_grad

TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(arch, **kw):
    """``arch`` cut by each package's reduce_config (scale 0.05, f32, no
    remat), with ``kw`` replaced in both."""
    return (dataclasses.replace(j_reduce(j_get_config(arch), 0.05), **kw),
            dataclasses.replace(t_reduce(get_config(arch), 0.05), **kw))

CONFIGS = {
    "moe": _pair("qwen3-moe-30b-a3b", num_experts=4, experts_per_token=2),
    "ssm": _pair("mamba2-370m", num_layers=2, ssm_state=16),
    "hybrid": _pair("zamba2-7b", num_layers=5, attn_every=2),
}


def _learnable_data(B=4, S=16, V=64, n_batches=64):
    """tests/test_train_integration.py's next-token pattern (token i+1 =
    (token i + 1) % 64)."""
    class DS:
        def batch(self, i):
            rng = np.random.default_rng(i % n_batches)
            start = rng.integers(0, 64, (B, 1), dtype=np.int32)
            seq = (start + np.arange(S + 1, dtype=np.int32)[None, :]) % V
            return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    return DS()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_flat(tree) -> dict:
    """The port's tree by the JAX package's leaf paths, the layer lists
    (and the hybrid's lists of them) stacked as the checkpointer stacks
    them."""
    out = {}
    for p, leaf in ckpt_mod._paths(tree):
        t = ckpt_mod._stack(leaf)
        out[p] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out


def _close_trees(got, want, what="", **tol):
    g, w = _port_flat(got), _jax_flat(want)
    assert sorted(g) == sorted(w), what
    for p in w:
        assert g[p].shape == w[p].shape, f"{what}{p}"
        np.testing.assert_allclose(g[p], np.asarray(w[p], g[p].dtype),
                                   err_msg=f"{what}{p}", **(tol or TOL))


def _equal_states(a, b):
    fa, fb = _port_flat(a), _port_flat(b)
    assert sorted(fa) == sorted(fb)
    for p in fa:
        np.testing.assert_array_equal(fa[p], fb[p], err_msg=p)


def _opt_pair(moments="f32"):
    if moments == "bf16":
        return (j_adamw(j_sched.constant(1e-3), moment_dtype=jnp.bfloat16),
                adamw(schedules.constant(1e-3), moment_dtype=torch.bfloat16))
    return j_adamw(j_sched.constant(1e-3)), adamw(schedules.constant(1e-3))


def _states(jc, tc, pair, seed=0):
    """The JAX LM and state, and the port's LM and carried copy of it."""
    jlm, tlm = JLM(jc), TLM(tc)
    js = j_create(jlm, pair[0], jax.random.PRNGKey(seed))
    return jlm, js, tlm, carry_train_state(_np_tree(js), tc, device="cpu")


# ---------------------------------------------------------------------------
# loss, gradients, remat and train steps against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_loss_and_every_gradient_match_jax(family):
    """LM.loss (the MoE's aux terms in it) and the gradient of every
    parameter, the hybrid's stacked groups and its shared block among
    them."""
    jc, tc = CONFIGS[family]
    jlm, tlm = JLM(jc), TLM(tc)
    jp = jlm.init(jax.random.PRNGKey(1))
    tp = carry_params(_np_tree(jp), tc, device="cpu")
    batch = _learnable_data().batch(3)
    (jl, _), jg = jax.jit(jax.value_and_grad(jlm.loss, has_aux=True))(
        jp, batch)
    (tl, _), tg = value_and_grad(tlm.loss, tp, batch)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_trees(tg, jg, "grad ")
    flat = _port_flat(tg)
    if family == "hybrid":
        assert flat["['groups']['mamba']['A_log']"].shape == \
            (2, 2, tc.ssm_heads)
        assert np.abs(flat["['shared_attn']['attn']['wq']"]).max() > 0
    if family == "moe":
        assert np.abs(flat["['layers']['moe']['router']"]).max() > 0


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_remat_gradients_equal_no_remat_bitwise(family):
    """cfg.remat recomputes each block (each mamba layer, each MoE block,
    each shared-block site) in backward; the loss and every gradient must
    not change at all."""
    _, tc = CONFIGS[family]
    tp = TLM(tc).init(0, device="cpu")
    batch = _learnable_data().batch(0)
    out = {}
    for remat in (False, True):
        lm = TLM(dataclasses.replace(tc, remat=remat))
        (loss, _), g = value_and_grad(lm.loss, tp, batch)
        out[remat] = (loss, _port_flat(g))
    assert torch.equal(out[False][0], out[True][0])
    for p, g in out[False][1].items():
        np.testing.assert_array_equal(out[True][1][p], g, err_msg=p)


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_train_steps_match_jax(family):
    """Three train steps from one state on the same batches: loss and
    grad_norm at 1e-5 relative each step, the first moments at 1e-4
    relative and 1e-6 absolute, the parameters within 1e-4 absolute.

    Adam's first step moves an entry by lr * g / (|g| + eps): by lr where
    |g| is far above eps (1e-8), but by anything in [-lr, lr] for a g
    within the gradient bar (1e-5) of 0, which the bar leaves that open
    (the hybrid here has an entry with g 1.07e-8 in the JAX package and
    6.4e-9 in the port, whose first updates differ by 1.27e-4).  So an
    entry whose first gradient (its first moment over 0.1) is within the
    gradient bar of 0 in either package is held to 2 lr a step, the most
    two such updates can differ by; every other entry to 1e-4."""
    jc, tc = CONFIGS[family]
    pair = _opt_pair()
    jlm, js, tlm, ts = _states(jc, tc, pair)
    jstep = jax.jit(j_make_train_step(jlm, pair[0]))
    tstep = make_train_step(tlm, pair[1])
    data = _learnable_data()
    for i in range(3):
        js, jm = jstep(js, data.batch(i))
        ts, tm = tstep(ts, data.batch(i))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                       rtol=1e-5, err_msg=f"step {i} {k}")
        if i == 0:
            jmu = _jax_flat(js.opt_state.mu)
            tmu = _port_flat(ts.opt_state.mu)
            open_ = {p: (np.abs(jmu[p]) < 1e-6) | (np.abs(tmu[p]) < 1e-6)
                     for p in jmu}
    assert int(ts.step) == int(js.step) == 3
    got, want = _port_flat(ts.params), _jax_flat(js.params)
    assert sorted(got) == sorted(want)
    for p in want:
        m = open_[p]
        np.testing.assert_allclose(got[p][~m], want[p][~m], rtol=0,
                                   atol=1e-4, err_msg=f"params {p}")
        np.testing.assert_allclose(got[p][m], want[p][m], rtol=0,
                                   atol=3 * 2 * 1e-3, err_msg=f"params {p}")
    _close_trees(ts.opt_state.mu, js.opt_state.mu, "mu ", rtol=1e-4,
                 atol=1e-6)


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_restart_resumes_bit_exact(family, tmp_path):
    """Six steps with a save every 3 and a crash at 5, then a restart from
    another seed: the final state equals an uninterrupted run bitwise
    (the hybrid's checkpoint carries its groups as a stack of stacks)."""
    _, tc = CONFIGS[family]
    lm = TLM(tc)
    opt = adamw(schedules.constant(1e-3))
    step = make_train_step(lm, opt)
    data = _learnable_data()
    ref = create(lm, opt, 0, device="cpu")
    for i in range(6):
        ref, _ = step(ref, data.batch(i))
    ckpt = Checkpointer(str(tmp_path))
    sup = TrainingSupervisor(ckpt, create(lm, opt, 0, device="cpu"),
                             save_every=3)
    with pytest.raises(RuntimeError, match="injected failure"):
        sup.run(step, data, 6, fail_at=5)
    sup2 = TrainingSupervisor(ckpt, create(lm, opt, 1, device="cpu"),
                              save_every=3)
    assert int(sup2.state.step) == 3
    final, _ = sup2.run(step, data, 6)
    _equal_states(final, ref)


# ---------------------------------------------------------------------------
# checkpoints in the JAX package's layout
# ---------------------------------------------------------------------------

def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_manifest_and_leaf_files_equal_jax(family, pdtype, tmp_path):
    """The same state written by both packages: the manifests (leaf paths,
    their order, files, dtypes and shapes: the hybrid's groups as
    (ngroups, attn_every, ...), its A_log, D and dt_bias f32 in a bf16
    config) and every leaf file are the same bytes."""
    jc, tc = (dataclasses.replace(c, param_dtype=pdtype)
              for c in CONFIGS[family])
    jlm, js, _, ts = _states(jc, tc, _opt_pair(
        "bf16" if pdtype == "bfloat16" else "f32"), seed=5)
    JCheckpointer(str(tmp_path / "jax")).save(3, js)
    Checkpointer(str(tmp_path / "port")).save(3, ts)
    want = _manifest(tmp_path / "jax", 3)
    got = _manifest(tmp_path / "port", 3)
    assert got == want
    if family == "hybrid":
        by_path = {e["path"]: e for e in got["leaves"]}
        a_log = by_path[".params['groups']['mamba']['A_log']"]
        assert a_log["shape"] == [2, 2, tc.ssm_heads]
        assert a_log["dtype"] == "float32"
    jd, td = tmp_path / "jax" / "step_00000003", \
        tmp_path / "port" / "step_00000003"
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    for name in os.listdir(jd):
        assert (jd / name).read_bytes() == (td / name).read_bytes(), name


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
def test_hybrid_jax_checkpoint_restores_into_the_port(pdtype, tmp_path):
    """A hybrid state saved by repro.checkpoint.Checkpointer after one
    train step, restored by the port, equals carry_train_state of the same
    state bitwise (f32, and bf16 parameters and moments), groups, tail and
    shared block alike."""
    jc, tc = (dataclasses.replace(c, param_dtype=pdtype)
              for c in CONFIGS["hybrid"])
    pair = _opt_pair("bf16" if pdtype == "bfloat16" else "f32")
    jlm, js, tlm, _ = _states(jc, tc, pair, seed=2)
    js, _ = jax.jit(j_make_train_step(jlm, pair[0]))(
        js, _learnable_data().batch(0))
    JCheckpointer(str(tmp_path)).save(1, js)
    got = Checkpointer(str(tmp_path)).restore(
        create(tlm, pair[1], 0, device="cpu"))
    want = carry_train_state(_np_tree(js), tc, device="cpu")
    _equal_states(got, want)
    layer = got.params["groups"][1][1]["mamba"]
    assert layer["in_proj"].dtype == getattr(torch, pdtype)
    assert layer["A_log"].dtype == torch.float32
    assert len(got.params["groups"]) == 2 and len(got.params["tail"]) == 1
    assert got.opt_state.mu["groups"][0][1]["mamba"]["in_proj"].dtype == \
        getattr(torch, pdtype)


def test_hybrid_port_checkpoint_restores_into_jax(tmp_path):
    """f32 only: the JAX package's own restore cannot cast a bf16 leaf
    back (ROADMAP queue 3 item 4).  The port's state after one train step,
    restored by the JAX package, holds the same arrays under the same
    paths, and the JAX package trains on from it as the port does."""
    jc, tc = CONFIGS["hybrid"]
    pair = _opt_pair()
    tlm = TLM(tc)
    tstep = make_train_step(tlm, pair[1])
    ts = create(tlm, pair[1], 4, device="cpu")
    ts, _ = tstep(ts, _learnable_data().batch(0))
    Checkpointer(str(tmp_path)).save(1, ts)
    jlm = JLM(jc)
    jt = j_create(jlm, pair[0], jax.random.PRNGKey(0))
    got = JCheckpointer(str(tmp_path)).restore(jt)
    want, have = _port_flat(ts), _jax_flat(got)
    assert sorted(want) == sorted(have)
    for p in want:
        assert have[p].dtype == want[p].dtype, p
        np.testing.assert_array_equal(have[p], want[p], err_msg=p)
    js, jm = jax.jit(j_make_train_step(jlm, pair[0]))(
        got, _learnable_data().batch(1))
    ts, tm = tstep(ts, _learnable_data().batch(1))
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-5)
    _close_trees(ts.params, js.params, "params ", rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,layers", [("qwen3-moe-30b-a3b", 48),
                                         ("zamba2-7b", 81),
                                         ("arctic-480b", 35)])
def test_train_launcher_refuses_a_config_larger_than_the_card(
        arch, layers, monkeypatch, capsys):
    """At scale 1 qwen3-moe-30b-a3b's parameters, gradients and AdamW
    moments take 427 GB and zamba2-7b's 94 GB: on an 80 GB card the
    launcher says so, and how many layers would fit, before it allocates.
    arctic-480b fits at no depth: one layer is 14.1 B parameters (its
    experts 13.4 B)."""
    monkeypatch.setattr(t_launch, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"total_memory": 80e9}))
    monkeypatch.setattr(t_launch, "Trainer", None)   # never reached
    with pytest.raises(SystemExit):
        t_launch.main(["--arch", arch, "--scale", "1.0", "--steps", "1"])
    err = capsys.readouterr().err
    assert "do not fit the card's 80.0 GB" in err
    cfg = get_config(arch)
    fit = int(err.split("at full width ")[1].split(" of")[0])
    assert f"of its {layers} layers" in err
    assert (fit == 0) == (arch == "arctic-480b") and fit < layers
    assert fit == 0 or t_launch.train_state_bytes(dataclasses.replace(
        cfg, num_layers=fit)) <= 80e9
    assert t_launch.train_state_bytes(dataclasses.replace(
        cfg, num_layers=fit + 1)) > 80e9


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "arctic-480b",
                                  "mamba2-370m", "zamba2-7b"])
def test_train_launcher_trains_each_family_reduced(arch, capsys):
    """launch.train at scale 0.05 on the CPU: two steps, a finite loss."""
    assert t_launch.main(["--arch", arch, "--scale", "0.05", "--steps", "2",
                          "--batch", "2", "--seq", "16",
                          "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"training {arch}-x0.05" in out
    assert np.isfinite(float(out.split("final loss: ")[1]))
