"""The port's training path (repro_torch: models.lm loss, optim, train,
data, checkpoint, runtime, launch.train and launch.serve --ckpt-dir)
against the JAX package's, on the same numpy inputs, at CPU sizes.

Both packages start from the same state: the JAX package's, carried over
by ``repro_torch.interop.carry_train_state`` (parameters and AdamW state
as numpy).  The JAX side runs on its CPU plane; the port's host tensors
select the torch plane, whose attention autograd differentiates (the
kernel wrappers' own backward is held in tests/test_torch_attention_grad.py
and, on the card, tests/test_torch_kernels.py).

Bars: losses, gradients and one optimizer step at 1e-5; schedules at 1e-6
relative; batches and checkpoint arrays bitwise.  Parameters after several
Adam steps are held at a bar each test states (Adam's m / sqrt(v) turns an
f32 rounding in a near-zero gradient into an update of up to lr).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_config as j_get_config
from repro.configs.base import ModelConfig as JCfg
from repro.data import ByteCorpus as JByteCorpus
from repro.data import SyntheticLM as JSyntheticLM
from repro.models.lm import LM as JLM
from repro.models.lm import cross_entropy_loss as j_ce
from repro.optim import adamw as j_adamw
from repro.optim import compress as j_compress
from repro.optim import schedules as j_sched
from repro.train import create as j_create
from repro.train import make_train_step as j_make_train_step
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint import checkpointer as ckpt_mod
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig as TCfg
from repro_torch.data import ByteCorpus, SyntheticLM, host_slice, prefetch
from repro_torch.interop import carry_params, carry_train_state
from repro_torch.launch import train as t_launch
from repro_torch.models.lm import LM as TLM
from repro_torch.models.lm import cross_entropy_loss
from repro_torch.optim import adamw, compress, schedules
from repro_torch.runtime import (FileHeartbeatStore, HeartbeatStore, Monitor,
                                 TrainingSupervisor, WorkerState)
from repro_torch.train import create, make_eval_step, make_train_step
from repro_torch.train.step import value_and_grad
from repro_torch.utils.tree import tree_leaves, tree_map

TOL = dict(rtol=1e-5, atol=1e-5)

#: tests/test_train_integration.py's config.
ITEST = dict(name="itest", family="dense", num_layers=2, d_model=32,
             vocab_size=64, num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64,
             dtype="float32", param_dtype="float32")


def _qwen3_small(base):
    """qwen3-1.7b's structure (qk_norm, GQA, tied) at a CPU size."""
    return dataclasses.replace(
        base, name="qwen3-small", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=300,
        dtype="float32", param_dtype="float32", remat=False)


CONFIGS = {
    "itest": (JCfg(**ITEST, remat=False), TCfg(**ITEST, remat=False)),
    "qwen3": (_qwen3_small(j_get_config("qwen3-1.7b")),
              _qwen3_small(get_config("qwen3-1.7b"))),
}


def _learnable_data(n_batches=64, B=8, S=16, V=64):
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
    """The port's tree by the JAX package's leaf paths, layers stacked."""
    out = {}
    for p, leaf in ckpt_mod._paths(tree):
        t = torch.stack(leaf) if isinstance(leaf, list) else leaf
        t = t.detach()
        out[p] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out


def _close_trees(got, want, what="", **tol):
    g, w = _port_flat(got), _jax_flat(want)
    assert sorted(g) == sorted(w), what
    for p in w:
        np.testing.assert_allclose(g[p], np.asarray(w[p], g[p].dtype),
                                   err_msg=f"{what}{p}", **(tol or TOL))


def _states(name, opt_pair, seed=0):
    """The JAX state and the port's carried copy of it."""
    jc, tc = CONFIGS[name]
    jlm, tlm = JLM(jc), TLM(tc)
    js = j_create(jlm, opt_pair[0], jax.random.PRNGKey(seed))
    ts = carry_train_state(_np_tree(js), tc, device="cpu")
    return jlm, js, tlm, ts


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 5, 17)).astype(np.float32) * 3
    labels = rng.integers(0, 17, (3, 5)).astype(np.int32)
    labels[0, :2] = -1                       # ignored positions
    got, n = cross_entropy_loss(torch.as_tensor(logits),
                                torch.as_tensor(labels))
    want, jn = j_ce(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert int(n) == int(jn) == 13
    none = np.full((3, 5), -1, np.int32)
    got, n = cross_entropy_loss(torch.as_tensor(logits),
                                torch.as_tensor(none))
    assert float(got) == 0.0 and int(n) == 1


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_and_every_gradient_match_jax(name):
    """LM.loss and the gradient of every parameter (wq, wk, wv, q_norm and
    k_norm among them: what a missing attention backward gets wrong)."""
    jc, tc = CONFIGS[name]
    jlm, tlm = JLM(jc), TLM(tc)
    jp = jlm.init(jax.random.PRNGKey(1))
    tp = carry_params(_np_tree(jp), tc, device="cpu")
    batch = _learnable_data(B=4, S=12, V=jc.vocab_size).batch(3)
    (jl, _), jg = jax.value_and_grad(jlm.loss, has_aux=True)(jp, batch)
    (tl, metrics), tg = value_and_grad(tlm.loss, tp, batch)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert int(metrics["tokens"]) == 4 * 12
    _close_trees(tg, jg, "grad ")
    if name == "qwen3":
        assert "['layers']['attn']['q_norm']['scale']" in _port_flat(tg)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_remat_gradients_equal_no_remat_bitwise(name):
    """cfg.remat recomputes each block in backward; the values must not
    change at all."""
    _, tc = CONFIGS[name]
    tp = TLM(tc).init(0, device="cpu")
    batch = _learnable_data(B=4, S=12, V=tc.vocab_size).batch(0)
    out = {}
    for remat in (False, True):
        lm = TLM(dataclasses.replace(tc, remat=remat))
        (loss, _), g = value_and_grad(lm.loss, tp, batch)
        out[remat] = (loss, _port_flat(g))
    assert torch.equal(out[False][0], out[True][0])
    for p, g in out[False][1].items():
        np.testing.assert_array_equal(out[True][1][p], g, err_msg=p)


def test_remat_recompute_keeps_the_requested_plane(monkeypatch):
    """A CUDA backward (and so remat's recompute) runs on the autograd
    engine's own thread, which does not see a ``use_backend`` request: the
    recompute must still run the plane the forward ran.  Here the device
    rule is made to pick the kernel wrappers (their plain versions run on
    host tensors), the forward runs under use_backend("torch"), and the
    backward outside it, as that thread would see it."""
    from repro_torch.core import registry
    _, tc = CONFIGS["qwen3"]
    lm = TLM(dataclasses.replace(tc, remat=True))
    params = lm.init(0, device="cpu")
    batch = _learnable_data(B=2, S=12, V=tc.vocab_size).batch(0)
    monkeypatch.setattr(registry, "device_type_of", lambda *t: "cuda")
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    with registry.use_backend("torch"):
        loss, _ = lm.loss(live, batch)
    grads = torch.autograd.grad(loss, leaves)
    with registry.use_backend("torch"):
        _, want = value_and_grad(TLM(tc).loss, params, batch)
    for g, w in zip(grads, tree_leaves(want)):
        assert torch.equal(g, w)


def test_eval_step_matches_loss():
    _, tc = CONFIGS["itest"]
    lm = TLM(tc)
    tp = lm.init(0, device="cpu")
    batch = _learnable_data().batch(0)
    m = make_eval_step(lm)(tp, batch)
    assert m["loss"].grad_fn is None
    assert float(m["loss"]) == float(lm.loss(tp, batch)[0])


# ---------------------------------------------------------------------------
# optimizer, schedules, compression
# ---------------------------------------------------------------------------

def _opt_pair(**kw):
    jkw = dict(kw)
    tkw = dict(kw)
    if "moment_dtype" in kw:
        jkw["moment_dtype"] = jnp.bfloat16
        tkw["moment_dtype"] = torch.bfloat16
    return (j_adamw(j_sched.constant(1e-3), **jkw),
            adamw(schedules.constant(1e-3), **tkw))


def _grads_like(tree_np, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * scale).astype(np.float32),
        tree_np)


@pytest.mark.parametrize("clip", [None, 1.0, 1e3])
@pytest.mark.parametrize("moments", ["f32", "bf16"])
@pytest.mark.parametrize("steps", [1, 5])
def test_adamw_matches_jax(steps, moments, clip):
    """Updates from carried states on the same gradients: clip 1.0 is
    active (the gradients' norm is about 7), 1e3 inactive; bf16 moments
    round m and v each step."""
    kw = dict(clip=clip, weight_decay=0.1)
    if moments == "bf16":
        kw["moment_dtype"] = "bf16"
    pair = _opt_pair(**kw)
    _, js, _, ts = _states("itest", pair)
    jp, jo = js.params, js.opt_state
    tp, to = ts.params, ts.opt_state
    for i in range(steps):
        g_np = _grads_like(_np_tree(jp), i, 0.05)
        ju, jo = pair[0].update(jax.tree_util.tree_map(jnp.asarray, g_np),
                                jo, jp)
        tu, to = pair[1].update(carry_params(g_np, CONFIGS["itest"][1],
                                             device="cpu"), to, tp)
        _close_trees(tu, ju, f"step {i} update ", rtol=1e-5, atol=1e-7)
        from repro.optim import apply_updates as j_apply
        from repro_torch.optim import apply_updates as t_apply
        jp, tp = j_apply(jp, ju), t_apply(tp, tu)
    assert int(to.count) == int(jo.count) == steps
    mdt = torch.bfloat16 if moments == "bf16" else torch.float32
    assert to.mu["embed"].dtype == mdt
    _close_trees(tp, jp, "params ", rtol=1e-5, atol=1e-6)
    _close_trees(to.mu, jo.mu, "mu ", rtol=1e-5, atol=1e-7)
    _close_trees(to.nu, jo.nu, "nu ", rtol=1e-5, atol=1e-9)


def test_global_norm_and_apply_updates_match_jax():
    from repro.optim import apply_updates as j_apply
    from repro.optim import global_norm as j_norm
    from repro_torch.optim import apply_updates, global_norm
    rng = np.random.default_rng(4)
    t = {"a": rng.standard_normal((3, 4)).astype(np.float32),
         "b": [rng.standard_normal(5).astype(np.float32)]}
    jt = {"a": jnp.asarray(t["a"]), "b": [jnp.asarray(t["b"][0])]}
    tt = {"a": torch.as_tensor(t["a"]), "b": [torch.as_tensor(t["b"][0])]}
    np.testing.assert_allclose(global_norm(tt).numpy(),
                               np.asarray(j_norm(jt)), **TOL)
    p16 = {"a": torch.as_tensor(t["a"]).bfloat16(), "b": [tt["b"][0]]}
    got = apply_updates(p16, tt)
    want = j_apply({"a": jt["a"].astype(jnp.bfloat16), "b": jt["b"]}, jt)
    assert got["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["a"].float().numpy(),
                                  np.asarray(want["a"], np.float32))


SCHEDULES = [("constant", (2e-3,), {}), ("linear_warmup", (2e-3, 10), {}),
             ("wsd", (1e-2, 1000), {}), ("wsd", (3e-4, 10), {}),
             ("cosine", (1e-2, 1000), {}),
             ("cosine", (1e-2, 50), dict(warmup_frac=0.1, floor=0.0))]


@pytest.mark.parametrize("name,args,kw", SCHEDULES)
def test_schedules_match_jax(name, args, kw):
    """Steps 0, 1, end of warmup, the plateau, decay start and the end, at
    1e-6 relative; plus 1e-7 of the peak rate absolute, for the end of a
    cosine decay to 0, where 1 + cos(pi t) cancels and a last-ulp
    difference of the two packages' cos grows to 2e-5 relative."""
    total = args[1] if name in ("wsd", "cosine") else 100
    steps = sorted({0, 1, 2, max(1, int(total * 0.01)), total // 2,
                    int(total * 0.9), int(total * 0.9) + 1, total - 1,
                    total, total + 5, 10})
    jf = getattr(j_sched, name)(*args, **kw)
    tf = getattr(schedules, name)(*args, **kw)
    for s in steps:
        for step in (s, torch.tensor(s, dtype=torch.int32)):
            got = tf(step)
            assert got.dtype == torch.float32 and got.shape == ()
            np.testing.assert_allclose(got.numpy(), np.asarray(jf(s)),
                                       rtol=1e-6, atol=1e-7 * args[0],
                                       err_msg=str(s))


def test_quantize_int8_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(1000).astype(np.float32) * 3
    q, s = compress.quantize_int8(torch.as_tensor(x))
    jq, js = j_compress.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)
    np.testing.assert_allclose(compress.dequantize_int8(q, s).numpy(),
                               np.asarray(j_compress.dequantize_int8(jq, js)),
                               **TOL)


def test_compressed_optimizer_matches_jax():
    """Three updates through int8 error feedback: the updates and the
    carried error agree."""
    jopt = j_compress.compressed(j_adamw(j_sched.constant(1e-2), clip=None))
    topt = compress.compressed(adamw(schedules.constant(1e-2), clip=None))
    rng = np.random.default_rng(5)
    p = {"w": rng.standard_normal((4, 8)).astype(np.float32)}
    jp = {"w": jnp.asarray(p["w"])}
    tp = {"w": torch.as_tensor(p["w"])}
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(3):
        g = (rng.standard_normal((4, 8)) * 10.0 ** -i).astype(np.float32)
        ju, js = jopt.update({"w": jnp.asarray(g)}, js, jp)
        tu, ts = topt.update({"w": torch.as_tensor(g)}, ts, tp)
        np.testing.assert_allclose(tu["w"].numpy(), np.asarray(ju["w"]),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(ts["ef"]["w"].numpy(),
                                   np.asarray(js["ef"]["w"]), **TOL)
    # compressed_psum over a one-rank 'pod' axis (use_level(O4) without a
    # process group): the quantisation round trip, as the reference's
    # single-participant shard_map (tests/test_compress.py)
    from jax.sharding import Mesh, PartitionSpec as JP

    from repro_torch.core import ExecLevel, use_level

    x = np.linspace(-1, 1, 64).astype(np.float32)
    want = jax.shard_map(lambda v: j_compress.compressed_psum(v, "pod"),
                         mesh=Mesh(np.array(jax.devices()[:1]), ("pod",)),
                         in_specs=JP(), out_specs=JP())(jnp.asarray(x))
    with use_level(ExecLevel.O4):
        got = compress.compressed_psum(torch.as_tensor(x), "pod")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(got.numpy(), x, atol=1.0 / 127)
    with pytest.raises(ValueError, match="no such axis"):
        compress.compressed_psum(torch.as_tensor(x), "pod")


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_jax(name, microbatches):
    """Three train steps from one state on the same batches: loss and
    grad_norm at 1e-5 relative each step; parameters within 1e-4
    absolute, a tenth of the most one step can move a weight (lr = 1e-3).
    Adam's m / sqrt(v) magnifies the packages' f32 differences where a
    gradient is near 0 (the JAX test's own warning): the largest
    difference seen was 2.4e-5 at qwen3-small and 5e-7 at itest."""
    pair = (j_adamw(j_sched.constant(1e-3)), adamw(schedules.constant(1e-3)))
    jlm, js, tlm, ts = _states(name, pair)
    jstep = jax.jit(j_make_train_step(jlm, pair[0],
                                      microbatches=microbatches))
    tstep = make_train_step(tlm, pair[1], microbatches=microbatches)
    data = _learnable_data(B=4, S=12, V=CONFIGS[name][0].vocab_size)
    for i in range(3):
        js, jm = jstep(js, data.batch(i))
        ts, tm = tstep(ts, data.batch(i))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                       rtol=1e-5, err_msg=f"step {i} {k}")
    assert int(ts.step) == int(js.step) == 3
    _close_trees(ts.params, js.params, "params ", rtol=1e-4, atol=1e-4)


def test_loss_decreases_on_learnable_task():
    """The port's test_train_integration.py::TestLearning counterpart."""
    _, tc = CONFIGS["itest"]
    lm = TLM(tc)
    opt = adamw(schedules.constant(3e-3))
    state = create(lm, opt, 0, device="cpu")
    step = make_train_step(lm, opt)
    data = _learnable_data()
    losses = []
    for i in range(60):
        state, m = step(state, data.batch(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    assert losses[-1] < 1.0


def test_grad_accumulation_matches_full_batch():
    """Mean of per-microbatch grads == full-batch grad (relative 1e-4),
    and the train steps' losses agree."""
    _, tc = CONFIGS["itest"]
    lm = TLM(tc)
    params = lm.init(0, device="cpu")
    batch = _learnable_data(B=8).batch(0)
    (_, _), g_full = value_and_grad(lm.loss, params, batch)
    parts = [value_and_grad(lm.loss, params,
                             {k: v[2 * i:2 * i + 2] for k, v in
                              batch.items()})[1] for i in range(4)]
    full, mean = _port_flat(g_full), None
    flats = [_port_flat(g) for g in parts]
    mean = {p: sum(f[p] for f in flats) / 4.0 for p in full}
    worst = max(np.abs(full[p] - mean[p]).max() / (np.abs(full[p]).max()
                                                   + 1e-8) for p in full)
    assert worst < 1e-4
    opt = adamw(schedules.constant(1e-3))
    _, m1 = make_train_step(lm, opt)(create(lm, opt, 0, device="cpu"),
                                     batch)
    _, m2 = make_train_step(lm, opt, microbatches=4)(
        create(lm, opt, 0, device="cpu"), batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-4)


def test_train_step_leaves_its_input_state():
    _, tc = CONFIGS["itest"]
    lm = TLM(tc)
    opt = adamw(schedules.constant(1e-3))
    state = create(lm, opt, 0, device="cpu")
    before = _port_flat(state)
    make_train_step(lm, opt)(state, _learnable_data().batch(0))
    for p, x in _port_flat(state).items():
        np.testing.assert_array_equal(x, before[p])


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_and_byte_batches_equal_jax(seed):
    for i in (0, 1, 17):
        t = SyntheticLM(vocab_size=300, seq_len=24, global_batch=3,
                        seed=seed).batch(i)
        j = JSyntheticLM(vocab_size=300, seq_len=24, global_batch=3,
                         seed=seed).batch(i)
        assert sorted(t) == sorted(j)
        for k in j:
            assert t[k].dtype == j[k].dtype
            np.testing.assert_array_equal(t[k], j[k])
        f = SyntheticLM(vocab_size=50, seq_len=12, global_batch=2, seed=seed,
                        frontend_len=4, d_model=8).batch(i)
        jf = JSyntheticLM(vocab_size=50, seq_len=12, global_batch=2,
                          seed=seed, frontend_len=4, d_model=8).batch(i)
        np.testing.assert_array_equal(f["frontend_embeds"],
                                      jf["frontend_embeds"])
    blob = bytes(range(256)) * 16
    for i in (0, 3):
        t = ByteCorpus(blob, seq_len=32, global_batch=4, seed=seed).batch(i)
        j = JByteCorpus(blob, seq_len=32, global_batch=4, seed=seed).batch(i)
        for k in j:
            np.testing.assert_array_equal(t[k], j[k])
        np.testing.assert_array_equal(t["tokens"][:, 1:],
                                      t["labels"][:, :-1])


def test_prefetch_keeps_order_and_host_slice():
    ds = SyntheticLM(vocab_size=16, seq_len=4, global_batch=6)
    got = [b for _, b in zip(range(5), prefetch(iter(ds), size=2,
                                                device="cpu"))]
    for i, b in enumerate(got):
        assert isinstance(b["tokens"], torch.Tensor)
        np.testing.assert_array_equal(b["tokens"].numpy(),
                                      ds.batch(i)["tokens"])
    rows = host_slice(ds.batch(0), 1, 3)
    np.testing.assert_array_equal(rows["labels"],
                                  ds.batch(0)["labels"][1::3])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _port_state(seed=0, moment_dtype=torch.float32, pdtype="float32"):
    _, tc = CONFIGS["qwen3"]
    lm = TLM(dataclasses.replace(tc, param_dtype=pdtype))
    opt = adamw(schedules.constant(1e-3), moment_dtype=moment_dtype)
    return lm, opt, create(lm, opt, seed, device="cpu")


def _equal_states(a, b):
    fa, fb = _port_flat(a), _port_flat(b)
    assert sorted(fa) == sorted(fb)
    for p in fa:
        np.testing.assert_array_equal(fa[p], fb[p], err_msg=p)


class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        for pdtype in ("float32", "bfloat16"):
            _, _, state = _port_state(pdtype=pdtype)
            ckpt = Checkpointer(str(tmp_path / pdtype))
            ckpt.save(7, state)
            assert ckpt.latest_step() == 7
            _, _, other = _port_state(seed=3, pdtype=pdtype)
            restored = ckpt.restore(other)
            _equal_states(restored, state)
            assert restored.params["embed"].dtype == getattr(torch, pdtype)

    def test_async_save_and_prune(self, tmp_path):
        _, _, state = _port_state()
        ckpt = Checkpointer(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            ckpt.save_async(s, state)
        ckpt.wait()
        assert ckpt.all_steps() == [3, 4]
        assert ckpt.latest_step() == 4

    def test_atomic_publish_no_tmp_left(self, tmp_path):
        _, _, state = _port_state()
        ckpt = Checkpointer(str(tmp_path))
        ckpt.save(1, state)
        names = os.listdir(tmp_path)
        assert not any(n.startswith(".tmp") for n in names)
        assert "LATEST" in names

    def test_restart_resumes_bit_exact(self, tmp_path):
        """Train 10 steps with a crash at 7 -> restart -> the final state
        equals an uninterrupted 10-step run bitwise."""
        lm, opt, _ = _port_state()
        step = make_train_step(lm, opt)
        data = _learnable_data(V=300)
        ref = create(lm, opt, 0, device="cpu")
        for i in range(10):
            ref, _ = step(ref, data.batch(i))
        ckpt = Checkpointer(str(tmp_path))
        sup = TrainingSupervisor(ckpt, create(lm, opt, 0, device="cpu"),
                                 save_every=5)
        with pytest.raises(RuntimeError, match="injected failure"):
            sup.run(step, data, 10, fail_at=7)
        sup2 = TrainingSupervisor(ckpt, create(lm, opt, 1, device="cpu"),
                                  save_every=5)
        assert int(sup2.state.step) == 5
        final, _ = sup2.run(step, data, 10)
        _equal_states(final, ref)

    def test_mismatched_template_and_mesh_raise(self, tmp_path):
        _, _, state = _port_state()
        ckpt = Checkpointer(str(tmp_path))
        ckpt.save(1, state)
        with pytest.raises(ValueError, match="does not match"):
            ckpt.restore(state.params)
        # a mesh without shardings is not read (the reference's restore
        # reads only shardings): the leaves come back whole
        _equal_states(ckpt.restore(state, mesh=object()), state)
        with pytest.raises(ValueError, match="do not match the tree"):
            ckpt.save(2, state, specs=object())

    @pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
    def test_jax_checkpoint_restores_into_the_port(self, tmp_path, pdtype):
        """A state saved by repro.checkpoint.Checkpointer, restored by the
        port, equals carry_train_state of the same state (f32, and bf16
        parameters and moments, bitwise)."""
        jc, tc = CONFIGS["qwen3"]
        jc = dataclasses.replace(jc, param_dtype=pdtype)
        tc = dataclasses.replace(tc, param_dtype=pdtype)
        mdt = (jnp.float32, torch.float32) if pdtype == "float32" else \
            (jnp.bfloat16, torch.bfloat16)
        jopt = j_adamw(j_sched.constant(1e-3), moment_dtype=mdt[0])
        topt = adamw(schedules.constant(1e-3), moment_dtype=mdt[1])
        jlm, tlm = JLM(jc), TLM(tc)
        js = j_create(jlm, jopt, jax.random.PRNGKey(2))
        js, _ = jax.jit(j_make_train_step(jlm, jopt))(
            js, _learnable_data(B=2, S=8, V=300).batch(0))
        JCheckpointer(str(tmp_path)).save(1, js)
        got = Checkpointer(str(tmp_path)).restore(
            create(tlm, topt, 0, device="cpu"))
        want = carry_train_state(_np_tree(js), tc, device="cpu")
        _equal_states(got, want)
        assert got.params["layers"][1]["attn"]["wq"].dtype == \
            getattr(torch, pdtype)
        assert got.opt_state.mu["embed"].dtype == mdt[1]

    def test_port_checkpoint_restores_into_jax(self, tmp_path):
        """f32 only: the JAX package's own restore cannot cast a bf16 leaf
        back (ROADMAP queue 3 item 4)."""
        jc, tc = CONFIGS["qwen3"]
        tlm = TLM(tc)
        topt = adamw(schedules.constant(1e-3))
        ts = create(tlm, topt, 4, device="cpu")
        ts, _ = make_train_step(tlm, topt)(
            ts, _learnable_data(B=2, S=8, V=300).batch(0))
        Checkpointer(str(tmp_path)).save(1, ts)
        jopt = j_adamw(j_sched.constant(1e-3))
        jt = j_create(JLM(jc), jopt, jax.random.PRNGKey(0))
        got = JCheckpointer(str(tmp_path)).restore(jt)
        want, have = _port_flat(ts), _jax_flat(got)
        assert sorted(want) == sorted(have)
        for p in want:
            assert have[p].dtype == want[p].dtype, p
            np.testing.assert_array_equal(have[p], want[p], err_msg=p)

    def test_bf16_leaf_files_equal_jax(self, tmp_path):
        """The same bf16 tree written by both packages: the manifests and
        every leaf file are the same bytes."""
        jc, tc = CONFIGS["qwen3"]
        jc = dataclasses.replace(jc, param_dtype="bfloat16")
        tc = dataclasses.replace(tc, param_dtype="bfloat16")
        jopt = j_adamw(j_sched.constant(1e-3), moment_dtype=jnp.bfloat16)
        js = j_create(JLM(jc), jopt, jax.random.PRNGKey(5))
        ts = carry_train_state(_np_tree(js), tc, device="cpu")
        JCheckpointer(str(tmp_path / "jax")).save(3, js)
        Checkpointer(str(tmp_path / "port")).save(3, ts)
        jd, td = tmp_path / "jax" / "step_00000003", \
            tmp_path / "port" / "step_00000003"
        assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
        for name in os.listdir(jd):
            assert (jd / name).read_bytes() == (td / name).read_bytes(), name


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

class TestFaultTolerance:
    def test_monitor_verdicts(self):
        store = HeartbeatStore()
        now = 1000.0
        store.post(0, step=50, now=now - 1)        # healthy
        store.post(1, step=50, now=now - 120)      # silent too long -> dead
        store.post(2, step=30, now=now - 30)       # lagging + stale
        mon = Monitor(store, dead_after=60, straggler_lag=3,
                      straggler_factor=2.0)
        v = mon.verdicts(now=now)
        assert v[0] == WorkerState.HEALTHY
        assert v[1] == WorkerState.DEAD
        assert v[2] == WorkerState.STRAGGLER
        assert mon.survivors(now=now) == [0, 2]

    def test_file_heartbeat_store(self, tmp_path):
        store = FileHeartbeatStore(str(tmp_path))
        store.post(3, step=9, now=500.0, occupancy=0.25)
        beats = store.all()
        assert beats[3].step == 9 and beats[3].time == 500.0
        assert beats[3].occupancy == 0.25


# ---------------------------------------------------------------------------
# the trainer, its launcher, serving from a checkpoint, devices
# ---------------------------------------------------------------------------

def test_minicpm_trainer_matches_jax():
    """Two Trainer steps of minicpm-2b cut to a CPU size (the WSD branch)
    from the JAX trainer's state: the same losses, and the same parameters
    within the train-step bar."""
    from repro.launch.train import Trainer as JTrainer
    from repro.launch.train import reduce_config as j_reduce
    jc = j_reduce(j_get_config("minicpm-2b"), 0.05)
    tc = t_launch.reduce_config(get_config("minicpm-2b"), 0.05)
    jt = JTrainer(jc, lr=1e-3, total_steps=2)
    tt = t_launch.Trainer(tc, lr=1e-3, total_steps=2, device="cpu")
    tt.state = carry_train_state(_np_tree(jt.state), tc, device="cpu")
    data = JSyntheticLM(vocab_size=jc.vocab_size, seq_len=16,
                        global_batch=2)
    jh = jt.fit(data, 2, log_every=1)["history"]
    th = tt.fit(data, 2, log_every=1)["history"]
    assert [h["step"] for h in th] == [1, 2]
    for a, b in zip(th, jh):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
    _close_trees(tt.state.params, jt.state.params, rtol=1e-4, atol=1e-4)


def test_train_launcher_then_serve_from_its_checkpoint(tmp_path, capsys):
    """launch.train trains 2 steps at a CPU scale and saves; launch.serve
    --ckpt-dir loads those parameters and generates from them."""
    from repro_torch.launch import serve as t_serve
    from repro_torch.serve import Engine, SamplingParams
    d = str(tmp_path)
    assert t_launch.main(["--arch", "qwen3-1.7b", "--scale", "0.05",
                          "--steps", "2", "--batch", "2", "--seq", "16",
                          "--device", "cpu", "--ckpt-dir", d]) == 0
    assert Checkpointer(d).latest_step() == 2
    assert t_serve.main(["--arch", "qwen3-1.7b", "--scale", "0.05",
                         "--batch", "2", "--prompt-len", "8",
                         "--new-tokens", "4", "--device", "cpu",
                         "--ckpt-dir", d]) == 0
    out = capsys.readouterr().out
    assert "loaded checkpoint step 2" in out
    cfg = t_launch.reduce_config(get_config("qwen3-1.7b"), 0.05)
    lm = TLM(cfg)
    opt = adamw(schedules.constant(1e-4))
    params = Checkpointer(d).restore(create(lm, opt, 0,
                                            device="cpu")).params
    gen = torch.Generator(device="cpu").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
    toks = Engine(lm, params, max_len=20,
                  sampling=SamplingParams(greedy=True)).generate(
        prompts, max_new_tokens=4, seed=0)
    assert f"first row: {toks[0].tolist()}" in out
    fresh = TLM(cfg).init(0, device="cpu")
    assert not torch.equal(fresh["embed"], params["embed"])


def test_training_entry_points_go_to_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc = CONFIGS["itest"]
    lm = TLM(tc)
    opt = adamw(schedules.constant(1e-3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create(lm, opt, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_launch.Trainer(tc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_launch.main(["--arch", "qwen3-1.7b", "--scale", "0.05",
                       "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(prefetch(iter(SyntheticLM(vocab_size=8, seq_len=4,
                                       global_batch=1))))
    from repro_torch.core.topology import LocalMesh

    with pytest.raises(NotImplementedError, match="queue 1 item 10b-iii"):
        t_launch.Trainer(tc, mesh=LocalMesh(("data", "model"), (1, 2)),
                         device="cpu")
    assert t_launch.Trainer(tc, device="cpu").state.step.device.type == "cpu"
