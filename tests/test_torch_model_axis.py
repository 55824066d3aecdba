"""The port's compute split over the model axis (``distributed.
model_split``: Megatron's products, vocab-parallel logits and cross
entropy, expert parallelism, the SSM leaves gathered at use) in
``Trainer(mesh=...)`` and the fixed ``Engine``, against the JAX package's
``Trainer`` and ``Engine`` on meshes of the same shape.

The port runs on 8 gloo ranks of one spawned world (one per test module),
on the meshes (data 4, model 2), (data 2, model 4), (pod 2, data 2,
model 2) and (data 2, model 2) over the first four ranks; the JAX side
runs the same calls on the 8 forced host devices while the world runs.
Both sides start from the port's seeded parameters: the ranks draw them,
the JAX side gets them restacked (no JAX init).  A spawned rank imports
this module by name, so it imports no JAX at top level.

Bars: the JAX suites' f32 tolerance, 1e-5, on losses, gradients and
parameters; the shared results, every rank's, bitwise.
"""
import os
import re

import numpy as np
import pytest
import torch

WORLD = 8
SEQ, BATCH, STEPS = 16, 8, 3
TOL = dict(rtol=1e-5, atol=1e-5)
#: tests/test_models.py's ``tiny`` configs, by family.
BASE = dict(num_layers=2, d_model=32, vocab_size=64, dtype="float32",
            param_dtype="float32", remat=False)
ATTN = dict(num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64)
CONFIGS = {
    "dense": dict(family="dense", **ATTN),
    "moe": dict(family="moe", **{**ATTN, "d_ff": 0}, num_experts=4,
                experts_per_token=2, moe_d_ff=32, capacity_factor=4.0),
    "ssm": dict(family="ssm", ssm_state=16, ssm_headdim=16),
    "hybrid": dict(family="hybrid", **{**ATTN, "num_kv_heads": 4},
                   ssm_state=16, ssm_headdim=16, attn_every=2,
                   num_layers=5),
    # a vocabulary of 200 padded to 256: at model 2 the last rank holds
    # rows 128-255, the padding among them; qk_norm's scales and the lane
    # floor's replicated wk / wv are each rank's in part
    "untied": dict(family="dense", **ATTN, vocab_size=200, qk_norm=True),
    "tied": dict(family="dense", **ATTN, vocab_size=200, qk_norm=True,
                 tie_embeddings=True),
    # 6 q heads and 3 kv heads divide neither 2 nor 4 ranks by whole GQA
    # groups: the attention runs whole on every rank of the model group
    "odd_heads": dict(family="dense", **{**ATTN, "num_heads": 6,
                                         "num_kv_heads": 3},
                      qk_norm=True),
}
#: (config, capacity factor, mesh, level) of the Trainer runs: the losses
#: (and the parameters gathered whole after the steps) against the
#: reference's; at O3 attention runs over the data ring at the rank's
#: heads.
TRAIN_RUNS = (("dense", None, "m42", None), ("dense", None, "m42", "O3"),
              ("dense", None, "m24", None), ("dense", None, "m222", "O4"),
              ("moe", 4.0, "m42", None), ("moe", 1.0, "m42", None),
              ("moe", 1.0, "m24", None), ("ssm", None, "m42", None),
              ("hybrid", None, "m24", None))
#: The reference run each Trainer run is held against: (mesh, level).
#: Where dispatch groups do not change the values (every config but the
#: MoE's at capacity factor 1, whose groups are the data shards and drop
#: tokens), the reference's values do not depend on its mesh, and one run
#: stands for the rest: the dense family's on (data 4, model 2), the
#: others' without a mesh (its SPMD compile takes 8-30 s a run here,
#: without one 2-3 s).
REFERENCE = {("dense", None): ("m42", None), ("moe", 4.0): (None, None),
             ("ssm", None): (None, None), ("hybrid", None): (None, None)}
#: (config, mesh) of one step's gradients, every leaf gathered whole.
GRAD_RUNS = (("untied", "m42"), ("tied", "m42"), ("untied", "m24"),
             ("odd_heads", "m42"), ("odd_heads", "m24"))
#: JAX mesh shapes of the port's meshes.
MESHES = {"m42": ((4, 2), ("data", "model")),
          "m24": ((2, 4), ("data", "model")),
          "m222": ((2, 2, 2), ("pod", "data", "model"))}
ENGINE_NEW = 4


def _cfg(cls, name, cf=None):
    kw = {**BASE, **CONFIGS[name]}
    if cf is not None:
        kw["capacity_factor"] = cf
    return cls(name=f"tiny-{name}", **kw)


def _data(cls, vocab):
    return cls(vocab_size=vocab, seq_len=SEQ, global_batch=BATCH)


def _prompts():
    return np.random.default_rng(5).integers(0, 200, (2, 8)).astype(np.int32)


def _whole_tree(params) -> dict:
    """{JAX path: stacked numpy leaf} of a port parameter tree."""
    from repro_torch.checkpoint import checkpointer as ckpt_mod

    return {p: ckpt_mod._stack(leaf).numpy()
            for p, leaf in ckpt_mod._paths(params)}


# ---------------------------------------------------------------------------
# the port's side: one world of 8 ranks runs every case
# ---------------------------------------------------------------------------

def _port_cases(rank, meshes, tmp):
    """(results every rank must share bit for bit, this rank's own)."""
    import contextlib

    import torch.distributed as dist

    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import ExecLevel, use_level
    from repro_torch.core.topology import LocalMesh
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import model_split as ms
    from repro_torch.distributed.collectives import reduce_plan
    from repro_torch.distributed.partition import model_dims, param_specs
    from repro_torch.distributed.sharding import sharded_rows
    from repro_torch.launch.train import Trainer
    from repro_torch.models.lm import LM
    from repro_torch.runtime import replan
    from repro_torch.serve import ContinuousEngine, Engine, SamplingParams
    from repro_torch.train.step import (model_shard, mesh_loss,
                                        shard_batch, value_and_grad,
                                        whole_state)
    from repro_torch.utils.tree import tree_map

    shared, own = {}, {}

    def record(where, name, fn):
        try:
            where[name] = fn()
        except Exception as e:                  # the test reads it
            where[name] = {"raised": f"{type(e).__name__}: {e}"}

    def whole_params(t):
        return _whole_tree(whole_state(t.state, t.plan, t.dims, t.split,
                                       t.mdims).params)

    def trainer_run(cfg, mesh, steps, level=None, **kw):
        with use_level(ExecLevel[level], mesh) if level else \
                contextlib.nullcontext():
            t = Trainer(cfg, mesh=mesh, device="cpu", **kw)
            hist = t.fit(_data(SyntheticLM, cfg.vocab_size), steps,
                         log_every=1)["history"]
        return t, [h["loss"] for h in hist]

    def trainers():
        got = {}
        for name, cf, mesh, level in TRAIN_RUNS:
            t, losses = trainer_run(_cfg(ModelConfig, name, cf),
                                    meshes[mesh], STEPS, level)
            got[f"{name} {cf} {mesh} {level}"] = {
                "losses": losses, "params": whole_params(t)}
        return got
    record(shared, "train", trainers)

    def grads():
        """One step's loss and gradients (and the MoE's aux_lb), each
        gradient summed over the data ranks and gathered whole."""
        got = {}
        runs = GRAD_RUNS + (("moe", "m42"),)
        for name, mesh_name in runs:
            mesh = meshes[mesh_name]
            cfg = _cfg(ModelConfig, name, 1.0 if name == "moe" else None)
            lm = LM(cfg)
            plan, split = reduce_plan(mesh), ms.split_of(mesh, held=True)
            params = lm.init(0, device="cpu")
            mdims = model_dims(param_specs(params))
            shards = tree_map(lambda p, m: model_shard(p, m, split),
                              params, mdims)
            batch = _data(SyntheticLM, cfg.vocab_size).batch(0)
            with sharded_rows(plan), ms.splitting(split):
                (loss, metrics), g = value_and_grad(
                    mesh_loss(lm.loss, plan), shards,
                    shard_batch(mesh, batch))
            g = tree_map(lambda x, m: x if m is None else
                         split.all_gather(x, m),
                         tree_map(plan.psum_all, g), mdims)
            got[f"{name} {mesh_name}"] = {
                "loss": float(plan.psum_all(loss.reshape(1))[0]),
                "grads": _whole_tree(g)}
            if name == "moe":           # the global mean over the ranks
                got[f"{name} {mesh_name}"]["aux_lb"] = float(plan.psum_all(
                    metrics["aux_lb"].reshape(1))[0] / plan.width)
        return got
    record(shared, "grads", grads)

    ck = os.path.join(tmp, "ckpt")

    def checkpoints():
        """Save at 2 on (data 4, model 2) and resume there to 3 (bitwise
        the uninterrupted run); restore on (data 2, model 2) with replan's
        microbatches and go on to 3 (ranks 4-7 sit that one out)."""
        got = {}
        cfg = _cfg(ModelConfig, "untied")
        t, got["uninterrupted"] = trainer_run(cfg, meshes["m42"], STEPS)
        got["uninterrupted params"] = whole_params(t)
        trainer_run(cfg, meshes["m42"], 2, ckpt_dir=ck)
        if rank == 0:
            import shutil
            shutil.copytree(ck, ck + "-elastic")
        dist.barrier()
        t, got["resumed"] = trainer_run(cfg, meshes["m42"], STEPS,
                                        ckpt_dir=ck)
        got["resumed params"] = whole_params(t)
        plan = replan(4, model=2, global_batch=BATCH, per_replica_batch=2)
        got["replan"] = (plan.data, plan.model, plan.microbatches)
        if rank < 4:
            t, losses = trainer_run(cfg, meshes["m22"], STEPS,
                                    ckpt_dir=ck + "-elastic",
                                    microbatches=plan.microbatches)
            own["elastic"] = losses
            own["elastic wq"] = tuple(
                t.state.params["layers"][0]["attn"]["wq"].shape)
        dist.barrier()
        return got
    record(shared, "checkpoints", checkpoints)

    def engine():
        cfg = _cfg(ModelConfig, "untied")
        lm = LM(cfg)
        params = lm.init(0, device="cpu")
        with use_level(ExecLevel.O3, meshes["m24"]):
            eng = Engine(lm, params, max_len=16,
                         sampling=SamplingParams(greedy=True))
        toks = eng.generate(torch.as_tensor(_prompts()),
                            max_new_tokens=ENGINE_NEW)
        return {"tokens": toks.numpy(), "split": eng.split.size}
    record(shared, "engine", engine)

    def continuous():
        cfg = _cfg(ModelConfig, "untied")
        lm = LM(cfg)
        with use_level(ExecLevel.O3, meshes["m24"]):
            ContinuousEngine(lm, lm.init(0, device="cpu"), num_slots=2,
                             max_len=32)
    record(shared, "continuous", continuous)

    def local_mesh():
        Trainer(_cfg(ModelConfig, "dense"), device="cpu",
                mesh=LocalMesh(("data", "model"), (1, 2)))
    record(shared, "local_mesh", local_mesh)
    return shared, own


def _port_world(rank: int, world: int, tmp: str):
    from repro_torch.launch.mesh import make_mesh

    # eight ranks share the host's cores: one thread each
    torch.set_num_threads(1)
    meshes = {"m42": make_mesh(data=4, model=2, device_type="cpu"),
              "m24": make_mesh(data=2, model=4, device_type="cpu"),
              "m222": make_mesh(data=2, model=2, pod=2, device_type="cpu"),
              "m22": make_mesh(data=2, model=2, device_type="cpu")}
    return _port_cases(rank, meshes, tmp)


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

def _jax_params(cfg):
    """The port's seeded parameters of ``cfg`` (as every rank draws them),
    restacked in the JAX package's layout."""
    import jax.numpy as jnp

    from repro_torch.models.lm import LM

    tree: dict = {}
    for path, leaf in _whole_tree(LM(cfg).init(0, device="cpu")).items():
        keys = re.findall(r"\['([^']+)'\]", path)
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = jnp.asarray(leaf)
    return tree


def _jax_cases(tmp):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from repro.checkpoint import Checkpointer as JCheckpointer
    from repro.configs.base import ModelConfig as JCfg
    from repro.core import ExecLevel, compat, use_level
    from repro.data import SyntheticLM as JSyntheticLM
    from repro.distributed.partition import param_specs, zero1_specs
    from repro.launch import train as jtrain
    from repro.launch.train import Trainer as JTrainer
    from repro.models.lm import LM as JLM
    from repro.optim import adamw
    from repro.optim.adamw import AdamState
    from repro.serve import Engine as JEngine
    from repro.serve import SamplingParams as JSampling
    from repro.train import TrainState
    from repro_torch.configs.base import ModelConfig

    meshes = {k: compat.make_mesh(*v) for k, v in MESHES.items()}
    meshes[None] = None
    out = {}

    def run(name, cf, mesh, steps, level=None):
        jcfg = _cfg(JCfg, name, cf)
        params = _jax_params(_cfg(ModelConfig, name, cf))
        # the trainer starts from these parameters: its ``create`` (an
        # eager init, seconds a run) is stood in for while it is built
        real = jtrain.create
        jtrain.create = lambda lm, opt, key: TrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            opt_state=opt.init(params))
        try:
            with use_level(ExecLevel[level], mesh) if level else _Null():
                t = JTrainer(jcfg, mesh=mesh)
                hist = t.fit(_data(JSyntheticLM, jcfg.vocab_size), steps,
                             log_every=1)["history"]
        finally:
            jtrain.create = real
        leaves = jax.tree_util.tree_flatten_with_path(t.state.params)[0]
        return {"losses": [h["loss"] for h in hist],
                "params": {jax.tree_util.keystr(p): np.asarray(x)
                           for p, x in leaves}}

    for key in sorted({_reference(r) for r in TRAIN_RUNS},
                      key=str):
        name, cf, mesh, level = key
        out[f"train {key}"] = run(name, cf, meshes[mesh], STEPS, level)
    out["train untied"] = run("untied", None, None, STEPS)

    for name in sorted({n for n, _ in GRAD_RUNS}):
        jcfg = _cfg(JCfg, name)
        lm = JLM(jcfg)
        batch = {k: jnp.asarray(v) for k, v in
                 _data(JSyntheticLM, jcfg.vocab_size).batch(0).items()}
        (loss, _), g = jax.jit(jax.value_and_grad(lm.loss, has_aux=True))(
            _jax_params(_cfg(ModelConfig, name)), batch)
        out[f"grads {name}"] = {
            "loss": float(loss),
            "grads": {jax.tree_util.keystr(p): np.asarray(x) for p, x in
                      jax.tree_util.tree_flatten_with_path(g)[0]}}

    # the MoE's aux_lb at (data 4, model 2): 4 dispatch groups, as the
    # reference's trainer takes under its mesh
    jcfg = _cfg(JCfg, "moe", 1.0)
    batch = {k: jnp.asarray(v) for k, v in
             _data(JSyntheticLM, jcfg.vocab_size).batch(0).items()}
    with compat.set_mesh(meshes["m42"]):
        loss, metrics = jax.jit(JLM(jcfg).loss)(
            _jax_params(_cfg(ModelConfig, "moe", 1.0)), batch)
    out["moe aux"] = {"loss": float(loss),
                      "aux_lb": float(metrics["aux_lb"])}

    # the manifest the reference writes with its trainer's specs
    jcfg = _cfg(JCfg, "untied")
    qp = _jax_params(_cfg(ModelConfig, "untied"))
    opt = adamw(lambda count: 1e-3)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=qp,
                       opt_state=opt.init(qp))
    m = zero1_specs(qp, meshes["m42"])
    specs = TrainState(step=JP(), params=param_specs(qp),
                       opt_state=AdamState(count=JP(), mu=m, nu=m))
    JCheckpointer(os.path.join(tmp, "jax-ckpt")).save(2, state, specs=specs)
    out["manifest"] = _manifest(os.path.join(tmp, "jax-ckpt"), 2)

    greedy = JSampling(greedy=True)
    with use_level(ExecLevel.O3, meshes["m24"]):
        eng = JEngine(JLM(jcfg), qp, max_len=16, sampling=greedy)
    out["engine"] = np.asarray(eng.generate(jnp.asarray(_prompts()),
                                            max_new_tokens=ENGINE_NEW))
    return out


class _Null:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


def _reference(run: tuple) -> tuple:
    """The reference run (config, capacity factor, mesh, level) a Trainer
    run is held against (:data:`REFERENCE`)."""
    name, cf, mesh, level = run
    return (name, cf) + REFERENCE.get((name, cf), (mesh, level))


def _manifest(directory, step):
    import json

    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(rank 0's shared results, every rank's own, the JAX package's):
    the 8-rank gloo world runs while the JAX side computes; the shared
    results must be the same bits on every rank."""
    from repro_torch.launch.world import start_world

    tmp = str(tmp_path_factory.mktemp("model-axis"))
    world = start_world(_port_world, WORLD, args=(tmp,), timeout=240)
    try:
        jx = _jax_cases(tmp)
    finally:
        ranks = world.join()
    for r, (shared, _) in enumerate(ranks[1:], 1):
        assert _same_bits(shared, ranks[0][0]), \
            f"rank {r} differs from rank 0"
    return ranks[0][0], [own for _, own in ranks], jx, tmp


def _ok(res):
    assert not (isinstance(res, dict) and res.get("raised")), res["raised"]
    return res


def _close_trees(got: dict, want: dict, what: str) -> None:
    assert sorted(got) == sorted(want), what
    for path in want:
        np.testing.assert_allclose(got[path], want[path], **TOL,
                                   err_msg=f"{what}: {path}")


# ---------------------------------------------------------------------------
# the memory count at a model width (no world)
# ---------------------------------------------------------------------------

def test_train_peak_bytes_at_model_2_by_hand():
    """qwen3-1.7b at 4 layers on (data 2, model 2), 4 ranks on one card,
    1024 positions a rank: the parameters a rank holds from the specs (the
    leaves split over ``model`` a half each, the norms and the lane
    floor's wk / wv whole), bf16 parameters (2) and gradients (4) of
    them, the moments (8) and the update's transients (12) a half each
    over data 2, and the logits' chain over half the vocabulary."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import train

    cfg = dataclasses.replace(get_config("qwen3-1.7b"), num_layers=4)
    d, hd, hk = cfg.d_model, cfg.head_dim, cfg.num_kv_heads
    split = cfg.padded_vocab * d + 4 * (
        cfg.num_heads * hd * d * 2 + 3 * d * cfg.d_ff)
    whole = 4 * (2 * d * hk * hd + 2 * d + 2 * hd) + d
    n = train.rank_param_count(cfg, 2)
    assert n == split // 2 + whole
    tokens = 1024
    update = 4 * n * (2 + 4 + (8 + 12) / 2)
    act = tokens * (16 * cfg.padded_vocab // 2 + 2 * 4 * d)
    backward = 4 * (n * (2 + 4 + 8 / 2) + act)
    assert train.update_peak_bytes(cfg, data_width=2, ranks_per_card=4,
                                   model_width=2) == int(update)
    assert train.train_peak_bytes(cfg, tokens, data_width=2,
                                  ranks_per_card=4, model_width=2) \
        == max(int(update), int(backward))
    assert train.rank_param_count(cfg) == cfg.param_count()


# ---------------------------------------------------------------------------
# Trainer(mesh=...) against the reference's Trainer on the same mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,cf,mesh,level", TRAIN_RUNS)
def test_trainer_matches_reference(both, name, cf, mesh, level):
    """3 steps on the mesh: the losses, and every parameter gathered whole
    after them.  The MoE runs split the experts 2 a rank (model 2) and 1
    (model 4), at capacity factor 4 (no drops) and 1 (every dispatch
    group drops)."""
    shared, _, jx, _ = both
    got = _ok(shared["train"])[f"{name} {cf} {mesh} {level}"]
    want = jx[f"train {_reference((name, cf, mesh, level))}"]
    np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
    _close_trees({".params" + k: v for k, v in got["params"].items()},
                 {".params" + k: v for k, v in want["params"].items()},
                 f"{name} at {mesh}")


@pytest.mark.parametrize("name,mesh", GRAD_RUNS)
def test_gradients_match_jax_grad(both, name, mesh):
    """One step's loss and every gradient, gathered whole, against
    ``jax.value_and_grad`` of the reference loss: the lane floor's
    replicated wk / wv and qk_norm's scales (each rank's part summed by
    ``into``), the norms (whole on every rank, not summed), the embedding
    tied and not with the padding on the last model rank, and heads that
    do not divide the model axis (the attention whole on every rank)."""
    shared, _, jx, _ = both
    got = _ok(shared["grads"])[f"{name} {mesh}"]
    want = jx[f"grads {name}"]
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    _close_trees(got["grads"], want["grads"], f"{name} at {mesh}")


def test_moe_aux_lb_matches_reference(both):
    """tiny("moe") at capacity factor 1 on (data 4, model 2): the loss and
    the load-balancing loss (global means) against the reference's under
    its mesh, whose 4 dispatch groups are the port's data shards."""
    shared, _, jx, _ = both
    got = _ok(shared["grads"])["moe m42"]
    np.testing.assert_allclose(got["loss"], jx["moe aux"]["loss"], **TOL)
    np.testing.assert_allclose(got["aux_lb"], jx["moe aux"]["aux_lb"],
                               **TOL)


# ---------------------------------------------------------------------------
# checkpoints: specs, resume, replan
# ---------------------------------------------------------------------------

def test_manifest_specs_match_reference(both):
    _, _, jx, tmp = both
    got = _manifest(os.path.join(tmp, "ckpt"), 2)
    want = jx["manifest"]
    assert [e["path"] for e in got["leaves"]] == \
        [e["path"] for e in want["leaves"]]
    assert [e["shape"] for e in got["leaves"]] == \
        [e["shape"] for e in want["leaves"]]
    assert got["specs"] == want["specs"]
    assert "PartitionSpec(None, None, 'model')" in got["specs"]


def test_resume_on_the_same_mesh_is_bitwise(both):
    shared, _, jx, _ = both
    got = _ok(shared["checkpoints"])
    assert got["resumed"] == got["uninterrupted"][2:]
    assert _same_bits(got["resumed params"], got["uninterrupted params"])
    np.testing.assert_allclose(got["uninterrupted"],
                               jx["train untied"]["losses"], **TOL)


def test_restore_after_replan_on_data2_model2(both):
    """The (data 4, model 2) checkpoint of step 2 restored on (data 2,
    model 2), each rank keeping its model shard and its half of the
    moments, at replan's 2 microbatches: step 3's loss within 1e-5 of the
    uninterrupted run's."""
    shared, own, _, _ = both
    got = _ok(shared["checkpoints"])
    assert got["replan"] == (2, 2, 2)
    for r in range(4):
        np.testing.assert_allclose(own[r]["elastic"],
                                   got["uninterrupted"][2:], **TOL)
        assert own[r]["elastic wq"] == (32, 16)      # (d, heads * hd / 2)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_engine_tokens_match_reference_at_data2_model4(both):
    shared, _, jx, _ = both
    got = _ok(shared["engine"])
    assert got["split"] == 4
    np.testing.assert_array_equal(got["tokens"], jx["engine"])


def test_continuous_engine_raises_naming_10b_iii_b(both):
    got = both[0]["continuous"]
    assert "NotImplementedError" in got["raised"]
    assert "queue 1 item 10b-iii-b" in got["raised"]


def test_model_axis_without_a_process_group_raises(both):
    got = both[0]["local_mesh"]
    assert got["raised"].startswith("ValueError")
    assert "no process group" in got["raised"]
